"""The plan of the split-K binary product on the tensor cores
(``csrc/bmma.cuh``), which K4's grouped mode and K6's ``gb_counts`` run:
its passes and the ring each block sizes for a pass, mirrored from the
C defines so that the tests hold them without a card (they read the
defines and fail on a drift).

The product is ``out[i, j] = Σ popcount(A_i & B_j)`` over whole
``[S, W]`` planes: A the GroupBy masks, B the magnitude planes and a
column of ones (K4) or the rows the ids pick (K6). A pass takes
``A_PLANES`` masks and ``BSI_COLS`` (K4) or ``PAIR_COLS`` (K6) columns,
and is one launch of the kernel that reads its planes once; more masks
or columns take further passes. Each stage of a block's ring holds a
chunk of every loaded plane, and a position of zeros and one of ones;
the chunk is the longest that leaves ``MIN_STAGES`` stages.
"""

from __future__ import annotations

CHUNK_MIN = 256  # BM_CH_MIN: words of a plane per chunk at least (32 k-steps)
CHUNK_MAX = 2048  # BM_CH_MAX
MIN_STAGES = 2  # BM_MIN_STAGES
A_PLANES = 32  # BM_A_PLANES: masks per pass
BSI_COLS = 24  # BM_BSI_COLS: K4's columns per pass (magnitude bits, then the ones)
PAIR_COLS = 64  # BM_PAIR_COLS: K6's ids per pass
MAX_STAGES = 8  # BM_MAX_STAGES
SMEM_BYTES = 229376  # BM_SMEM_BYTES: a block's dynamic shared memory
HEAD_BYTES = 18176  # BM_HEAD_BYTES: the block's sums, barriers and plane tables


def chunk(n_live: int) -> tuple[int, int]:
    """(chunk words, stages) of a block's ring for ``n_live`` loaded
    planes: the longest chunk that leaves MIN_STAGES stages, else the
    shortest with the stages that fit, at most MAX_STAGES."""
    n_pos = n_live + 2  # and a position of zeros, one of ones
    ch = CHUNK_MAX
    while True:
        stages = (SMEM_BYTES - HEAD_BYTES) // (n_pos * (4 * ch + 16))
        if stages >= MIN_STAGES or ch == CHUNK_MIN:
            return ch, min(stages, MAX_STAGES)
        ch //= 2


def ring_bytes(n_live: int) -> int:
    """The shared memory a block's head and ring take for ``n_live``
    loaded planes (within SMEM_BYTES, which every block is given)."""
    ch, stages = chunk(n_live)
    return HEAD_BYTES + stages * (n_live + 2) * (4 * ch + 16)


def passes(bsi: bool, n_groups: int, n_cols: int) -> list[tuple[int, int, int, int]]:
    """(first mask, masks, first column, columns) of each launch, in
    order: K4 has ``n_cols = D + 1`` (the ones count n), K6 ``n_cols =
    K``."""
    per = BSI_COLS if bsi else PAIR_COLS
    return [
        (g0, min(A_PLANES, n_groups - g0), c0, min(per, n_cols - c0))
        for g0 in range(0, n_groups, A_PLANES)
        for c0 in range(0, n_cols, per)
    ]
