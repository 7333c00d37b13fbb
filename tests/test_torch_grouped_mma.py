"""K4's grouped mode and K6's gb_counts: the split-K binary product on
the tensor cores (csrc/bmma.cuh) and what stands beside it on the CPU.

(a) The plain versions, which the kernels are held to on the card, against
pilosa_tpu's grouped Sum (``jax.vmap(Executor._sum_fn, in_axes=(None,
0))``) and ``_gb_counts``, exactly, at the edges of the new route: G of 2,
16, 17 and 33 masks (one mask octet, two, a third begun, a second pass),
depths 0, 1, 20, 24, 25 and 63 (the ones column alone, three column
tiles, a second pass of columns), short stacks, all-ones and bit-31 words;
ids -1, R and 2^30 for K6.
(b) On ``meta`` tensors, with the C entries swapped for recorders, what
each wrapper hands its kernel and the route and mode it takes.
(c) The route function and the passes, and that every pass's ring fits a
block's 232,448 B of shared memory on the H100.
(d) The Python plan's constants are the sources' defines.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.executor.executor import Executor as RefExecutor
from pilosa_tpu.executor.executor import _gb_counts
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.ops import _cuda, bmma, bsi, groupby
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

W = WORDS_PER_SHARD
SHARDS = 2
# the shared memory a block may take on the H100 (hopper-kernels guide)
SMEM_PER_BLOCK = 232448
GROUPED = jax.jit(jax.vmap(RefExecutor._sum_fn, in_axes=(None, 0)))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _planes(rng, n: int) -> np.ndarray:
    """uint32[n, SHARDS, W] of random words; word 0 of shard 0 all ones
    and word 1 only bit 31 in every plane."""
    out = rng.integers(0, 2**32, (n, SHARDS, W), dtype=np.uint32)
    out[:, 0, 0] = 0xFFFFFFFF
    out[:, 0, 1] = 0x80000000
    return out


def _padded(stack: np.ndarray, depth: int) -> np.ndarray:
    """The reference's [2 + D, S, W] view: zero planes past the stack's
    height (compile.py:1326)."""
    out = np.zeros((2 + depth,) + stack.shape[1:], dtype=np.uint32)
    out[: min(2 + depth, stack.shape[0])] = stack[: 2 + depth]
    return out


# (G, D): every G of the route's edges and every depth at least once
SUM_CASES = [(2, 0), (2, 63), (16, 1), (16, 20), (17, 24), (17, 25), (33, 20), (33, 63)]


@pytest.mark.parametrize("n_groups,depth", SUM_CASES)
def test_grouped_sum_plain_matches_reference(rng, n_groups, depth):
    """bsi_sum_plain under G masks against the reference's grouped Sum,
    on a full stack and on a short one (the top planes missing)."""
    masks = _planes(rng, n_groups)
    masks[1] = 0xFFFFFFFF
    masks[-1, 1] = 0
    full = _planes(rng, 2 + depth)
    full[1] &= rng.integers(0, 2**32, (SHARDS, W), dtype=np.uint32)  # fewer negatives
    short = full[: max(1, 2 + depth - 3)].copy()
    for stack in (full, short):
        want = [np.asarray(x) for x in GROUPED(_padded(stack, depth), masks)]
        got = ops.bsi_sum(_t(stack), depth, _t(masks))
        assert bsi.sum_route(n_groups, depth) == "bmma"
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("n_groups,n_ids", [(2, 1), (16, 16), (17, 33), (33, 16)])
def test_gb_counts_plain_matches_reference(rng, n_groups, n_ids):
    """gb_counts_plain against _gb_counts with ids -1, R and 2^30 among
    the K. The reference's jnp.take wraps -1 to the last row (ROADMAP.md
    §C): those columns are held to zero instead."""
    n_rows = 12
    matrix = _planes(rng, n_rows)
    matrix[3] = 0xFFFFFFFF
    masks = _planes(rng, n_groups)
    ids = rng.integers(0, n_rows, n_ids).astype(np.int32)
    for i, bad in enumerate((-1, n_rows, 1 << 30)):
        if i < n_ids:
            ids[(i * 7) % n_ids] = bad
    pad = ids == -1
    want = np.asarray(_gb_counts(masks, matrix, jnp.asarray(ids)))
    got = ops.gb_counts(_t(masks), _t(matrix), torch.from_numpy(ids))
    assert got.dtype == torch.int64 and tuple(got.shape) == (n_groups, n_ids)
    assert np.array_equal(got.numpy()[:, ~pad], want[:, ~pad])
    assert not got.numpy()[:, pad].any()


# --------------------------------------------- the launches, on meta tensors
@pytest.fixture
def launches(monkeypatch):
    """K4's and K6's C entries replaced by recorders: (kernel, mode, args)."""
    calls = []
    for name in ("bsi_sum", "gb_counts"):
        kern = _cuda.KERNELS[name]
        monkeypatch.setattr(kern, "launch", lambda dev, *args, mode="", _n=name: calls.append((_n, mode, args)))
    return calls


def _meta(shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


@pytest.mark.parametrize("n_groups", [1, 2, 16, 17, 33])
@pytest.mark.parametrize("depth,present", [(0, 2), (20, 32), (24, 22), (63, 12)])
def test_bsi_sum_hands_its_kernel_the_stack_and_masks(launches, n_groups, depth, present):
    """One launch a call: the stack's plane count and vectors, the depth,
    G; mode ``grouped`` exactly where the route is ``bmma``."""
    stack, masks = _meta((present, 3, 64)), _meta((n_groups, 3, 64))
    pos, neg, n = ops.bsi_sum(stack, depth, masks)
    assert tuple(pos.shape) == tuple(neg.shape) == (n_groups, depth) and tuple(n.shape) == (n_groups,)
    ((name, mode, args),) = launches
    assert name == "bsi_sum" and args[1:4] == (3 * 64 // 4, present, depth) and args[5] == n_groups
    route = bsi.sum_route(n_groups, depth)
    assert route == ("bmma" if n_groups >= 2 else "cores")
    assert mode == ("grouped" if route == "bmma" else "filtered")
    launches.clear()
    ops.bsi_sum(stack, depth)
    assert [(m, a[5]) for _n, m, a in launches] == [("all", 1)]


@pytest.mark.parametrize("n_groups", [2, 16, 33])
@pytest.mark.parametrize("n_ids", [0, 1, 16, 33, 65])
def test_gb_counts_hands_its_kernel_masks_rows_and_ids(launches, n_groups, n_ids):
    masks, matrix = _meta((n_groups, 2, 8)), _meta((7, 2, 8))
    ids = torch.empty(n_ids, dtype=torch.int32, device="meta")
    out = ops.gb_counts(masks, matrix, ids)
    assert tuple(out.shape) == (n_groups, n_ids) and out.dtype == torch.int64
    if n_ids == 0:
        assert launches == []
        return
    ((name, mode, args),) = launches
    assert name == "gb_counts" and mode == ""
    assert (args[1], args[3], args[4], args[6]) == (n_groups, 7, 2 * 8 // 4, n_ids)


# ------------------------------------------------- the route and its passes
def test_sum_route_and_its_passes():
    assert bsi.sum_route(1, 20) == "cores"
    assert all(bsi.sum_route(g, d) == "bmma" for g in (2, 3, 16, 32, 33, 1000) for d in (0, 20, 63))
    for bad in ((0, 5), (2, -1), (2, 64)):
        with pytest.raises(ValueError):
            bsi.sum_route(*bad)
    # the taxi shapes take one pass: every plane and mask read once
    for g in (2, 10, 16, 17, 32):
        assert bsi.grouped_passes(g, 20) == [(0, g, 0, 21)]
    assert len(bsi.grouped_passes(33, 63)) == 2 * 3
    assert groupby.counts_passes(4, 16) == [(0, 4, 0, 16)]
    assert len(groupby.counts_passes(40, 4096)) == 2 * 64
    for n_groups in (1, 2, 31, 32, 33, 65):
        for n_cols, bsi_mode in ((1, True), (21, True), (24, True), (25, True), (64, True), (1, False), (64, False), (65, False)):
            ps = bmma.passes(bsi_mode, n_groups, n_cols)
            cover = np.zeros((n_groups, n_cols), dtype=int)
            for g0, n_a, c0, n_b in ps:
                assert 1 <= n_a <= bmma.A_PLANES and 1 <= n_b <= (bmma.BSI_COLS if bsi_mode else bmma.PAIR_COLS)
                cover[g0 : g0 + n_a, c0 : c0 + n_b] += 1
            assert (cover == 1).all()


def test_every_ring_fits_a_blocks_shared_memory():
    """For every count of loaded planes a pass can have (K4: its masks,
    e, s and magnitude planes; K6: its masks and ids), at least two
    stages, the head and ring within a block's shared memory, and the
    chunk a power of two in [CHUNK_MIN, CHUNK_MAX] that leaves MIN_STAGES
    stages wherever it is longer than CHUNK_MIN."""
    most = max(bmma.A_PLANES + 2 + bmma.BSI_COLS, bmma.A_PLANES + bmma.PAIR_COLS)
    for n_live in range(1, most + 1):
        ch, stages = bmma.chunk(n_live)
        assert bmma.CHUNK_MIN <= ch <= bmma.CHUNK_MAX and ch & (ch - 1) == 0
        assert 2 <= stages <= bmma.MAX_STAGES
        assert ch == bmma.CHUNK_MIN or stages >= bmma.MIN_STAGES
        assert bmma.ring_bytes(n_live) <= bmma.SMEM_BYTES <= SMEM_PER_BLOCK
        # four bytes a word and 16 more: eight positions skew over the banks
        assert (4 * ch) % 128 == 0
    # K6's 4 masks x 10 rows: 14 planes in 4 KB chunks, three stages;
    # K4's 16 masks at depth 20: 38 planes in 2 KB chunks, two stages;
    # its 32 masks: 54 planes in 1 KB chunks, three stages
    assert bmma.chunk(14) == (1024, 3) and bmma.chunk(38) == (512, 2) and bmma.chunk(54) == (256, 3)


def test_plan_is_the_sources_defines():
    """ops.bmma's constants and K4's route threshold are the ones the C
    host code plans with: a drift would size the ring past the kernel's
    shared memory or split the passes differently."""
    src = ""
    for name in ("bmma.cuh", "bsi_sum.cu"):
        with open(f"{_cuda.CSRC}/{name}") as fh:
            src += fh.read()
    d = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\b", src)}
    assert bmma.CHUNK_MIN == d["BM_CH_MIN"] and bmma.CHUNK_MAX == d["BM_CH_MAX"]
    assert bmma.MIN_STAGES == d["BM_MIN_STAGES"] and bmma.MAX_STAGES == d["BM_MAX_STAGES"]
    assert bmma.A_PLANES == d["BM_A_PLANES"] and bmma.BSI_COLS == d["BM_BSI_COLS"]
    assert bmma.PAIR_COLS == d["BM_PAIR_COLS"]
    assert bmma.SMEM_BYTES == d["BM_SMEM_BYTES"] and bmma.HEAD_BYTES == d["BM_HEAD_BYTES"]
    assert bsi.GROUPED_MIN_MASKS == d["BS_MMA_MIN_GROUPS"]
    # BmShared: the block's int64 sums, two barriers a stage, a pointer,
    # a position and a live index a plane, the live count
    head = 8 * d["BM_OUT"] + 16 * d["BM_MAX_STAGES"] + 16 * d["BM_MAX_SLOTS"] + 4
    assert head <= bmma.HEAD_BYTES and bmma.HEAD_BYTES % 128 == 0
    assert d["BM_MAX_SLOTS"] == bmma.A_PLANES + bmma.PAIR_COLS
    assert d["BM_OUT"] >= bmma.A_PLANES * max(bmma.PAIR_COLS, 2 * bmma.BSI_COLS)
