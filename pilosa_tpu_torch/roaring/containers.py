"""Roaring containers over a 16-bit value space (host side, numpy).

Re-implements the semantics of the reference's container layer
(reference: roaring/roaring.go — Container, intersectArrayArray/ArrayBitmap/
BitmapBitmap, unionRunRun, differenceBitmapRun, popcount helpers) with a
numpy-first design rather than a port of the Go pairwise-typed loops:

- ``array``  — sorted ``uint16[n]``, n <= 4096
- ``bitmap`` — ``uint64[1024]`` (65,536 bits)
- ``run``    — ``uint16[n, 2]`` inclusive [start, last] intervals, sorted

Set operations normalise mixed-type operands to whichever representation
vectorises best under numpy (the Go version hand-writes all 9 type pairs;
on host we only need this codec to be a correct oracle and a reasonably
fast CPU baseline — the hot path is the TPU packed-dense kernels in
``pilosa_tpu_torch.ops``).
"""

from __future__ import annotations

import numpy as np

ARRAY_MAX = 4096  # max cardinality for an array container (same as reference)
BITMAP_N = 1024  # uint64 words per bitmap container
CONTAINER_BITS = 1 << 16

TYPE_ARRAY = 1
TYPE_BITMAP = 2
TYPE_RUN = 3

_EMPTY_U16 = np.empty(0, dtype=np.uint16)


class Container:
    """One roaring container: (type tag, numpy payload)."""

    __slots__ = ("type", "data")

    def __init__(self, ctype: int, data: np.ndarray) -> None:
        self.type = ctype
        self.data = data

    def __repr__(self) -> str:
        name = {TYPE_ARRAY: "array", TYPE_BITMAP: "bitmap", TYPE_RUN: "run"}[self.type]
        return f"<Container {name} n={container_count(self)}>"


def array_container(values: np.ndarray) -> Container:
    return Container(TYPE_ARRAY, np.asarray(values, dtype=np.uint16))


def bitmap_container(words: np.ndarray) -> Container:
    return Container(TYPE_BITMAP, np.asarray(words, dtype=np.uint64))


def run_container(runs: np.ndarray) -> Container:
    return Container(TYPE_RUN, np.asarray(runs, dtype=np.uint16).reshape(-1, 2))


def from_values(values: np.ndarray) -> Container:
    """Array/bitmap container from sorted-unique uint16 values. No run
    detection here — this is the write hot path (one call per touched
    container per bulk import); run compaction happens at explicit
    ``optimize(runs=True)`` time (snapshot/serialize), matching the
    reference, where writes pick array-vs-bitmap by cardinality only and
    runs appear via an explicit Optimize pass."""
    values = np.asarray(values, dtype=np.uint16)
    if values.size > ARRAY_MAX:
        return bitmap_container(_values_to_words(values))
    return array_container(values)


def _values_to_words(values: np.ndarray) -> np.ndarray:
    # bool scatter + packbits: a plain index store plus one C pass —
    # ~6x faster than the bitwise_or.at ufunc scatter it replaces
    # (ufunc.at pays the generalized-indexing machinery per element;
    # this path runs once per dense container on every bulk import)
    bits = np.zeros(CONTAINER_BITS, dtype=bool)
    bits[values] = True
    return np.packbits(bits, bitorder="little").view(np.uint64)


def _words_to_values(words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint16)


def _runs_to_values(runs: np.ndarray) -> np.ndarray:
    if runs.size == 0:
        return _EMPTY_U16
    starts = runs[:, 0].astype(np.int64)
    lasts = runs[:, 1].astype(np.int64)
    lengths = lasts - starts + 1
    total = int(lengths.sum())
    # vectorised concatenation of aranges
    out = np.repeat(starts - np.concatenate(([0], np.cumsum(lengths)[:-1])), lengths)
    out = out + np.arange(total)
    return out.astype(np.uint16)


def _values_to_runs(values: np.ndarray) -> np.ndarray:
    if values.size == 0:
        return np.empty((0, 2), dtype=np.uint16)
    v = values.astype(np.int64)
    breaks = np.flatnonzero(np.diff(v) != 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [v.size - 1]))
    return np.stack([v[starts], v[ends]], axis=1).astype(np.uint16)


def as_values(c: Container) -> np.ndarray:
    """Sorted uint16 values in the container."""
    if c.type == TYPE_ARRAY:
        return c.data
    if c.type == TYPE_BITMAP:
        return _words_to_values(c.data)
    return _runs_to_values(c.data)


def as_words(c: Container) -> np.ndarray:
    """uint64[1024] bitmap view of the container."""
    if c.type == TYPE_BITMAP:
        return c.data
    if c.type == TYPE_ARRAY:
        return _values_to_words(c.data)
    # run → words: fill intervals
    words = np.zeros(BITMAP_N, dtype=np.uint64)
    if c.data.size:
        words_u8 = np.zeros(BITMAP_N * 64, dtype=np.uint8)
        for s, l in c.data.astype(np.int64):
            words_u8[s : l + 1] = 1
        words = np.packbits(words_u8, bitorder="little").view(np.uint64)
    return words


def container_count(c: Container) -> int:
    if c.type == TYPE_ARRAY:
        return int(c.data.size)
    if c.type == TYPE_BITMAP:
        return int(np.bitwise_count(c.data).sum())
    if c.data.size == 0:
        return 0
    return int(
        (c.data[:, 1].astype(np.int64) - c.data[:, 0].astype(np.int64) + 1).sum()
    )


def container_contains(c: Container, v: int) -> bool:
    if c.type == TYPE_ARRAY:
        i = int(np.searchsorted(c.data, np.uint16(v)))
        return i < c.data.size and int(c.data[i]) == v
    if c.type == TYPE_BITMAP:
        return bool((int(c.data[v >> 6]) >> (v & 63)) & 1)
    if c.data.size == 0:
        return False
    i = int(np.searchsorted(c.data[:, 0], np.uint16(v), side="right")) - 1
    return i >= 0 and int(c.data[i, 0]) <= v <= int(c.data[i, 1])


def container_add(c: Container, v: int) -> tuple[Container, bool]:
    """Return (new container, changed)."""
    if container_contains(c, v):
        return c, False
    if c.type == TYPE_ARRAY and c.data.size < ARRAY_MAX:
        i = int(np.searchsorted(c.data, np.uint16(v)))
        return array_container(np.insert(c.data, i, np.uint16(v))), True
    words = as_words(c).copy()
    words[v >> 6] |= np.uint64(1) << np.uint64(v & 63)
    out = bitmap_container(words)
    # re-optimize on a type transition; run containers (post-load) keep
    # full run re-analysis so point writes don't decompact them, while
    # array→bitmap transitions skip it (write hot path); an already-
    # bitmap container stays bitmap with no per-add re-analysis
    if c.type == TYPE_BITMAP:
        return out, True
    return optimize(out, runs=c.type == TYPE_RUN), True


def container_remove(c: Container, v: int) -> tuple[Container, bool]:
    if not container_contains(c, v):
        return c, False
    if c.type == TYPE_ARRAY:
        i = int(np.searchsorted(c.data, np.uint16(v)))
        return array_container(np.delete(c.data, i)), True
    words = as_words(c).copy()
    words[v >> 6] &= ~(np.uint64(1) << np.uint64(v & 63))
    return optimize(bitmap_container(words), runs=c.type == TYPE_RUN), True


def batch_optimize(conts: list[Container]) -> list[Container]:
    """``optimize(c, runs=True)`` over MANY containers in a few
    vectorized passes instead of one numpy micro-call chain each.

    Snapshot serialization optimizes every container on the way out; at
    bulk-ingest scale that is tens of thousands of containers, and the
    per-container ``np.diff``/``flatnonzero``/``stack`` overhead — not
    the actual bytes — dominated snapshot time (measured 2026-07-31:
    64k-container snapshot 1.9 s per-container vs ~0.03 s batched, the
    difference between 3.7 and >100 M set-bits/s persisting ingest).

    The decision rule is identical to optimize(): run rep wins iff
    4*n_runs < min(2n, 8192); else array iff n <= ARRAY_MAX; else
    bitmap. Only the winning containers pay a per-container conversion.
    """
    out = list(conts)
    # --- array containers: adjacency analysis over ONE concatenation
    arr_idx = [
        i for i, c in enumerate(conts) if c.type == TYPE_ARRAY and c.data.size
    ]
    if arr_idx:
        sizes = np.fromiter(
            (conts[i].data.size for i in arr_idx), np.int64, len(arr_idx)
        )
        vals = np.concatenate([conts[i].data for i in arr_idx]).astype(np.int32)
        ends = np.cumsum(sizes)
        adj = (np.diff(vals) == 1).astype(np.int64)
        if adj.size:
            # kill adjacency across container boundaries (pair j spans
            # positions j, j+1; boundary pairs start at ends[:-1]-1)
            adj[ends[:-1] - 1] = 0
        cum = np.concatenate(([0], np.cumsum(adj)))
        # pairs fully inside container k: indices [start, end-1)
        n_runs = sizes - (cum[ends - 1] - cum[ends - sizes])
        run_wins = 4 * n_runs < np.minimum(2 * sizes, 8192)
        for k in np.flatnonzero(run_wins):
            i = arr_idx[k]
            out[i] = run_container(_values_to_runs(conts[i].data))
    # --- bitmap containers: run starts are (word & ~prev_bit) popcounts
    bm_idx = [i for i, c in enumerate(conts) if c.type == TYPE_BITMAP]
    if bm_idx:
        words = np.stack([conts[i].data for i in bm_idx])  # [k, 1024] u64
        prev = words << np.uint64(1)
        prev[:, 1:] |= words[:, :-1] >> np.uint64(63)
        n_runs = np.bitwise_count(words & ~prev).sum(axis=1).astype(np.int64)
        n = np.bitwise_count(words).sum(axis=1).astype(np.int64)
        run_wins = 4 * n_runs < np.minimum(2 * n, 8192)
        for k, i in enumerate(bm_idx):
            if n[k] == 0:
                out[i] = array_container(_EMPTY_U16)
            elif run_wins[k]:
                out[i] = run_container(_values_to_runs(as_values(conts[i])))
            elif n[k] <= ARRAY_MAX:
                out[i] = array_container(_words_to_values(conts[i].data))
    return out


def optimize(c: Container, runs: bool = True) -> Container:
    """Convert to the smallest representation (reference:
    Container.optimize). ``runs=False`` skips run detection (the write
    paths use it only to settle array-vs-bitmap after a type-changing
    mutation); full run compaction is for snapshot/serialize time."""
    n = container_count(c)
    if n == 0:
        return array_container(_EMPTY_U16)
    if not runs:
        if c.type != TYPE_RUN:
            if n <= ARRAY_MAX and c.type != TYPE_ARRAY:
                return array_container(as_values(c))
            if n > ARRAY_MAX and c.type != TYPE_BITMAP:
                return bitmap_container(as_words(c))
            return c
        # fall through for run containers: re-analyze fully
    values = as_values(c)
    rns = _values_to_runs(values)
    # sizes in bytes: array 2n, bitmap 8192, run 4*len(runs)
    run_sz, arr_sz = 4 * rns.shape[0], 2 * n
    if run_sz < min(arr_sz, 8192):
        return run_container(rns)
    if n <= ARRAY_MAX:
        return array_container(values)
    return bitmap_container(as_words(c))


def _binary_op(a: Container, b: Container, op: str) -> Container:
    """Typed-pair dispatch collapsed to two fast paths: sorted-array merges
    when both sides are arrays, uint64 word ops otherwise."""
    if a.type == TYPE_ARRAY and b.type == TYPE_ARRAY:
        if op == "and":
            out = np.intersect1d(a.data, b.data, assume_unique=True)
        elif op == "or":
            # linear merge of the two sorted sides — np.union1d re-sorts
            # the concatenation (a full sort per pair, measured hot on
            # the bulk-ingest union/fold chains)
            from pilosa_tpu_torch import native

            out = native.merge_unique_u64(
                a.data.astype(np.uint64), b.data.astype(np.uint64)
            )
        elif op == "xor":
            out = np.setxor1d(a.data, b.data, assume_unique=True)
        else:  # andnot
            out = np.setdiff1d(a.data, b.data, assume_unique=True)
        return from_values(out.astype(np.uint16))
    wa, wb = as_words(a), as_words(b)
    if op == "and":
        w = wa & wb
    elif op == "or":
        w = wa | wb
        if a.type == TYPE_BITMAP or b.type == TYPE_BITMAP:
            # a union can only ADD bits: with a >ARRAY_MAX side in, the
            # result stays a bitmap — optimize()'s popcount pass per
            # container is pure overhead on the bulk-ingest union chain
            # (serialize-time batch_optimize still run-compacts)
            return bitmap_container(w)
    elif op == "xor":
        w = wa ^ wb
    else:
        w = wa & ~wb
    return optimize(bitmap_container(w), runs=False)


def container_and(a: Container, b: Container) -> Container:
    return _binary_op(a, b, "and")


def container_or(a: Container, b: Container) -> Container:
    return _binary_op(a, b, "or")


def container_xor(a: Container, b: Container) -> Container:
    return _binary_op(a, b, "xor")


def container_andnot(a: Container, b: Container) -> Container:
    return _binary_op(a, b, "andnot")
