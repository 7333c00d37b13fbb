"""The BSI and GroupBy slice of pilosa_tpu_torch against pilosa_tpu.

The plain torch versions of ops/bsi.py and ops/groupby.py (K4, K5, K6
and K1's CMP opcode run them on the CPU) are held against
pilosa_tpu.ops.bsi and the reference executor's GroupBy programs, on
inputs made with numpy from a seed. Every result is an integer, so every
comparison is exact. Blocks hold encoded values around the constants
compared (0, ±1, ±(2^D − 1)), all-ones and bit-31 words, and raw random
words; stacks hold fewer planes than 2 + D (read as zeros) or more
(ignored).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pilosa_tpu.core as ref_core
import pilosa_tpu_torch.core as pt_core
from pilosa_tpu import ops as ref_ops
from pilosa_tpu.executor.compile import QueryCompiler as RefCompiler
from pilosa_tpu.executor.executor import Executor as RefExecutor
from pilosa_tpu.executor.executor import _gb_counts, _gb_masks
from pilosa_tpu.pql import parse as ref_parse
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.executor.compile import QueryCompiler
from pilosa_tpu_torch.ops import _cuda, bitwise, bsi, groupby
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

from _torch_parity import N_SHARDS, fill

W = WORDS_PER_SHARD
DEPTHS = [1, 11, 20]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _constants(depth: int) -> list[int]:
    top = (1 << depth) - 1
    return sorted({0, 1, -1, 2, -2, top, -top, top - 1, 1 << depth, -(1 << depth), 5, -5})


def _encode(values: np.ndarray, exists: np.ndarray, depth: int) -> np.ndarray:
    """Sign-magnitude BSI planes of one shard → uint32[2 + D, W]."""
    bits = np.zeros((2 + depth, values.size), dtype=bool)
    bits[0] = exists
    bits[1] = exists & (values < 0)
    mag = np.abs(values)
    for k in range(depth):
        bits[2 + k] = exists & ((mag >> k) & 1).astype(bool)
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def _block(rng, depth: int, shards: int = 0) -> np.ndarray:
    """uint32[2 + D, W] (or [2 + D, S, W]): values drawn around the
    constants, ~85 % of columns present; word 0 holds all-ones
    magnitudes under existence and a positive sign (value 2^D − 1 in all
    32 columns), word 1 only bit 31 in every plane (one column at
    −(2^D − 1))."""
    n = shards or 1
    blocks = []
    for _ in range(n):
        pool = np.array(_constants(depth) + [0], dtype=np.int64)
        pool = pool[np.abs(pool) < (1 << depth)]
        vals = np.where(
            rng.random(W * 32) < 0.5,
            rng.choice(pool, W * 32),
            rng.integers(-(1 << depth) + 1, 1 << depth, W * 32),
        )
        blk = _encode(vals, rng.random(W * 32) < 0.85, depth)
        blk[:, 0] = 0xFFFFFFFF
        blk[1, 0] = 0
        blk[:, 1] = 0x80000000
        blocks.append(blk)
    return np.stack(blocks, axis=1) if shards else blocks[0]


@pytest.mark.parametrize("depth", DEPTHS)
def test_compare_between_and_magnitude_match_reference(rng, depth):
    blocks = [_block(rng, depth), rng.integers(0, 2**32, (2 + depth, W), dtype=np.uint32)]
    for blk in blocks:
        t = _t(blk)
        for c in _constants(depth):
            if abs(c) < 1 << depth:
                want = [np.asarray(x) for x in ref_ops.bsi._magnitude_cmp(blk[2:], abs(c))]
                got = [_u(x) for x in bsi._magnitude_cmp(t[2:], abs(c))]
                assert all(np.array_equal(g, w) for g, w in zip(got, want)), c
            for op in bsi.CMP_OPS:
                want = np.asarray(ref_ops.bsi.compare(blk, op, c))
                assert np.array_equal(_u(bsi.compare(t, op, c)), want), (op, c)
                # a list of planes, as K1's plain interpreter passes them
                planes = bsi.bsi_planes(t, depth)
                assert np.array_equal(_u(bsi.compare(planes, op, c)), want), (op, c)
        top = (1 << depth) - 1
        for lo, hi in ((-5, 5), (0, top), (-top, -1), (3, -3), (-(1 << depth), 1 << depth)):
            want = np.asarray(ref_ops.bsi.between(blk, lo, hi))
            assert np.array_equal(_u(bsi.between(t, lo, hi)), want), (lo, hi)


@pytest.mark.parametrize("depth", DEPTHS)
def test_sum_counts_and_min_max_match_reference(rng, depth):
    for blk in (_block(rng, depth), rng.integers(0, 2**32, (2 + depth, W), dtype=np.uint32)):
        for filt in (
            np.full(W, 0xFFFFFFFF, dtype=np.uint32),
            rng.integers(0, 2**32, W, dtype=np.uint32),
            np.zeros(W, dtype=np.uint32),
        ):
            rp, rn, rc = ref_ops.bsi.sum_counts(blk, filt)
            p, n, c = bsi.sum_counts(_t(blk), _t(filt))
            assert p.dtype == torch.int32 and c.dtype == torch.int64
            assert np.array_equal(p.numpy(), np.asarray(rp))
            assert np.array_equal(n.numpy(), np.asarray(rn))
            assert int(c) == int(rc)
            assert bsi.weigh_sum(p, n) == ref_ops.bsi.weigh_sum(np.asarray(rp), np.asarray(rn))
            for want_max in (False, True):
                rv, rcount = ref_ops.bsi.min_max(blk, filt, want_max)
                v, count = bsi.min_max(_t(blk), _t(filt), want_max)
                assert (int(v), int(count)) == (int(rv), int(rcount)), want_max


def _padded(stack: np.ndarray, depth: int) -> np.ndarray:
    """The reference's [2 + D, S, W] view of a stack: zero planes past
    its height, planes past 2 + D dropped (compile.py:1326)."""
    need = 2 + depth
    out = np.zeros((need,) + stack.shape[1:], dtype=np.uint32)
    out[: min(need, stack.shape[0])] = stack[:need]
    return out


def _stacks(rng, depth: int, shards: int):
    """(stack, depth) pairs: exactly 2 + D planes, the top magnitude
    planes missing, and extra planes past 2 + D holding garbage."""
    full = _block(rng, depth, shards)
    # a shard with no value at all: count 0 in Min/Max
    full[:, shards - 1] = 0
    short = full[: max(1, 2 + depth - 3)].copy()
    extra = np.concatenate([full, rng.integers(0, 2**32, (3, shards, W), dtype=np.uint32)])
    return [full, short, extra]


@pytest.mark.parametrize("depth", DEPTHS)
def test_bsi_sum_plain_matches_reference_sum_programs(rng, depth):
    """K4's plain version against the reference's _sum_fn and its group
    vmap, on stacks of every height and with G = 1 and G = 3 masks."""
    shards = 3
    masks = rng.integers(0, 2**32, (3, shards, W), dtype=np.uint32)
    masks[1] = 0xFFFFFFFF
    plain = jax.jit(RefExecutor._sum_fn)
    grouped = jax.jit(jax.vmap(RefExecutor._sum_fn, in_axes=(None, 0)))
    for stack in _stacks(rng, depth, shards):
        slices = _padded(stack, depth)
        ones = np.full((shards, W), 0xFFFFFFFF, dtype=np.uint32)
        want = [np.asarray(x) for x in plain(slices, ones)]
        pos, neg, n = ops.bsi_sum(_t(stack), depth)
        assert pos.dtype == neg.dtype == n.dtype == torch.int64
        assert np.array_equal(pos.numpy(), want[0][None])
        assert np.array_equal(neg.numpy(), want[1][None])
        assert np.array_equal(n.numpy(), np.atleast_1d(want[2]))
        want = [np.asarray(x) for x in grouped(slices, masks)]
        got = ops.bsi_sum(_t(stack), depth, _t(masks))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("depth", DEPTHS)
def test_bsi_min_max_plain_matches_reference_min_max(rng, depth):
    shards = 3
    filt = rng.integers(0, 2**32, (shards, W), dtype=np.uint32)
    full, short, extra = _stacks(rng, depth, shards)
    # the extra planes are ignored: ``extra`` is held to ``full``'s answers
    for stack in (full, short):
        slices = _padded(stack, depth)
        for want_max in (False, True):
            ref_fn = jax.vmap(
                lambda ss, ff, m=want_max: ref_ops.bsi.min_max(ss, ff, want_max=m),
                in_axes=(1, 0),
            )
            for f in (None, filt):
                ff = np.full((shards, W), 0xFFFFFFFF, dtype=np.uint32) if f is None else f
                rv, rc = (np.asarray(x) for x in ref_fn(slices, ff))
                v, c = ops.bsi_min_max(_t(stack), depth, None if f is None else _t(f), want_max)
                assert v.dtype == c.dtype == torch.int64
                assert np.array_equal(v.numpy(), rv) and np.array_equal(c.numpy(), rc)
                assert c[shards - 1] == 0
                if stack is full:
                    v, c = ops.bsi_min_max(_t(extra), depth, None if f is None else _t(f), want_max)
                    assert np.array_equal(v.numpy(), rv) and np.array_equal(c.numpy(), rc)


def test_groupby_plain_matches_reference_programs(rng):
    """K6's plain versions against _gb_counts and _gb_masks: rows past R,
    G padding, all-ones and bit-31 rows. A padding row id of -1 reads a
    zero row here; the reference's jnp.take wraps -1 to the stack's last
    row (ROADMAP.md §C), so those slots are held to zero instead."""
    m = rng.integers(0, 2**32, (5, 2, W), dtype=np.uint32)
    m[3] = 0xFFFFFFFF
    m[4] = 0x80000000
    masks = rng.integers(0, 2**32, (3, 2, W), dtype=np.uint32)
    masks[2] = 0xFFFFFFFF
    rows = np.array([0, 4, -1, 3, 7, 2, -1, 1 << 30], dtype=np.int32)
    pad = rows == -1
    want = np.asarray(_gb_counts(masks, m, jnp.asarray(rows)))
    got = ops.gb_counts(_t(masks), _t(m), torch.from_numpy(rows))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy()[:, ~pad], want[:, ~pad])
    assert not got.numpy()[:, pad].any() and want[:, pad].all()
    g_idx = np.array([0, 2, 1, 2, 0, 0, 0, 0], dtype=np.int32)
    row_sel = np.array([1, 3, 4, -1, 0, -1, 9, -1], dtype=np.int32)
    pad = row_sel == -1
    want = np.asarray(_gb_masks(masks, m, jnp.asarray(g_idx), jnp.asarray(row_sel)))
    got = _u(ops.gb_masks(_t(masks), _t(m), torch.from_numpy(g_idx), torch.from_numpy(row_sel)))
    assert np.array_equal(got[~pad], want[~pad])
    assert not got[pad].any()


def test_new_wrappers_take_the_plain_version_on_cpu_tensors(rng, monkeypatch):
    def no_build(names):
        raise AssertionError(f"build attempted for {names}")

    monkeypatch.setattr(_cuda, "build", no_build)
    before = {k: v.launches for k, v in _cuda.KERNELS.items()}
    stack = _t(_block(rng, 4, 2))
    m = _t(rng.integers(0, 2**32, (3, 2, W), dtype=np.uint32))
    ops.bsi_sum(stack, 4, m)
    ops.bsi_min_max(stack, 4, m[0], True)
    ops.gb_counts(m, m, torch.tensor([0, -1], dtype=torch.int32))
    ops.gb_masks(m, m, torch.tensor([0], dtype=torch.int32), torch.tensor([2], dtype=torch.int32))
    ops.tree_eval([stack], [], [(bitwise.OP_CMP, 0)], 2, True, conds=[(0, 4, ">", 3)])
    ops.shift_words(m[0], 33)
    ops.container_count(torch.full((2, 8), -1, dtype=torch.int32), 1)
    ops.scatter_rows(m, torch.tensor([1], dtype=torch.int32), m[:1])
    keys, hist = ops.similarity.search_keys(m[0], m[0, 0], 0.3)
    ops.similarity.select_top(keys, hist, 2)
    ops.similarity.pairwise(m[0], m[1], "cosine")
    counts = torch.tensor([3, 0, 9], dtype=torch.int64)
    ops.similarity.mesh_sim_keys(counts, counts + 1, counts[2:], "cosine")
    pops = torch.tensor([1.0, 2.0], dtype=torch.float32)
    ops.similarity.mesh_pairwise_finish(pops[:, None] * pops[None, :], pops, pops, "tanimoto")
    ops.ingest_counts(m.clone(), m, m[0])
    ops.select_top_counts(counts, 2)
    assert {k: v.launches for k, v in _cuda.KERNELS.items()} == before
    assert all(k._fn is None for k in _cuda.KERNELS.values())
    assert {k.stem for k in _cuda.KERNELS.values()} == set(_cuda.SOURCES)
    assert set(_cuda.SOURCES) == {
        "tree_eval", "row_counts", "stack_delta", "bsi_sum", "bsi_minmax", "groupby",
        "shift_words", "container_count", "similarity_scan", "pairwise", "mesh_finish",
        "ingest_counts",
    }


def test_condition_table_layout_is_the_sources():
    """TE_CMP, TE_MAX_CONDS, the CmpOp order and the 4 KB parameter."""
    import ctypes

    with open(_cuda.CSRC + "/tree_interp.cuh") as fh:
        src = fh.read()
    assert int(re.search(r"#define TE_MAX_CONDS (\d+)", src).group(1)) == bitwise.TREE_MAX_CONDS
    assert int(re.search(r"TE_CMP = (\d+)", src).group(1)) == bitwise.OP_CMP
    cmp_enum = dict(re.findall(r"(CMP_\w+) = (\d+)", src))
    names = ["CMP_EQ", "CMP_NE", "CMP_LT", "CMP_LE", "CMP_GT", "CMP_GE"]
    assert [int(cmp_enum[k]) for k in names] == list(range(6))
    assert bsi.CMP_OPS == ("==", "!=", "<", "<=", ">", ">=")
    assert ctypes.sizeof(bitwise._TreeCond) == 32
    assert ctypes.sizeof(bitwise._TreeArgs) <= 4096


# ------------------------------------------------- K1 with BSI conditions
@pytest.fixture(scope="module")
def pair():
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    return fill(ref_core, ref_h), fill(pt_core, pt_h), RefCompiler(), QueryCompiler(device="cpu")


def _cond(rng):
    kind = int(rng.integers(0, 5))
    c = int(rng.choice([0, 1, -1, 250, -250, 999, 1000, -1024, 1024, 3000]))
    if kind == 0:
        lo = int(rng.integers(-1100, 1100))
        return f"Row({lo} <= v <= {lo + int(rng.integers(-50, 600))})"
    if kind == 1:
        return f"Row(v {rng.choice(['==', '!='])} null)"
    return f"Row(v {rng.choice(list(bsi.CMP_OPS))} {c})"


def _tree(rng, depth):
    if depth == 0 or rng.random() < 0.3:
        return _cond(rng) if rng.random() < 0.6 else f"Row(f={int(rng.integers(0, 6))})"
    name = rng.choice(["Union", "Intersect", "Difference", "Xor", "Not"])
    if name == "Not":
        return f"Not({_tree(rng, depth - 1)})"
    kids = [_tree(rng, depth - 1) for _ in range(int(rng.integers(1, 4)))]
    return f"{name}({', '.join(kids)})"


def _trees():
    rng = np.random.default_rng(5)
    return [_tree(rng, 3) for _ in range(12)]


@pytest.mark.parametrize("pql", _trees())
def test_random_condition_tree_matches_reference_compiler(pair, pql):
    ref_idx, pt_idx, ref_c, pt_c = pair
    shards = list(range(N_SHARDS))
    ref_call, pt_call = ref_parse(pql)[0], parse(pql)[0]
    want_words = np.asarray(ref_c.bitmap_words(ref_idx, ref_call, shards))
    assert np.array_equal(pt_c.bitmap_words(pt_idx, pt_call, shards), want_words)
    assert int(pt_c.count_async(pt_idx, pt_call, shards)) == int(ref_c.count_async(ref_idx, ref_call, shards))


def test_one_launch_plans_conditions_beside_row_leaves(pair):
    """Count(Intersect(Row(f=1), Row(v > 50))) is one program: a LOAD,
    a CMP over v's BSI stack, an AND."""
    _ref_idx, pt_idx, _ref_c, pt_c = pair
    stacks, leaves, prog, conds = pt_c._plan(
        pt_idx, parse("Intersect(Row(f=1), Row(v > 50))")[0], list(range(N_SHARDS))
    )
    assert prog == [(bitwise.OP_LOAD, 0), (bitwise.OP_CMP, 0), (bitwise.OP_AND, 0)]
    assert conds == [(1, pt_idx.field("v").bit_depth, ">", 50)]
    between = pt_c._plan(pt_idx, parse("Row(-10 < v < 300)")[0], [0])[2]
    assert between == [(bitwise.OP_CMP, 0), (bitwise.OP_CMP, 1), (bitwise.OP_AND, 0)]


def test_condition_table_cap_is_a_plan_error(pair):
    """17 BSI conditions (C4) split into groups of at most 16: the count
    and the words equal the reference compiler's; 8 betweens (16
    entries) stay one program."""
    ref_idx, pt_idx, ref_c, pt_c = pair
    shards = list(range(N_SHARDS))
    over = ", ".join(f"Row(v > {i})" for i in range(bitwise.TREE_MAX_CONDS + 1))
    ref_call, pt_call = ref_parse(f"Union({over})")[0], parse(f"Union({over})")[0]
    assert int(pt_c.count_async(pt_idx, pt_call, shards)) == int(ref_c.count_async(ref_idx, ref_call, shards))
    want = np.asarray(ref_c.bitmap_words(ref_idx, ref_call, shards))
    assert np.array_equal(pt_c.bitmap_words(pt_idx, pt_call, shards), want)
    _stacks, _leaves, _prog, conds = pt_c._plan(pt_idx, pt_call, shards)
    assert len(conds) == 1
    # between takes two entries
    eight = ", ".join(f"Row({i} <= v <= {i + 9})" for i in range(bitwise.TREE_MAX_CONDS // 2))
    stacks, _leaves, _prog, conds = pt_c._plan(pt_idx, parse(f"Union({eight})")[0], shards)
    assert len(conds) == bitwise.TREE_MAX_CONDS and len(stacks) == 1
    want = int(ref_c.count_async(ref_idx, ref_parse(f"Union({eight})")[0], shards))
    assert int(pt_c.count_async(pt_idx, parse(f"Union({eight})")[0], shards)) == want
