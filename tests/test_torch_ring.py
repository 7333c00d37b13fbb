"""K1's ring kernel and K3's flat copy: their launches and their plain
versions at the limits.

On ``meta`` tensors (shapes without data) the wrappers take their kernel
path; with the C entries swapped for recorders the tests read what each
call hands its kernel, and under a dispatch mode which other tensor ops
it runs, and nothing runs. The plain versions are held against
pilosa_tpu's ``_apply_stack_delta``, ``_scatter_rows``, the word ops and
the BSI compare on the same edge cases, exactly.
"""

import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pilosa_tpu import ops as ref_ops
from pilosa_tpu.executor.compile import _OOB, _apply_stack_delta, _scatter_rows
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.ops import _cuda, bitwise, bsi
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

W = WORDS_PER_SHARD
L, Z, C = bitwise.OP_LOAD, bitwise.OP_ZERO, bitwise.OP_CMP
A, O, X, N = bitwise.OP_AND, bitwise.OP_OR, bitwise.OP_XOR, bitwise.OP_ANDNOT
OOB = int(_OOB)
# the shared memory a block may take on the H100 (hopper-kernels guide)
SMEM_PER_BLOCK = 232448


@pytest.fixture
def launches(monkeypatch):
    """K1's and K3's C entries replaced by recorders: (kernel name, mode,
    args) per launch."""
    calls = []
    for name in ("tree_eval", "stack_delta"):
        kern = _cuda.KERNELS[name]
        monkeypatch.setattr(kern, "launch", lambda dev, *args, mode="", _n=name: calls.append((_n, mode, args)))
    return calls


class _TensorOps(TorchDispatchMode):
    """The aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ------------------------------------------------------------------- K3
# (name, idx): K = 0, every entry out of range, two entries on one plane
DELTAS = {
    "k0": np.zeros((0, 2), np.int32),
    "all_oob": np.array([[OOB, 0], [0, OOB], [OOB, OOB], [4, 1], [0, 3]], np.int32),
    "dup": np.array([[1, 2], [3, 0], [1, 2], [OOB, 1], [3, 0], [1, 2]], np.int32),
}


@pytest.mark.parametrize("name", list(DELTAS))
def test_delta_launch_passes_the_entries_as_they_are(launches, name):
    idx = DELTAS[name]
    k = idx.shape[0]
    m, i, rows = _meta((4, 3, 64)), _meta((k, 2)), _meta((k, 64))
    with _TensorOps() as seen:
        out = ops.apply_stack_delta(m, i, rows)
    assert out.shape == m.shape
    (kern, mode, args), = launches
    assert (kern, mode) == ("stack_delta", "delta")
    # out, in, n_rows, n_shards, w_vec, idx, cols, rows, k, slot
    assert args[2:5] == (4, 3, 16) and args[6] == 2 and args[8] == k
    # the scratch slot map, one int per (row, shard) plane, only for K > 0
    assert (args[9] is None) == (k == 0)
    want = ["aten.empty_like.default"] + (["aten.empty.memory_format"] if k else [])
    assert seen.names == want


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("kind", ["dense", "sparse", "run"])
def test_row_scatter_passes_slot_p_and_l(launches, kind, n):
    """(slot, P, L) go to the kernel as they are: no (slot, plane) pairs,
    no launch besides K3's, a slot map of one int per row."""
    shape = {"dense": (6, 5, 64), "sparse": (6, 2048), "run": (6, 128, 2)}[kind]
    p, length = {"dense": (5, 64), "sparse": (1, 2048), "run": (1, 256)}[kind]
    store, idx, rows = _meta(shape), _meta((n,)), _meta((n,) + shape[1:])
    with _TensorOps() as seen:
        out = ops.scatter_rows(store, idx, rows)
    assert out.shape == store.shape
    (kern, mode, args), = launches
    assert (kern, mode) == ("stack_delta", "rows")
    assert args[2:5] == (6, p, length // 4) and args[6] == 1 and args[8] == n
    assert args[9] is not None
    assert seen.names == ["aten.empty_like.default", "aten.empty.memory_format"]


def test_row_scatter_checks_what_the_kernel_takes(launches):
    store = _meta((6, 2048))
    with pytest.raises(ValueError):
        ops.scatter_rows(store, _meta((1,), torch.int64), _meta((1, 2048)))
    with pytest.raises(ValueError):
        ops.scatter_rows(store, _meta((2,)), _meta((1, 2048)))
    with pytest.raises(ValueError):
        ops.scatter_rows(_meta((6, 5, 6)), _meta((1,)), _meta((1, 5, 6)))  # L = 30 words
    assert launches == []


@pytest.mark.parametrize("name", list(DELTAS))
def test_delta_plain_matches_reference_at_the_edges(rng, name):
    idx = DELTAS[name]
    m = _words(rng, (4, 3, W))
    rows = _words(rng, (idx.shape[0], W))
    got = ops.apply_stack_delta(_t(m), torch.from_numpy(idx), _t(rows))
    assert np.array_equal(_np(got), np.asarray(_apply_stack_delta(m, idx, rows)))


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("kind", ["dense", "sparse", "run"])
def test_row_scatter_plain_matches_reference(rng, kind, n):
    shape = {"dense": (6, 3, W), "sparse": (6, 2048), "run": (6, 128, 2)}[kind]
    store = rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
    # one slot, or two on one slot (the later wins) and one out of range
    idx = np.array([2] if n == 1 else [2, OOB, 5, 2], np.int32)
    rows = rng.integers(-(2**31), 2**31 - 1, (n,) + shape[1:], dtype=np.int64).astype(np.int32)
    got = ops.scatter_rows(torch.from_numpy(store), torch.from_numpy(idx), torch.from_numpy(rows))
    assert np.array_equal(got.numpy(), np.asarray(_scatter_rows(store, idx, rows)))


# ------------------------------------------------------------------- K1
def _limit_programs():
    """(name, stacks' shapes, leaves, program, conds) at K1's limits."""
    s = 3
    wide = [(0, 1 + i) for i in range(bitwise.TREE_MAX_LEAVES)]
    wide_prog = [(L, 0)] + [op for i in range(1, len(wide)) for op in ((L, i), (O, 0))]
    deep = [(0, 1 + i % 7) for i in range(bitwise.TREE_MAX_STACK)]
    deep_prog = [(L, i) for i in range(len(deep))] + [(X if i % 2 else A, 0) for i in range(len(deep) - 1)]
    ops_ = bsi.CMP_OPS
    values = [0, 1, -1, 5, -(2**62), 2**62 + 3, 2**63 - 1, -(2**63 - 1)]
    conds = [(1, 63, ops_[i % 6], values[i % len(values)]) for i in range(bitwise.TREE_MAX_CONDS)]
    cond_prog = [(C, 0)] + [op for i in range(1, len(conds)) for op in ((C, i), (O if i % 3 else A, 0))]
    nulls = [(0, -1), (0, 8), (0, OOB), (0, 2)]
    null_prog = [(L, 0), (L, 3), (O, 0), (L, 1), (N, 0), (L, 2), (X, 0), (Z, 0), (O, 0)]
    return [
        ("256 leaves", [(257, s, 64)], wide, wide_prog, []),
        ("depth 32", [(8, s, 64)], deep, deep_prog, []),
        ("16 conditions of depth 63", [(8, s, 64), (65, s, 64)], [], cond_prog, conds),
        ("null leaves", [(8, s, 64)], nulls, null_prog, []),
    ]


@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("case", range(4))
def test_tree_launch_at_the_limits(launches, case, count):
    name, shapes, leaves, prog, conds = _limit_programs()[case]
    stacks = [_meta(sh) for sh in shapes]
    s, w = shapes[0][1], shapes[0][2]
    got = ops.tree_eval(stacks, leaves, prog, s, count=count, conds=conds, n_words=w)
    assert tuple(got.shape) == (() if count else (s, w))
    (kern, mode, args), = launches
    assert kern == "tree_eval"
    assert mode == ("count" if count else "words") + ("+cmp" if conds else "")
    packed, n_vec = args[0]._obj, args[1]
    assert n_vec == s * w // 4 and (args[2] is None) == count and (args[3] is None) != count
    assert (packed.n_leaves, packed.n_ops, packed.n_conds) == (len(leaves), len(prog), len(conds))
    assert [(packed.op[i], packed.arg[i]) for i in range(len(prog))] == prog
    plane = s * w * 4
    for i, (si, row) in enumerate(leaves):
        # meta tensors start at 0: a row's plane starts at row * plane
        want = row * plane if 0 <= row < shapes[si][0] else 0
        assert (packed.leaf[i] or 0) == want, (name, i)
    for i, (si, depth, cmp_op, value) in enumerate(conds):
        c = packed.cond[i]
        assert (c.stride, c.present, c.depth) == (n_vec, shapes[si][0], depth)
        assert (c.op, c.neg, c.big) == (bsi.CMP_OPS.index(cmp_op), value < 0, abs(value) >= 1 << depth)
    assert bitwise.program_depth(prog) <= bitwise.TREE_MAX_STACK


def test_tree_past_the_limits_raises(launches):
    m = [_meta((300, 2, 64))]
    too_wide = [(0, i) for i in range(bitwise.TREE_MAX_LEAVES + 1)]
    with pytest.raises(ValueError):
        ops.tree_eval(m, too_wide, [(L, 0)] + [op for i in range(1, 257) for op in ((L, i), (O, 0))], 2, True, n_words=64)
    too_deep = [(L, 0)] * (bitwise.TREE_MAX_STACK + 1) + [(A, 0)] * bitwise.TREE_MAX_STACK
    with pytest.raises(ValueError):
        ops.tree_eval(m, [(0, 1)], too_deep, 2, True, n_words=64)
    assert launches == []


def _defines(path: str) -> dict:
    with open(f"{_cuda.CSRC}/{path}") as fh:
        return {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", fh.read())}


def test_ring_plans_fit_a_block():
    """K1's tile and ring, and K3's, are fixed by the sources: every
    stage fits the block's shared memory, a tile splits into whole warps
    of 16 B vectors, and no program limit enters the plan, so every
    program that tree_program_ok accepts streams through the same ring
    (its planes take the stages in turn)."""
    te = _defines("tree_eval.cu")
    tile, stages, warps = te["TE_TILE"], te["TE_STAGES"], te["TE_CONSUMER_WARPS"]
    assert tile % 32 == 0 and tile % (warps * 32) == 0
    # the ring, a full and an empty barrier per stage, a sum per warp
    assert stages * tile * 16 + 16 * stages + 8 * warps <= SMEM_PER_BLOCK
    assert stages >= 4 and (warps + 1) * 32 <= 1024
    sd = _defines("stack_delta.cu")
    assert sd["SD_CHUNK"] % 16 == 0 and sd["SD_STAGES"] >= 4
    assert sd["SD_CHUNK"] * sd["SD_STAGES"] + 8 * sd["SD_STAGES"] <= SMEM_PER_BLOCK
    with open(f"{_cuda.CSRC}/tree_eval.cu") as fh:
        code = re.sub(r"//[^\n]*", "", fh.read())
    # one kernel for every program, and not the one-vector interpreter
    assert "tree_eval_kernel" not in code and not re.search(r"\bte_eval\s*\(", code)
    limits = _defines("tree_interp.cuh")
    assert (limits["TE_MAX_LEAVES"], limits["TE_MAX_STACK"], limits["TE_MAX_CONDS"]) == (
        bitwise.TREE_MAX_LEAVES, bitwise.TREE_MAX_STACK, bitwise.TREE_MAX_CONDS)


def _ref_tree(planes, prog, leaves, conds, stacks):
    """The reference's word ops and BSI compare, one postfix walk."""
    fns = {A: ref_ops.w_and, O: ref_ops.w_or, X: ref_ops.w_xor, N: ref_ops.w_andnot}
    zero = np.zeros(planes, np.uint32)
    st = []
    for op, arg in prog:
        if op == L:
            si, row = leaves[arg]
            st.append(stacks[si][row] if 0 <= row < stacks[si].shape[0] else zero)
        elif op == Z:
            st.append(zero)
        elif op == C:
            si, depth, cmp_op, value = conds[arg]
            m = stacks[si]
            blk = np.concatenate([m, np.zeros((max(0, 2 + depth - m.shape[0]),) + planes, np.uint32)])[: 2 + depth]
            flat = blk.reshape(2 + depth, -1)
            st.append(np.asarray(ref_ops.bsi.compare(flat, cmp_op, value)).reshape(planes))
        else:
            b = st.pop()
            st.append(np.asarray(fns[op](st.pop(), b)))
    (out,) = st
    return np.asarray(out)


@pytest.mark.parametrize("case", range(4))
def test_tree_plain_matches_reference_at_the_limits(rng, case):
    name, shapes, leaves, prog, conds = _limit_programs()[case]
    s = shapes[0][1]
    stacks = [_words(rng, (sh[0], s, W)) for sh in shapes]
    if conds:
        # ~85 % of columns present, some negative, the top magnitude bits set
        stacks[1][0] |= _words(rng, (s, W))
        stacks[1][1] &= _words(rng, (s, W))
    want = _ref_tree((s, W), prog, leaves, conds, stacks)
    t = [_t(m) for m in stacks]
    words = ops.tree_eval(t, leaves, prog, s, count=False, conds=conds)
    assert np.array_equal(_np(words), want), name
    assert int(ops.tree_eval(t, leaves, prog, s, count=True, conds=conds)) == int(np.bitwise_count(want).sum())
