"""pilosa_tpu_torch.ops: the plain torch versions against pilosa_tpu.ops.

Inputs are made with numpy from a seed and handed to both packages.
Every result is an integer, so every comparison is exact. The edge words
(all ones, only bit 31, zero) are the ones an int32 view gets wrong when
a right shift is left unmasked.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu import ops as ref_ops
from pilosa_tpu.executor.compile import _OOB, _apply_stack_delta
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.ops import _cuda, bitwise, stack
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

W = WORDS_PER_SHARD
EDGE = np.array([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0, 1, 0x55555555], dtype=np.uint32)


def _words(rng, shape):
    """Random uint32 words with the edge words written over the start."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = w.reshape(-1)
    flat[: EDGE.size] = EDGE
    return w


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_popcount_family_matches_reference(rng):
    a = _words(rng, (3, 4, W))
    b = _words(rng, (3, 4, W))
    assert np.array_equal(
        ops.popcount_words(_t(a)).numpy(), np.asarray(ref_ops.popcount_words(a))
    )
    assert np.array_equal(
        ops.popcount_rows(_t(a)).numpy(), np.asarray(ref_ops.popcount_rows(a))
    )
    assert ops.popcount_rows(_t(a)).dtype == torch.int32
    total = ops.popcount(_t(a))
    assert total.dtype == torch.int64 and int(total) == int(ref_ops.popcount(a))
    for name in ("count_and", "count_or", "count_xor", "count_andnot"):
        got = int(getattr(ops, name)(_t(a), _t(b)))
        assert got == int(getattr(ref_ops, name)(a, b)), name


def test_all_ones_and_high_bit_words_count_exactly():
    ones = np.full((2, W), 0xFFFFFFFF, dtype=np.uint32)
    high = np.full((2, W), 0x80000000, dtype=np.uint32)
    assert int(ops.popcount(_t(ones))) == 2 * W * 32 == int(ref_ops.popcount(ones))
    assert int(ops.popcount(_t(high))) == 2 * W == int(ref_ops.popcount(high))
    assert int(ops.count_andnot(_t(ones), _t(high))) == 2 * W * 31


def test_matrix_filter_counts_matches_reference(rng):
    m = _words(rng, (5, W))
    f = _words(rng, (W,))
    got = ops.matrix_filter_counts(_t(m), _t(f)).numpy()
    assert np.array_equal(got, np.asarray(ref_ops.matrix_filter_counts(m, f)))


@pytest.mark.parametrize("width", [0, 1, 31, 32, 33, 100, 32 * 7])
def test_column_mask_matches_reference(width):
    got = ops.column_mask(width, 8, device="cpu").numpy().view(np.uint32)
    assert np.array_equal(got, np.asarray(ref_ops.column_mask(width, 8)))


def test_column_mask_defaults_to_the_card():
    """Like every public op, column_mask runs on the card unless the CPU
    is asked for: without CUDA the default raises, as Server's does."""
    if torch.cuda.is_available():
        assert ops.column_mask(33, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ops.column_mask(33, 8)
    got = ops.column_mask(33, 8, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(ref_ops.column_mask(33, 8)))


def test_candidate_counts_matches_reference(rng):
    m = _words(rng, (6, W))
    f = _words(rng, (W,))
    ids = np.array([0, 5, -1, 6, 99, 3], dtype=np.int32)
    got = ops.candidate_counts(_t(m), torch.from_numpy(ids), _t(f)).numpy()
    want = np.asarray(ref_ops.topn.candidate_counts(m, jnp.asarray(ids), f))
    assert np.array_equal(got, want)


def test_row_counts_plain_matches_reference_topn_programs(rng):
    """K2's plain version against the reference TopN program bodies:
    popcount_rows(m & filt) summed over shards, and the ids= recount."""
    m = _words(rng, (6, 3, W))
    f = _words(rng, (3, W))
    want = np.asarray(ref_ops.popcount_rows(m & f[None])).astype(np.int64).sum(axis=1)
    got = ops.row_counts(_t(m), _t(f))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    unfiltered = np.asarray(ref_ops.popcount_rows(m)).astype(np.int64).sum(axis=1)
    assert np.array_equal(ops.row_counts(_t(m)).numpy(), unfiltered)
    ids = np.array([2, -1, 6, 0, 1 << 30], dtype=np.int32)
    got_ids = ops.row_counts(_t(m), _t(f), torch.from_numpy(ids)).numpy()
    per_shard = [
        np.asarray(ref_ops.topn.candidate_counts(m[:, s], jnp.asarray(ids), f[s]))
        for s in range(3)
    ]
    assert np.array_equal(got_ids, np.sum(per_shard, axis=0, dtype=np.int64))


def test_stack_delta_plain_matches_reference_scatter(rng):
    m = _words(rng, (4, 3, W))
    idx = np.array([[1, 2], [3, 0], [_OOB, _OOB], [0, _OOB], [4, 1]], dtype=np.int32)
    rows = _words(rng, (5, W))
    want = np.asarray(_apply_stack_delta(m, idx, rows))
    src = _t(m)
    got = ops.apply_stack_delta(src, torch.from_numpy(idx), _t(rows))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # a new stack: the old one is untouched for readers in flight
    assert np.array_equal(src.numpy().view(np.uint32), m)
    assert stack.OOB == int(_OOB)


def test_stack_delta_plain_later_entry_wins(rng):
    """Two entries for one (row, shard) plane: the later one is written,
    as the CUDA kernel's slot map (atomicMax over entry numbers) does."""
    m = _words(rng, (3, 2, W))
    idx = np.array([[2, 1], [0, 0], [2, 1], [_OOB, 1], [0, 0], [1, 1]], dtype=np.int32)
    rows = _words(rng, (6, W))
    want = m.copy()
    for k, (r, s) in enumerate(idx):
        if 0 <= r < 3 and 0 <= s < 2:
            want[r, s] = rows[k]
    got = ops.apply_stack_delta(_t(m), torch.from_numpy(idx), _t(rows))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def _random_program(rng, n_leaves):
    """A random well-formed postfix program over ``n_leaves`` leaves."""
    prog, depth = [], 0
    for _ in range(12):
        if depth >= 2 and rng.random() < 0.5:
            prog.append((int(rng.integers(bitwise.OP_AND, bitwise.OP_ANDNOT + 1)), 0))
            depth -= 1
        elif rng.random() < 0.15:
            prog.append((bitwise.OP_ZERO, 0))
            depth += 1
        else:
            prog.append((bitwise.OP_LOAD, int(rng.integers(0, n_leaves))))
            depth += 1
    while depth > 1:
        prog.append((bitwise.OP_OR, 0))
        depth -= 1
    return prog


def test_tree_eval_plain_matches_numpy_interpreter(rng):
    stacks_np = [_words(rng, (4, 2, W)), _words(rng, (8, 2, W))]
    leaves = [(0, 1), (1, 7), (0, -1), (1, 8), (0, 3), (1, 0)]
    np_ops = {
        bitwise.OP_AND: np.bitwise_and,
        bitwise.OP_OR: np.bitwise_or,
        bitwise.OP_XOR: np.bitwise_xor,
        bitwise.OP_ANDNOT: lambda a, b: a & ~b,
    }
    for _ in range(6):
        prog = _random_program(rng, len(leaves))
        st = []
        for op, arg in prog:
            if op == bitwise.OP_LOAD:
                si, r = leaves[arg]
                m = stacks_np[si]
                st.append(m[r] if 0 <= r < m.shape[0] else np.zeros((2, W), np.uint32))
            elif op == bitwise.OP_ZERO:
                st.append(np.zeros((2, W), np.uint32))
            else:
                b = st.pop()
                st.append(np_ops[op](st.pop(), b))
        want = st[0]
        stacks = [_t(m) for m in stacks_np]
        words = ops.tree_eval(stacks, leaves, prog, 2, count=False)
        assert np.array_equal(words.numpy().view(np.uint32), want)
        count = ops.tree_eval(stacks, leaves, prog, 2, count=True)
        assert count.dtype == torch.int64
        assert int(count) == int(np.bitwise_count(want).sum())


def test_cpu_tensors_take_the_plain_version_and_nothing_else(rng, monkeypatch):
    """On a box without CUDA a wrapper given CPU tensors runs the plain
    version: no build, no load, no launch, no count."""

    def no_build(names):
        raise AssertionError(f"build attempted for {names}")

    monkeypatch.setattr(_cuda, "build", no_build)
    before = {k: v.launches for k, v in _cuda.KERNELS.items()}
    m = _t(_words(rng, (4, 2, W)))
    idx = torch.tensor([[1, 1]], dtype=torch.int32)
    rows = _t(_words(rng, (1, W)))
    ops.tree_eval([m], [(0, 1)], [(bitwise.OP_LOAD, 0)], 2, count=True)
    ops.tree_eval([], [], [(bitwise.OP_ZERO, 0)], 2, count=False, device="cpu")
    ops.row_counts(m, m[0].contiguous(), torch.tensor([0, 9], dtype=torch.int32))
    ops.apply_stack_delta(m, idx, rows)
    assert {k: v.launches for k, v in _cuda.KERNELS.items()} == before
    assert all(k._fn is None for k in _cuda.KERNELS.values())


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.resolve_device("cuda")
    assert ops.resolve_device("cpu") == torch.device("cpu")


def test_kernel_limits_are_the_sources_defines():
    """The planner's limits are the kernel's: read them from the source."""
    import re

    with open(_cuda.CSRC + "/tree_interp.cuh") as fh:
        src = fh.read()
    defines = dict(re.findall(r"#define (TE_MAX_\w+) (\d+)", src))
    assert int(defines["TE_MAX_STACK"]) == bitwise.TREE_MAX_STACK == 32
    assert int(defines["TE_MAX_OPS"]) == bitwise.TREE_MAX_OPS
    assert int(defines["TE_MAX_LEAVES"]) == bitwise.TREE_MAX_LEAVES
    ops_enum = dict(re.findall(r"(TE_\w+) = (\d+)", src))
    assert [int(ops_enum[k]) for k in ("TE_LOAD", "TE_ZERO", "TE_AND", "TE_OR", "TE_XOR", "TE_ANDNOT")] == [
        bitwise.OP_LOAD, bitwise.OP_ZERO, bitwise.OP_AND, bitwise.OP_OR, bitwise.OP_XOR, bitwise.OP_ANDNOT,
    ]
