"""Packed-word bitwise ops and the fused call-tree kernel (K1).

Reference: pilosa_tpu/ops/bitwise.py. Words are ``torch.int32`` views of
the reference's ``uint32`` words: PyTorch on the CPU cannot shift,
complement or scatter-add ``uint32``, and its int32 ``>>`` is arithmetic,
so every plain version below masks after each right shift. The CUDA
kernels read the same bytes as ``uint32_t``.

The plain versions stage their sums as the reference does: a per-row
int32 sum over the trailing word axis (a shard row holds at most 2^20
bits) and an int64 total across rows.

``tree_eval`` is the wrapper of ``csrc/tree_eval.cu``: a CPU tensor takes
the plain interpreter, a CUDA tensor launches the kernel or raises. Its
CMP opcode evaluates a BSI condition in the same launch; the plain
interpreter runs ``ops.bsi.compare`` for it.
"""

from __future__ import annotations

import ctypes

import torch

from pilosa_tpu_torch.ops import _cuda
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

BITS_PER_WORD = 32


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (SWAR), same shape, int32."""
    w = words
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return (
        (w & 0xFF) + ((w >> 8) & 0xFF) + ((w >> 16) & 0xFF) + ((w >> 24) & 0xFF)
    )


def popcount_rows(matrix: torch.Tensor) -> torch.Tensor:
    """Reduce the trailing word axis: ``int32[..., W] → int32[...]``."""
    return torch.sum(popcount_words(matrix), dim=-1, dtype=torch.int32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits over all axes → int64 scalar."""
    return torch.sum(popcount_rows(words).to(torch.int64))


def count_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(a & b)


def count_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(a | b)


def count_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(a ^ b)


def count_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return popcount(a & ~b)


def matrix_filter_counts(matrix: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Per-row filtered counts: ``int32[R, W] & int32[W] → int32[R]``."""
    return popcount_rows(matrix & filt[..., None, :])


def column_mask(width: int, n_words: int, device="cpu") -> torch.Tensor:
    """int32[n_words] with the low ``width`` bits set."""
    idx = torch.arange(n_words, dtype=torch.int32, device=device)
    full, rem = width // BITS_PER_WORD, width % BITS_PER_WORD
    w = torch.where(idx < full, torch.tensor(-1, dtype=torch.int32, device=device), 0)
    if rem:
        # (1 << rem) - 1 as an int32 bit pattern (rem ≤ 31 stays positive)
        w = torch.where(idx == full, torch.tensor((1 << rem) - 1, dtype=torch.int32, device=device), w)
    return w.to(torch.int32)


# ------------------------------------------------------------ tree programs
# Opcodes of the postfix call-tree program, and the kernel's fixed limits
# (the #defines of csrc/tree_eval.cu; the planner raises PlanError above
# them). CMP's argument indexes the condition table: (stack index, depth
# D, op in bsi.CMP_OPS, constant) per BSI condition.
OP_LOAD, OP_ZERO, OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_CMP = range(7)
TREE_MAX_LEAVES = 256
TREE_MAX_OPS = 512
TREE_MAX_STACK = 32
TREE_MAX_CONDS = 16
_PUSHES = (OP_LOAD, OP_ZERO, OP_CMP)


class _TreeCond(ctypes.Structure):
    _fields_ = [
        ("base", ctypes.c_void_p),
        ("stride", ctypes.c_longlong),
        ("c_abs", ctypes.c_ulonglong),
        ("present", ctypes.c_int),
        ("depth", ctypes.c_ubyte),
        ("op", ctypes.c_ubyte),
        ("neg", ctypes.c_ubyte),
        ("big", ctypes.c_ubyte),
    ]


class _TreeArgs(ctypes.Structure):
    _fields_ = [
        ("leaf", ctypes.c_void_p * TREE_MAX_LEAVES),
        ("cond", _TreeCond * TREE_MAX_CONDS),
        ("n_leaves", ctypes.c_int),
        ("n_ops", ctypes.c_int),
        ("n_conds", ctypes.c_int),
        ("op", ctypes.c_ubyte * TREE_MAX_OPS),
        ("arg", ctypes.c_ubyte * TREE_MAX_OPS),
    ]


def program_depth(ops: list[tuple[int, int]]) -> int:
    """Deepest operand stack a postfix program reaches."""
    depth = most = 0
    for op, _arg in ops:
        depth += 1 if op in _PUSHES else -1
        most = max(most, depth)
    return most


def _apply(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == OP_AND:
        return a & b
    if op == OP_OR:
        return a | b
    if op == OP_XOR:
        return a ^ b
    if op == OP_ANDNOT:
        return a & ~b
    raise ValueError(f"bad tree opcode {op}")


def tree_eval_plain(
    stacks: list[torch.Tensor],
    leaves: list[tuple[int, int]],
    ops: list[tuple[int, int]],
    n_shards: int,
    count: bool,
    device="cpu",
    conds: list[tuple[int, int, str, int]] = (),
) -> torch.Tensor:
    """Plain interpreter of a postfix program. ``stacks`` are int32
    [R_i, S, W]; ``leaves`` are (stack index, row id) with out-of-range
    rows reading zero words; ``conds`` are the BSI conditions of the CMP
    ops. → int64 scalar (``count``) or int32[S, W]."""
    from pilosa_tpu_torch.ops import bsi

    zeros = lambda: torch.zeros(  # noqa: E731
        (n_shards, WORDS_PER_SHARD), dtype=torch.int32, device=device
    )
    st: list[torch.Tensor] = []
    for op, arg in ops:
        if op == OP_LOAD:
            si, row = leaves[arg]
            m = stacks[si]
            st.append(m[row] if 0 <= row < m.shape[0] else zeros())
        elif op == OP_ZERO:
            st.append(zeros())
        elif op == OP_CMP:
            si, depth, cmp_op, value = conds[arg]
            st.append(bsi.compare(bsi.bsi_planes(stacks[si], depth), cmp_op, value))
        else:
            b = st.pop()
            st.append(_apply(op, st.pop(), b))
    (out,) = st
    if count:
        return popcount(out)
    # a lone LOAD is a view of the stack: hand back a copy, as the kernel does
    return out.clone() if ops[0][0] == OP_LOAD and len(ops) == 1 else out


def tree_eval(
    stacks: list[torch.Tensor],
    leaves: list[tuple[int, int]],
    ops: list[tuple[int, int]],
    n_shards: int,
    count: bool,
    device="cpu",
    conds: list[tuple[int, int, str, int]] = (),
) -> torch.Tensor:
    """Evaluate a postfix call-tree program over [S, W] planes (K1).

    The stacks' device decides the route; ``device`` names it only for a
    program with no stack (an empty Union(), say)."""
    from pilosa_tpu_torch.ops.bsi import CMP_OPS

    dev = stacks[0].device if stacks else torch.device(device)
    for m in stacks:
        if m.device != dev:
            raise ValueError(f"stacks on {m.device} and {dev}")
        if m.dtype != torch.int32 or m.dim() != 3 or not m.is_contiguous():
            raise ValueError("stacks must be contiguous int32[R, S, W]")
        if m.shape[1] != n_shards or m.shape[2] != WORDS_PER_SHARD:
            raise ValueError(f"stack shape {tuple(m.shape)} is not [R, {n_shards}, {WORDS_PER_SHARD}]")
    for _si, depth, cmp_op, _value in conds:
        if cmp_op not in CMP_OPS or not 0 <= depth <= 63:
            raise ValueError(f"bad BSI condition {cmp_op!r} at depth {depth}")
    if dev.type == "cpu":
        return tree_eval_plain(stacks, leaves, ops, n_shards, count, dev, conds)
    if (
        len(leaves) > TREE_MAX_LEAVES
        or len(ops) > TREE_MAX_OPS
        or len(conds) > TREE_MAX_CONDS
        or program_depth(ops) > TREE_MAX_STACK
    ):
        raise ValueError("tree program exceeds the kernel's limits")
    plane_bytes = n_shards * WORDS_PER_SHARD * 4
    n_vec = n_shards * WORDS_PER_SHARD // 4
    a = _TreeArgs()
    for i, (si, row) in enumerate(leaves):
        m = stacks[si]
        # a row outside the stack reads zero words: the kernel's null leaf
        a.leaf[i] = m.data_ptr() + row * plane_bytes if 0 <= row < m.shape[0] else None
    for i, (si, depth, cmp_op, value) in enumerate(conds):
        c = a.cond[i]
        c.base, c.stride, c.present = stacks[si].data_ptr(), n_vec, stacks[si].shape[0]
        c.depth, c.op, c.neg = depth, CMP_OPS.index(cmp_op), value < 0
        # |c| >= 2^D compares as past every stored magnitude (bsi.py:71)
        c.big = abs(value) >= 1 << depth
        c.c_abs = 0 if c.big else abs(value)
    for i, (op, arg) in enumerate(ops):
        a.op[i] = op
        a.arg[i] = arg
    a.n_leaves, a.n_ops, a.n_conds = len(leaves), len(ops), len(conds)
    mode = ("count" if count else "words") + ("+cmp" if conds else "")
    if count:
        out = torch.zeros((), dtype=torch.int64, device=dev)
        _cuda.TREE_EVAL.launch(dev, ctypes.byref(a), n_vec, None, out.data_ptr(), mode=mode)
    else:
        out = torch.empty((n_shards, WORDS_PER_SHARD), dtype=torch.int32, device=dev)
        _cuda.TREE_EVAL.launch(dev, ctypes.byref(a), n_vec, out.data_ptr(), None, mode=mode)
    return out
