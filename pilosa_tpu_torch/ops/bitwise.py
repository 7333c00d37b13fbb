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
interpreter runs ``ops.bsi.compare`` for it. LOAD_SPARSE and LOAD_RUN
read a row that is resident as a compressed container; the plain
interpreter decodes it with ``ops.containers``. ``pack_tree`` packs a
program for the interpreter (csrc/tree_interp.cuh), and a
``PlannedFilter`` is a program that K2, K4 and K5 evaluate as their
filter.

``shift_words`` (PQL Shift) is the wrapper of ``csrc/shift_words.cu``
(K7), with the same CPU/CUDA split.

The public counts (``popcount``, ``popcount_rows``, ``count_*``,
``matrix_filter_counts``) take the same split: a CPU tensor runs the
SWAR, a CUDA tensor launches K1's count mode or K2 (``topn.row_counts``).
The ``*_plain`` SWAR names are what the plain versions of every kernel
count with, on either device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


def w_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_and(a, b)


def w_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_or(a, b)


def w_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_xor(a, b)


def w_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_and(a, torch.bitwise_not(b))


def w_not(a: torch.Tensor) -> torch.Tensor:
    """Complement. Caller must mask to the valid column range afterwards
    (Not() in PQL is bounded by the index's existence row)."""
    return torch.bitwise_not(a)


# The public counts below keep the plain SWAR for a CPU tensor; a CUDA
# tensor goes through K1's count mode (``tree_eval``) or K2
# (``topn.row_counts``), which raise on what they do not take.


def _rows(words: torch.Tensor) -> torch.Tensor:
    """``int32[..., W]`` as K2's ``[N, 1, W]`` rows (a view where it can)."""
    if words.dtype != torch.int32 or words.dim() < 1:
        raise ValueError("words must be int32[..., W]")
    return words.contiguous().reshape(-1, 1, words.shape[-1])


def _flat(*words: torch.Tensor) -> list[torch.Tensor]:
    """Same-shape int32 operands as one-row stacks ``[1, 1, N]`` of all
    their words: a total count does not care how the words are laid out."""
    for t in words:
        if t.dtype != torch.int32 or t.shape != words[0].shape or t.device != words[0].device:
            raise ValueError("operands must be int32 tensors of one shape on one device")
    return [t.contiguous().reshape(1, 1, -1) for t in words]


def _k1_count(op: int | None, *words: torch.Tensor) -> torch.Tensor:
    """K1's count of one leaf, or of ``op`` over two leaves → int64 scalar."""
    stacks = _flat(*words)
    leaves = [(i, 0) for i in range(len(stacks))]
    prog = [(OP_LOAD, i) for i in range(len(stacks))] + ([] if op is None else [(op, 0)])
    return tree_eval(stacks, leaves, prog, 1, count=True, n_words=stacks[0].shape[-1])


def popcount_rows_plain(matrix: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the trailing word axis: ``int32[..., W] →
    int32[...]``, on any device (the plain versions' count)."""
    return torch.sum(popcount_words(matrix), dim=-1, dtype=torch.int32)


def popcount_plain(words: torch.Tensor) -> torch.Tensor:
    return torch.sum(popcount_rows_plain(words).to(torch.int64))


def matrix_filter_counts_plain(matrix: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    return popcount_rows_plain(matrix & filt[..., None, :])


def popcount_rows(matrix: torch.Tensor) -> torch.Tensor:
    """Reduce the trailing word axis: ``int32[..., W] → int32[...]``; on
    CUDA K2 over the rows with no filter (a row of at most 2^26 words
    counts below 2^31)."""
    if matrix.device.type == "cpu":
        return popcount_rows_plain(matrix)
    from pilosa_tpu_torch.ops.topn import row_counts

    return row_counts(_rows(matrix)).to(torch.int32).reshape(matrix.shape[:-1])


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits over all axes → int64 scalar (K1 count on CUDA)."""
    if words.device.type == "cpu":
        return popcount_plain(words)
    return _k1_count(None, words)


def count_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """popcount(a & b) → int64 scalar; on CUDA K2 of ``a`` as a one-row
    stack under ``b`` as the filter."""
    if a.device.type == "cpu":
        return popcount_plain(a & b)
    from pilosa_tpu_torch.ops.topn import row_counts

    ma, mb = _flat(a, b)
    return row_counts(ma, mb[0]).reshape(())


def count_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return popcount_plain(a | b)
    return _k1_count(OP_OR, a, b)


def count_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return popcount_plain(a ^ b)
    return _k1_count(OP_XOR, a, b)


def count_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return popcount_plain(a & ~b)
    return _k1_count(OP_ANDNOT, a, b)


def matrix_filter_counts(matrix: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Per-row filtered counts: ``int32[..., R, W] & int32[..., W] →
    int32[..., R]``; on CUDA K2 of ``int32[R, W]`` under ``int32[W]``."""
    if matrix.device.type == "cpu":
        return matrix_filter_counts_plain(matrix, filt)
    from pilosa_tpu_torch.ops.topn import row_counts

    if matrix.dim() != 2 or filt.dim() != 1:
        raise ValueError("on CUDA, matrix_filter_counts takes int32[R, W] and int32[W]")
    if filt.dtype != torch.int32 or filt.shape[0] != matrix.shape[1]:
        raise ValueError(f"filter {tuple(filt.shape)} does not match rows of {matrix.shape[1]} words")
    return row_counts(_rows(matrix), filt.contiguous()[None]).to(torch.int32)


def column_mask(width: int, n_words: int, device="cuda") -> torch.Tensor:
    """int32[n_words] with the low ``width`` bits set, on ``device``
    (the card by default; ``device="cpu"`` asks for the CPU)."""
    device = _cuda.resolve_device(device)
    idx = torch.arange(n_words, dtype=torch.int32, device=device)
    full, rem = width // BITS_PER_WORD, width % BITS_PER_WORD
    w = torch.where(idx < full, torch.tensor(-1, dtype=torch.int32, device=device), 0)
    if rem:
        # (1 << rem) - 1 as an int32 bit pattern (rem ≤ 31 stays positive)
        w = torch.where(idx == full, torch.tensor((1 << rem) - 1, dtype=torch.int32, device=device), w)
    return w.to(torch.int32)


def shift_words_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    """Shift set-bit positions up by ``n`` within each shard (PQL Shift):
    bit p of ``int32[..., W]`` moves to p + n, bits past the end of the
    last axis drop. A word roll plus a cross-word carry, as the
    reference's ``shift_words``; every right shift is masked, so the
    int32 shifts are logical."""
    if n < 0:
        raise ValueError(f"shift amount must be non-negative, got {n}")
    if n == 0:
        return words
    n_words = words.shape[-1]
    q, r = n // BITS_PER_WORD, n % BITS_PER_WORD
    w = words
    if q:
        w = torch.zeros_like(words)
        if q < n_words:
            w[..., q:] = words[..., : n_words - q]
    if r:
        carry = torch.zeros_like(w)
        carry[..., 1:] = (w[..., :-1] >> (BITS_PER_WORD - r)) & ((1 << r) - 1)
        w = (w << r) | carry
    return w


def shift_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """PQL Shift over ``int32[S, W]`` words, per shard, into a new plane
    (K7). ``n`` must be non-negative; ``n == 0`` returns ``words``."""
    if n < 0:
        raise ValueError(f"shift amount must be non-negative, got {n}")
    if words.dtype != torch.int32 or words.dim() != 2 or not words.is_contiguous():
        raise ValueError("words must be contiguous int32[S, W]")
    dev = words.device
    if dev.type == "cpu":
        return shift_words_plain(words, n)
    if n == 0:
        return words
    n_shards, n_words = words.shape
    if n_words % 4:
        raise ValueError(f"W = {n_words} is not a multiple of 4 words")
    out = torch.empty_like(words)
    _cuda.SHIFT_WORDS.launch(dev, words.data_ptr(), out.data_ptr(), n_shards, n_words, n)
    return out


# ------------------------------------------------------------ tree programs
# Opcodes of the postfix call-tree program, and the kernel's fixed limits
# (the #defines of csrc/tree_interp.cuh; the planner raises PlanError above
# them). CMP's argument indexes the condition table: (stack index, depth
# D, op in bsi.CMP_OPS, constant) per BSI condition. A LOAD_SPARSE or
# LOAD_RUN leaf is (store index, slot) into an int32[H, K] sparse or
# int32[H, K, 2] run store (executor/residency.py).
OP_LOAD, OP_ZERO, OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_CMP, OP_LOAD_SPARSE, OP_LOAD_RUN = range(9)
TREE_MAX_LEAVES = 256
TREE_MAX_OPS = 512
TREE_MAX_STACK = 32
TREE_MAX_CONDS = 16
_LOADS = (OP_LOAD, OP_LOAD_SPARSE, OP_LOAD_RUN)
_PUSHES = _LOADS + (OP_ZERO, OP_CMP)
# container payloads hold int32 global bit positions of the plane
_MAX_CONTAINER_PLANE_BITS = 1 << 31


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
        ("sparse_cap", ctypes.c_int),
        ("run_cap", ctypes.c_int),
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
    n_words: int = WORDS_PER_SHARD,
) -> torch.Tensor:
    """Plain interpreter of a postfix program. ``stacks`` are int32
    [R_i, S, W] planes or compressed container stores; ``leaves`` are
    (stack index, row or slot) with out-of-range rows reading zero words;
    ``conds`` are the BSI conditions of the CMP ops. → int64 scalar
    (``count``) or int32[S, W]."""
    from pilosa_tpu_torch.ops import bsi, containers

    zeros = lambda: torch.zeros(  # noqa: E731
        (n_shards, n_words), dtype=torch.int32, device=device
    )
    st: list[torch.Tensor] = []
    for op, arg in ops:
        if op in _LOADS:
            si, row = leaves[arg]
            m = stacks[si]
            if not 0 <= row < m.shape[0]:
                st.append(zeros())
            elif op == OP_LOAD:
                st.append(m[row])
            elif op == OP_LOAD_SPARSE:
                st.append(containers.sparse_plane(m[row], n_shards, WORDS_PER_SHARD))
            else:
                st.append(containers.run_plane(m[row], n_shards, WORDS_PER_SHARD))
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
        return popcount_plain(out)
    # a lone LOAD is a view of the stack: hand back a copy, as the kernel does
    return out.clone() if ops[0][0] == OP_LOAD and len(ops) == 1 else out


def _check_stacks(
    stacks: list[torch.Tensor],
    leaves: list[tuple[int, int]],
    ops: list[tuple[int, int]],
    n_shards: int,
    conds: list[tuple[int, int, str, int]],
    n_words: int = WORDS_PER_SHARD,
) -> tuple[int, int]:
    """Raise on a stack the program cannot read; → the sparse and run
    payload capacities (0 where the program has no such leaf)."""
    from pilosa_tpu_torch.ops.bsi import CMP_OPS

    for m in stacks:
        if m.dtype != torch.int32 or m.dim() < 2 or not m.is_contiguous():
            raise ValueError("stacks must be contiguous int32 tensors")
    plane = (n_shards, n_words)
    caps = {OP_LOAD_SPARSE: set(), OP_LOAD_RUN: set()}
    for op, arg in ops:
        if op not in _LOADS:
            continue
        m = stacks[leaves[arg][0]]
        if op == OP_LOAD and (m.dim() != 3 or tuple(m.shape[1:]) != plane):
            raise ValueError(f"stack shape {tuple(m.shape)} is not [R, {n_shards}, {n_words}]")
        if op == OP_LOAD_SPARSE and m.dim() != 2:
            raise ValueError(f"sparse store shape {tuple(m.shape)} is not [H, K]")
        if op == OP_LOAD_RUN and (m.dim() != 3 or m.shape[2] != 2):
            raise ValueError(f"run store shape {tuple(m.shape)} is not [H, K, 2]")
        if op != OP_LOAD:
            if n_words != WORDS_PER_SHARD:
                raise ValueError("a container leaf needs whole shards, not a block of the word axis")
            if n_shards * WORDS_PER_SHARD * BITS_PER_WORD > _MAX_CONTAINER_PLANE_BITS:
                raise ValueError("a container leaf needs a plane of at most 2^31 bits")
            caps[op].add(m.shape[1])
    for _si, depth, cmp_op, _value in conds:
        if cmp_op not in CMP_OPS or not 0 <= depth <= 63:
            raise ValueError(f"bad BSI condition {cmp_op!r} at depth {depth}")
    for si, *_ in conds:
        m = stacks[si]
        if m.dim() != 3 or tuple(m.shape[1:]) != plane:
            raise ValueError(f"BSI stack shape {tuple(m.shape)} is not [P, {n_shards}, {n_words}]")
    if len(caps[OP_LOAD_SPARSE]) > 1 or len(caps[OP_LOAD_RUN]) > 1:
        raise ValueError(f"container stores of several capacities in one program: {caps}")
    return max(caps[OP_LOAD_SPARSE], default=0), max(caps[OP_LOAD_RUN], default=0)


def pack_tree(
    stacks: list[torch.Tensor],
    leaves: list[tuple[int, int]],
    ops: list[tuple[int, int]],
    n_shards: int,
    conds: list[tuple[int, int, str, int]] = (),
    n_words: int = WORDS_PER_SHARD,
) -> _TreeArgs:
    """Pack a planned tree against the planes it reads into the kernels'
    ``TreeArgs`` (csrc/tree_interp.cuh), after checking the stacks and
    K1's limits. The struct holds raw pointers: the caller keeps
    ``stacks`` alive until the launch."""
    from pilosa_tpu_torch.ops.bsi import CMP_OPS

    sparse_cap, run_cap = _check_stacks(stacks, leaves, ops, n_shards, conds, n_words)
    if (
        len(leaves) > TREE_MAX_LEAVES
        or len(ops) > TREE_MAX_OPS
        or len(conds) > TREE_MAX_CONDS
        or program_depth(ops) > TREE_MAX_STACK
    ):
        raise ValueError("tree program exceeds the kernel's limits")
    n_vec = n_shards * n_words // 4
    a = _TreeArgs()
    for i, (si, row) in enumerate(leaves):
        m = stacks[si]
        # a row outside the stack reads zero words: the kernel's null leaf;
        # a row is one [S, W] plane, or one slot's payload of a store
        row_bytes = m[0].numel() * 4
        a.leaf[i] = m.data_ptr() + row * row_bytes if 0 <= row < m.shape[0] else None
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
    a.sparse_cap, a.run_cap = sparse_cap, run_cap
    return a


def tree_eval(
    stacks: list[torch.Tensor],
    leaves: list[tuple[int, int]],
    ops: list[tuple[int, int]],
    n_shards: int,
    count: bool,
    device="cpu",
    conds: list[tuple[int, int, str, int]] = (),
    out: torch.Tensor | None = None,
    n_words: int = WORDS_PER_SHARD,
) -> torch.Tensor:
    """Evaluate a postfix call-tree program over [S, W] planes (K1).

    The stacks' device decides the route; ``device`` names it only for a
    program with no stack (an empty Union(), say). In words mode ``out``
    (contiguous int32[S, W], a plane of a larger tensor, say) receives
    the words in place of a new tensor. ``n_words`` is W: a shard's
    words, or a mesh block's slice of them (parallel/mesh.py)."""
    dev = stacks[0].device if stacks else torch.device(device)
    for m in stacks:
        if m.device != dev:
            raise ValueError(f"stacks on {m.device} and {dev}")
    if n_words < 4 or n_words % 4:
        raise ValueError(f"W = {n_words} is not a positive multiple of 4 words")
    plane = (n_shards, n_words)
    if out is not None and (
        count or out.device != dev or out.dtype != torch.int32
        or tuple(out.shape) != plane or not out.is_contiguous()
    ):
        raise ValueError(f"out must be a contiguous int32{list(plane)} on {dev}, in words mode")
    if dev.type == "cpu":
        _check_stacks(stacks, leaves, ops, n_shards, conds, n_words)
        got = tree_eval_plain(stacks, leaves, ops, n_shards, count, dev, conds, n_words)
        if out is None:
            return got
        out.copy_(got)
        return out
    a = pack_tree(stacks, leaves, ops, n_shards, conds, n_words)
    n_vec = n_shards * n_words // 4
    mode = ("count" if count else "words") + ("+cmp" if conds else "")
    if a.sparse_cap or a.run_cap:
        mode += "+containers"
    if count:
        res = torch.zeros((), dtype=torch.int64, device=dev)
        _cuda.TREE_EVAL.launch(dev, ctypes.byref(a), n_vec, None, res.data_ptr(), mode=mode)
    else:
        res = out if out is not None else torch.empty(plane, dtype=torch.int32, device=dev)
        _cuda.TREE_EVAL.launch(dev, ctypes.byref(a), n_vec, res.data_ptr(), None, mode=mode)
    return res


# ----------------------------------------------------- planned filters
class PlannedFilter(NamedTuple):
    """A filter's call tree, planned against the planes it reads but not
    launched: what K2, K4 and K5 take in place of an [S, W] filter plane
    (``topn.row_counts``, ``bsi.bsi_sum``, ``bsi.bsi_min_max``). Their
    fused modes evaluate it word by word inside the aggregate's kernel,
    as the reference evaluates a filter inside the aggregate's program
    (pilosa_tpu/executor/executor.py:1019 ``_filter_plan``), so the [S, W]
    filter is never written to device memory. ``arrays``, ``leaves``,
    ``ops`` and ``conds`` are ``tree_eval``'s stacks, leaves, program and
    BSI conditions; ``n_shards`` and ``n_words`` the [S, W] it covers (a
    mesh block's own, parallel/mesh.py)."""

    arrays: list
    leaves: list
    ops: list
    conds: list
    n_shards: int
    n_words: int

    def check(self, device: torch.device, plane: tuple[int, int]) -> None:
        """Raise where the filter covers another [S, W] than the
        aggregate's ``plane``, or reads planes on another device."""
        if (self.n_shards, self.n_words) != tuple(plane):
            raise ValueError(f"filter over {(self.n_shards, self.n_words)} != {tuple(plane)}")
        for m in self.arrays:
            if m.device != device:
                raise ValueError(f"a filter plane on {m.device}, the aggregate's on {device}")

    def plain(self, device: torch.device, plane: tuple[int, int]) -> torch.Tensor:
        """The filter's words by the plain interpreter, checked against
        the aggregate's ``plane``: the first half of every fused kernel's
        plain version."""
        self.check(device, plane)
        _check_stacks(self.arrays, self.leaves, self.ops, self.n_shards, self.conds, self.n_words)
        return tree_eval_plain(
            self.arrays, self.leaves, self.ops, self.n_shards, False, device, self.conds, self.n_words,
        )

    def pack(self, device: torch.device, plane: tuple[int, int]) -> _TreeArgs:
        """``pack_tree`` for a fused launch over the aggregate's ``plane``
        on ``device``, after ``check``."""
        self.check(device, plane)
        return pack_tree(self.arrays, self.leaves, self.ops, self.n_shards, self.conds, self.n_words)
