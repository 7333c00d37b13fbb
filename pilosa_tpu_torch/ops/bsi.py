"""Bit-sliced index (BSI) ops on int fields: conditions, Sum, Min/Max.

Reference: pilosa_tpu/ops/bsi.py. An int field's BSI stack is row-major
``int32[P, S, W]``: plane 0 is existence (the column has a value),
plane 1 the sign (the value is negative), planes 2 .. 2 + D - 1 the
magnitude bits, LSB first. Values are sign-magnitude. A stack may hold
fewer planes than 2 + D (a field whose high bits were never set): a
plane at or past P reads as zero, where the reference pads the stack
with zero planes (``compile.py:1326``), and the kernels read nothing for
it. Planes past 2 + D are ignored.

Words are int32 views of the reference's uint32 words, as in
``ops.bitwise``. The plain versions take either a tensor
``[2 + D, ..., W]`` or a list of 2 + D planes (``bsi_planes``), and
count bits per trailing word axis, so a single shard's block gives the
reference's results exactly and a ``[.., S, W]`` block gives one per
shard.

Kernels here (each a wrapper: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises):

- K4 ``bsi_sum`` (csrc/bsi_sum.cu): per-bit positive and negative counts
  and the value count under G masks → int64 ``pos[G, D]``,
  ``neg[G, D]``, ``n[G]``; one mask on the CUDA cores, two or more
  (GroupBy's aggregate=Sum, mode ``grouped``) as a binary product on the
  tensor cores (``sum_route``, ``ops.bmma``);
- K5 ``bsi_min_max`` (csrc/bsi_minmax.cu): the extreme value per shard
  and how many columns hold it → int64 ``value[S]``, ``count[S]``.

Both take their filter (K4: its one mask) as a planned call tree too
(``bitwise.PlannedFilter``), which their fused modes evaluate inside
the kernel; the plain version is the filter's plain words, then the
aggregate's plain version.

The BSI conditions run inside K1 (``bitwise.tree_eval``'s CMP op).
"""

from __future__ import annotations

import ctypes

import torch

from pilosa_tpu_torch.ops import _cuda, bmma
from pilosa_tpu_torch.ops.bitwise import PlannedFilter, popcount_plain, popcount_rows_plain

# the widest word axis K5 takes: 8,192 vectors per shard, held in one
# block's registers (csrc/bsi_minmax.cu)
MINMAX_MAX_WORDS = 1 << 15

# K4 runs the tensor cores' split-K product from this many masks up
# (BS_MMA_MIN_GROUPS in csrc/bsi_sum.cu)
GROUPED_MIN_MASKS = 2

EXISTS_ROW = 0
SIGN_ROW = 1
OFFSET_ROW = 2

# the comparison ops of a BSI condition, in csrc/tree_eval.cu's CmpOp order
CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")


def bsi_planes(stack: torch.Tensor, depth: int) -> list[torch.Tensor]:
    """The 2 + ``depth`` planes of a ``[P, ..., W]`` stack: views of its
    rows, and one shared zero plane for each plane at or past P."""
    need = OFFSET_ROW + depth
    have = min(need, stack.shape[0])
    planes = [stack[p] for p in range(have)]
    if have < need:
        zero = torch.zeros(stack.shape[1:], dtype=stack.dtype, device=stack.device)
        planes += [zero] * (need - have)
    return planes


def _magnitude_cmp(
    mag, c_abs: int, like: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-column compare of the magnitude planes (LSB first) with the
    constant |c| → (eq, lt, gt) word masks: the classic MSB→LSB
    bit-sliced comparison. ``like`` gives the plane shape when there is
    no magnitude plane."""
    like = mag[0] if like is None else like
    eq = torch.full_like(like, -1)
    lt = torch.zeros_like(like)
    gt = torch.zeros_like(like)
    for k in range(len(mag) - 1, -1, -1):
        bit = mag[k]
        if (c_abs >> k) & 1:
            lt = lt | (eq & ~bit)
            eq = eq & bit
        else:
            gt = gt | (eq & bit)
            eq = eq & ~bit
    return eq, lt, gt


def compare(slices, op: str, value: int) -> torch.Tensor:
    """Columns whose stored value ⟨op⟩ ``value`` → int32[..., W] mask,
    existence applied. ``op`` is one of CMP_OPS."""
    exists = slices[EXISTS_ROW]
    sign = slices[SIGN_ROW]
    mag = slices[OFFSET_ROW:]
    pos = exists & ~sign
    neg = exists & sign
    c_abs = abs(value)
    if c_abs >= 1 << len(mag):
        # |c| exceeds every representable magnitude: nothing equal or
        # greater, every stored magnitude is smaller
        eq_m = torch.zeros_like(exists)
        gt_m = torch.zeros_like(exists)
        lt_m = torch.full_like(exists, -1)
    else:
        eq_m, lt_m, gt_m = _magnitude_cmp(mag, c_abs, like=exists)
    if value >= 0:
        eq = pos & eq_m
        # v < c: every negative, plus positives with smaller magnitude
        lt = neg | (pos & lt_m)
        gt = pos & gt_m
    else:
        eq = neg & eq_m
        # v < c (c negative): negatives with larger magnitude
        lt = neg & gt_m
        gt = pos | (neg & lt_m)
    if op == "==":
        return eq
    if op == "!=":
        return exists & ~eq
    if op == "<":
        return lt
    if op == "<=":
        return lt | eq
    if op == ">":
        return gt
    if op == ">=":
        return gt | eq
    raise ValueError(f"bad BSI comparison op {op!r}")


def between(slices, lo: int, hi: int) -> torch.Tensor:
    """Columns with lo <= value <= hi → int32[..., W]."""
    return compare(slices, ">=", lo) & compare(slices, "<=", hi)


def sum_counts(slices, filt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-magnitude-bit signed counts for Sum → (pos int32[D, ...],
    neg int32[D, ...], n int64): the exact sum is Σ_k 2^k (pos[k] −
    neg[k]), taken by the caller (``weigh_sum``)."""
    exists = slices[EXISTS_ROW]
    sign = slices[SIGN_ROW]
    mag = slices[OFFSET_ROW:]
    pos = exists & ~sign & filt
    neg = exists & sign & filt
    shape = (0,) + tuple(exists.shape[:-1])
    if len(mag):
        pos_counts = torch.stack([popcount_rows_plain(m & pos) for m in mag])
        neg_counts = torch.stack([popcount_rows_plain(m & neg) for m in mag])
    else:
        pos_counts = neg_counts = torch.zeros(shape, dtype=torch.int32, device=exists.device)
    return pos_counts, neg_counts, popcount_plain(exists & filt)


def weigh_sum(pos_counts, neg_counts) -> int:
    """Host-side exact weighted sum of per-bit counts (Python ints)."""
    total = 0
    for k, (p, q) in enumerate(zip(pos_counts.tolist(), neg_counts.tolist())):
        total += (int(p) - int(q)) << k
    return total


def min_max(slices, filt: torch.Tensor, want_max: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(value int64[...], count int64[...]) of the min or max stored
    value among the filtered, existing columns, per leading index (one
    pair for a single shard's ``[2 + D, W]``). count 0 means no value.

    Branch-free, as the reference: both candidate walks run, then the
    select."""
    exists = slices[EXISTS_ROW]
    sign = slices[SIGN_ROW]
    mag = slices[OFFSET_ROW:]
    depth = len(mag)
    base = exists & filt
    pos_cand = base & ~sign
    neg_cand = base & sign
    has_pos = popcount_rows_plain(pos_cand) > 0
    has_neg = popcount_rows_plain(neg_cand) > 0

    def walk(cand, prefer_set: bool):
        """MSB→LSB: narrow the candidates toward the extreme magnitude."""
        val = torch.zeros(cand.shape[:-1], dtype=torch.int64, device=cand.device)
        for k in range(depth - 1, -1, -1):
            t = (cand & mag[k]) if prefer_set else (cand & ~mag[k])
            nonempty = popcount_rows_plain(t) > 0
            cand = torch.where(nonempty[..., None], t, cand)
            bit_is_one = nonempty if prefer_set else ~nonempty
            val = val + (bit_is_one.to(torch.int64) << k)
        return val, cand

    if want_max:
        # max = the largest positive if any, else the negative of
        # smallest magnitude
        pv, pc = walk(pos_cand, prefer_set=True)
        nv, nc = walk(neg_cand, prefer_set=False)
        value = torch.where(has_pos, pv, -nv)
        cand = torch.where(has_pos[..., None], pc, nc)
    else:
        # min = the most negative if any, else the positive of smallest
        # magnitude
        nv, nc = walk(neg_cand, prefer_set=True)
        pv, pc = walk(pos_cand, prefer_set=False)
        value = torch.where(has_neg, -nv, pv)
        cand = torch.where(has_neg[..., None], nc, pc)
    return value, popcount_rows_plain(cand).to(torch.int64)


# ------------------------------------------------------------------ kernels
def _check_stack(stack: torch.Tensor, depth: int) -> tuple[int, int]:
    if stack.dtype != torch.int32 or stack.dim() != 3 or not stack.is_contiguous():
        raise ValueError("BSI stack must be contiguous int32[P, S, W]")
    if stack.shape[2] < 4 or stack.shape[2] % 4:
        # a shard's words, or a mesh block's slice of them
        raise ValueError(f"BSI stack word axis {stack.shape[2]} is not a positive multiple of 4")
    if not 0 <= depth <= 63:
        raise ValueError(f"BSI depth {depth} outside [0, 63]")
    return stack.shape[1], stack.shape[2]


def _check_plane(t: torch.Tensor, shape: tuple, dev: torch.device, what: str) -> None:
    if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous int32 on the stack's device")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} shape {tuple(t.shape)} != {shape}")


def sum_route(n_groups: int, depth: int) -> str:
    """K4's route for G masks at depth D: ``cores`` (one mask: each
    thread's vector of every plane in registers, popcounts on the CUDA
    cores) or ``bmma`` (G >= GROUPED_MIN_MASKS: the split-K binary
    product of csrc/bmma.cuh, in ``grouped_passes(G, D)`` launches)."""
    if n_groups < 1 or not 0 <= depth <= 63:
        raise ValueError(f"{n_groups} masks at depth {depth}")
    return "bmma" if n_groups >= GROUPED_MIN_MASKS else "cores"


def grouped_passes(n_groups: int, depth: int) -> list[tuple[int, int, int, int]]:
    """The passes of K4's ``bmma`` route: (first mask, masks, first
    column, columns) over the D magnitude bits and the ones column."""
    return bmma.passes(True, n_groups, depth + 1)


def bsi_sum_plain(
    stack: torch.Tensor, depth: int, masks: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's plain version: ``sum_counts`` under each mask (one all-ones
    mask without ``masks``), summed over the shards → int64 pos[G, D],
    neg[G, D], n[G]. One mask at a time, so the temporaries stay the size
    of a few planes."""
    planes = bsi_planes(stack, depth)
    n_groups = 1 if masks is None else masks.shape[0]
    pos = torch.zeros((n_groups, depth), dtype=torch.int64, device=stack.device)
    neg = torch.zeros_like(pos)
    n = torch.zeros(n_groups, dtype=torch.int64, device=stack.device)
    for g in range(n_groups):
        filt = torch.full_like(planes[0], -1) if masks is None else masks[g]
        p, q, c = sum_counts(planes, filt)
        pos[g] = p.to(torch.int64).sum(dim=-1)
        neg[g] = q.to(torch.int64).sum(dim=-1)
        n[g] = c
    return pos, neg, n


def bsi_sum(
    stack: torch.Tensor, depth: int, masks: "torch.Tensor | PlannedFilter | None" = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum counts of a BSI stack ``int32[P, S, W]`` at depth D under
    ``masks`` (``int32[G, S, W]``, a planned filter as one mask, or None
    for one all-ones mask) (K4) → int64 pos[G, D], neg[G, D], n[G]."""
    n_shards, n_words = _check_stack(stack, depth)
    dev = stack.device
    tree = masks if isinstance(masks, PlannedFilter) else None
    if masks is not None and tree is None:
        if masks.dim() != 3 or masks.shape[0] < 1:
            raise ValueError("masks must be int32[G, S, W] with G >= 1")
        _check_plane(masks, (masks.shape[0], n_shards, n_words), dev, "masks")
    if dev.type == "cpu":
        if tree is not None:
            return bsi_sum_plain(stack, depth, tree.plain(dev, (n_shards, n_words))[None])
        return bsi_sum_plain(stack, depth, masks)
    n_groups = 1 if masks is None or tree is not None else masks.shape[0]
    pos = torch.zeros((n_groups, depth), dtype=torch.int64, device=dev)
    neg = torch.zeros_like(pos)
    n = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    n_vec = n_shards * n_words // 4
    if tree is not None:
        args = tree.pack(dev, (n_shards, n_words))
        _cuda.BSI_SUM_TREE.launch(
            dev, ctypes.byref(args), stack.data_ptr(), n_vec, stack.shape[0], depth,
            pos.data_ptr(), neg.data_ptr(), n.data_ptr(), mode="one+tree",
        )
        return pos, neg, n
    _cuda.BSI_SUM.launch(
        dev,
        stack.data_ptr(),
        n_vec,
        stack.shape[0],
        depth,
        None if masks is None else masks.data_ptr(),
        n_groups,
        pos.data_ptr(),
        neg.data_ptr(),
        n.data_ptr(),
        mode="grouped" if sum_route(n_groups, depth) == "bmma" else ("filtered" if masks is not None else "all"),
    )
    return pos, neg, n


def weigh_device(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """``Σ_k (pos[k] - neg[k]) · 2^k`` of int64[D] per-bit counts as an
    int64 on their device, wrapping modulo 2^64 as the reference's int64
    dot does (D ≤ 63 elements: torch glue, not a kernel)."""
    depth = pos.shape[-1]
    weights = torch.tensor([1 << k for k in range(depth)], dtype=torch.int64, device=pos.device)
    return torch.sum((pos - neg) * weights)


def sum_device(slices: torch.Tensor, filt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All-device Sum of a BSI stack under a filter → (sum int64, count
    int64), both on the stack's device: ``int32[2 + D, W]`` under
    ``int32[W]`` (one fragment), or ``int32[2 + D, S, W]`` under
    ``int32[S, W]``. K4 filtered, then ``weigh_device``."""
    if slices.dim() == 2:
        slices, filt = slices[:, None], filt[None]
    depth = slices.shape[0] - OFFSET_ROW
    pos, neg, n = bsi_sum(slices.contiguous(), depth, filt.contiguous()[None])
    return weigh_device(pos[0], neg[0]), n[0]


def bsi_min_max_plain(
    stack: torch.Tensor, depth: int, filt: torch.Tensor | None, want_max: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: ``min_max`` over every shard at once."""
    planes = bsi_planes(stack, depth)
    if filt is None:
        filt = torch.full_like(planes[0], -1)
    return min_max(planes, filt, want_max)


def bsi_min_max(
    stack: torch.Tensor, depth: int, filt: "torch.Tensor | PlannedFilter | None", want_max: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard Min or Max of a BSI stack ``int32[P, S, W]`` at depth D
    under ``filt`` (``int32[S, W]``, a planned filter, or None for all
    columns) (K5) → int64 value[S], count[S]."""
    n_shards, n_words = _check_stack(stack, depth)
    dev = stack.device
    tree = filt if isinstance(filt, PlannedFilter) else None
    if filt is not None and tree is None:
        _check_plane(filt, (n_shards, n_words), dev, "filter")
    if dev.type == "cpu":
        if tree is not None:
            filt = tree.plain(dev, (n_shards, n_words))
        return bsi_min_max_plain(stack, depth, filt, want_max)
    if n_words > MINMAX_MAX_WORDS:
        raise ValueError(f"K5 takes at most {MINMAX_MAX_WORDS} words per shard, got {n_words}")
    value = torch.empty(n_shards, dtype=torch.int64, device=dev)
    count = torch.empty(n_shards, dtype=torch.int64, device=dev)
    name = "max" if want_max else "min"
    if tree is not None:
        args = tree.pack(dev, (n_shards, n_words))
        _cuda.BSI_MINMAX_TREE.launch(
            dev, ctypes.byref(args), stack.data_ptr(), n_shards, n_words // 4, stack.shape[0], depth,
            int(want_max), value.data_ptr(), count.data_ptr(), mode=name + "+tree",
        )
        return value, count
    _cuda.BSI_MINMAX.launch(
        dev,
        stack.data_ptr(),
        n_shards,
        n_words // 4,
        stack.shape[0],
        depth,
        None if filt is None else filt.data_ptr(),
        int(want_max),
        value.data_ptr(),
        count.data_ptr(),
        mode=name + (" filtered" if filt is not None else ""),
    )
    return value, count
