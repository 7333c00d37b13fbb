"""The point-write delta scatter into a resident stack (K3).

Reference: ``_apply_stack_delta`` (pilosa_tpu/executor/compile.py:194).
``apply_stack_delta`` is the wrapper of ``csrc/stack_delta.cu``: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises. Both return a NEW stack: readers in flight keep the old one.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import _cuda

# scatter index sentinel: out of range on both axes, so the entry drops
OOB = 2**30


def apply_stack_delta_plain(
    matrix: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """``out[idx[k, 0], idx[k, 1]] = rows[k]`` on a copy of ``matrix``;
    entries out of range on either axis drop, and where two entries name
    one (row, shard) plane the later one wins."""
    n_rows, n_shards, n_words = matrix.shape
    out = matrix.clone()
    r, s = idx[:, 0].long(), idx[:, 1].long()
    keep = (r >= 0) & (r < n_rows) & (s >= 0) & (s < n_shards)
    slot = torch.full((n_rows * n_shards,), -1, dtype=torch.long, device=matrix.device)
    k_all = torch.arange(idx.shape[0], device=matrix.device)
    slot.scatter_reduce_(0, (r * n_shards + s)[keep], k_all[keep], reduce="amax")
    hit = slot >= 0
    out.view(n_rows * n_shards, n_words)[hit] = rows[slot[hit]]
    return out


def apply_stack_delta(
    matrix: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """Copy ``int32[R, S, W]`` and write ``rows`` (int32[K, W]) at
    ``idx`` (int32[K, 2], (row, shard) pairs) (K3). On the card one
    kernel pass does both the copy and the writes."""
    dev = matrix.device
    if matrix.dtype != torch.int32 or matrix.dim() != 3 or not matrix.is_contiguous():
        raise ValueError("matrix must be contiguous int32[R, S, W]")
    n_rows, n_shards, n_words = matrix.shape
    k = idx.shape[0]
    if tuple(idx.shape) != (k, 2) or tuple(rows.shape) != (k, n_words):
        raise ValueError(f"idx {tuple(idx.shape)} / rows {tuple(rows.shape)} do not match [K, 2] / [K, {n_words}]")
    for t in (idx, rows):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("idx and rows must be contiguous int32 on the matrix's device")
    if dev.type == "cpu":
        return apply_stack_delta_plain(matrix, idx, rows)
    if n_words % 4:
        raise ValueError(f"W = {n_words} is not a multiple of 4 words")
    out = torch.empty_like(matrix)
    # scratch map (row, shard) plane → the entry that replaces it, or -1
    slot = torch.empty(n_rows * n_shards, dtype=torch.int32, device=dev)
    _cuda.STACK_DELTA.launch(
        dev,
        out.data_ptr(),
        matrix.data_ptr(),
        n_rows,
        n_shards,
        n_words // 4,
        idx.data_ptr(),
        rows.data_ptr(),
        k,
        slot.data_ptr(),
    )
    return out
