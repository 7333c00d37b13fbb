"""Scatters into resident stacks and stores (K3).

Reference: ``_apply_stack_delta`` and ``_scatter_rows``
(pilosa_tpu/executor/compile.py:194, :185). ``apply_stack_delta`` is the
wrapper of ``csrc/stack_delta.cu``: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises. ``scatter_rows`` runs K3 in
row mode, for the tiered residency stores, with (slot, P, L) in place of
one (row, plane) pair per plane. Both return a NEW tensor: readers in
flight keep the old one.
"""

from __future__ import annotations

import math

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
    matrix: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, mode: str = "delta"
) -> torch.Tensor:
    """Copy ``int32[R, S, W]`` and write ``rows`` (int32[K, W]) at
    ``idx`` (int32[K, 2], (row, shard) pairs) (K3). On the card the copy
    is one flat stream and the kept rows are written over it after.
    ``mode`` names the caller in the launch counts: a point-write delta,
    a hot-slot upload or a row scatter."""
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
    return _launch(matrix, n_rows, n_shards, n_words, idx, 2, rows, mode)


def _launch(
    src: torch.Tensor, n_rows: int, n_shards: int, n_words: int,
    idx: torch.Tensor, cols: int, rows: torch.Tensor, mode: str,
) -> torch.Tensor:
    """K3 into a new tensor: ``src`` is [n_rows, n_shards, n_words]
    words; ``cols`` 2 for a delta's (row, shard) pairs, 1 for a row
    scatter's rows of n_shards planes (``csrc/stack_delta.cu``)."""
    if n_words % 4:
        raise ValueError(f"W = {n_words} is not a multiple of 4 words")
    k = idx.shape[0]
    for t in (src, rows):
        if t.data_ptr() % 16:
            raise ValueError("K3 copies 16 B vectors: the tensors must start on a 16 B boundary")
    out = torch.empty_like(src)
    # scratch map plane (or row) -> the entry that replaces it
    slot = torch.empty(n_rows * (n_shards if cols == 2 else 1), dtype=torch.int32, device=src.device) if k else None
    _cuda.STACK_DELTA.launch(
        src.device,
        out.data_ptr(),
        src.data_ptr(),
        n_rows,
        n_shards,
        n_words // 4,
        idx.data_ptr(),
        cols,
        rows.data_ptr(),
        k,
        None if slot is None else slot.data_ptr(),
        mode=mode,
    )
    return out


def _row_planes(store: torch.Tensor) -> int:
    """Planes P of one store row: a dense [H, S, W] store keeps its S
    shard planes, a sparse [H, K] or run [H, K, 2] row is one plane."""
    return store.shape[1] if store.dim() == 3 and store.shape[2] % 4 == 0 else 1


def _check_rows(store: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    if store.dtype != torch.int32 or store.dim() < 2 or not store.is_contiguous():
        raise ValueError("store must be a contiguous int32 [H, ...]")
    k = idx.shape[0]
    if idx.dim() != 1 or tuple(rows.shape) != (k,) + tuple(store.shape[1:]):
        raise ValueError(f"idx {tuple(idx.shape)} / rows {tuple(rows.shape)} do not match the store {tuple(store.shape)}")


def _as_planes(store: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """(store as [H, P, L], (slot, plane) pairs int32[K * P, 2], rows as
    int32[K * P, L]) for the plain row scatter."""
    _check_rows(store, idx, rows)
    k = idx.shape[0]
    h, p = store.shape[0], _row_planes(store)
    length = store[0].numel() // p
    planes = torch.arange(p, dtype=torch.int32, device=store.device).repeat(k)
    pairs = torch.stack([idx.to(torch.int32).repeat_interleave(p), planes], dim=1).contiguous()
    return store.view(h, p, length), pairs, rows.reshape(k * p, length).contiguous()


def scatter_rows_plain(store: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The plain version of ``scatter_rows``, on any device."""
    view, pairs, flat = _as_planes(store, idx, rows)
    return apply_stack_delta_plain(view, pairs, flat).view(store.shape)


def scatter_rows(store: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``store[idx[k]] = rows[k]`` on a copy of an int32 store [H, ...]
    (idx int32[K], rows int32[K, ...]): K3 in row mode, the store read as
    H rows of P planes of L words, (slot, P, L) passed to the kernel as
    they are. Entries out of range drop; where two name one slot the
    later wins."""
    if store.device.type == "cpu":
        return scatter_rows_plain(store, idx, rows)
    _check_rows(store, idx, rows)
    for t in (idx, rows):
        if t.device != store.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("idx and rows must be contiguous int32 on the store's device")
    h, p = store.shape[0], _row_planes(store)
    length = math.prod(store.shape[1:]) // p
    return _launch(store, h, p, length, idx, 1, rows, "rows")
