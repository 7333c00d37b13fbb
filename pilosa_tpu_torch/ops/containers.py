"""Compressed row containers: decode and direct counts (B13).

Reference: pilosa_tpu/ops/containers.py. A row of an over-budget field
may be resident as a container payload (executor/residency.py):

- sparse: ``int32[K]`` sorted GLOBAL bit positions of the flattened
  ``[S * W * 32)`` plane (shard-major, bit-minor, little bit order),
  −1 padding;
- run: ``int32[K, 2]`` sorted, disjoint ``[start, end)`` intervals in the
  same space, ``(0, 0)`` padding (``end <= start`` is empty).

``sparse_plane`` and ``run_plane`` are the plain decodes; on the card a
query decodes the payload inside K1 (its LOAD_SPARSE and LOAD_RUN
opcodes) and never builds the plane. ``container_count`` is the wrapper
of ``csrc/container_count.cu`` (K8): the count of one slot's payload,
read straight from it, for a Count whose whole tree is one container
leaf. A CPU tensor takes ``sparse_count``/``run_count``.

Words are int32 views of the reference's uint32 words; sums run in
int64 and wrap to int32 at the end.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import _cuda

_FULL_WORD = 0xFFFFFFFF


def _as_int32_words(flat: torch.Tensor, n_shards: int, n_words: int) -> torch.Tensor:
    """int64 words in [0, 2^32) → their int32 bit patterns, [S, W]."""
    flat = torch.where(flat >= 1 << 31, flat - (1 << 32), flat)
    return flat.to(torch.int32).reshape(n_shards, n_words)


def sparse_plane(ids: torch.Tensor, n_shards: int, n_words: int) -> torch.Tensor:
    """Sorted sparse ids ``int32[K]`` (−1 padding) → ``int32[S, W]``:
    each id sets bit ``id & 31`` of word ``id >> 5``. Distinct ids name
    distinct bits, so an add equals an OR."""
    total = n_shards * n_words
    ids = ids.to(torch.int64)
    valid = ids >= 0
    word = torch.where(valid, ids >> 5, total)
    bit = torch.where(valid, torch.ones_like(ids) << (ids & 31), 0)
    flat = torch.zeros(total + 1, dtype=torch.int64, device=ids.device)
    flat.index_add_(0, word, bit)
    return _as_int32_words(flat[:total], n_shards, n_words)


def run_plane(runs: torch.Tensor, n_shards: int, n_words: int) -> torch.Tensor:
    """Run intervals ``int32[K, 2]`` → ``int32[S, W]`` by interval
    arithmetic, O(K + S·W), as the reference: the full words inside a run
    from a coverage prefix sum (+1 at its first full word, −1 past its
    last), and the ≤ 2 partial words at its ends set directly (runs are
    disjoint, so an add equals an OR)."""
    total = n_shards * n_words
    dev = runs.device
    lo, hi = runs[:, 0].to(torch.int64), runs[:, 1].to(torch.int64)
    live = hi > lo
    w_lo, b_lo = lo >> 5, lo & 31
    w_hi, b_hi = hi >> 5, hi & 31
    same = w_lo == w_hi
    start_full = w_lo + (b_lo != 0).to(torch.int64)
    has_full = live & (start_full < w_hi)
    drop = total + 1
    delta = torch.zeros(total + 2, dtype=torch.int64, device=dev)
    delta.index_add_(0, torch.where(has_full, start_full, drop), has_full.to(torch.int64))
    delta.index_add_(0, torch.where(has_full, w_hi, drop), -has_full.to(torch.int64))
    full = torch.cumsum(delta, 0)[:total] > 0
    zero = torch.zeros_like(lo)
    head = torch.where(live & ~same & (b_lo > 0), (_FULL_WORD << b_lo) & _FULL_WORD, zero)
    tail = torch.where(live & ~same & (b_hi > 0), (torch.ones_like(b_hi) << b_hi) - 1, zero)
    span = torch.clamp(b_hi - b_lo, max=31)
    inside = torch.where(live & same, ((torch.ones_like(span) << span) - 1) << b_lo, zero)
    partial = torch.zeros(total + 1, dtype=torch.int64, device=dev)
    for mask, w in ((head, w_lo), (tail, w_hi), (inside, w_lo)):
        partial.index_add_(0, torch.where(mask > 0, w, total), mask)
    flat = torch.where(full, _FULL_WORD, 0) | partial[:total]
    return _as_int32_words(flat, n_shards, n_words)


def sparse_count(ids: torch.Tensor) -> torch.Tensor:
    """Set bits of a sparse payload: its valid ids. int64 scalar."""
    return (ids >= 0).sum(dtype=torch.int64)


def run_count(runs: torch.Tensor) -> torch.Tensor:
    """Set bits of a run payload: Σ (end − start), as the reference sums
    it ((0, 0) padding adds nothing). int64 scalar."""
    return (runs[:, 1].to(torch.int64) - runs[:, 0].to(torch.int64)).sum()


def container_count(store: torch.Tensor, slot: int) -> torch.Tensor:
    """Count of slot ``slot`` of a sparse store ``int32[H, K]`` or a run
    store ``int32[H, K, 2]``, read from the payload alone (K8). A slot
    outside the store counts 0. → int64 scalar."""
    if store.dtype != torch.int32 or not store.is_contiguous():
        raise ValueError("store must be contiguous int32")
    run = store.dim() == 3
    if not (store.dim() == 2 or (run and store.shape[2] == 2)):
        raise ValueError(f"store shape {tuple(store.shape)} is neither [H, K] nor [H, K, 2]")
    inside = 0 <= slot < store.shape[0]
    dev = store.device
    if dev.type == "cpu":
        if not inside:
            return torch.zeros((), dtype=torch.int64)
        return run_count(store[slot]) if run else sparse_count(store[slot])
    k = store.shape[1]
    out = torch.empty((), dtype=torch.int64, device=dev)
    payload = store.data_ptr() + slot * store[0].numel() * 4 if inside else None
    _cuda.CONTAINER_COUNT.launch(
        dev, payload, int(run), k, out.data_ptr(), mode="run" if run else "sparse"
    )
    return out
