"""GroupBy's level counts and group masks (K6).

Reference: ``_gb_counts`` and ``_gb_masks``
(pilosa_tpu/executor/executor.py:177, :192), the two jitted programs the
reference's GroupBy runs per level (and its fused path chains). Here
they are ops of their own: ``gb_counts`` and ``gb_masks`` are the
wrappers of the two entry points of ``csrc/groupby.cu``; a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

A row id of −1 (the executor's padding) or ≥ R gathers a zero row, as
the reference's ``jnp.take(mode="fill", fill_value=0)``; so does a group
index outside [0, G), which the executor never produces.

``gb_counts`` runs the split-K binary product on the tensor cores
(``csrc/bmma.cuh``, ``ops.bmma``): the G masks against the K rows the
ids pick, in ``counts_passes(G, K)`` launches of the kernel; an id
outside [0, R) loads nothing.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import _cuda, bmma
from pilosa_tpu_torch.ops.bitwise import popcount_rows_plain


def gb_counts_plain(
    masks: torch.Tensor, matrix: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """``out[g, k] = Σ_s popcount(masks[g] & matrix[rows[k]])`` →
    int64[G, K]; one (group, row) plane pair at a time."""
    n_groups, n_rows = masks.shape[0], matrix.shape[0]
    out = torch.zeros((n_groups, rows.shape[0]), dtype=torch.int64, device=masks.device)
    for k, r in enumerate(rows.tolist()):
        if not 0 <= r < n_rows:
            continue
        for g in range(n_groups):
            out[g, k] = popcount_rows_plain(masks[g] & matrix[r]).to(torch.int64).sum()
    return out


def gb_masks_plain(
    masks: torch.Tensor,
    matrix: torch.Tensor,
    g_idx: torch.Tensor,
    row_sel: torch.Tensor,
) -> torch.Tensor:
    """``out[p] = masks[g_idx[p]] & matrix[row_sel[p]]`` → int32[P, S, W],
    zero where either index is out of range."""
    out = torch.zeros(
        (g_idx.shape[0],) + tuple(masks.shape[1:]), dtype=torch.int32, device=masks.device
    )
    for p, (g, r) in enumerate(zip(g_idx.tolist(), row_sel.tolist())):
        if 0 <= g < masks.shape[0] and 0 <= r < matrix.shape[0]:
            torch.bitwise_and(masks[g], matrix[r], out=out[p])
    return out


def counts_passes(n_groups: int, n_ids: int) -> list[tuple[int, int, int, int]]:
    """The passes of ``gb_counts``: (first mask, masks, first id, ids)."""
    return bmma.passes(False, n_groups, n_ids)


def _check(masks: torch.Tensor, matrix: torch.Tensor, *index: torch.Tensor) -> None:
    for t, what in ((masks, "masks"), (matrix, "matrix")):
        if t.dtype != torch.int32 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous int32[N, S, W]")
        if t.device != masks.device:
            raise ValueError(f"{what} on {t.device}, masks on {masks.device}")
    if masks.shape[0] < 1 or matrix.shape[0] < 1:
        raise ValueError("masks and matrix need at least one plane each")
    if matrix.shape[1:] != masks.shape[1:] or masks.shape[2] < 4 or masks.shape[2] % 4:
        raise ValueError(
            f"masks {tuple(masks.shape)} and matrix {tuple(matrix.shape)} "
            "are not [N, S, W] over the same shards and words (W a multiple of 4)"
        )
    for t in index:
        if t.device != masks.device or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("indices must be contiguous int32[K] on the masks' device")


def gb_counts(masks: torch.Tensor, matrix: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Counts of every (group mask, candidate row) pair summed over the
    shards: ``int32[G, S, W]`` × rows of ``int32[R, S, W]`` picked by
    ``rows`` (int32[K]) → int64[G, K] (K6)."""
    _check(masks, matrix, rows)
    dev = masks.device
    if dev.type == "cpu":
        return gb_counts_plain(masks, matrix, rows)
    n_groups, n_shards, n_words = masks.shape
    out = torch.zeros((n_groups, rows.shape[0]), dtype=torch.int64, device=dev)
    if rows.shape[0]:
        _cuda.GB_COUNTS.launch(
            dev,
            masks.data_ptr(),
            n_groups,
            matrix.data_ptr(),
            matrix.shape[0],
            n_shards * n_words // 4,
            rows.data_ptr(),
            rows.shape[0],
            out.data_ptr(),
        )
    return out


def gb_masks(
    masks: torch.Tensor,
    matrix: torch.Tensor,
    g_idx: torch.Tensor,
    row_sel: torch.Tensor,
) -> torch.Tensor:
    """The next level's group masks: ``masks[g_idx[p]] & matrix[row_sel[p]]``
    → int32[P, S, W] (K6)."""
    _check(masks, matrix, g_idx, row_sel)
    if g_idx.shape != row_sel.shape:
        raise ValueError(f"g_idx {tuple(g_idx.shape)} != row_sel {tuple(row_sel.shape)}")
    dev = masks.device
    if dev.type == "cpu":
        return gb_masks_plain(masks, matrix, g_idx, row_sel)
    n_groups, n_shards, n_words = masks.shape
    out = torch.empty((g_idx.shape[0], n_shards, n_words), dtype=torch.int32, device=dev)
    if g_idx.shape[0]:
        _cuda.GB_MASKS.launch(
            dev,
            out.data_ptr(),
            masks.data_ptr(),
            n_groups,
            matrix.data_ptr(),
            matrix.shape[0],
            n_shards * n_words // 4,
            g_idx.data_ptr(),
            row_sel.data_ptr(),
            g_idx.shape[0],
        )
    return out
