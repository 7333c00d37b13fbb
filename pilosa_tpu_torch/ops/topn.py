"""TopN counts: per-row masked popcount summed over shards (K2).

Reference: pilosa_tpu/ops/topn.py and the TopN programs of
pilosa_tpu/executor/executor.py:1306-1390. ``row_counts`` is the wrapper
of ``csrc/row_counts.cu``: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import _cuda
from pilosa_tpu_torch.ops.bitwise import popcount_rows


def candidate_counts(
    matrix: torch.Tensor, row_ids: torch.Tensor, filt: torch.Tensor | None
) -> torch.Tensor:
    """Gather candidate rows (axis 0) and popcount them under the filter;
    an out-of-range id counts 0. ``int32[R, ..., W]``, ``int32[C]``,
    ``int32[..., W]`` → ``int32[C, ...]``."""
    n_rows = matrix.shape[0]
    in_range = (row_ids >= 0) & (row_ids < n_rows)
    gathered = matrix[torch.where(in_range, row_ids, 0).long()]
    counts = popcount_rows(gathered if filt is None else gathered & filt)
    mask = in_range.reshape((-1,) + (1,) * (counts.dim() - 1))
    return torch.where(mask, counts, 0)


def row_counts_plain(
    matrix: torch.Tensor,
    filt: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """int64 counts per row of ``int32[R, S, W]`` (or per candidate id),
    summed over shards. One plane at a time, so the plain version's
    temporaries stay the size of one row."""
    rows = ids if ids is not None else torch.arange(matrix.shape[0], device=matrix.device)
    out = torch.zeros(rows.shape[0], dtype=torch.int64, device=matrix.device)
    for o in range(rows.shape[0]):
        out[o] = candidate_counts(matrix, rows[o : o + 1], filt).sum(dtype=torch.int64)
    return out


def row_counts(
    matrix: torch.Tensor,
    filt: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-row popcount of ``matrix & filt`` summed over shards → int64[R],
    or int64[C] for candidate ``ids`` (int32[C]) (K2)."""
    dev = matrix.device
    if matrix.dtype != torch.int32 or matrix.dim() != 3 or not matrix.is_contiguous():
        raise ValueError("matrix must be contiguous int32[R, S, W]")
    n_rows, n_shards, n_words = matrix.shape
    if n_words < 4 or n_words % 4:
        # a shard's words, or a mesh block's slice of them
        raise ValueError(f"matrix word axis {n_words} is not a positive multiple of 4")
    for t in (filt, ids):
        if t is not None and (t.device != dev or t.dtype != torch.int32 or not t.is_contiguous()):
            raise ValueError("filter and ids must be contiguous int32 on the matrix's device")
    if filt is not None and tuple(filt.shape) != (n_shards, n_words):
        raise ValueError(f"filter shape {tuple(filt.shape)} != {(n_shards, n_words)}")
    if ids is not None and ids.dim() != 1:
        raise ValueError("ids must be int32[C]")
    if dev.type == "cpu":
        return row_counts_plain(matrix, filt, ids)
    n_out = n_rows if ids is None else ids.shape[0]
    out = torch.zeros(n_out, dtype=torch.int64, device=dev)
    if n_out:
        _cuda.ROW_COUNTS.launch(
            dev,
            matrix.data_ptr(),
            n_rows,
            n_shards * n_words // 4,
            None if filt is None else filt.data_ptr(),
            None if ids is None else ids.data_ptr(),
            n_out,
            out.data_ptr(),
            mode=("filtered" if filt is not None else "rows") + (" ids" if ids is not None else ""),
        )
    return out
