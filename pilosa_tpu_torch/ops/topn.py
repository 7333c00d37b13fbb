"""TopN counts: per-row masked popcount summed over shards (K2), the
fused ingest step (K13) and the integer top-k.

Reference: pilosa_tpu/ops/topn.py, the TopN programs of
pilosa_tpu/executor/executor.py:1306-1390, and the ingest step of
__graft_entry__.py:65 ``query_step`` (pilosa_tpu/parallel/mesh.py:852
``_ingest_prog`` per device). ``row_counts`` is the wrapper of
``csrc/row_counts.cu`` and ``ingest_counts`` of ``csrc/ingest_counts.cu``:
a CPU tensor takes the plain version, a CUDA tensor launches the kernel
or raises. ``row_counts`` takes its filter as an [S, W] plane or as a
planned call tree (``bitwise.PlannedFilter``), which K2's fused mode
evaluates itself. ``select_top_counts`` is ``lax.top_k`` of int64
counts: K10's one-launch ``small int`` route up to 4,096 counts, else
K12's count keys and K10's int mode (ops/similarity.py); ``top_rows``
is K2 then that top-k.
"""

from __future__ import annotations

import ctypes

import torch

from pilosa_tpu_torch.ops import _cuda, similarity
from pilosa_tpu_torch.ops.bitwise import PlannedFilter, popcount_rows_plain


def candidate_counts(
    matrix: torch.Tensor, row_ids: torch.Tensor, filt: torch.Tensor | None
) -> torch.Tensor:
    """Gather candidate rows (axis 0) and popcount them under the filter;
    an out-of-range id counts 0. ``int32[R, ..., W]``, ``int32[C]``,
    ``int32[..., W]`` → ``int32[C, ...]``."""
    n_rows = matrix.shape[0]
    in_range = (row_ids >= 0) & (row_ids < n_rows)
    gathered = matrix[torch.where(in_range, row_ids, 0).long()]
    counts = popcount_rows_plain(gathered if filt is None else gathered & filt)
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
    filt: "torch.Tensor | PlannedFilter | None" = None,
    ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-row popcount of ``matrix & filt`` summed over shards → int64[R],
    or int64[C] for candidate ``ids`` (int32[C]) (K2). ``filt`` is an
    int32[S, W] plane, a planned call tree (K2's fused mode evaluates it
    once per vector), or None for all columns."""
    dev = matrix.device
    if matrix.dtype != torch.int32 or matrix.dim() != 3 or not matrix.is_contiguous():
        raise ValueError("matrix must be contiguous int32[R, S, W]")
    n_rows, n_shards, n_words = matrix.shape
    if n_words < 4 or n_words % 4:
        # a shard's words, or a mesh block's slice of them
        raise ValueError(f"matrix word axis {n_words} is not a positive multiple of 4")
    tree = filt if isinstance(filt, PlannedFilter) else None
    plane = filt if tree is None else None
    for t in (plane, ids):
        if t is not None and (t.device != dev or t.dtype != torch.int32 or not t.is_contiguous()):
            raise ValueError("filter and ids must be contiguous int32 on the matrix's device")
    if plane is not None and tuple(plane.shape) != (n_shards, n_words):
        raise ValueError(f"filter shape {tuple(plane.shape)} != {(n_shards, n_words)}")
    if ids is not None and ids.dim() != 1:
        raise ValueError("ids must be int32[C]")
    if dev.type == "cpu":
        return row_counts_plain(matrix, plane if tree is None else tree.plain(dev, (n_shards, n_words)), ids)
    n_out = n_rows if ids is None else ids.shape[0]
    out = torch.zeros(n_out, dtype=torch.int64, device=dev)
    n_vec = n_shards * n_words // 4
    ids_ptr = None if ids is None else ids.data_ptr()
    if tree is not None:
        args = tree.pack(dev, (n_shards, n_words))
        if n_out:
            _cuda.ROW_COUNTS_TREE.launch(
                dev, ctypes.byref(args), matrix.data_ptr(), n_rows, n_vec, ids_ptr, n_out, out.data_ptr(),
                mode=("ids" if ids is not None else "rows") + "+tree",
            )
    elif n_out:
        _cuda.ROW_COUNTS.launch(
            dev,
            matrix.data_ptr(),
            n_rows,
            n_vec,
            None if plane is None else plane.data_ptr(),
            ids_ptr,
            n_out,
            out.data_ptr(),
            mode=("filtered" if plane is not None else "rows") + (" ids" if ids is not None else ""),
        )
    return out


# -------------------------------------------------------- the ingest step


def ingest_counts_plain(
    matrix: torch.Tensor, delta: torch.Tensor, filt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K13's plain version: ``matrix |= delta`` in place, then the
    filtered row counts and their sum."""
    matrix |= delta
    counts = row_counts_plain(matrix, filt)
    return matrix, counts, counts.sum()


def ingest_counts(
    matrix: torch.Tensor, delta: torch.Tensor, filt: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply a write delta and count every row under a filter, in one
    pass (K13): ``int32[R, S, W] | int32[R, S, W]``, ``int32[S, W]`` →
    (matrix, int64[R] counts, int64 total). The OR is in place, as the
    reference donates the matrix: the ``matrix`` handle now holds the new
    matrix, and it is what is returned. The total stays on the device."""
    if matrix.dtype != torch.int32 or matrix.dim() != 3 or not matrix.is_contiguous():
        raise ValueError("matrix must be contiguous int32[R, S, W]")
    n_rows, n_shards, n_words = matrix.shape
    if n_words < 4 or n_words % 4:
        raise ValueError(f"matrix word axis {n_words} is not a positive multiple of 4")
    dev = matrix.device
    for t, shape, what in ((delta, tuple(matrix.shape), "delta"), (filt, (n_shards, n_words), "filter")):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{what} must be a contiguous int32{list(shape)} on {dev}")
    if dev.type == "cpu":
        return ingest_counts_plain(matrix, delta, filt)
    counts = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    if n_rows:
        _cuda.INGEST_COUNTS.launch(
            dev, matrix.data_ptr(), delta.data_ptr(), n_rows, n_shards * n_words // 4,
            filt.data_ptr(), counts.data_ptr(), total.data_ptr(),
        )
    return matrix, counts, total.reshape(())


# ------------------------------------------------------- the integer top-k


def select_top_counts_plain(counts: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``select_top_counts``' plain version: the plain count keys and
    K10's plain int mode."""
    k = min(int(k), counts.shape[0])
    keys, _hist = similarity.count_keys_plain(counts)
    return similarity.select_top_plain(keys, k, similarity.count_key_bits(counts.shape[0]))


def select_top_counts(counts: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of ``int64[R]`` counts in descending order →
    (int64 counts[k], int32 ids[k]), k clamped to R, ties to the lower
    row: ``lax.top_k``'s answer for any int64 counts. Up to SELECT_TILE
    counts, one K10 launch (``small int``) that reads the counts; above
    that, K12's count keys, then K10's int mode. Nothing waits for the
    card."""
    if k < 0:
        raise ValueError(f"k must be non-negative, got {k}")
    if counts.dtype != torch.int64 or counts.dim() != 1:
        raise ValueError("counts must be int64[R]")
    counts = counts.contiguous()
    n = counts.shape[0]
    k = min(int(k), n)
    if k == 0:
        return counts[:0].clone(), torch.empty(0, dtype=torch.int32, device=counts.device)
    bits = similarity.count_key_bits(n)
    if similarity.select_route(n, k, bits) == "small int":
        return similarity.select_counts(counts, k)
    keys, hist = similarity.count_keys(counts)
    return similarity.select_top(keys, hist, k, bits)


def top_rows(matrix: torch.Tensor, filt: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts int32[k], row_ids int32[k]) of the k largest filtered row
    counts of one fragment ``int32[R, W]`` under ``int32[W]``, k clamped
    to R; rows of count 0 appear when k passes the non-zero rows. K2
    filtered, then ``select_top_counts``."""
    if matrix.dim() != 2 or filt.dim() != 1:
        raise ValueError("top_rows takes one fragment int32[R, W] and a filter int32[W]")
    counts = row_counts(matrix[:, None].contiguous(), filt[None].contiguous())
    vals, ids = select_top_counts(counts, k)
    return vals.to(torch.int32), ids
