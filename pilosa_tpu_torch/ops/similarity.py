"""Tanimoto and cosine similarity over packed bit vectors (K9-K12).

Reference: pilosa_tpu/ops/similarity.py (B14), the one-device path of
the chemical-similarity demo and BASELINE's fifth config. Fingerprints
are ``int32[.., W]`` views of the reference's ``uint32`` words.

- ``tanimoto_search``: one query against every row. K9 ``search_keys``
  (csrc/similarity_scan.cu) scans the matrix once and writes one 64-bit
  key per row; K10 ``select_top`` (same file) picks the k largest keys
  in order, on the route ``select_route`` picks from (n, k): one block
  over at most 4,096 keys, else a radix select, then one block's sort
  or a radix sort of the k it gathered. The key is ``(float bits of the score) << 32 | (2^32 - 1 -
  row)``: scores are non-negative f32, so their bits order like their
  values, and among equal scores the lower row has the larger key. The
  k largest of these distinct keys are exactly ``jax.lax.top_k``'s
  answer, ties to the lower index, the zero-score tail in index order.
- ``pairwise_intersections``, ``tanimoto_matrix``, ``cosine_matrix``:
  all pairs. K11 ``pairwise`` (csrc/pairwise.cu) counts each pair with
  the tensor cores' binary MMA (AND, then popcount, of the packed words)
  and applies the mode's epilogue in the same launch.

- ``mesh_sim_keys``, ``mesh_pairwise_finish``: K12 (csrc/mesh_finish.cu),
  the elementwise finish of the mesh engine's programs
  (parallel/mesh.py) on counts reduced over the mesh: the search's K10
  keys, and the all-pairs scores from summed intersection counts.
- ``select_sim``: the mesh search's whole finish, its scores and their
  top-k. Up to 4,096 rows K10's one-launch ``small sim`` route reads the
  reduced counts and scores them into their keys itself (no
  ``mesh_sim_keys``); past that, K12's keys and K10's select.
- ``select_counts`` (K10's one-launch ``small int`` route, up to 4,096
  counts), or ``count_keys`` (K12) and ``select_top``'s int mode (K10):
  the top-k of int64 counts (``topn.select_top_counts``), keys ``count ^
  2^63`` (the count alone, ordered as uint64), whose ties K10 takes in
  row order.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for CUDA tensors, or raises. The public entry points take
numpy ``uint32`` arrays or int32 tensors and ``device=`` (default
``"cuda"``); they move the words there first.

The epilogues round as the reference's f32 program: counts are cast to
f32, ``union = (|a| + |b|) - inter``, one IEEE division (and square
root), and the threshold compared in f32. The plain versions take the
division and the square root in f64 and round to f32, which is the
correctly rounded f32 result: torch's own f32 sqrt on the CPU can be one
place off, the reference's and the kernels' are not.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pilosa_tpu_torch.ops import _cuda
from pilosa_tpu_torch.ops.bitwise import matrix_filter_counts_plain, popcount_rows_plain

# K10's radix select: 12-bit digits of the 64-bit key, most significant
# first (the last digit 4 bits); the int mode's ties go on through the
# row order's digits, at most SELECT_ROW_LEVELS more
SELECT_BITS = 12
SELECT_BINS = 1 << SELECT_BITS
SELECT_SHIFTS = (52, 40, 28, 16, 4, 0)
SELECT_ROW_LEVELS = 3
# a count key is the int64 count with its sign bit flipped
_SIGN = -(1 << 63)
# K10 sorts up to this many keys in one block's shared memory
SELECT_TILE = 4096
# K10's routes (csrc/similarity_scan.cu): the C entry's route number by
# the name ``select_route`` gives (the int mode appends " int")
SELECT_ROUTES = {"small": 0, "small counts": 1, "tile": 2, "radix": 3, "small sim": 4}
# the select's zeroed level histograms and state, in int64 words
SELECT_ZEROED_WORDS = (len(SELECT_SHIFTS) - 1 + SELECT_ROW_LEVELS) * SELECT_BINS // 2 + 160
# K10's radix sort: 8-bit digits, RADIX_TILE keys a block
RADIX_BINS = 256
RADIX_TILE = 2048
# K9 counts a row's bits in 32 bits
SEARCH_MAX_WORDS = 1 << 26
_LOW32 = 0xFFFFFFFF
# K11's modes (csrc/pairwise.cu)
PAIRWISE_MODES = {"inter": 0, "tanimoto": 1, "cosine": 2}
# counts stay exact in f32 (below 2^24), as the reference's bf16 product
PAIRWISE_MAX_WORDS = 1 << 19
# K11's rows on either side: any int32 row index
PAIRWISE_MAX_ROWS = (1 << 31) - 1
# plain pairwise: rows of ``a`` unpacked per matmul
_PLAIN_ROWS = 4096


def as_words(x, device: "str | torch.device") -> torch.Tensor:
    """Packed words as a contiguous int32 tensor on ``device``: a numpy
    ``uint32`` (or int32) array is viewed as int32, the same bytes."""
    if isinstance(x, np.ndarray):
        if x.dtype not in (np.uint32, np.int32):
            raise ValueError(f"packed words must be uint32 or int32, got {x.dtype}")
        x = torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise ValueError("packed words must be a uint32 numpy array or an int32 tensor")
    return x.to(device).contiguous()


# --------------------------------------------------------------- search


def _div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32 ``x / y`` correctly rounded: taken in f64 and rounded once more
    to f32, which gives the IEEE f32 quotient (53 >= 2 * 24 + 2 bits)."""
    return (x.to(torch.float64) / y.to(torch.float64)).to(torch.float32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """f32 square root correctly rounded, as ``_div`` (torch's f32 sqrt
    on the CPU can be one place off)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _scores_plain(
    inter: torch.Tensor, row_pop: torch.Tensor, q_pop: torch.Tensor, threshold: float
) -> torch.Tensor:
    """f32 Tanimoto scores with the threshold, as the reference rounds them."""
    inter = inter.to(torch.float32)
    union = (row_pop.to(torch.float32) + q_pop.to(torch.float32)) - inter
    scores = torch.where(union > 0, _div(inter, union), 0.0)
    thr = torch.tensor(threshold, dtype=torch.float32, device=scores.device)
    return torch.where(scores >= thr, scores, 0.0)


def search_keys_plain(
    matrix: torch.Tensor, query: torch.Tensor, threshold: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(int64[R] keys, int32[SELECT_BINS] histogram of the keys' top
    digit): the plain version of K9, 2^20 rows at a time."""
    n_rows = matrix.shape[0]
    q_pop = popcount_rows_plain(query)
    keys = torch.empty(n_rows, dtype=torch.int64, device=matrix.device)
    for lo in range(0, n_rows, 1 << 20):
        part = matrix[lo : lo + (1 << 20)]
        scores = _scores_plain(matrix_filter_counts_plain(part, query), popcount_rows_plain(part), q_pop, threshold)
        ids = torch.arange(lo, lo + part.shape[0], dtype=torch.int64, device=matrix.device)
        keys[lo : lo + part.shape[0]] = (scores.view(torch.int32).to(torch.int64) << 32) | (_LOW32 - ids)
    hist = torch.bincount(keys >> SELECT_SHIFTS[0], minlength=SELECT_BINS).to(torch.int32)
    return keys, hist


def select_top_plain(keys: torch.Tensor, k: int, int_bits: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest keys in descending order, decoded → (f32 scores[k],
    int32 ids[k]), or with ``int_bits`` b > 0 count keys (``count_keys``)
    → (int64 counts[k], int32 ids[k]), ties in row order; the plain
    version of K10."""
    if int_bits:
        counts = keys ^ _SIGN
        order = torch.sort(counts, descending=True, stable=True).indices[:k]
        return counts[order], order.to(torch.int32)
    top = torch.topk(keys, k).values
    scores = (top >> 32).to(torch.int32).view(torch.float32)
    ids = (_LOW32 - (top & _LOW32)).to(torch.int32)
    return scores, ids


def tanimoto_search_plain(
    matrix: torch.Tensor, query: torch.Tensor, k: int = 10, threshold: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k rows of ``int32[R, W]`` by Tanimoto similarity to ``int32[W]``
    → (f32 scores[k], int32 ids[k]), k clamped to R."""
    k = _clamp_k(k, matrix.shape[0])
    return select_top_plain(search_keys_plain(matrix, query, threshold)[0], k)


def _clamp_k(k: int, n_rows: int) -> int:
    if k < 0:
        raise ValueError(f"k must be non-negative, got {k}")
    return min(int(k), n_rows)


def _check_search(matrix: torch.Tensor, query: torch.Tensor) -> None:
    if matrix.dtype != torch.int32 or matrix.dim() != 2 or not matrix.is_contiguous():
        raise ValueError("matrix must be contiguous int32[R, W]")
    if query.dtype != torch.int32 or tuple(query.shape) != (matrix.shape[1],) or not query.is_contiguous():
        raise ValueError(f"query must be contiguous int32[{matrix.shape[1]}]")
    if query.device != matrix.device:
        raise ValueError(f"query on {query.device}, matrix on {matrix.device}")
    if not 1 <= matrix.shape[1] <= SEARCH_MAX_WORDS:
        raise ValueError(f"fingerprints need 1 to {SEARCH_MAX_WORDS} words")


def search_keys(
    matrix: torch.Tensor, query: torch.Tensor, threshold: float = 0.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """One scan of ``int32[R, W]`` against ``int32[W]`` → (int64[R] keys,
    int32[SELECT_BINS] histogram of their top digit) (K9)."""
    _check_search(matrix, query)
    dev = matrix.device
    thr = float(np.float32(threshold))
    if dev.type == "cpu":
        return search_keys_plain(matrix, query, thr)
    n_rows, n_words = matrix.shape
    keys = torch.empty(n_rows, dtype=torch.int64, device=dev)
    hist = torch.zeros(SELECT_BINS, dtype=torch.int32, device=dev)
    if n_rows:
        vec = n_words % 4 == 0 and matrix.data_ptr() % 16 == 0 and query.data_ptr() % 16 == 0
        _cuda.SIM_SCAN.launch(
            dev, matrix.data_ptr(), n_rows, n_words, query.data_ptr(), ctypes.c_float(thr),
            int(vec), keys.data_ptr(), hist.data_ptr(),
            mode="vec4" if vec else "words",
        )
    return keys, hist


def select_route(n: int, k: int, int_bits: int = 0) -> str:
    """K10's route for the k largest of n keys: ``none`` for k = 0;
    ``small`` for n <= SELECT_TILE (one block sorts every key, one
    launch); else the radix select and a compaction of the k largest,
    then ``tile`` (k <= SELECT_TILE, sorted in one block) or ``radix``
    (a radix sort). The int mode (``int_bits`` > 0) appends " int"."""
    if k == 0:
        return "none"
    route = "small" if n <= SELECT_TILE else "tile" if k <= SELECT_TILE else "radix"
    return route + (" int" if int_bits else "")


def select_work_bytes(k: int, int_bits: int, route: str) -> int:
    """Bytes of K10's uninitialised work buffer on the ``tile`` or
    ``radix`` route: the k gathered keys (int64) and, in the int mode,
    their rows (int32); the radix sort keeps two of each and its
    [RADIX_BINS, blocks] table of int32 offsets."""
    rows = 4 * k if int_bits else 0
    if route.startswith("tile"):
        return 8 * k + rows
    blocks = -(-k // RADIX_TILE)
    return 2 * (8 * k + rows) + 4 * RADIX_BINS * blocks


def _launch_select(src: torch.Tensor, hist, k: int, int_bits: int, route: str, counts: bool = False):
    """One K10 call on ``route`` (``select_route``'s name) → (values[k],
    int32 ids[k]); ``counts``: ``src`` holds int64 counts (the small int
    route builds their keys itself). Its launches count under the route's
    name, but ``count_keys``' keys on the small int route count as
    ``small int keys``, apart from the counts route that
    ``select_top_counts`` takes. (``select_sim`` launches the small sim
    route itself.)"""
    dev = src.device
    values = torch.empty(k, dtype=torch.int64 if int_bits else torch.float32, device=dev)
    ids = torch.empty(k, dtype=torch.int32, device=dev)
    base = route.split(" ")[0]
    zeroed = work = None
    if base != "small":
        zeroed = torch.zeros(SELECT_ZEROED_WORDS, dtype=torch.int64, device=dev)
        work = torch.empty(select_work_bytes(k, int_bits, base), dtype=torch.uint8, device=dev)
    _cuda.SIM_SELECT.launch(
        dev, src.data_ptr(), src.shape[0], None if hist is None else hist.data_ptr(),
        None if zeroed is None else zeroed.data_ptr(), None if work is None else work.data_ptr(),
        k, int_bits, SELECT_ROUTES["small counts" if counts else base], None, None, 0,
        values.data_ptr(), ids.data_ptr(),
        mode=route + (" keys" if route == "small int" and not counts else ""),
    )
    return values, ids


def select_top(
    keys: torch.Tensor, hist: torch.Tensor, k: int, int_bits: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of ``int64[R]`` distinct keys in descending order →
    (f32 scores[k], int32 ids[k]) (K10, on ``select_route``'s route).
    ``hist`` is K9's histogram of the keys' top digit. With ``int_bits``
    b > 0 (R <= 2^b) the keys are ``count_keys``' and decode to (int64
    counts[k], int32 ids[k]), equal counts in row order: K10's int mode."""
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be contiguous int64[R]")
    if hist.dtype != torch.int32 or tuple(hist.shape) != (SELECT_BINS,) or hist.device != keys.device:
        raise ValueError(f"hist must be int32[{SELECT_BINS}] on the keys' device")
    if not 0 <= k <= keys.shape[0]:
        raise ValueError(f"k = {k} is not in [0, {keys.shape[0]}]")
    if not 0 <= int_bits <= 31 or (int_bits and keys.shape[0] > 1 << int_bits):
        raise ValueError(f"int_bits = {int_bits} is not in [0, 31] or below the row bits of {keys.shape[0]} keys")
    dev = keys.device
    if dev.type == "cpu":
        return select_top_plain(keys, k, int_bits)
    route = select_route(keys.shape[0], k, int_bits)
    if route == "none":
        return (torch.empty(0, dtype=torch.int64 if int_bits else torch.float32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    return _launch_select(keys, hist, k, int_bits, route)


def select_counts(counts: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of at most SELECT_TILE ``int64[R]`` counts in
    descending order, ties to the lower row → (int64 counts[k], int32
    ids[k]): K10's ``small int`` route, one launch that reads the counts
    and builds their keys itself (no ``count_keys``)."""
    if counts.dtype != torch.int64 or counts.dim() != 1 or not counts.is_contiguous():
        raise ValueError("counts must be contiguous int64[R]")
    n = counts.shape[0]
    if not 0 <= k <= n or n > SELECT_TILE:
        raise ValueError(f"k = {k} of {n} counts: k must be in [0, R] and R at most {SELECT_TILE}")
    bits = count_key_bits(n)
    if counts.device.type == "cpu":  # K10's plain int mode on the keys count ^ 2^63
        return select_top_plain(counts ^ _SIGN, k, bits)
    route = select_route(n, k, bits)
    if route == "none":
        return counts[:0].clone(), torch.empty(0, dtype=torch.int32, device=counts.device)
    return _launch_select(counts, None, k, bits, route, counts=True)


def tanimoto_search(
    matrix, query, k: int = 10, threshold: float = 0.0, device: "str | torch.device" = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k rows of ``matrix`` (uint32[R, W]) by Tanimoto similarity to
    ``query`` (uint32[W]) → (f32 scores[k], int32 ids[k]) on ``device``,
    k clamped to R; a score below ``threshold`` (compared in f32) counts
    as 0.0.

    tanimoto(a, b) = |a∩b| / (|a| + |b| - |a∩b|)
    """
    dev = _cuda.resolve_device(device)
    m, q = as_words(matrix, dev), as_words(query, dev)
    _check_search(m, q)
    k = _clamp_k(k, m.shape[0])
    if k == 0:
        return torch.empty(0, dtype=torch.float32, device=dev), torch.empty(0, dtype=torch.int32, device=dev)
    keys, hist = search_keys(m, q, threshold)
    return select_top(keys, hist, k)


# ------------------------------------------------------------ all pairs


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """int32[..., W] → f32[..., W * 32] of {0, 1}, LSB first in a word."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1  # masked: the int32 shift is arithmetic
    return bits.reshape(*packed.shape[:-1], -1).to(torch.float32)


def pairwise_intersections_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32[N, M] = |a_i ∩ b_j| as a product of the unpacked bits, a few
    thousand rows of ``a`` at a time. Exact: the operands are 0 and 1 and
    every partial sum is an integer below 2^24."""
    b_bits = unpack_bits(b).T
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device)
    for lo in range(0, a.shape[0], _PLAIN_ROWS):
        torch.matmul(unpack_bits(a[lo : lo + _PLAIN_ROWS]), b_bits, out=out[lo : lo + _PLAIN_ROWS])
    return out


def tanimoto_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    inter = pairwise_intersections_plain(a, b)
    a_pop = popcount_rows_plain(a).to(torch.float32)
    b_pop = popcount_rows_plain(b).to(torch.float32)
    union = (a_pop[:, None] + b_pop[None, :]) - inter
    return torch.where(union > 0, _div(inter, union), 0.0)


def cosine_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    inter = pairwise_intersections_plain(a, b)
    a_pop = popcount_rows_plain(a).to(torch.float32)
    b_pop = popcount_rows_plain(b).to(torch.float32)
    denom = _sqrt(a_pop[:, None] * b_pop[None, :])
    return torch.where(denom > 0, _div(inter, denom), 0.0)


_PLAIN = {
    "inter": pairwise_intersections_plain,
    "tanimoto": tanimoto_matrix_plain,
    "cosine": cosine_matrix_plain,
}


def pairwise_plain(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    return _PLAIN[mode](a, b)


def pairwise(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """All pairs of ``int32[N, W]`` × ``int32[M, W]`` → f32[N, M]:
    intersection counts, Tanimoto or cosine (``mode``) (K11)."""
    if mode not in PAIRWISE_MODES:
        raise ValueError(f"mode must be one of {sorted(PAIRWISE_MODES)}, got {mode!r}")
    for t, what in ((a, "a"), (b, "b")):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous int32[N, W]")
    if a.shape[1] != b.shape[1] or not 1 <= a.shape[1] <= PAIRWISE_MAX_WORDS:
        raise ValueError(
            f"a {tuple(a.shape)} and b {tuple(b.shape)} need the same W in [1, {PAIRWISE_MAX_WORDS}]"
        )
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    dev = a.device
    if dev.type == "cpu":
        return pairwise_plain(a, b, mode)
    n, m = a.shape[0], b.shape[0]
    if n > PAIRWISE_MAX_ROWS or m > PAIRWISE_MAX_ROWS:
        raise ValueError(f"N = {n} and M = {m} must each fit an int32 row index")
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    if n and m:
        # 16 B copies where every row starts on a 16 B boundary
        vec = a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
        _cuda.PAIRWISE.launch(
            dev, a.data_ptr(), n, b.data_ptr(), m, a.shape[1], PAIRWISE_MODES[mode], int(vec), out.data_ptr(),
            mode=mode,
        )
    return out


def pairwise_intersections(a, b, device: "str | torch.device" = "cuda") -> torch.Tensor:
    """All-pairs intersection counts: uint32[N, W], uint32[M, W] →
    f32[N, M] = |a_i ∩ b_j|."""
    dev = _cuda.resolve_device(device)
    return pairwise(as_words(a, dev), as_words(b, dev), "inter")


def tanimoto_matrix(a, b, device: "str | torch.device" = "cuda") -> torch.Tensor:
    """All-pairs Tanimoto: f32[N, M]."""
    dev = _cuda.resolve_device(device)
    return pairwise(as_words(a, dev), as_words(b, dev), "tanimoto")


def cosine_matrix(a, b, device: "str | torch.device" = "cuda") -> torch.Tensor:
    """All-pairs cosine similarity of bit vectors: f32[N, M] =
    |a∩b| / sqrt(|a|·|b|)."""
    dev = _cuda.resolve_device(device)
    return pairwise(as_words(a, dev), as_words(b, dev), "cosine")


# ------------------------------------------------------- the mesh finish
# K12 (csrc/mesh_finish.cu): the elementwise passes of the mesh engine's
# similarity programs (parallel/mesh.py), run on counts its reduction
# tree summed over the mesh.

MESH_METRICS = {"tanimoto": 0, "cosine": 1}


def _score_plain(inter: torch.Tensor, a_pop: torch.Tensor, b_pop: torch.Tensor, metric: str) -> torch.Tensor:
    """f32 Tanimoto or cosine of f32 counts, rounded as the reference:
    ``(a + b) - inter`` or ``sqrt(f32(a * b))``, then one division."""
    if metric == "tanimoto":
        union = (a_pop + b_pop) - inter
        return torch.where(union > 0, _div(inter, union), 0.0)
    denom = _sqrt(a_pop * b_pop)
    return torch.where(denom > 0, _div(inter, denom), 0.0)


def mesh_sim_keys_plain(
    inter: torch.Tensor, row_pop: torch.Tensor, q_pop: torch.Tensor, metric: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """K12's search entry, plain: int64 counts → (int64[R] K10 keys,
    int32[SELECT_BINS] histogram of their top digit)."""
    f32 = torch.float32
    scores = _score_plain(inter.to(f32), row_pop.to(f32), q_pop.reshape(()).to(f32), metric)
    ids = torch.arange(inter.shape[0], dtype=torch.int64, device=inter.device)
    keys = (scores.view(torch.int32).to(torch.int64) << 32) | (_LOW32 - ids)
    hist = torch.bincount(keys >> SELECT_SHIFTS[0], minlength=SELECT_BINS).to(torch.int32)
    return keys, hist


def _check_sim(inter: torch.Tensor, row_pop: torch.Tensor, q_pop: torch.Tensor, metric: str) -> None:
    if metric not in MESH_METRICS:
        raise ValueError(f"metric must be one of {sorted(MESH_METRICS)}, got {metric!r}")
    dev = inter.device
    for t, what in ((inter, "inter"), (row_pop, "row_pop"), (q_pop, "q_pop")):
        if t.dtype != torch.int64 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous int64 on {dev}")
    if inter.dim() != 1 or row_pop.shape != inter.shape or q_pop.numel() != 1:
        raise ValueError(f"inter {tuple(inter.shape)}, row_pop {tuple(row_pop.shape)} and q_pop must be [R], [R], [1]")


def mesh_sim_keys(
    inter: torch.Tensor, row_pop: torch.Tensor, q_pop: torch.Tensor, metric: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scores of a one-vs-all search from its reduced counts (K12):
    ``inter`` = |a ∩ q| and ``row_pop`` = |a| (int64[R]), ``q_pop`` = |q|
    (an int64 of one element) → (int64[R] keys, int32[SELECT_BINS]
    histogram) for ``select_top`` (K10)."""
    _check_sim(inter, row_pop, q_pop, metric)
    dev = inter.device
    if dev.type == "cpu":
        return mesh_sim_keys_plain(inter, row_pop, q_pop, metric)
    n = inter.shape[0]
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    hist = torch.zeros(SELECT_BINS, dtype=torch.int32, device=dev)
    if n:
        _cuda.MESH_SIM_KEYS.launch(
            dev, inter.data_ptr(), row_pop.data_ptr(), q_pop.data_ptr(), n, MESH_METRICS[metric],
            keys.data_ptr(), hist.data_ptr(), mode=metric,
        )
    return keys, hist


def select_sim_plain(
    inter: torch.Tensor, row_pop: torch.Tensor, q_pop: torch.Tensor, metric: str, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``select_sim``, plain: K12's plain keys and K10's plain select."""
    return select_top_plain(mesh_sim_keys_plain(inter, row_pop, q_pop, metric)[0], k)


def select_sim(
    inter: torch.Tensor, row_pop: torch.Tensor, q_pop: torch.Tensor, metric: str, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best rows of a one-vs-all search from its reduced counts
    (``mesh_sim_keys``' arguments) → (f32 scores[k], int32 ids[k]),
    equal bit for bit to ``select_top(*mesh_sim_keys(...), k)``. Up to
    SELECT_TILE rows it is one K10 launch on the ``small sim`` route,
    which scores the rows into their keys in shared memory; past that,
    K12's keys and K10's ``tile`` or ``radix`` route."""
    _check_sim(inter, row_pop, q_pop, metric)
    n = inter.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"k = {k} is not in [0, {n}]")
    dev = inter.device
    if dev.type == "cpu":
        return select_sim_plain(inter, row_pop, q_pop, metric, k)
    route = select_route(n, k)
    if route == "none":
        return torch.empty(0, dtype=torch.float32, device=dev), torch.empty(0, dtype=torch.int32, device=dev)
    if route != "small":
        return select_top(*mesh_sim_keys(inter, row_pop, q_pop, metric), k)
    scores = torch.empty(k, dtype=torch.float32, device=dev)
    ids = torch.empty(k, dtype=torch.int32, device=dev)
    _cuda.SIM_SELECT.launch(
        dev, inter.data_ptr(), n, None, None, None, k, 0, SELECT_ROUTES["small sim"],
        row_pop.data_ptr(), q_pop.data_ptr(), MESH_METRICS[metric], scores.data_ptr(), ids.data_ptr(),
        mode="small sim",
    )
    return scores, ids


def mesh_pairwise_finish_plain(
    inter: torch.Tensor, a_pop: torch.Tensor, b_pop: torch.Tensor, metric: str
) -> torch.Tensor:
    """K12's all-pairs entry, plain: f32[N, M] scores."""
    return _score_plain(inter, a_pop[:, None], b_pop[None, :], metric)


def mesh_pairwise_finish(
    inter: torch.Tensor, a_pop: torch.Tensor, b_pop: torch.Tensor, metric: str
) -> torch.Tensor:
    """All-pairs Tanimoto or cosine from intersection counts summed over
    the mesh's words axis, ``inter`` f32[N, M], and the row counts
    ``a_pop`` f32[N], ``b_pop`` f32[M] → f32[N, M] (K12), rounded as
    K11's fused modes."""
    if metric not in MESH_METRICS:
        raise ValueError(f"metric must be one of {sorted(MESH_METRICS)}, got {metric!r}")
    dev = inter.device
    for t, what in ((inter, "inter"), (a_pop, "a_pop"), (b_pop, "b_pop")):
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous f32 on {dev}")
    if inter.dim() != 2 or tuple(a_pop.shape) != (inter.shape[0],) or tuple(b_pop.shape) != (inter.shape[1],):
        raise ValueError(f"inter {tuple(inter.shape)}, a_pop {tuple(a_pop.shape)}, b_pop {tuple(b_pop.shape)} do not match")
    if dev.type == "cpu":
        return mesh_pairwise_finish_plain(inter, a_pop, b_pop, metric)
    n, m = inter.shape
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    if n and m:
        _cuda.MESH_PAIRWISE_FINISH.launch(
            dev, inter.data_ptr(), a_pop.data_ptr(), b_pop.data_ptr(), n, m, MESH_METRICS[metric],
            out.data_ptr(), mode=metric,
        )
    return out


# ------------------------------------------------------ integer top-k keys
# K12's count_keys entry: the keys of a top-k of int64 counts for K10's
# int mode. ``key = count ^ 2^63``: the count alone, whose uint64 order is
# the int64 order of the counts over their whole range. Equal counts give
# equal keys; K10's int mode takes their ties in row order (the row is
# the key's index), so its k largest are ``lax.top_k``'s answer.


def count_key_bits(n: int) -> int:
    """The row bits b of ``n`` count keys, K10's int mode's tie levels:
    max(1, bit length of n - 1)."""
    return max(1, (n - 1).bit_length())


def _first_digits(keys: torch.Tensor) -> torch.Tensor:
    """The histogram of the keys' top digit as uint64 (a logical shift of
    int64 keys)."""
    digits = (keys >> SELECT_SHIFTS[0]) & (SELECT_BINS - 1)
    return torch.bincount(digits, minlength=SELECT_BINS).to(torch.int32)


def count_keys_plain(counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K12's count_keys, plain: int64[R] counts → (int64[R] keys,
    int32[SELECT_BINS] histogram of their top digit)."""
    keys = counts ^ _SIGN
    return keys, _first_digits(keys)


def count_keys(counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys of an integer top-k of ``int64[R]`` counts (K12) → (int64[R]
    keys, int32[SELECT_BINS] histogram) for ``select_top`` with
    ``int_bits=count_key_bits(R)``."""
    if counts.dtype != torch.int64 or counts.dim() != 1 or not counts.is_contiguous():
        raise ValueError("counts must be contiguous int64[R]")
    n = counts.shape[0]
    if n > 1 << 31:
        raise ValueError(f"{n} counts are more than 2^31 rows")
    dev = counts.device
    if dev.type == "cpu":
        return count_keys_plain(counts)
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    hist = torch.zeros(SELECT_BINS, dtype=torch.int32, device=dev)
    if n:
        _cuda.COUNT_KEYS.launch(dev, counts.data_ptr(), n, keys.data_ptr(), hist.data_ptr())
    return keys, hist
