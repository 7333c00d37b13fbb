"""ctypes loader for the native host bitmap kernels.

Builds ``native/bitmap_kernels.cpp`` with g++ on first use (cached in
``pilosa_tpu_torch/_build/``), binds it via ctypes, and exposes numpy-signature wrappers.
Every entry point has a numpy fallback so the package works without a
toolchain; ``AVAILABLE`` reports which path is live.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "bitmap_kernels.cpp")
# the port's own build directory (git-ignored), so the two packages never
# race on one shared library next to the source
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_LIB = os.path.join(BUILD_DIR, "libbitmap_kernels.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
AVAILABLE = False


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return True
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        # per-process temp name: test workers may build concurrently
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        subprocess.run(
            [
                "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                "-o", tmp, _SRC,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        from pilosa_tpu_torch.utils import durable

        # the compiler produced the tmp; commit it with the sanctioned
        # rename (durable=False: a lost build artifact just rebuilds)
        durable.replace_durable(tmp, _LIB, durable=False)
        return True
    except (subprocess.SubprocessError, OSError, PermissionError):
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, AVAILABLE
    with _lock:
        if _lib is not None:
            return _lib
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        try:
            return _bind(lib)
        except AttributeError:
            # a stale prebuilt .so (mtime-preserving deploys) missing a
            # newer symbol must degrade to the numpy fallbacks, not crash
            # every native entry point
            return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every symbol's signature; AttributeError (stale .so)
    propagates to _load's fallback."""
    global _lib, AVAILABLE
    if True:  # keep the binding block's indentation stable
        c_u32p = ctypes.POINTER(ctypes.c_uint32)
        c_u64p = ctypes.POINTER(ctypes.c_uint64)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        for name in ("u32_and", "u32_or", "u32_xor", "u32_andnot"):
            fn = getattr(lib, name)
            fn.argtypes = [c_u32p, c_u32p, c_u32p, ctypes.c_int64]
            fn.restype = None
        lib.u32_popcount.argtypes = [c_u32p, ctypes.c_int64]
        lib.u32_popcount.restype = ctypes.c_int64
        lib.u32_and_popcount.argtypes = [c_u32p, c_u32p, ctypes.c_int64]
        lib.u32_and_popcount.restype = ctypes.c_int64
        lib.u32_matrix_filter_counts.argtypes = [
            c_u32p, c_u32p, ctypes.c_int64, ctypes.c_int64, c_i64p,
        ]
        lib.u32_matrix_filter_counts.restype = None
        lib.pack_positions.argtypes = [c_i64p, ctypes.c_int64, c_u32p, ctypes.c_int64]
        lib.pack_positions.restype = None
        lib.unpack_words.argtypes = [c_u32p, ctypes.c_int64, c_i64p]
        lib.unpack_words.restype = ctypes.c_int64
        for name in ("u64_union", "u64_intersect", "u64_difference"):
            fn = getattr(lib, name)
            fn.argtypes = [c_u64p, ctypes.c_int64, c_u64p, ctypes.c_int64, c_u64p]
            fn.restype = ctypes.c_int64
        lib.u64_sort_unique.argtypes = [c_u64p, ctypes.c_int64, c_u64p]
        lib.u64_sort_unique.restype = ctypes.c_int64
        lib.u64_counting_argsort.argtypes = [
            c_u64p, ctypes.c_int64, ctypes.c_int64, c_i64p, c_i64p,
        ]
        lib.u64_counting_argsort.restype = None
        lib.u64_bucket_lows.argtypes = [
            c_u64p, ctypes.c_int64, ctypes.c_int64, c_i64p,
            ctypes.POINTER(ctypes.c_uint16),
        ]
        lib.u64_bucket_lows.restype = None
        lib.u32_stack_fill.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), c_i64p, ctypes.c_int64,
            ctypes.c_int64, c_u32p, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.u32_stack_fill.restype = None
        _lib = lib
        AVAILABLE = True
        return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ------------------------------------------------------------- public API
def words_count(words: np.ndarray) -> int:
    lib = _load()
    w = np.ascontiguousarray(words, dtype=np.uint32)
    if lib is None:
        return int(np.bitwise_count(w).sum())
    return int(lib.u32_popcount(_ptr(w, ctypes.c_uint32), w.size))


def and_count(a: np.ndarray, b: np.ndarray) -> int:
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    if lib is None:
        return int(np.bitwise_count(a & b).sum())
    return int(lib.u32_and_popcount(_ptr(a, ctypes.c_uint32), _ptr(b, ctypes.c_uint32), a.size))


def matrix_filter_counts(matrix: np.ndarray, filt: np.ndarray) -> np.ndarray:
    lib = _load()
    m = np.ascontiguousarray(matrix, dtype=np.uint32)
    f = np.ascontiguousarray(filt, dtype=np.uint32)
    if lib is None:
        return np.bitwise_count(m & f[None, :]).sum(axis=1).astype(np.int64)
    out = np.empty(m.shape[0], dtype=np.int64)
    lib.u32_matrix_filter_counts(
        _ptr(m, ctypes.c_uint32), _ptr(f, ctypes.c_uint32),
        m.shape[0], m.shape[1], _ptr(out, ctypes.c_int64),
    )
    return out


def pack_positions(positions: np.ndarray, width: int) -> np.ndarray:
    lib = _load()
    p = np.ascontiguousarray(positions, dtype=np.int64)
    if p.size and (int(p.min()) < 0 or int(p.max()) >= width):
        # the C path writes unchecked; keep the numpy path's bounds contract
        raise IndexError(
            f"position out of range [0, {width}): min={p.min()}, max={p.max()}"
        )
    n_words = width // 32
    if lib is None:
        words = np.zeros(n_words, dtype=np.uint32)
        if p.size:
            np.bitwise_or.at(words, p >> 5, np.uint32(1) << (p & 31).astype(np.uint32))
        return words
    words = np.empty(n_words, dtype=np.uint32)
    lib.pack_positions(_ptr(p, ctypes.c_int64), p.size, _ptr(words, ctypes.c_uint32), n_words)
    return words


def unpack_words(words: np.ndarray) -> np.ndarray:
    lib = _load()
    w = np.ascontiguousarray(words, dtype=np.uint32)
    if lib is None:
        bits = np.unpackbits(w.view(np.uint8), bitorder="little")
        return np.flatnonzero(bits).astype(np.int64)
    out = np.empty(int(words_count(w)), dtype=np.int64)
    n = lib.unpack_words(_ptr(w, ctypes.c_uint32), w.size, _ptr(out, ctypes.c_int64))
    return out[:n]


def sort_unique_u64(values: np.ndarray, owned: bool = False) -> np.ndarray:
    """Sorted-unique uint64 values (np.unique equivalent): LSD radix in
    C when available — the import path's dominant sort — numpy fallback
    otherwise. The input is not modified unless ``owned=True`` (the
    caller hands over a scratch array, e.g. a fresh concatenate result,
    saving a full copy on the hot path)."""
    lib = _load()
    v = np.ascontiguousarray(values, dtype=np.uint64)
    if lib is None or v.size < 2048:  # call overhead beats tiny inputs
        return np.unique(v)
    data = v if (owned and v is values) else v.copy()
    tmp = np.empty_like(data)
    n = lib.u64_sort_unique(
        _ptr(data, ctypes.c_uint64), data.size, _ptr(tmp, ctypes.c_uint64)
    )
    return data[:n]


def stack_fill(
    mats: list, dst: np.ndarray, threads: int | None = None
) -> bool:
    """Fill the stacked [R, S, W] uint32 matrix from per-shard [R_i, W]
    matrices (None ⇒ stays zero) with row-range-parallel C memcpy. The
    pure-numpy fill is 82k+ tiny strided assignments at pod scale;
    threads write disjoint row planes. Returns False
    when the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return False
    import threading as _threading

    r_total, n_shards, words = dst.shape
    srcs = (ctypes.c_void_p * n_shards)()
    rows = np.zeros(n_shards, dtype=np.int64)
    keepalive = []
    for i, m in enumerate(mats):
        if m is None or m.size == 0:
            srcs[i] = None
            continue
        m = np.ascontiguousarray(m, dtype=np.uint32)
        keepalive.append(m)
        srcs[i] = m.ctypes.data
        rows[i] = m.shape[0]
    n_threads = min(threads or (os.cpu_count() or 1), r_total)
    if n_threads <= 1:
        lib.u32_stack_fill(
            srcs, _ptr(rows, ctypes.c_int64), n_shards, words,
            _ptr(dst, ctypes.c_uint32), 0, r_total,
        )
        return True
    step = (r_total + n_threads - 1) // n_threads
    ts = []
    for t in range(n_threads):
        r0, r1 = t * step, min((t + 1) * step, r_total)
        if r0 >= r1:
            break
        th = _threading.Thread(
            target=lib.u32_stack_fill,
            args=(srcs, _ptr(rows, ctypes.c_int64), n_shards, words,
                  _ptr(dst, ctypes.c_uint32), r0, r1),
            name=f"native-fill-{t}",
        )
        th.start()
        ts.append(th)
    for th in ts:
        th.join()
    return True


def merge_unique_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two SORTED-UNIQUE uint64 arrays via one linear C merge —
    the roaring union hot path, where re-radix-sorting the concatenation
    (sort_unique_u64) costs ~8 passes over data that is already 99%
    ordered. numpy fallback: concatenate + np.unique."""
    lib = _load()
    if lib is None or a.size + b.size < 2048:
        return np.unique(np.concatenate([a, b]))
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    out = np.empty(a.size + b.size, dtype=np.uint64)
    n = lib.u64_union(
        _ptr(a, ctypes.c_uint64), a.size,
        _ptr(b, ctypes.c_uint64), b.size,
        _ptr(out, ctypes.c_uint64),
    )
    return out[:n]


def counting_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of small-integer uint64 keys in O(n + max_key)
    (shard grouping: keys are shard ids). Computes the key maximum
    itself — ONE scan doubles as the bounds guarantee for the unchecked
    C write (same discipline as pack_positions). Falls back to numpy's
    stable argsort when the native library is absent or the key range is
    out of proportion to n (zeroing/scanning the counts buffer would
    dominate)."""
    lib = _load()
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    if lib is None or k.size < 2048:
        return np.argsort(k, kind="stable")
    max_key = int(k.max())
    if max_key > 4 * k.size:
        return np.argsort(k, kind="stable")
    counts = np.zeros(max_key + 1, dtype=np.int64)
    order = np.empty(k.size, dtype=np.int64)
    lib.u64_counting_argsort(
        _ptr(k, ctypes.c_uint64), k.size, max_key,
        _ptr(counts, ctypes.c_int64), _ptr(order, ctypes.c_int64),
    )
    return order


def bucket_lows(
    keys: np.ndarray, max_gk: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Group combined ``(gk << 16 | low)`` keys by gk in ONE native
    counting pass, returning (lows_sorted_by_group uint16, per-group
    histogram int64) — the bulk container builder's grouping step with
    no argsort permutation, no gather, no separate bincount. None when
    the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    counts = np.zeros(max_gk + 1, dtype=np.int64)
    lows = np.empty(k.size, dtype=np.uint16)
    lib.u64_bucket_lows(
        _ptr(k, ctypes.c_uint64), k.size, max_gk,
        _ptr(counts, ctypes.c_int64),
        _ptr(lows, ctypes.c_uint16),
    )
    return lows, np.diff(counts, prepend=0)


def uniq_sorted(arr: np.ndarray):
    """(unique values, start indices) of an ALREADY-SORTED array in O(n)
    — np.unique re-sorts, a full radix pass per call on import paths.
    Shared by the roaring bulk merges and the field shard grouping."""
    if arr.size == 0:
        return arr, np.empty(0, dtype=np.int64)
    mask = np.empty(arr.size, dtype=bool)
    mask[0] = True
    np.not_equal(arr[1:], arr[:-1], out=mask[1:])
    starts = np.flatnonzero(mask)
    return arr[starts], starts


def u64_merge(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-unique uint64 set merge: op ∈ {union, intersect, difference}."""
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    if lib is None:
        if op == "union":
            return np.union1d(a, b)
        if op == "intersect":
            return np.intersect1d(a, b, assume_unique=True)
        return np.setdiff1d(a, b, assume_unique=True)
    out = np.empty(a.size + b.size, dtype=np.uint64)
    fn = getattr(lib, f"u64_{op}" if op != "intersect" else "u64_intersect")
    n = fn(_ptr(a, ctypes.c_uint64), a.size, _ptr(b, ctypes.c_uint64), b.size, _ptr(out, ctypes.c_uint64))
    return out[:n]
