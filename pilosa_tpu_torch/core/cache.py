"""Per-fragment TopN row caches.

Reference: cache.go (cache interface, rankCache, lruCache, nopCache). The
rank cache keeps the top-K (row → count) pairs per fragment so TopN phase 1
reads candidates without scanning; on TPU phase 1 can also run as a full
masked-popcount + top_k over the device matrix, so the cache is a host-side
accelerator for sparse/cold fragments and for src-parity of the cache-backed
PQL semantics (TopN without a filter consults the cache)."""

from __future__ import annotations

from collections import OrderedDict

DEFAULT_CACHE_SIZE = 50_000

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
CACHE_TYPE_NONE = "none"


class RankCache:
    """Top-K rows by count (reference: cache.go rankCache)."""

    def __init__(self, max_size: int = DEFAULT_CACHE_SIZE):
        self.max_size = max_size
        self._counts: dict[int, int] = {}

    def add(self, row: int, count: int) -> None:
        if count <= 0:
            self._counts.pop(row, None)
            return
        self._counts[row] = count
        if len(self._counts) > self.max_size * 2:
            self._prune()

    def _prune(self) -> None:
        top = sorted(self._counts.items(), key=lambda kv: -kv[1])[: self.max_size]
        self._counts = dict(top)

    def get(self, row: int) -> int:
        return self._counts.get(row, 0)

    def top(self, n: int | None = None) -> list[tuple[int, int]]:
        """[(row, count)] sorted by count desc, then row asc."""
        pairs = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return pairs if n is None else pairs[:n]

    def rows(self) -> list[int]:
        return list(self._counts)

    def clear(self) -> None:
        self._counts.clear()


class LRUCache:
    """LRU row cache (reference: cache.go lruCache)."""

    def __init__(self, max_size: int = DEFAULT_CACHE_SIZE):
        self.max_size = max_size
        self._counts: OrderedDict[int, int] = OrderedDict()

    def add(self, row: int, count: int) -> None:
        if count <= 0:
            self._counts.pop(row, None)
            return
        self._counts[row] = count
        self._counts.move_to_end(row)
        while len(self._counts) > self.max_size:
            self._counts.popitem(last=False)

    def get(self, row: int) -> int:
        c = self._counts.get(row, 0)
        if c:
            self._counts.move_to_end(row)
        return c

    def top(self, n: int | None = None) -> list[tuple[int, int]]:
        pairs = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return pairs if n is None else pairs[:n]

    def rows(self) -> list[int]:
        return list(self._counts)

    def clear(self) -> None:
        self._counts.clear()


class NopCache:
    def __init__(self, max_size: int = 0):
        self.max_size = 0

    def add(self, row: int, count: int) -> None:
        pass

    def get(self, row: int) -> int:
        return 0

    def top(self, n: int | None = None) -> list[tuple[int, int]]:
        return []

    def rows(self) -> list[int]:
        return []

    def clear(self) -> None:
        pass


def make_cache(cache_type: str, size: int):
    if cache_type == CACHE_TYPE_RANKED:
        return RankCache(size)
    if cache_type == CACHE_TYPE_LRU:
        return LRUCache(size)
    if cache_type == CACHE_TYPE_NONE:
        return NopCache()
    raise ValueError(f"unknown cache type {cache_type!r}")
