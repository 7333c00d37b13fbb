"""Row query result — a bitmap spanning shards.

Reference: row.go (Row with per-shard segments; cross-shard "union" of
results is concatenation because shards cover disjoint column ranges).
Segments here are packed uint32 words (device or host); materializing
column IDs happens once at the API boundary.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.roaring import unpack_words, words_count
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH


class RowResult:
    """Per-shard packed segments of one logical row / bitmap expression."""

    def __init__(self, segments: dict[int, np.ndarray] | None = None):
        # shard -> uint32[WORDS_PER_SHARD] (numpy array)
        self.segments = segments or {}
        self.attrs: dict = {}
        self.keys: list[str] | None = None
        # Options() wrapper flags (reference: QueryRequest ExcludeColumns/
        # ExcludeRowAttrs; ColumnAttrSets when columnAttrs=true)
        self.exclude_columns = False
        self.exclude_row_attrs = False
        self.column_attr_sets: list[dict] | None = None

    def count(self) -> int:
        return sum(words_count(np.asarray(w)) for w in self.segments.values())

    def columns(self) -> np.ndarray:
        """Absolute column IDs, ascending, uint64."""
        parts = []
        for shard in sorted(self.segments):
            pos = unpack_words(np.asarray(self.segments[shard]))
            if pos.size:
                parts.append(pos.astype(np.uint64) + np.uint64(shard * SHARD_WIDTH))
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(parts)

    def to_json(self) -> dict:
        out: dict = {"columns": self.columns().tolist()}
        if self.keys is not None:
            out = {"keys": self.keys}
        if self.exclude_columns:
            out.pop("columns", None)
            out.pop("keys", None)
        if self.attrs and not self.exclude_row_attrs:
            out["attrs"] = self.attrs
        return out
