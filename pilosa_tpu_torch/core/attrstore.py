"""Row/column attribute store.

Reference: attrstore.go + boltdb/attrstore.go (AttrStore; attrs synced via
100-ID block checksums). BoltDB is replaced by a JSON file persisted on
mutation; the block-checksum diff surface is kept for anti-entropy.

Divergence from the reference, deliberate: every attribute key carries a
last-writer-wins timestamp, and deletions are kept as tombstones. The
reference's block merge is a plain union, which silently resurrects
deleted attrs when a node that missed the delete broadcast rejoins; with
LWW metadata the anti-entropy merge converges on the newest write
(including deletes) instead.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

from pilosa_tpu_torch.utils import durable

ATTR_BLOCK_SIZE = 100

# journal entries that trigger a compaction (snapshot rewrite + truncate)
MAX_JOURNAL_OPS = 1024

# tombstones older than this are pruned; must exceed the longest node
# outage you expect anti-entropy to repair, or a delete can resurrect
TOMBSTONE_TTL_SECONDS = 7 * 24 * 3600.0

# value sentinel for a deleted key inside the versioned cell
_TOMBSTONE = None


class AttrStore:
    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.RLock()
        # id → key → [value-or-None(tombstone), lww-timestamp]
        self._cells: dict[int, dict[str, list]] = {}
        self._journal_ops = 0

    def open(self) -> None:
        with self._lock:
            if self.path and os.path.exists(self.path):
                with open(self.path) as f:
                    raw = json.load(f)
                if raw.get("_v") == 2:
                    self._cells = {
                        int(k): {a: list(cell) for a, cell in v.items()}
                        for k, v in raw["cells"].items()
                    }
                else:  # v1 format: plain id → attrs dict, no versions.
                    # Stamp ts=0 so any real (timestamped) write or delete
                    # elsewhere in the cluster wins over migrated data.
                    self._cells = {
                        int(k): {a: [val, 0.0] for a, val in v.items()}
                        for k, v in raw.items()
                        if not k.startswith("_")
                    }
            jp = self._journal_path()
            if jp and os.path.exists(jp):
                with open(jp, "rb") as f:
                    data = f.read()
                good = 0  # bytes of fully replayed records
                for raw in data.splitlines(keepends=True):
                    if not raw.endswith(b"\n"):
                        break  # torn tail from a crash mid-append
                    line = raw.strip()
                    if line:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            break
                        self._apply_cells(rec)
                        self._journal_ops += 1
                    good += len(raw)
                if good < len(data):
                    # truncate the torn tail NOW — appending after it
                    # would weld the next record onto the partial line,
                    # silently discarding everything from the tear on at
                    # the following open
                    durable.truncate_file(jp, good)

    def close(self) -> None:
        pass

    def _journal_path(self) -> str | None:
        return self.path + ".log" if self.path else None

    def _apply_cells(self, rec: dict) -> None:
        """LWW-apply a {id: {key: [value, ts]}} delta (journal replay —
        idempotent, so a crash between compaction's snapshot replace and
        journal truncate just re-applies over the new snapshot)."""
        for id_s, cells in rec.items():
            mine = self._cells.setdefault(int(id_s), {})
            for k, cell in cells.items():
                if k not in mine or mine[k][1] <= cell[1]:
                    mine[k] = [cell[0], cell[1]]

    def _journal(self, delta: dict) -> None:
        """Append one applied delta; O(delta) bytes per write instead of
        an O(store) full-file rewrite (the
        fragment snapshot + ops-log discipline, reused). Compaction folds
        the journal into the snapshot every MAX_JOURNAL_OPS appends."""
        jp = self._journal_path()
        if jp is None or not delta:
            return
        self._journal_ops += 1
        if self._journal_ops > MAX_JOURNAL_OPS:
            self._compact()
            return
        os.makedirs(os.path.dirname(jp), exist_ok=True)
        # WAL-mode append (docs/durability.md): fsynced inline in
        # `always`, group-fsynced at the API's ack barrier in `batch`
        durable.append_wal(jp, (json.dumps(delta) + "\n").encode())

    def _compact(self) -> None:
        self._prune_tombstones()
        self._persist()
        jp = self._journal_path()
        if jp and os.path.exists(jp):
            # reset AFTER the snapshot replace is durable: a crash
            # between the two just replays the journal over the new
            # snapshot (idempotent LWW apply)
            durable.truncate_file(jp, 0)
        self._journal_ops = 0

    def _persist(self) -> None:
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        durable.atomic_write_file(
            self.path,
            json.dumps(
                {
                    "_v": 2,
                    "cells": {str(k): v for k, v in self._cells.items()},
                }
            ),
        )

    def set_attrs(self, id_: int, attrs: dict, ts: float | None = None) -> None:
        """Merge attrs for an ID; null values delete keys — kept as
        tombstones so the delete wins anti-entropy merges (reference:
        AttrStore.SetAttrs). ``ts`` lets a cluster coordinator stamp one
        timestamp on every replica of a broadcast write so LWW never
        compares unsynchronized node clocks."""
        with self._lock:
            now = time.time() if ts is None else ts
            cells = self._cells.setdefault(id_, {})
            applied: dict[str, list] = {}
            for k, v in attrs.items():
                # same newer-ts-wins rule as merge_block: a delayed
                # out-of-order broadcast must not regress a newer write
                if k in cells and cells[k][1] > now:
                    continue
                cell = [_TOMBSTONE if v is None else v, now]
                cells[k] = cell
                applied[k] = cell
            if applied:
                self._journal({str(id_): applied})

    def _prune_tombstones(self) -> None:
        """Drop tombstones past TTL (and then-empty IDs) so churny
        delete workloads don't grow the store without bound."""
        # wall clock on purpose: tombstone timestamps are persisted and
        # replicated — node-local monotonic time means nothing to peers
        horizon = time.time() - TOMBSTONE_TTL_SECONDS  # pilosa: allow(wall-clock)
        for id_ in list(self._cells):
            cells = self._cells[id_]
            for k in [
                k
                for k, c in cells.items()
                if c[0] is _TOMBSTONE and c[1] < horizon
            ]:
                del cells[k]
            if not cells:
                del self._cells[id_]

    def attrs(self, id_: int) -> dict:
        with self._lock:
            return {
                k: cell[0]
                for k, cell in self._cells.get(id_, {}).items()
                if cell[0] is not _TOMBSTONE
            }

    def block_checksums(self) -> list[tuple[int, bytes]]:
        """Checksums cover the versioned cells (tombstones included) so
        two stores agree exactly when their merge states agree."""
        with self._lock:
            blocks: dict[int, list[int]] = {}
            for id_ in self._cells:
                blocks.setdefault(id_ // ATTR_BLOCK_SIZE, []).append(id_)
            out = []
            for block_id in sorted(blocks):
                h = hashlib.blake2b(digest_size=16)
                for id_ in sorted(blocks[block_id]):
                    h.update(
                        json.dumps([id_, self._cells[id_]], sort_keys=True).encode()
                    )
                out.append((block_id, h.digest()))
            return out

    def block_data(self, block_id: int) -> dict[int, dict]:
        """id → {key: [value, ts]} for one block, tombstones included."""
        with self._lock:
            lo = block_id * ATTR_BLOCK_SIZE
            hi = lo + ATTR_BLOCK_SIZE
            return {
                i: {k: list(c) for k, c in cells.items()}
                for i, cells in self._cells.items()
                if lo <= i < hi
            }

    def merge_block(self, data: dict[int, dict]) -> None:
        """Key-wise LWW merge of a peer's block (anti-entropy repair):
        the newer timestamp wins, so missed deletes propagate instead of
        being resurrected."""
        with self._lock:
            applied: dict[str, dict[str, list]] = {}
            for id_, cells in data.items():
                mine = self._cells.setdefault(int(id_), {})
                for k, cell in cells.items():
                    value, ts = cell[0], cell[1]
                    if k not in mine:
                        mine[k] = [value, ts]
                        applied.setdefault(str(id_), {})[k] = mine[k]
                        continue
                    # newer ts wins; equal ts (e.g. two divergent
                    # v1-migrated files, both stamped 0.0) tie-breaks on
                    # the serialized value so every replica converges to
                    # the same winner regardless of merge order
                    my_val, my_ts = mine[k][0], mine[k][1]
                    if my_ts < ts or (
                        my_ts == ts
                        and json.dumps(value, sort_keys=True)
                        > json.dumps(my_val, sort_keys=True)
                    ):
                        mine[k] = [value, ts]
                        applied.setdefault(str(id_), {})[k] = mine[k]
            self._journal(applied)
