"""Holder — the node-local root of all data.

Reference: holder.go (Holder, Open — walks the data dir loading every
index/field/view/fragment). Directory layout:

    <data-dir>/<index>/.meta.json
    <data-dir>/<index>/<field>/.meta.json
    <data-dir>/<index>/<field>/views/<view>/fragments/<shard>

Durability (docs/durability.md): the holder owns the node's ONE
background compaction queue (core/compact.py) — every fragment created
under it inherits the compactor, so an over-threshold ops log folds off
the write path. ``open()`` loads fragments through a bounded thread
pool: cold start is dominated by snapshot deserialize + ops-log replay,
which parallelize cleanly (per-fragment state, no shared mutation), and
the device upload stays lazy (first query per stack), so
restart-to-serving is bounded by the slowest fragment, not the sum.
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

from pilosa_tpu_torch.core.compact import Compactor
from pilosa_tpu_torch.core.index import Index, IndexOptions
from pilosa_tpu_torch.utils import sanitize, saturation


class _LoadPool(ThreadPoolExecutor):
    """ThreadPoolExecutor plus a futures list the field loaders append
    to, so Holder.open can join (and surface the first error from)
    every concurrent fragment open."""

    def __init__(self, workers: int):
        super().__init__(max_workers=workers, thread_name_prefix="holder-load")
        self.futures: list = []


class Holder:
    def __init__(
        self,
        path: str | None = None,
        compaction_workers: int = 1,
        load_workers: int = 8,
        load_min_fragments: int = 32,
        stats=None,
    ):
        self.path = path
        self.indexes: dict[str, Index] = {}
        # contention-counted (docs/profiling.md): /debug/saturation's
        # "holder" lock family
        self._create_lock = sanitize.make_lock(
            "Holder._create_lock", inner=saturation.ContendedLock("holder")
        )
        # parallel cold-start fragment loading; <=1 loads serially
        self.load_workers = load_workers
        # fragment-count floor below which open() loads serially even
        # with workers configured: at small counts the pool's thread
        # spin-up + future machinery COSTS more than it overlaps
        # (BENCH_INGEST_r08 measured parallel 0.159s vs serial 0.066s
        # over 12 fragments)
        self.load_min_fragments = load_min_fragments
        self.compactor = Compactor(workers=compaction_workers, stats=stats)

    def _count_fragment_files(self) -> int:
        """Cheap pre-scan of on-disk fragment files (one listdir pass
        per directory — no file opens) sizing the parallel-load
        decision; tmp/quarantine leftovers (dotted suffixes) excluded."""
        count = 0
        for root, dirs, files in os.walk(self.path):
            if os.path.basename(root) == "fragments":
                count += sum(1 for fn in files if "." not in fn)
                dirs.clear()  # fragment dirs hold no nested data dirs
        return count

    def open(self) -> None:
        if self.path is None:
            return
        os.makedirs(self.path, exist_ok=True)
        use_pool = (
            self.load_workers > 1
            and self._count_fragment_files() >= self.load_min_fragments
        )
        pool = _LoadPool(self.load_workers) if use_pool else None
        try:
            for entry in sorted(os.listdir(self.path)):
                index_path = os.path.join(self.path, entry)
                if os.path.isdir(index_path) and os.path.exists(
                    os.path.join(index_path, ".meta.json")
                ):
                    self.indexes[entry] = Index.load(
                        entry, index_path, compactor=self.compactor, pool=pool
                    )
            if pool is not None:
                # join every concurrent fragment open; re-raise the first
                # failure (a quarantined snapshot logs and recovers, so
                # what reaches here is a real I/O error worth dying on)
                for fut in pool.futures:
                    fut.result()
        finally:
            if pool is not None:
                pool.shutdown(wait=True)

    def close(self) -> None:
        # drain queued compactions first: shutdown must not abandon an
        # over-threshold ops log a queued fold was about to shrink
        self.compactor.close(drain=True)
        for idx in self.indexes.values():
            idx.close()

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

    def create_index(self, name: str, options: IndexOptions | None = None) -> Index:
        if name in self.indexes:
            raise ValueError(f"index {name!r} already exists")
        return self.create_index_if_not_exists(name, options)

    def create_index_if_not_exists(
        self, name: str, options: IndexOptions | None = None
    ) -> Index:
        existing = self.indexes.get(name)
        if existing is not None:
            return existing
        with self._create_lock:
            return self._create_index_locked(name, options)

    def _create_index_locked(
        self, name: str, options: IndexOptions | None = None
    ) -> Index:
        existing = self.indexes.get(name)
        if existing is not None:
            return existing
        index_path = os.path.join(self.path, name) if self.path else None
        idx = Index(name, index_path, options)
        idx.compactor = self.compactor
        idx.save_meta()
        self.indexes[name] = idx
        return idx

    def delete_index(self, name: str) -> None:
        idx = self.indexes.pop(name, None)
        if idx is None:
            raise KeyError(f"index {name!r} not found")
        idx.close()
        if idx.path and os.path.isdir(idx.path):
            shutil.rmtree(idx.path)

    def wal_ledger(self) -> dict:
        """Aggregate ops-log (WAL) debt across every open fragment — the
        byte half of the /debug/resources durability row.  ``opsLogBytes``
        is what a crash would replay; ``maxOpLogFill`` is the fullest
        fragment's op_n/max_op_n fraction (1.0 = a fold is due)."""
        ops_bytes = 0
        pending_ops = 0
        fragments = 0
        worst_fill = 0.0
        for idx in list(self.indexes.values()):
            for field in list(idx.fields.values()):
                for view in list(field.views.values()):
                    for frag in list(view.fragments.values()):
                        fragments += 1
                        ops_bytes += frag.ops_bytes
                        pending_ops += frag.op_n
                        worst_fill = max(
                            worst_fill, frag.op_n / max(1, frag.max_op_n)
                        )
        return {
            "fragments": fragments,
            "opsLogBytes": ops_bytes,
            "pendingOps": pending_ops,
            "maxOpLogFill": round(worst_fill, 4),
        }

    def schema(self) -> list[dict]:
        """Schema description (reference: api.Schema)."""
        out = []
        for iname in sorted(self.indexes):
            idx = self.indexes[iname]
            fields = []
            for fname in sorted(idx.fields):
                f = idx.fields[fname]
                if fname.startswith("_"):
                    continue
                fields.append(
                    {
                        "name": fname,
                        "options": {
                            "type": f.options.field_type,
                            "cacheType": f.options.cache_type,
                            "cacheSize": f.options.cache_size,
                            "timeQuantum": f.options.time_quantum,
                            "keys": f.options.keys,
                            "min": f.options.min,
                            "max": f.options.max,
                            "hasRange": f.options.has_range,
                        },
                        "shards": sorted(f.available_shards()),
                    }
                )
            out.append(
                {
                    "name": iname,
                    "options": {
                        "keys": idx.options.keys,
                        "trackExistence": idx.options.track_existence,
                    },
                    "fields": fields,
                    "shards": sorted(idx.available_shards()),
                }
            )
        return out
