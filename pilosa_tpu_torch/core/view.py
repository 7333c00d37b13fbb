"""View — groups the fragments of one variant of a field.

Reference: view.go (view, viewStandard, time-view naming). A set field has
one "standard" view; a time field adds one view per calendar bucket; an int
(BSI) field keeps its bit-slice rows in a "bsi" view.
"""

from __future__ import annotations

import itertools
import os
import threading

from pilosa_tpu_torch.core.fragment import Fragment

VIEW_STANDARD = "standard"
VIEW_BSI = "bsi"

_VIEW_STAMPS = itertools.count(1)


class View:
    def __init__(
        self,
        name: str,
        index: str,
        field: str,
        path: str | None,
        cache_type: str,
        cache_size: int,
    ):
        self.name = name
        self.index = index
        self.field = field
        self.path = path  # <field-path>/views/<name>
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.fragments: dict[int, Fragment] = {}
        self._create_lock = threading.Lock()
        # per-shard creation locks: fragment OPEN (snapshot deserialize +
        # ops-log replay, the cold-start cost) must run outside any
        # view-wide lock or holder-load-workers degenerates to a serial
        # load; _create_lock only guards this dict and self.fragments
        self._open_locks: dict[int, threading.Lock] = {}
        # background compaction queue (core/compact.py) injected by the
        # holder chain; every fragment created here inherits it so an
        # over-threshold ops log folds off the write path
        self.compactor = None
        # mutation stamp covering EVERY fragment of this view (bumped on
        # any fragment mutation or creation): lets the query compiler's
        # stack cache validate a whole shard list in O(1) instead of
        # reading every fragment's version per query. Stamps come from a
        # GLOBAL counter so a deleted-and-recreated view can never replay
        # a stamp an old cache entry carries.
        self.version = next(_VIEW_STAMPS)

    def _bump_version(self) -> None:
        self.version = next(_VIEW_STAMPS)

    def fragment(self, shard: int) -> Fragment | None:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        # double-checked under a PER-SHARD lock: two concurrent writers
        # racing the same shard would otherwise build two Fragment
        # objects over the same file (clashing snapshot tmp files, lost
        # updates) — while opens of DIFFERENT shards (the parallel
        # holder cold start) proceed concurrently. The fragment is
        # published only after open() completes, so readers never see a
        # half-loaded bitmap.
        frag = self.fragments.get(shard)
        if frag is not None:
            return frag
        with self._create_lock:
            frag = self.fragments.get(shard)
            if frag is not None:
                return frag
            shard_lock = self._open_locks.setdefault(shard, threading.Lock())
        with shard_lock:
            frag = self.fragments.get(shard)
            if frag is not None:
                return frag
            frag_path = (
                os.path.join(self.path, "fragments", str(shard))
                if self.path
                else None
            )
            frag = Fragment(
                frag_path,
                self.index,
                self.field,
                self.name,
                shard,
                cache_type=self.cache_type,
                cache_size=self.cache_size,
            )
            frag._compactor = self.compactor
            frag.open()
            frag._on_mutate = self._bump_version
            self.fragments[shard] = frag
            self._bump_version()
        return frag

    def available_shards(self) -> set[int]:
        return set(self.fragments)

    def remove_fragment(self, shard: int) -> bool:
        """Drop a fragment and its on-disk file — the relinquish half of a
        cluster resize handoff (reference: fragment deletion in
        ResizeJob). Bumps the view version so device stack caches built
        over the old shard set invalidate."""
        frag = self.fragments.pop(shard, None)
        if frag is None:
            return False
        self._bump_version()
        frag.close()
        # drop() marks the fragment relinquished under its own lock —
        # a compaction already queued (or mid-flight) for it must not
        # rewrite the file and resurrect the shard's data on disk
        frag.drop()
        return True

    def close(self) -> None:
        for frag in self.fragments.values():
            frag.close()
