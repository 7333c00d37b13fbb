"""String key ↔ uint64 ID translation.

Reference: translate.go (TranslateStore, TranslateFile — an append-only
mmap log; primary writes, replicas tail). Here: an in-memory dict pair with
an append-only JSON-lines log for durability and replication tailing (the
log offset is the replication cursor — see the cluster layer).

One store instance serves either an index's column keys or one field's row
keys (reference keeps per-index and per-field maps in one file; separate
files are simpler and shard-friendly).
"""

from __future__ import annotations

import json
import os
import threading

from pilosa_tpu_torch.utils import durable, sanitize
from pilosa_tpu_torch.utils.log import Logger

_LOG = Logger()  # stderr sink; recovery events must be loud


class TranslateStore:
    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = sanitize.make_lock("TranslateStore._lock", reentrant=True)
        self._by_key: dict[str, int] = {}
        self._by_id: dict[int, str] = {}
        self._next_id = 1  # 0 is reserved (reference never allocates 0)
        # highest id N such that ids 1..N are ALL present — except the
        # ids listed in _holes. Replica tailing must resume from this
        # watermark, not max(_by_id): a hole below max (a missed primary
        # push) would otherwise never be refilled.
        self._dense_through = 0
        # ids ≤ _dense_through with NO local binding: vacated by a fork
        # displacement. Tracked explicitly (instead of clamping the
        # watermark below them) so incremental tailing stays O(new):
        # a clamped watermark under a permanent hole re-ships the entire
        # tail above it on EVERY sync pass. Pulls request hole ids
        # explicitly, so a binding the surviving chain issues for a hole
        # id later still arrives (see entries_from(holes=...)).
        self._holes: set[int] = set()
        self._hole_pull_cursor = 0
        self._file = None

    def open(self) -> None:
        with self._lock:
            if self.path is None:
                return
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            if os.path.exists(self.path):
                with open(self.path, "rb") as f:
                    raw = f.read()
                good = 0  # byte offset of the last complete good line
                for line_b in raw.splitlines(keepends=True):
                    if not line_b.endswith(b"\n"):
                        break  # torn tail: the line never completed
                    line = line_b.strip()
                    if line:
                        try:
                            entry = json.loads(line)
                        except (json.JSONDecodeError, UnicodeDecodeError):
                            break  # torn/corrupt record
                        # replay with displacement: the log may record a
                        # fork reconciliation (winning entry appended
                        # after the stale one) — last write wins cleanly
                        self._apply_displacing(entry["k"], entry["id"], [])
                    good += len(line_b)
                if good < len(raw):
                    # truncate the untrusted tail BEFORE reopening for
                    # append: a new record welded onto a partial line
                    # would make one unparseable line, and the NEXT
                    # reopen would silently drop every acknowledged
                    # binding appended after the weld
                    _LOG.log(
                        f"translate log {self.path}: discarding "
                        f"{len(raw) - good} torn/corrupt tail byte(s) "
                        f"at offset {good}"
                    )
                    durable.truncate_file(self.path, good)
            # retained append handle (allocation rate makes open-per-
            # write measurable here); binary mode so the batched append
            # helper (durable.wal_write) can apply torn-write fault caps
            # on raw bytes. Durability bookkeeping happens once per
            # flushed BATCH via durable.wal_written.
            self._file = durable.open_wal(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            if self._file:
                self._file.close()
                self._file = None

    def _apply(self, key: str, id_: int) -> None:
        self._by_key[key] = id_
        self._by_id[id_] = key
        self._next_id = max(self._next_id, id_ + 1)
        self._holes.discard(id_)  # a late binding fills the gap
        self._advance_watermark()

    @property
    def dense_through(self) -> int:
        """Replica tailing cursor: every id ≤ this is present locally,
        except the ids in holes()."""
        with self._lock:
            return self._dense_through

    def holes(self) -> list[int]:
        """Ids vacated by fork displacements and not since re-bound. A
        tailing pull must request the ones at/below its offset
        explicitly — they are invisible to an `id > offset` scan (the
        sender ignores requested holes above the offset: the tail scan
        already covers those)."""
        with self._lock:
            return sorted(self._holes)

    def translate_key(self, key: str, create: bool = True) -> int | None:
        """key → ID, allocating when ``create`` (reference:
        TranslateStore.TranslateColumnsToUint64)."""
        return self.translate_keys([key], create=create)[0]

    def translate_keys(self, keys: list[str], create: bool = True) -> list[int | None]:
        """Batched key → ID translation: one lock acquisition, one WAL
        append (all new bindings joined into a single buffer), one flush
        and one group-commit mark for the WHOLE batch — the per-key
        write/flush/fsync-mark loop made keyed imports pay a durability
        round per rowKey/columnKey (docs/ingest.md). The API façade's
        ``ack_barrier`` after the request is the one fsync point either
        way."""
        with self._lock:
            out: list[int | None] = []
            new_lines: list[str] = []
            for key in keys:
                id_ = self._by_key.get(key)
                if id_ is None and create:
                    id_ = self._next_id
                    self._apply(key, id_)
                    new_lines.append(json.dumps({"k": key, "id": id_}))
                out.append(id_)
            if new_lines and self._file:
                durable.wal_write(
                    self._file, "\n".join(new_lines) + "\n", self.path
                )
            return out

    def translate_id(self, id_: int) -> str | None:
        with self._lock:
            return self._by_id.get(id_)

    def translate_ids(self, ids: list[int]) -> list[str | None]:
        with self._lock:
            return [self._by_id.get(i) for i in ids]

    # ------------------------------------------------- replication support
    def _advance_watermark(self) -> None:
        """Advance dense_through across present ids AND recorded holes
        (callers hold self._lock)."""
        while (nxt := self._dense_through + 1) in self._by_id or (
            nxt in self._holes
        ):
            self._dense_through += 1

    def adopt_holes(self, ids: list[int]) -> None:
        """Adopt a SENDER's known holes (fork vacancies) for ids this
        store has no binding for. Without this, a node that never saw
        the displacement locally — e.g. one that full-pulled after the
        fork — has its watermark stuck below the cluster-wide vacancy
        and re-ships the whole tail above it on every sync."""
        with self._lock:
            for i in ids:
                if i not in self._by_id:
                    self._holes.add(i)
            self._advance_watermark()

    def holes_for_pull(self, limit: int = 1024) -> list[int]:
        """A bounded, ROTATING slice of the hole set to request on an
        incremental pull. Permanent cluster-wide vacancies are never
        dropped (a node with a stale view of who holds what could
        otherwise tombstone an id the surviving chain actually binds —
        permanent divergence); instead the per-pull overhead is capped
        and every hole is retried within ceil(n/limit) passes."""
        with self._lock:
            if not self._holes:
                return []
            ordered = sorted(self._holes)
            if len(ordered) <= limit:
                return ordered
            start = self._hole_pull_cursor % len(ordered)
            self._hole_pull_cursor = (start + limit) % len(ordered)
            window = ordered[start : start + limit]
            if len(window) < limit:  # wrap
                window += ordered[: limit - len(window)]
            return window

    SENDER_HOLES_MAX = 4096

    def tail_for(
        self, offset: int, requested_holes: list[int] | None = None
    ) -> tuple[list[tuple[str, int]], list[int]]:
        """The full tailing answer: (entries, own_holes). ``entries``
        are bindings with id > offset plus any binding held for a
        requested hole id; ``own_holes`` are this store's known
        vacancies ABOVE the offset, for the puller to adopt — holes at
        or below the puller's cursor are either bound on the puller or
        already its own holes, so shipping them is pure payload. Capped;
        an over-cap remainder reaches the puller on later pulls (its
        offset advances past the holes it already adopted)."""
        entries = self.entries_from(offset, holes=requested_holes)
        with self._lock:
            own = sorted(i for i in self._holes if i > offset)[
                : self.SENDER_HOLES_MAX
            ]
        return entries, own

    def entries_from(
        self, offset: int, holes: list[int] | None = None
    ) -> list[tuple[str, int]]:
        """All (key, id) pairs after a cursor for replica tailing
        (reference: /internal/translate/data streaming). ``holes`` lists
        ids at/below the caller's cursor that the caller lacks (fork
        vacancies): any binding this store holds for them is included,
        since an `id > offset` scan can never deliver those again."""
        with self._lock:
            span = self._next_id - 1 - offset
            if 0 < span <= 4 * len(self._by_id):
                # dense-allocation common case: walking (offset, next_id)
                # is O(tail) — sorting the whole map made every
                # incremental heartbeat sync O(n log n) in keyspace size
                tail = []
                for i in range(offset + 1, self._next_id):
                    k = self._by_id.get(i)
                    if k is not None:
                        tail.append((k, i))
            elif span > 0:
                # a sparse high push binding jumped next_id far past the
                # held ids: scanning the gap would be O(next_id), worse
                # than sorting what we actually hold
                tail = [
                    (k, i)
                    for i, k in sorted(self._by_id.items())
                    if i > offset
                ]
            else:
                tail = []
            for i in sorted(set(holes or ())):
                if i <= offset:
                    k = self._by_id.get(i)
                    if k is not None:
                        tail.append((k, i))
            return tail

    def apply_entries(
        self, entries: list[tuple[str, int]]
    ) -> list[tuple[str, int]]:
        """Apply replicated entries; the incoming (primary-chain) binding
        WINS conflicts. Returns the local bindings that were displaced —
        non-empty only after a keyspace fork (a deposed primary's
        never-replicated allocations colliding with the surviving chain),
        so callers log them. Reference: translate.go replicas tail the
        primary verbatim and can't conflict; this store can, because it
        supports primary failover (see cluster._ensure_translate_primacy).
        """
        dropped: list[tuple[str, int]] = []
        with self._lock:
            new_lines: list[str] = []
            for key, id_ in entries:
                if self._apply_displacing(key, id_, dropped):
                    new_lines.append(json.dumps({"k": key, "id": id_}))
            if new_lines and self._file:
                # one batched append + one group-commit mark, like
                # translate_keys — replication apply is the same lane
                durable.wal_write(
                    self._file, "\n".join(new_lines) + "\n", self.path
                )
        return dropped

    def _apply_displacing(
        self, key: str, id_: int, dropped: list[tuple[str, int]]
    ) -> bool:
        """_apply plus removal of any binding the new entry displaces
        (appended to ``dropped``). Returns False when the entry was
        already present (callers skip the log write, keeping it O(delta)).
        """
        old_key = self._by_id.get(id_)
        if old_key == key:
            return False
        if old_key is not None:
            dropped.append((old_key, id_))
            del self._by_key[old_key]
        old_id = self._by_key.get(key)
        if old_id is not None and old_id != id_:
            dropped.append((key, old_id))
            if self._by_id.get(old_id) == key:
                del self._by_id[old_id]
                # the removal punches a hole: record it (tailing requests
                # hole ids explicitly; the watermark advance may cross
                # recorded holes) instead of clamping the watermark — a
                # permanent fork hole would otherwise pin the watermark
                # forever and make every incremental sync re-ship the
                # whole tail above it. Unconditional: a vacancy ABOVE the
                # watermark would equally block the advance when later
                # ids fill in around it.
                self._holes.add(old_id)
        self._apply(key, id_)
        return True
