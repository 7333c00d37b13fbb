"""Fragment — the storage/compute unit: one (index, field, view, shard).

Reference: fragment.go (fragment, setBit/clearBit, row, rows, top,
importRoaring, bulkImport, snapshot, blocks/blockData/checksum). Redesigned
for TPU execution:

- the authoritative store is a host roaring Bitmap (bit position =
  row * SHARD_WIDTH + column-in-shard, identical to the reference) with the
  snapshot + append-only-ops-log durability discipline;
- the *compute* representation is a dense packed bit matrix
  ``uint32[padded_rows, WORDS_PER_SHARD]`` kept on the host. Mutations mark
  rows dirty; the next query repacks dirty rows host-side, and the
  executor's StackCache uploads them to the GPU. Row capacity grows by
  doubling so stack shapes stay stable.

Rank-cache policy: the reference maintains a per-
fragment row→count rank cache on every mutation because its TopN phase 1
reads it (cache.go rankCache, fragment.go top). Here TopN is EXACT in one
fused device pass over the whole row matrix, so cache maintenance would be
pure write amplification — fragments therefore do NOT update ``cache`` on
mutation. The cache object remains for API parity (``cacheType``/
``cacheSize`` field options round-trip) and is populated only if a caller
explicitly asks via ``rebuild_cache()``.

Unlike the reference there is no per-fragment RWMutex — the executor runs
queries against immutable device arrays, and host mutation is serialized by
a per-fragment lock only around bitmap/ops-log updates.
"""

from __future__ import annotations

import hashlib
import itertools
import os

import numpy as np

_FRAGMENT_UIDS = itertools.count(1)

from pilosa_tpu_torch import roaring
from pilosa_tpu_torch.core.cache import NopCache, make_cache
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.utils import durable, sanitize, saturation
from pilosa_tpu_torch.utils.log import Logger

_LOG = Logger()  # stderr sink; recovery events must be loud

# ops-log length that triggers a snapshot fold (reference default 2000);
# env-overridable so benches/chaos runs can keep the background
# compactor hot without minutes of ingest per fold
MAX_OP_N = int(os.environ.get("PILOSA_TPU_MAX_OP_N", "2000"))
# ops-log BYTE debt that triggers a fold regardless of op count: bulk-
# ingest union records carry whole roaring frames, so a log can grow
# replay-expensive long before op_n trips the count threshold
MAX_OP_BYTES = int(os.environ.get("PILOSA_TPU_MAX_OP_BYTES", str(8 << 20)))
ROWS_PER_BLOCK = 100  # anti-entropy block granularity (reference: HashBlockSize)
MIN_PADDED_ROWS = 8  # sublane tile for int32


def _candidate_rows_of(bitmap: "roaring.Bitmap") -> list[int]:
    """Sorted row IDs that MAY hold bits in ``bitmap``, derived from its
    container keys (each key covers 2^16 positions; a key's span may
    overlap several rows when SHARD_WIDTH < 2^16) — no full scan."""
    candidates: set[int] = set()
    for key in bitmap._containers.keys():
        first = (key << 16) // SHARD_WIDTH
        last = ((key + 1) << 16) - 1
        candidates.update(range(first, last // SHARD_WIDTH + 1))
    return sorted(candidates)


def _column_positions(bitmap: "roaring.Bitmap", cols: np.ndarray) -> np.ndarray:
    """The positions ``bitmap`` holds in the in-shard columns ``cols``,
    in any row (a scan of its values, or of the candidate rows × cols
    grid, whichever is smaller)."""
    rows = np.asarray(_candidate_rows_of(bitmap), dtype=np.uint64)
    if bitmap.count() <= rows.size * cols.size:
        vals = bitmap.values()
        return vals[np.isin(vals % np.uint64(SHARD_WIDTH), cols)]
    grid = (rows[:, None] * np.uint64(SHARD_WIDTH) + cols[None, :]).ravel()
    return grid[bitmap.contains_many(grid)]


def _replay_captured(
    bitmap: "roaring.Bitmap", captured: list, own: "roaring.Bitmap"
) -> None:
    """Apply a catch-up's captured writes (``Fragment.capture_ops``) to
    the fetched copy ``bitmap``: the framed ops in the order this copy
    applied them, then the regions that a captured write gave its whole
    content take this copy's own content (``own``) there. Such a write
    was worked out against this copy's old content (a mutex Set clears
    the rows this copy held for the column), so its ops alone would
    leave on the fetched copy what this copy lacked; this copy's own
    content of the region is that write's and every later one's, which
    is what the region must hold. A ``("range", (start, stop))`` is a
    row range (ClearRow, Store, an anti-entropy block), a ``("columns",
    cols)`` in-shard columns in every row (a mutex or bool Set, an int
    value or its clear)."""
    ranges, cols = [], []
    for entry in captured:
        if isinstance(entry, bytes):
            roaring.replay_ops(bitmap, entry)
        elif entry[0] == "range":
            ranges.append(entry[1])
        else:
            cols.append(entry[1])
    for start, stop in ranges:
        bitmap.remove_many(bitmap.range_values(start, stop))
        bitmap.add_many(own.range_values(start, stop))
    if cols:
        c = np.unique(np.concatenate(cols))
        bitmap.remove_many(_column_positions(bitmap, c))
        bitmap.add_many(_column_positions(own, c))


def _pad_rows(n: int) -> int:
    p = MIN_PADDED_ROWS
    while p < n:
        p *= 2
    return p


class Fragment:
    def __init__(
        self,
        path: str | None,
        index: str,
        field: str,
        view: str,
        shard: int,
        cache_type: str = "ranked",
        cache_size: int = 50_000,
    ):
        self.path = path
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self.bitmap = roaring.Bitmap()
        self.cache = make_cache(cache_type, cache_size)
        self.op_n = 0
        # bytes of framed ops pending in the on-disk log beyond the
        # snapshot — the per-fragment WAL debt the /debug/resources
        # ledger aggregates (replay time after a crash grows with it)
        self.ops_bytes = 0
        self.max_op_n = MAX_OP_N
        self.max_op_bytes = MAX_OP_BYTES
        # serialized size of the last written snapshot: the byte-debt
        # fold trigger scales with it (fold when the log outgrows the
        # snapshot) so sustained bulk ingest pays O(1) amortized write
        # amplification — a FIXED byte trigger re-serializes an ever-
        # growing fragment at an ever-shorter interval
        self.snapshot_bytes = 0
        # contention-counted (docs/profiling.md): every fragment's lock
        # folds into the "fragment" family in /debug/saturation
        self._lock = sanitize.make_lock(
            "Fragment._lock", reentrant=True,
            inner=saturation.ContendedLock("fragment", reentrant=True),
        )
        self._opened = False  # gates ops-log appends (see _append_op)
        # background compaction hand-off (core/compact.py), injected by
        # the owning View: when set, an over-threshold ops log queues a
        # compaction instead of paying the full snapshot inside the
        # fragment lock on the write path; None = the pre-PR-8 inline
        # snapshot (standalone fragments, tests)
        self._compactor = None
        # snapshot-file generation: bumped (under _lock) every time the
        # file at ``path`` is rewritten. compact() records it before
        # releasing the lock to serialize and aborts its commit if an
        # inline snapshot() (bulk import, anti-entropy merge) rewrote
        # the file meanwhile — welding the NEW file's bytes past a stale
        # base offset onto the clone would commit garbage over it
        self._snap_gen = 0
        # set by drop(): the fragment was relinquished (resize handoff)
        # and its file deleted — late appends and queued compactions
        # must not resurrect it
        self._dropped = False
        # what the last open() recovered: {"tornBytes", "corrupt",
        # "corruptOffset", "quarantined"} — tests and /debug assert on
        # this instead of scraping the log
        self.last_recovery: dict | None = None

        self._np_matrix: np.ndarray | None = None
        self._dirty_rows: set[int] = set()
        self._all_dirty = True
        # monotone mutation counter; stacked-matrix caches key off
        # (uid, version) so a deleted-and-recreated fragment never
        # aliases a cache entry
        self.version = 0
        self.uid = next(_FRAGMENT_UIDS)
        # set by the owning View: bumps its whole-view mutation stamp so
        # the stack cache can validate a shard list in O(1)
        self._on_mutate = None
        # (version, ids) memo for row_ids(); ids stored as a tuple so a
        # caller mutating its result can't corrupt the memo
        self._row_ids_cache: tuple[int, tuple[int, ...]] | None = None
        # (version, row) log so stacked-matrix caches can apply O(dirty
        # rows) device-side deltas instead of re-uploading the stack;
        # bounded — readers asking about versions older than _dirty_floor
        # get None (= unknown, do a full restack)
        self._dirty_history: list[tuple[int, int]] = []
        self._dirty_floor = 0
        # lazily-computed upper bound on the max set position: n_rows()
        # must be O(1) (the stack-budget check runs per query); adds
        # raise it incrementally, removes leave it stale-high (harmless —
        # overestimates only pad), bulk rewrites reset it
        self._approx_max_pos = -1
        # a replica's catch-up (``capture_ops``/``replace``): the framed
        # ops this fragment applied since the capture was armed, and the
        # regions of _replay_captured, or None
        self._capture: list | None = None

    # ----------------------------------------------------------- lifecycle
    def open(self) -> None:
        """Load snapshot + replay ops log (reference: fragment.Open),
        repairing whatever a crash left behind (docs/durability.md):

        - a stale ``.snapshotting`` tmp is discarded — it was never
          renamed in, so the old snapshot at ``path`` is authoritative;
        - a snapshot with a bad roaring header is quarantined to
          ``<path>.corrupt`` and the fragment reopens empty (loudly) —
          the ``.snapshotting``-era recovery rule: never adopt bytes the
          atomic-replace protocol didn't commit;
        - the ops log replays through ``replay_ops_checked``: a torn
          tail truncates cleanly, a checksum mismatch (in-place
          corruption) is reported with fragment path + byte offset and
          everything from the bad record on is truncated — appending
          after a damaged tail would weld the next op onto it."""
        with self._lock:
            if self.path:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._recover()
                if not os.path.exists(self.path):
                    self._write_snapshot()
            self._opened = True
            self._mark_all_dirty()

    def _recover(self) -> None:
        # two tmp names: ".snapshotting" (inline snapshot) and
        # ".compacting" (background fold) — distinct so an inline
        # snapshot landing while a compaction serializes off-lock can
        # never write through the compactor's still-open tmp fd
        for suffix in (".snapshotting", ".compacting"):
            stale_tmp = self.path + suffix
            if os.path.exists(stale_tmp):
                _LOG.log(
                    f"fragment {self.path}: discarding stale {suffix} tmp "
                    "(crash mid-snapshot; previous snapshot is authoritative)"
                )
                os.remove(stale_tmp)
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        if not data:
            return
        rec = {"tornBytes": 0, "corrupt": False, "corruptOffset": -1,
               "quarantined": False}
        self.last_recovery = rec
        try:
            self.bitmap, consumed = roaring.deserialize(data)
        except ValueError as e:
            quarantine = self.path + ".corrupt"
            durable.replace_durable(self.path, quarantine)
            rec["quarantined"] = True
            _LOG.log(
                f"fragment {self.path}: snapshot rejected ({e}); "
                f"quarantined to {quarantine}, reopening empty"
            )
            self.bitmap = roaring.Bitmap()
            self.op_n = 0
            self.ops_bytes = 0
            return
        res = roaring.replay_ops_checked(self.bitmap, data[consumed:])
        self.op_n = res.n_ops
        self.ops_bytes = res.good_bytes
        self.snapshot_bytes = consumed
        good_end = consumed + res.good_bytes
        if res.corrupt:
            rec["corrupt"] = True
            rec["corruptOffset"] = consumed + res.corrupt_offset
            _LOG.log(
                f"fragment {self.path}: ops-log checksum mismatch at "
                f"byte offset {consumed + res.corrupt_offset} — "
                f"truncating the untrusted tail ({len(data) - good_end} "
                "bytes)"
            )
        if good_end < len(data):
            rec["tornBytes"] = len(data) - good_end
            durable.truncate_file(self.path, good_end)

    def close(self) -> None:
        pass  # no retained file handle (see _append_op)

    def _append_op(self, opcode: int, values: np.ndarray) -> None:
        """Ops-log append, open-per-write. A retained append handle per
        fragment exhausts the fd limit at scale: a time field with an
        hourly quantum materializes a fragment per (bucket view, shard) —
        one hourly-taxi import batch opened ~8.4k fragments, two batches
        blew a 20k ulimit. An open/write/close per BATCH (the import path
        is batched) is microseconds against the numpy work, and leaves
        fds in use only while a write is in flight. Gated on open():
        mutating a never-opened pathed fragment must stay in-memory-only
        (appending to a file with no snapshot header would corrupt it).

        Durability: the append goes through ``durable.append_wal`` —
        fsynced per the WAL mode (``always`` inline, ``batch`` at the
        API's ack barrier, ``off`` never). An over-threshold ops log
        queues a BACKGROUND compaction when a compactor is attached;
        the inline snapshot (which pays serialize+fsync+rename inside
        the fragment lock, stalling the write path) remains only for
        standalone fragments."""
        logged = self.path is not None and self._opened and not self._dropped
        if not logged and self._capture is None:
            return
        framed = roaring.append_op(opcode, values)
        if self._capture is not None:
            self._capture.append(framed)
        if not logged:
            return
        durable.append_wal(self.path, framed)
        self.op_n += 1
        self.ops_bytes += len(framed)
        self._maybe_fold()

    def _append_union_op(self, frame: bytes) -> None:
        """Ops-log append of one whole roaring frame (the bulk-ingest
        adopt record): same gating/durability rules as ``_append_op``,
        but the payload is the incoming serialized bitmap rather than a
        value vector — an import-roaring post pays ONE crc32-framed WAL
        append (group-fsynced at the ack barrier) instead of the full
        snapshot rewrite it used to pay, and the background Compactor
        folds the accumulated frames off the write path."""
        logged = self.path is not None and self._opened and not self._dropped
        if not logged and self._capture is None:
            return
        framed = roaring.append_union_op(frame)
        if self._capture is not None:
            self._capture.append(framed)
        if not logged:
            return
        durable.append_wal(self.path, framed)
        self.op_n += 1
        self.ops_bytes += len(framed)
        self._maybe_fold()

    # byte-debt fold trigger = max(max_op_bytes, FACTOR × snapshot):
    # scaling with the live snapshot bounds write amplification to
    # ~1 + 1/FACTOR and keeps the compactor's GIL-heavy whole-fragment
    # serialize at a low duty cycle under sustained bulk ingest (at
    # FACTOR=1 the fold ran after nearly every frame on a grown
    # fragment, stealing the serving core); crash replay stays within
    # ~FACTOR × the snapshot parse — union-frame replay is a
    # deserialize + container OR pass, far cheaper than the fold
    FOLD_BYTES_FACTOR = 4

    def _maybe_fold(self) -> None:
        # two debt axes, either trips the fold: record count (replay op
        # overhead) and bytes (replay parse volume — union frames can
        # blow past the byte axis in a handful of records)
        if self.op_n > self.max_op_n or self.ops_bytes > max(
            self.max_op_bytes, self.FOLD_BYTES_FACTOR * self.snapshot_bytes
        ):
            if self._compactor is not None:
                self._compactor.request(self, reason="threshold")
            else:
                self.snapshot()

    def snapshot(self) -> None:
        """Durable full rewrite; truncates the ops log (reference:
        fragment.snapshot). Synchronous — holds the fragment lock for
        the whole serialize; the hot write path uses the background
        compactor instead (see _append_op)."""
        with self._lock:
            if self.path is None or self._dropped:
                # dropped: a stale reference's late bulk write (import,
                # anti-entropy merge) must not recreate the relinquished
                # shard's file any more than a queued compaction may
                self.op_n = 0
                self.ops_bytes = 0
                return
            self._write_snapshot()
            self.op_n = 0
            self.ops_bytes = 0

    def _write_snapshot(self) -> None:
        # in-place compaction is safe here: callers hold _lock
        data = roaring.serialize(self.bitmap, compact_in_place=True)
        durable.atomic_write_file(
            self.path, data, tmp_suffix=".snapshotting", op="snapshot-write"
        )
        self.snapshot_bytes = len(data)
        self._snap_gen += 1

    def drop(self) -> None:
        """Mark the fragment relinquished and delete its file (cluster
        resize handoff) — under the fragment lock, so an in-flight
        ``compact()`` commit cannot land its tmp over the freshly
        deleted path and resurrect the shard's data on disk; a
        compaction still queued for this fragment becomes a no-op."""
        with self._lock:
            self._dropped = True
            if self.path and os.path.exists(self.path):
                os.remove(self.path)

    def compact(self) -> bool:
        """Fold the ops log into a fresh snapshot WITHOUT stalling
        writers: the bulk of the work (serializing the bitmap, writing +
        fsyncing the new snapshot) runs outside the fragment lock, so a
        concurrent ``Set()`` only ever waits for the two short locked
        phases (a shallow container-dict clone; the tail carry + rename).

        Protocol — crash-safe at every point (the old snapshot file
        stays valid until the atomic replace commits):

        1. under the lock: shallow-clone the bitmap (containers are
           copy-on-write — every mutator replaces, never edits, a
           container, so sharing them with a live writer is safe),
           record the current file length L and op count;
        2. off the lock: serialize the clone and write it to the
           ``.compacting`` tmp (NOT ``.snapshotting`` — an inline
           snapshot() racing this phase must not rename our half-written
           tmp into place or interleave with our open fd), fsynced;
        3. under the lock: re-check the snapshot generation — an inline
           ``snapshot()`` (bulk import adopt, anti-entropy merge) that
           rewrote the file while we serialized already folded every op,
           and our clone is stale against it, so the commit aborts —
           then copy the ops appended since the clone (the old file's
           bytes past L) onto the tmp, fsync, atomically replace +
           dir-fsync, and subtract the folded ops from op_n.

        Returns True if a snapshot was committed, False on an abort
        (dropped fragment, concurrent inline snapshot won) — the
        compactor counts only real folds.
        """
        with self._lock:
            if self._dropped:
                return False
            if self.path is None:
                self.op_n = 0
                return False
            if not os.path.exists(self.path):
                # never snapshotted (path created mid-teardown?): the
                # inline write is the only correct form
                self._write_snapshot()
                self.op_n = 0
                self.ops_bytes = 0
                return True
            clone = roaring.Bitmap()
            clone._containers = dict(self.bitmap._containers)
            base_len = os.path.getsize(self.path)
            ops_at_clone = self.op_n
            ops_bytes_at_clone = self.ops_bytes
            gen_at_clone = self._snap_gen
        data = roaring.serialize(clone)  # NOT in place: containers shared
        tmp = self.path + ".compacting"
        durable.write_new_file(tmp, data, op="snapshot-write")
        with self._lock:
            if self._dropped or self._snap_gen != gen_at_clone:
                # the file we cloned against is gone (drop) or was
                # rewritten by an inline snapshot that folded everything
                # — bytes past base_len are snapshot payload, not ops;
                # committing would clobber the newer state
                os.remove(tmp)
                return False
            with open(self.path, "rb") as f:
                f.seek(base_len)
                tail = f.read()  # ops appended while we serialized
            if tail:
                durable.append_file(tmp, tail, op="snapshot-write")
            durable.replace_durable(tmp, self.path)
            self.snapshot_bytes = len(data)
            self._snap_gen += 1
            self.op_n -= ops_at_clone
            self.ops_bytes = max(0, self.ops_bytes - ops_bytes_at_clone)
            return True

    # ------------------------------------------------------------- rows
    def n_rows(self) -> int:
        if not self.bitmap._containers:
            return 0
        if self._approx_max_pos < 0:
            self._approx_max_pos = int(self.bitmap.max())
        return self._approx_max_pos // SHARD_WIDTH + 1

    def _raise_max_pos(self, pos: int) -> None:
        if self._approx_max_pos >= 0:
            self._approx_max_pos = max(self._approx_max_pos, int(pos))

    def _candidate_rows(self) -> list[int]:
        """Sorted row IDs that MAY hold bits, derived from container keys
        (each key covers 2^16 positions; a key's span may overlap several
        rows when SHARD_WIDTH < 2^16) — no full scan."""
        return _candidate_rows_of(self.bitmap)

    def row_ids(self) -> list[int]:
        """Row IDs with ≥1 bit set (reference: fragment.rows). Memoized
        per mutation version — Rows/GroupBy/TopN consult this on every
        query and the candidate scan + per-row range_count is O(rows)."""
        with self._lock:
            cached = self._row_ids_cache
            if cached is not None and cached[0] == self.version:
                return list(cached[1])
            ids = [
                r
                for r in self._candidate_rows()
                if self.bitmap.range_count(r * SHARD_WIDTH, (r + 1) * SHARD_WIDTH)
            ]
            self._row_ids_cache = (self.version, tuple(ids))
            return ids

    def row_columns(self, row: int) -> np.ndarray:
        """Absolute column IDs set in a row, ascending (uint64)."""
        start = row * SHARD_WIDTH
        rel = self.bitmap.range_values(start, start + SHARD_WIDTH) - np.uint64(start)
        return rel + np.uint64(self.shard * SHARD_WIDTH)

    def row_packed(self, row: int) -> np.ndarray:
        start = row * SHARD_WIDTH
        return roaring.pack_range(self.bitmap, start, start + SHARD_WIDTH)

    def row_count(self, row: int) -> int:
        start = row * SHARD_WIDTH
        return self.bitmap.range_count(start, start + SHARD_WIDTH)

    # --------------------------------------------------------- mutation
    def _pos(self, row: int, col: int) -> int:
        return row * SHARD_WIDTH + (col % SHARD_WIDTH)

    def set_bit(self, row: int, col: int) -> bool:
        with self._lock:
            pos = self._pos(row, col)
            changed = self.bitmap.add(pos)
            if changed:
                self._append_op(roaring.OP_ADD, np.array([pos], dtype=np.uint64))
                self._raise_max_pos(pos)
                self._mark_dirty(row)
            return changed

    def clear_bit(self, row: int, col: int) -> bool:
        with self._lock:
            pos = self._pos(row, col)
            changed = self.bitmap.remove(pos)
            if changed:
                self._append_op(roaring.OP_REMOVE, np.array([pos], dtype=np.uint64))
                self._mark_dirty(row)
            return changed

    def contains(self, row: int, col: int) -> bool:
        return self.bitmap.contains(self._pos(row, col))

    def clear_row(self, row: int) -> bool:
        """Remove every bit in a row (PQL ClearRow)."""
        with self._lock:
            start = row * SHARD_WIDTH
            if self._capture is not None:
                self._capture.append(("range", (start, start + SHARD_WIDTH)))
            positions = self.bitmap.range_values(start, start + SHARD_WIDTH)
            if positions.size == 0:
                return False
            self.bitmap.remove_many(positions)
            self._append_op(roaring.OP_REMOVE, positions)
            self._mark_dirty(row)
            return True

    def set_row(self, row: int, columns: np.ndarray) -> bool:
        """Replace a row's contents with ``columns`` (in-shard positions;
        PQL Store)."""
        with self._lock:
            self.clear_row(row)
            if columns.size:
                positions = (
                    np.asarray(columns, dtype=np.uint64) % SHARD_WIDTH
                ) + np.uint64(row * SHARD_WIDTH)
                self.bitmap.add_many(positions)
                self._append_op(roaring.OP_ADD, positions)
                self._raise_max_pos(int(positions.max()))
            self._mark_dirty(row)
            return True

    def rows_containing(self, col: int) -> list[int]:
        """Rows whose bit for ``col`` is set (mutex/bool single-value
        enforcement; reference: fragment mutex handling). Only candidate
        rows (≥1 bit anywhere) are probed, all through one vectorized
        ``contains_many`` call — never a Python loop up to n_rows()."""
        cand = self._candidate_rows()
        if not cand:
            return []
        c = col % SHARD_WIDTH
        rids = np.asarray(cand, dtype=np.uint64)
        hit = self.bitmap.contains_many(
            rids * np.uint64(SHARD_WIDTH) + np.uint64(c)
        )
        return [int(r) for r in rids[hit]]

    def bulk_import(self, rows: np.ndarray, cols: np.ndarray, clear: bool = False) -> None:
        """Batched set/clear (reference: fragment.bulkImport). ``cols`` are
        absolute or in-shard column IDs; reduced mod SHARD_WIDTH. Empty
        batches are free (no ops-log record, no cache work)."""
        with self._lock:
            rows = np.asarray(rows, dtype=np.uint64)
            if rows.size == 0:
                return
            cols = np.asarray(cols, dtype=np.uint64) % np.uint64(SHARD_WIDTH)
            positions = rows * np.uint64(SHARD_WIDTH) + cols
            if clear:
                self.bitmap.remove_many(positions)
                self._append_op(roaring.OP_REMOVE, positions)
            else:
                self.bitmap.add_many(positions)
                self._append_op(roaring.OP_ADD, positions)
                self._raise_max_pos(int(positions.max()))
            for r in np.unique(rows).tolist():
                self._mark_dirty(int(r))

    def mutex_import(self, rows: np.ndarray, cols: np.ndarray) -> None:
        """Batched single-value (mutex/bool) import: for every imported
        column, clear the bit in every OTHER row, then set the target bit
        (reference: fragment.go mutex handling — which does it bit by
        bit; here one vectorized pass over the fragment's value set).

        ``cols`` must be deduplicated (last-wins resolved by the caller);
        they may be absolute or in-shard (reduced mod SHARD_WIDTH).
        """
        with self._lock:
            rows = np.asarray(rows, dtype=np.uint64)
            if rows.size == 0:
                return
            rel = np.asarray(cols, dtype=np.uint64) % np.uint64(SHARD_WIDTH)
            if self._capture is not None:
                self._capture.append(("columns", rel))
            # conflict scan, cost-adaptive: a big batch scans the whole
            # value set once (O(total bits)); a small batch against a big
            # fragment probes only the candidate (existing row × imported
            # column) grid via vectorized membership (O(rows·batch))
            existing_rows = self.row_ids()
            total_bits = self.bitmap.count()
            if total_bits <= len(existing_rows) * rel.size:
                vals = self.bitmap.range_values(0, self.n_rows() * SHARD_WIDTH)
                order = np.argsort(rel)
                rel_s, tgt_s = rel[order], rows[order]
                to_remove = np.empty(0, dtype=np.uint64)
                if vals.size:
                    vrows = vals // np.uint64(SHARD_WIDTH)
                    vcols = vals % np.uint64(SHARD_WIDTH)
                    at = np.searchsorted(rel_s, vcols)
                    at_c = np.minimum(at, rel_s.size - 1)
                    hit = rel_s[at_c] == vcols
                    conflict = hit & (vrows != tgt_s[at_c])
                    to_remove = vals[conflict]
            else:
                rids = np.asarray(existing_rows, dtype=np.uint64)
                cand = (
                    rids[:, None] * np.uint64(SHARD_WIDTH) + rel[None, :]
                ).ravel()
                hit = self.bitmap.contains_many(cand).reshape(
                    rids.size, rel.size
                )
                conflict = hit & (rids[:, None] != rows[None, :])
                to_remove = cand.reshape(rids.size, rel.size)[conflict]
            if to_remove.size:
                self.bitmap.remove_many(to_remove)
                self._append_op(roaring.OP_REMOVE, to_remove)
                for r in np.unique(to_remove // np.uint64(SHARD_WIDTH)).tolist():
                    self._mark_dirty(int(r))
            positions = rows * np.uint64(SHARD_WIDTH) + rel
            self.bitmap.add_many(positions)
            self._append_op(roaring.OP_ADD, positions)
            self._raise_max_pos(int(positions.max()))
            for r in np.unique(rows).tolist():
                self._mark_dirty(int(r))

    def import_roaring(self, data: bytes) -> "roaring.Bitmap":
        """Union a serialized roaring bitmap of fragment-relative positions
        straight into storage (reference: fragment.importRoaring fast
        path). Durability is ONE crc32-framed union-op WAL append of the
        incoming frame (group-fsynced at the caller's ack barrier) — NOT
        a full snapshot rewrite per post: an inline snapshot
        paid serialize+fsync+rename of the whole merged fragment inside
        the lock on every import, which is exactly what capped sustained
        ingest at demo speed. The background Compactor folds the
        accumulated frames off the write path (``_maybe_fold``).

        Returns the INCOMING bitmap (the delta, pre-union) so callers
        that derive follow-up work from the import — existence-field
        marking in api.ImportRoaring — stay O(delta) instead of
        re-enumerating the whole merged fragment per call. Returning the
        bitmap (not materialized values) keeps the return free for
        callers that ignore it; on the adopt path the caller must treat
        it as read-only — it IS the fragment's storage."""
        with self._lock:
            incoming, consumed = roaring.deserialize(data)
            roaring.replay_ops(incoming, data[consumed:])
            if not self.bitmap._containers:
                # fresh fragment: adopt the deserialized bitmap outright
                # (zero-copy buffer views) — the dominant bulk-load case
                self.bitmap = incoming
            else:
                self.bitmap = self.bitmap | incoming
            self._append_union_op(data)
            self._mark_all_dirty()
            return incoming

    def capture_ops(self) -> None:
        """Arm the capture that ``replace`` replays: from here on every
        op this fragment applies is also kept in memory (a replica's
        catch-up arms it before it fetches the current owner's copy)."""
        with self._lock:
            if self._capture is None:
                self._capture = []

    def capture_column_reset(self, cols) -> None:
        """Tell an armed capture that the write that follows gives the
        columns ``cols`` their whole value (a mutex or bool Set, an int
        value or its clear). That write's ops clear only the rows this
        copy holds for them, and a catch-up is replacing this copy, so
        ``replace`` gives those columns of the fetched copy this copy's
        own content (a no-op while nothing is armed)."""
        with self._lock:
            if self._capture is not None:
                self._capture.append(
                    ("columns", np.asarray(cols, dtype=np.uint64) % np.uint64(SHARD_WIDTH))
                )

    def end_capture(self) -> None:
        """Disarm the capture without replacing (a catch-up that failed)."""
        with self._lock:
            self._capture = None

    def replace(self, data: bytes) -> None:
        """Make the fragment's content exactly the serialized bitmap
        ``data`` (a replica's catch-up from a current owner: a union
        would keep the bits a missed Clear removed), then replay on it
        the ops captured since ``capture_ops`` and disarm the capture,
        durably: a full snapshot, the ops log truncated. A write this
        copy took while the owner's copy was being fetched is kept
        whether or not the owner had it at the fetch: every captured op
        is idempotent (a Set, a Clear, an import's union), and a write
        whose ops depend on this copy's old content gives its region
        this copy's own content (``_replay_captured``)."""
        with self._lock:
            incoming, consumed = roaring.deserialize(data)
            roaring.replay_ops(incoming, data[consumed:])
            if self._capture:
                _replay_captured(incoming, self._capture, self.bitmap)
            self._capture = None
            self.bitmap = incoming
            self.snapshot()
            self._mark_all_dirty()

    def union_positions(self, positions: np.ndarray) -> None:
        """Bulk-OR fragment-relative positions: the import_roaring merge
        without the wire codec — build the delta's containers vectorized,
        then ``union_bitmap``. O(delta); for deltas past the ops-log
        threshold this beats the per-op bit-list path by an order of
        magnitude, and the logged frame is far smaller than an OP_ADD
        record's 8 bytes/bit for dense deltas."""
        positions = np.asarray(positions, dtype=np.uint64)
        if positions.size == 0:
            return
        incoming = roaring.Bitmap()
        incoming.add_many(positions)
        self.union_bitmap(incoming)

    def union_bitmap(self, incoming: "roaring.Bitmap") -> None:
        """Union a PRE-BUILT delta bitmap into storage (the existence-
        marking fast path: the adopt delta's column set is folded
        container-wise, never re-sorted — docs/ingest.md). Durability is
        one compressed union-frame WAL append, like import_roaring. The
        caller must hand over ownership: containers may be adopted by
        reference."""
        if not incoming._containers:
            return
        with self._lock:
            frame = roaring.serialize(incoming)
            if not self.bitmap._containers:
                self.bitmap = incoming
            else:
                self.bitmap = self.bitmap | incoming
            self._append_union_op(frame)
            self._mark_all_dirty()

    DIRTY_HISTORY_MAX = 4096

    def _mark_dirty(self, row: int) -> None:
        self._dirty_rows.add(row)
        self.version += 1
        self._dirty_history.append((self.version, row))
        if len(self._dirty_history) > self.DIRTY_HISTORY_MAX:
            drop = len(self._dirty_history) // 2
            self._dirty_floor = self._dirty_history[drop - 1][0]
            del self._dirty_history[:drop]
        if self._on_mutate is not None:
            self._on_mutate()

    def _mark_all_dirty(self) -> None:
        """Bulk/out-of-band rewrite: delta tracking restarts here."""
        self._approx_max_pos = -1
        self._all_dirty = True
        self.version += 1
        self._dirty_history.clear()
        self._dirty_floor = self.version
        if self._on_mutate is not None:
            self._on_mutate()

    def dirty_rows_since(self, version: int) -> set[int] | None:
        """Rows dirtied after ``version``, or None when unknowable (the
        history was trimmed, or a bulk rewrite happened)."""
        with self._lock:
            if version < self._dirty_floor:
                return None
            return {r for v, r in self._dirty_history if v > version}

    def rebuild_cache(self) -> None:
        """Opt-in full rebuild — see the module docstring's rank-cache
        policy; no hot path calls this."""
        self.cache.clear()
        if isinstance(self.cache, NopCache):
            return
        for r in self.row_ids():
            self.cache.add(r, self.row_count(r))

    # ----------------------------------------------------------- device
    def host_matrix(self) -> tuple[np.ndarray, int]:
        """(np uint32[R_pad, W], n_rows) — packed matrix on host, with
        dirty rows repacked incrementally. The stacked-query path reads
        this directly (one upload for the whole stack) instead of paying
        a per-fragment device round trip."""
        with self._lock:
            n = max(self.n_rows(), 1)
            r_pad = _pad_rows(n)
            if (
                self._np_matrix is None
                or self._all_dirty
                or self._np_matrix.shape[0] < n
            ):
                m = np.zeros((r_pad, WORDS_PER_SHARD), dtype=np.uint32)
                for r in self.row_ids():
                    m[r] = self.row_packed(r)
                self._np_matrix = m
                self._all_dirty = False
                self._dirty_rows.clear()
            elif self._dirty_rows:
                for r in self._dirty_rows:
                    if r < self._np_matrix.shape[0]:
                        self._np_matrix[r] = self.row_packed(r)
                self._dirty_rows.clear()
            return self._np_matrix, n

    # ------------------------------------------------------ anti-entropy
    def block_checksums(self) -> list[tuple[int, bytes]]:
        """[(block_id, checksum)] over 100-row blocks with any bits set
        (reference: fragment.blocks). Used by the holder syncer to diff
        replicas cheaply."""
        out = []
        rows = self.row_ids()
        if not rows:
            return out
        blocks: dict[int, list[int]] = {}
        for r in rows:
            blocks.setdefault(r // ROWS_PER_BLOCK, []).append(r)
        for block_id in sorted(blocks):
            h = hashlib.blake2b(digest_size=16)
            start = block_id * ROWS_PER_BLOCK * SHARD_WIDTH
            stop = (block_id + 1) * ROWS_PER_BLOCK * SHARD_WIDTH
            h.update(self.bitmap.range_values(start, stop).tobytes())
            out.append((block_id, h.digest()))
        return out

    def block_data(self, block_id: int) -> tuple[np.ndarray, np.ndarray]:
        """(row_ids, in-shard columns) for one block (reference:
        fragment.blockData)."""
        start = block_id * ROWS_PER_BLOCK * SHARD_WIDTH
        stop = (block_id + 1) * ROWS_PER_BLOCK * SHARD_WIDTH
        positions = self.bitmap.range_values(start, stop)
        rows = positions // np.uint64(SHARD_WIDTH)
        cols = positions % np.uint64(SHARD_WIDTH)
        return rows, cols

    def merge_block(self, block_id: int, rows: np.ndarray, cols: np.ndarray) -> None:
        """Replace one block's contents with the reconciled (rows, cols)
        (anti-entropy repair: reference holder_syncer block merge)."""
        with self._lock:
            start = block_id * ROWS_PER_BLOCK * SHARD_WIDTH
            stop = (block_id + 1) * ROWS_PER_BLOCK * SHARD_WIDTH
            existing = self.bitmap.range_values(start, stop)
            incoming = (
                np.asarray(rows, dtype=np.uint64) * np.uint64(SHARD_WIDTH)
                + np.asarray(cols, dtype=np.uint64)
            )
            self.bitmap.remove_many(existing)
            self.bitmap.add_many(incoming)
            if self._capture is not None:
                # logged by its snapshot, not by _append_op
                self._capture.append(("range", (start, stop)))
                self._capture.append(roaring.append_op(roaring.OP_ADD, incoming))
            self.snapshot()
            self._mark_all_dirty()
