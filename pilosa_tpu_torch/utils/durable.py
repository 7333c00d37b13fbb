"""Durable file I/O: the ONE sanctioned write protocol for holder data.

The reference's durability story is "snapshot + append-only ops log with
atomic replace" (fragment.go snapshot/opN, PAPER.md). This module is
where that story actually becomes crash-safe (docs/durability.md):

- ``atomic_write_file`` — tmp write → fsync(file) → ``os.replace`` →
  fsync(parent dir). The dir fsync is not optional decoration: on a
  crash after rename but before the directory entry reaches disk, the
  rename itself can be lost and the file reverts to its old content (or
  to nothing, for a first write). Every snapshot/meta/schema write under
  the holder path goes through here — the ``durability`` analyzer rule
  bans bare write-mode ``open()`` under ``core/`` and ``os.replace``
  anywhere outside this module.
- WAL (ops-log) appends with a configurable acknowledgement fsync
  policy (config ``wal-fsync-mode``):

  * ``always`` — fsync inside every append (strongest, slowest);
  * ``batch``  — appends mark their file dirty; the durability barrier
    at the request acknowledgement point (``ack_barrier``, called by
    the API façade after every write request) group-fsyncs all dirty
    WAL files ONCE, coalescing with every other in-flight acknowledger
    of the same file (classic group commit);
  * ``off``    — no fsync (the pre-PR-8 behavior: page-cache-only,
    acknowledged writes can die with the OS).

- FS fault hooks: every primitive consults an installed hook
  (``parallel/faultinject.py``'s ``FSFaultInjector``) before touching
  the filesystem, so EIO/ENOSPC/partial-write/crash-at-named-point
  chaos is deterministic and reaches the write protocol exactly where
  real faults would. Hook ops: ``wal-append``, ``snapshot-write``
  (via the ``op`` argument), ``fsync``, ``rename``, ``dirfsync``,
  ``truncate``.
"""

from __future__ import annotations

import os
import threading

WAL_ALWAYS = "always"
WAL_BATCH = "batch"
WAL_OFF = "off"
WAL_MODES = (WAL_ALWAYS, WAL_BATCH, WAL_OFF)


class SimulatedCrash(BaseException):
    """A process death simulated at an exact point in the write
    protocol. BaseException on purpose: recovery code paths catch
    ``Exception``, and a simulated crash must tear through them exactly
    like SIGKILL would — only the test harness (and the compaction
    worker's crash containment) catches this."""


# ---------------------------------------------------------------- FS hook
_fs_hook = None


def install_fs_hook(hook) -> None:
    """Install (or clear, with None) the process-wide filesystem fault
    hook. Protocol: ``check(op, path)`` may raise OSError/SimulatedCrash
    or kill the process; ``write_cap(op, path, nbytes) -> int | None``
    returns how many bytes to actually write for a torn-write fault;
    after a capped write the layer calls ``torn(op, path)``, which must
    raise or kill."""
    global _fs_hook
    _fs_hook = hook


def fs_hook():
    return _fs_hook


def _check(op: str, path: str) -> None:
    h = _fs_hook
    if h is not None:
        h.check(op, path)


def _write(f, data: bytes, op: str, path: str) -> None:
    h = _fs_hook
    if h is not None:
        cap = h.write_cap(op, path, len(data))
        if cap is not None and cap < len(data):
            f.write(data[:cap])
            f.flush()
            h.torn(op, path)
            # torn() must not return; a hook bug would otherwise turn a
            # torn-write fault into a silent short write
            raise SimulatedCrash(f"torn {op} on {path}")
    f.write(data)


# ------------------------------------------------------------- primitives
def fsync_dir(dirpath: str) -> None:
    """fsync a DIRECTORY — makes a rename/create/unlink in it durable."""
    _check("dirfsync", dirpath)
    fd = os.open(dirpath or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_path(path: str) -> None:
    _check("fsync", path)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_file(
    path: str,
    data: bytes | str,
    *,
    tmp_suffix: str = ".tmp",
    op: str = "write",
    durable: bool = True,
) -> None:
    """Crash-safe whole-file write: tmp → fsync → rename → dir fsync.

    A crash at ANY point leaves either the complete old content or the
    complete new content at ``path`` — never a torn mix. ``durable=
    False`` keeps the atomic-replace half but skips both fsyncs, for
    best-effort caches (probe verdicts, diagnostics) whose loss costs
    nothing."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    tmp = path + tmp_suffix
    _check(op, tmp)
    with open(tmp, "wb") as f:
        _write(f, data, op, tmp)
        f.flush()
        if durable:
            _check("fsync", tmp)
            os.fsync(f.fileno())
    replace_durable(tmp, path, durable=durable)


def write_new_file(
    path: str, data: bytes, *, op: str = "write", durable: bool = True
) -> None:
    """Write + fsync a file WITHOUT the rename step — the first half of
    a staged atomic write whose commit (``replace_durable``) the caller
    performs later (the compaction worker: snapshot body first, op-log
    tail carried over under the fragment lock, then the rename)."""
    _check(op, path)
    with open(path, "wb") as f:
        _write(f, data, op, path)
        f.flush()
        if durable:
            _check("fsync", path)
            os.fsync(f.fileno())


def append_file(
    path: str, data: bytes, *, op: str = "write", durable: bool = True
) -> None:
    """Append + fsync — for pre-rename staging files only (the fsync is
    unconditional of the WAL mode: these bytes are about to be COMMITTED
    by a rename, so they must be on disk first)."""
    _check(op, path)
    with open(path, "ab") as f:
        _write(f, data, op, path)
        f.flush()
        if durable:
            _check("fsync", path)
            os.fsync(f.fileno())


def replace_durable(src: str, dst: str, *, durable: bool = True) -> None:
    """``os.replace`` + parent-directory fsync — the sanctioned rename.
    Callers that produced ``src`` through an external tool (the native-
    kernel build) use this directly; everything else goes through
    ``atomic_write_file``."""
    _check("rename", dst)
    os.replace(src, dst)
    if durable:
        fsync_dir(os.path.dirname(os.path.abspath(dst)))


def truncate_file(path: str, size: int = 0, *, durable: bool = True) -> None:
    """Truncate in place (torn-tail repair, journal reset) + fsync."""
    _check("truncate", path)
    os.truncate(path, size)
    if durable:
        _fsync_path(path)


# ------------------------------------------------------------ WAL policy
_wal_mode = WAL_BATCH


def set_wal_fsync_mode(mode: str) -> None:
    if mode not in WAL_MODES:
        raise ValueError(
            f"wal-fsync-mode must be one of {WAL_MODES}, got {mode!r}"
        )
    global _wal_mode
    _wal_mode = mode


def wal_fsync_mode() -> str:
    return _wal_mode


class GroupFsync:
    """Group commit for WAL fsyncs: concurrent acknowledgers of the same
    file share one fsync syscall.

    ``mark(path)`` stamps a monotone sequence per dirty file;
    ``flush()`` fsyncs every file whose latest mark is newer than its
    last completed fsync. While one flusher is fsyncing a file, other
    flushers needing the same file WAIT for that fsync instead of
    issuing their own — and a mark taken before the fsync started is
    covered by it (fsync flushes everything written so far, through any
    descriptor of the inode)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._seq = 0
        self._pending: dict[str, int] = {}
        self._synced: dict[str, int] = {}
        self._syncing: set[str] = set()

    def mark(self, path: str) -> None:
        with self._cond:
            self._seq += 1
            self._pending[path] = self._seq

    def flush(self) -> None:
        with self._cond:
            goals = {}
            for p in list(self._pending):
                s = self._pending[p]
                if s > self._synced.get(p, 0):
                    goals[p] = s
                elif p not in self._syncing:
                    # clean and idle: retire the bookkeeping — without
                    # this, every WAL file ever marked (including dropped
                    # fragments') stays in the maps forever and every
                    # acknowledgement scans all of them. Re-marking
                    # recreates the entry.
                    del self._pending[p]
                    self._synced.pop(p, None)
        for path, goal in goals.items():
            self._flush_one(path, goal)

    def _flush_one(self, path: str, goal: int) -> None:
        with self._cond:
            while True:
                if self._synced.get(path, 0) >= goal:
                    return  # another flusher covered our writes
                if path not in self._syncing:
                    self._syncing.add(path)
                    break
                self._cond.wait(timeout=5.0)
            # everything marked up to HERE is on disk once our fsync
            # completes — claim it so waiters behind us are released too
            claim = self._pending.get(path, goal)
        ok = False
        try:
            _fsync_path(path)
            ok = True
        except FileNotFoundError:
            # the WAL file was deleted (fragment dropped in a resize
            # handoff) — nothing left to make durable
            ok = True
        finally:
            with self._cond:
                self._syncing.discard(path)
                if ok:
                    self._synced[path] = max(
                        self._synced.get(path, 0), claim
                    )
                self._cond.notify_all()

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "dirtyFiles": sum(
                    1
                    for p, s in self._pending.items()
                    if s > self._synced.get(p, 0)
                ),
            }


_group = GroupFsync()


def append_wal(path: str, data: bytes) -> None:
    """The sanctioned ops-log append: open-per-write (see
    Fragment._append_op for why no handle is retained), flushed to the
    OS, then made durable per the WAL fsync mode."""
    _check("wal-append", path)
    with open(path, "ab") as f:
        _write(f, data, "wal-append", path)
        f.flush()
        if _wal_mode == WAL_ALWAYS:
            _check("fsync", path)
            os.fsync(f.fileno())
    if _wal_mode == WAL_BATCH:
        _group.mark(path)


def open_wal(path: str, mode: str = "a"):
    """Open a retained append handle for a line-oriented WAL (the
    translate-key log keeps one — allocation rate makes open-per-write
    measurable there). Writers must call ``wal_written`` after flushing."""
    _check("wal-append", path)
    return open(path, mode)


def wal_write(f, data: str | bytes, path: str) -> None:
    """One append through a RETAINED WAL handle with the full durability
    contract applied: fault-hook check + (torn-write-capable) write,
    flush, then per-mode durability bookkeeping. The batched translate-
    key allocator writes one record batch per call — one append, one
    flush, one group-commit mark, regardless of how many keys the batch
    carries (docs/ingest.md)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    _check("wal-append", path)
    # text-mode handles (the translate log) can't take bytes: write via
    # the underlying buffer so the torn-write cap operates on raw bytes
    sink = f.buffer if hasattr(f, "buffer") else f
    _write(sink, data, "wal-append", path)
    f.flush()
    wal_written(path, f.fileno())


def wal_written(path: str, fileno: int | None = None) -> None:
    """Durability bookkeeping for a WAL write that already reached the
    OS (flushed): fsync now (``always``), mark for the next
    ``ack_barrier`` (``batch``), or nothing (``off``)."""
    if _wal_mode == WAL_ALWAYS:
        _check("fsync", path)
        if fileno is not None:
            os.fsync(fileno)
        else:
            _fsync_path(path)
    elif _wal_mode == WAL_BATCH:
        _group.mark(path)


def ack_barrier() -> None:
    """The durability barrier at a write request's acknowledgement
    point: in ``batch`` mode, group-fsync every WAL file dirtied since
    the last barrier. In ``always`` mode appends are already durable;
    in ``off`` mode durability is explicitly waived. The API façade
    calls this after every accepted write request, BEFORE the response
    leaves the server."""
    if _wal_mode == WAL_BATCH:
        _group.flush()


def wal_snapshot() -> dict:
    """Debug/metrics view of the WAL policy state."""
    return {"mode": _wal_mode, **_group.snapshot()}
