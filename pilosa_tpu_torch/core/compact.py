"""Background ops-log → snapshot compaction.

The reference snapshots a fragment INLINE when its ops log passes
MAX_OP_N (fragment.go snapshot) — which means one unlucky ``Set()`` pays
a full serialize+fsync+rename inside the fragment lock, stalling every
writer behind it. Here that work moves to a bounded worker pool
(docs/durability.md): ``Fragment._append_op`` queues the fragment and
returns; the worker runs ``Fragment.compact()``, whose locked phases are
O(containers) + O(ops-since-clone) — writes continue against the live
bitmap and ops log throughout, and a crash mid-compaction leaves the old
snapshot valid (the ``.compacting`` tmp is only committed by the
atomic replace).

Backpressure: ``debt()`` (queued + in-flight compactions) feeds the
event front end's write lane — past ``compaction-max-debt`` new write
requests get 429 + Retry-After instead of growing the queue without
bound (the ops logs, and therefore replay time after a crash, grow with
the debt).

Observability: ``compaction_pending`` gauge, ``compactions_total{reason}``
counter, ``compaction.run`` trace spans.
"""

from __future__ import annotations

import threading
from collections import deque

from pilosa_tpu_torch.utils import GLOBAL_TRACER
from pilosa_tpu_torch.utils.durable import SimulatedCrash
from pilosa_tpu_torch.utils.log import Logger


class Compactor:
    """Bounded compaction worker pool with a per-fragment-deduped FIFO.

    One fragment is compacted by one worker at a time (the dedupe keys
    on the fragment uid and an entry stays claimed until its run
    finishes), so concurrent threshold trips cannot double-compact."""

    def __init__(self, workers: int = 1, stats=None, logger: Logger | None = None):
        self.workers = max(1, int(workers))
        self.stats = stats
        self.log = (logger or Logger()).log
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._queued: set[int] = set()  # fragment uids in _queue
        self._inflight: set[int] = set()
        self._threads: list[threading.Thread] = []
        self._closed = False
        self.compacted = 0
        self.failed = 0
        self.crashed = 0

    # ------------------------------------------------------------ control
    def start(self) -> None:
        with self._lock:
            if self._threads or self._closed:
                return
            for i in range(self.workers):
                t = threading.Thread(
                    target=self._run, daemon=True, name=f"compactor-{i}"
                )
                self._threads.append(t)
                t.start()

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        if drain:
            self.wait_idle(timeout)
        with self._lock:
            self._closed = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)

    # ------------------------------------------------------------- intake
    def request(self, fragment, reason: str = "threshold") -> bool:
        """Queue one compaction; deduped — a fragment already queued or
        in flight is not queued again (its queued run will fold the new
        ops too, or its next threshold trip re-queues it). Lazily starts
        the workers so a Holder used without a Server still compacts."""
        if getattr(fragment, "_dropped", False):
            return False  # relinquished in a resize handoff; file is gone
        # capture the REQUESTING thread's trace context: the compaction
        # this write triggered runs on a background worker, but its
        # compaction.run span must join the originating query's trace —
        # a slow query whose write tripped a compaction is only
        # self-explaining if the trace shows the compaction it caused
        ctx = GLOBAL_TRACER.current_context()
        with self._lock:
            if self._closed:
                return False
            if fragment.uid in self._queued or fragment.uid in self._inflight:
                return False
            self._queue.append((fragment, reason, ctx))
            self._queued.add(fragment.uid)
            self._cond.notify()
            started = bool(self._threads)
        if not started:
            self.start()
        self._gauge()
        return True

    def debt(self) -> int:
        """Queued + in-flight compactions — the write-lane backpressure
        signal (config ``compaction-max-debt``)."""
        with self._lock:
            return len(self._queue) + len(self._inflight)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until the queue and every worker are idle (tests, and
        drain-on-close so shutdown doesn't abandon queued folds)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: not self._queue and not self._inflight, timeout
            )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "workers": self.workers,
                "pending": len(self._queue) + len(self._inflight),
                "compacted": self.compacted,
                "failed": self.failed,
                "crashed": self.crashed,
            }

    # ------------------------------------------------------------- worker
    def _gauge(self) -> None:
        if self.stats is not None:
            self.stats.gauge("compaction_pending", float(self.debt()))

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                fragment, reason, ctx = self._queue.popleft()
                self._queued.discard(fragment.uid)
                self._inflight.add(fragment.uid)
            ok = False
            try:
                ok = self._compact_one(fragment, reason, ctx)
            finally:
                # a write burst that outran the fold leaves the ops log
                # over threshold with no future append to re-queue it —
                # follow up now, but ONLY after a successful fold (a
                # failing disk must not hot-loop the worker; the failed
                # fragment retries on its next append). Same lock as
                # the in-flight discard so wait_idle can't observe an
                # idle gap before the follow-up is queued.
                requeue = (
                    ok
                    and not self._closed
                    and fragment.op_n > fragment.max_op_n
                )
                with self._lock:
                    self._inflight.discard(fragment.uid)
                    if requeue and fragment.uid not in self._queued:
                        # follow-up of the same trigger: keep the
                        # originating context so the whole fold chain
                        # stays navigable from one trace
                        self._queue.append((fragment, "followup", ctx))
                        self._queued.add(fragment.uid)
                        self._cond.notify()
                    self._cond.notify_all()
                self._gauge()

    def _compact_one(self, fragment, reason: str, ctx=None) -> bool:
        try:
            # join the trace of the write that queued this compaction
            # (ctx is (trace_id, span_id) captured at request time);
            # detached() also isolates the worker from any leftover
            # span state on this thread
            tid, parent = ctx if ctx else (None, None)
            with GLOBAL_TRACER.detached(tid, parent):
                with GLOBAL_TRACER.span(
                    "compaction.run",
                    path=str(fragment.path),
                    reason=reason,
                    op_n=fragment.op_n,
                ):
                    committed = bool(fragment.compact())
            if committed:
                # counted ONLY on a real fold: an aborted commit (the
                # fragment was dropped, or an inline snapshot won the
                # race and folded everything itself) must not inflate
                # compactions_total / the bench's compactor-ran gate
                with self._lock:
                    self.compacted += 1
                if self.stats is not None:
                    self.stats.count(
                        "compactions_total", tags={"reason": reason}
                    )
            return committed
        except SimulatedCrash:
            # a fault-injected process death reached the worker instead
            # of killing the process (the in-process chaos suite): the
            # old snapshot is still valid on disk — record it and leave
            # recovery to whoever reopens the holder
            with self._lock:
                self.crashed += 1
            if self.stats is not None:
                self.stats.count("compactions_crashed")
        except Exception as e:  # pilosa: allow(broad-except) — worker
            # containment: EIO/ENOSPC from the disk (or the fault layer)
            # is the expected shape, but ANY unexpected error (a
            # serialize limit, a codec bug) must not kill the daemon
            # worker — with one worker dead, debt grows past
            # compaction-max-debt and the write lane 429s forever. The
            # old snapshot stays authoritative; the ops log keeps
            # growing, so the next threshold trip retries — debt-driven
            # write backpressure bounds how far that can run away.
            with self._lock:
                self.failed += 1
            if self.stats is not None:
                self.stats.count("compactions_failed")
            self.log(f"compaction failed for {fragment.path}: {e!r}")
        return False
