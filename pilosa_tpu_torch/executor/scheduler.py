"""Cross-query wave coalescing: the device dispatch scheduler.

Reference: pilosa_tpu/executor/scheduler.py. Every sync query that
settles its own readback pays one device→host synchronisation; N
concurrent users would pay N where the executor's one-readback
``_Pending`` wave pays one. This module closes that gap for
*independent concurrent* queries: request threads enqueue work
items, one of them becomes the wave leader, drains the queue (plus a
short adaptive window for stragglers), dispatches every query through
the existing compile/dispatch layer (``Executor.dispatch`` — the
parity-covered entry), and settles ALL queries' pending aggregates in
ONE device→host transfer (``fetch_wave``).  Under sustained concurrency
the group-commit effect alone coalesces waves (while one wave executes,
the next one's queries accumulate); the window only adds burst
alignment.

Semantics guardrails:

- writes, and queries containing writes, are NEVER coalesced across
  requests — they run direct, preserving per-request program order;
- host-routed queries bypass the window entirely (no readback to
  share; queueing would be pure added latency);
- error isolation: one query failing — at dispatch, at readback, or in
  its finish() — errors only that query, never its wave-mates;
- single-flight dedup: identical concurrent queries (same index, same
  calls, same shards, same stack token) share one execution; the stack
  token (a globally monotone mutation stamp, core/view.py) guarantees a
  query enqueued after a write never joins a pre-write execution.

Modes (config ``batch-mode`` / env ``PILOSA_TPU_BATCH_MODE``):
``off`` — every query runs direct (the pre-scheduler path);
``adaptive`` — solo traffic pays no window (the wave occupancy EWMA
gates it), concurrent traffic waits min(batch-window-us, readback-RTT
EWMA / 2) for stragglers; ``always`` — every wave waits the full
configured window.  See docs/query-batching.md.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from pilosa_tpu_torch.executor.executor import (
    WRITE_CALLS,
    ExecutionError,
    _Pending,
    finalize,
    unwrap_options,
)
from pilosa_tpu_torch.pql import Call, parse
from pilosa_tpu_torch.utils import sanitize, saturation, tracing
from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER

BATCH_MODES = ("off", "adaptive", "always")

# adaptive window opens only once waves actually coalesce: below this
# occupancy EWMA the traffic is effectively solo and the window would be
# pure added latency (the c1-p50 guard bench.py enforces)
_SOLO_OCCUPANCY = 1.25


def fetch_wave(pending: "list[_Pending]") -> None:
    """THE settlement layer — the one device→host readback site: every
    pending's device tensors, across every query of a wave, ravel to
    int64, concatenate (``torch.cat``), and cross in ONE ``.cpu()``
    copy.  Host arrays land on ``p.fetched`` (original shapes);
    resolving finish() is the caller's job so per-query error isolation
    stays possible. Mesh pendings hold what their reduction trees left on
    the lead device, so every member of a wave lies on one device."""
    flat = [torch.ravel(a).to(torch.int64) for p in pending for a in p.arrays]
    devices = {a.device for a in flat}
    if len(devices) > 1:
        raise RuntimeError(f"a readback wave spans several devices: {sorted(map(str, devices))}")
    joined = (flat[0] if len(flat) == 1 else torch.cat(flat)).cpu().numpy()
    host, off = [], 0
    for a in flat:
        host.append(joined[off : off + a.numel()])
        off += a.numel()
    i = 0
    for p in pending:
        args = []
        for a in p.arrays:
            args.append(host[i].reshape(tuple(a.shape)))
            i += 1
        p.fetched = args


def stack_token(idx) -> tuple:
    """Mutation stamp for single-flight dedup: every write bumps its
    view's version with a globally monotone counter (core/view.py), so
    two identical queries may share one execution ONLY while their
    tokens agree — a mutation between them forces the later query onto
    its own execution (read-your-writes across the dedup).

    Cost: O(fields × views) per batchable enqueue — microseconds for
    realistic schemas (tens of fields, 1-2 views each). If schemas ever
    grow to thousands of fields, maintain a per-INDEX max stamp in
    View._bump_version instead and read it here in O(1)."""
    tok, n = 0, 0
    for f in list(idx.fields.values()):
        for v in list(f.views.values()):
            n += 1
            if v.version > tok:
                tok = v.version
    return (tok, n)


def canonical_calls(calls) -> tuple:
    """The canonical call-repr tuple of ``dedup_key``, rendered at most
    once per parsed call object (cached on the Call): within one
    request the result cache's memoize and fill legs plus this
    scheduler's single-flight key would otherwise each re-render the
    same tree — ~10µs a pass — on the query's critical path.  Safe
    because call trees are treated immutable after parse."""
    out = []
    for c in calls:
        canon = getattr(c, "_canon", None)
        if canon is None:
            canon = repr(c)
            try:
                c._canon = canon
            except AttributeError:
                pass  # a slotted/foreign call type: render every time
        out.append(canon)
    return tuple(out)


def dedup_key(index: str, calls, shards, idx) -> tuple:
    """The single-flight identity: ``(index, canonical calls, shard
    scope, mutation stamp)``.  Two queries may share one answer exactly
    when these keys are equal — the law the wave dedup below applies to
    in-flight executions and the cross-request result cache
    (utils/resultcache.py) applies to settled ones, so the key shape
    MUST stay shared: a drift between them would let the cache serve
    across a boundary dedup would not."""
    return (
        index,
        canonical_calls(calls),
        tuple(shards) if shards is not None else None,
        stack_token(idx),
    )


class _WorkItem:
    __slots__ = (
        "index",
        "calls",
        "shards",
        "routes",
        "key",
        "done",
        "raw",
        "pendings",
        "results",
        "error",
        "trace_ctx",
        "profile",
        "followers",
        "sealed",
    )

    def __init__(self, index: str, calls: list[Call], shards, routes=None):
        self.index = index
        self.calls = calls
        self.shards = shards
        self.routes = routes  # per-call (route, work) from _batchable
        self.key: tuple | None = None
        self.done = threading.Event()
        self.raw: list[Any] = []
        self.pendings: list[_Pending] = []
        self.results: list[Any] | None = None
        self.error: BaseException | None = None
        self.trace_ctx: tuple | None = None
        self.profile = None
        self.followers: list["_WorkItem"] = []
        self.sealed = False


class WaveScheduler:
    """One scheduler per API façade, shared across request threads.
    Takes an ``executor_fn`` (not an Executor) so a rebuilt Executor
    never strands the scheduler on a stale engine."""

    def __init__(
        self,
        executor_fn: "Callable[[], Any]",
        stats=None,
        mode: str | None = None,
        window_us: float | None = None,
        max_queries: int | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if mode is None:
            mode = os.environ.get("PILOSA_TPU_BATCH_MODE", "") or "adaptive"
        if mode not in BATCH_MODES:
            raise ValueError(
                f"batch-mode must be one of {BATCH_MODES}, got {mode!r}"
            )
        if window_us is None:
            window_us = float(
                os.environ.get("PILOSA_TPU_BATCH_WINDOW_US", "") or 250.0
            )
        if max_queries is None:
            max_queries = int(
                os.environ.get("PILOSA_TPU_BATCH_MAX_QUERIES", "") or 64
            )
        self.mode = mode
        self.window_s = float(window_us) / 1e6
        self.max_queries = max(1, int(max_queries))
        self._executor_fn = executor_fn
        self.stats = stats
        self._clock = clock
        # contention-counted (docs/profiling.md): /debug/saturation's
        # "scheduler" lock family.  NOTE: Condition.wait's re-acquire
        # after notify counts as contention — that is real time a woken
        # wave-mate spends waiting for the queue lock, not noise.
        self._lock = sanitize.make_lock(
            "WaveScheduler._lock", inner=saturation.ContendedLock("scheduler")
        )
        # one condition over the queue/leadership state: enqueues and
        # wave completions notify; waiting submitters contend to lead
        self._cond = threading.Condition(self._lock)
        self._queue: deque[_WorkItem] = deque()
        self._inflight: dict[tuple, _WorkItem] = {}
        self._leader_active = False
        self.waves = 0
        self.batched_queries = 0
        self.deduped_queries = 0
        self.direct_queries = 0
        # lazy pool for execute_many's DIRECT (host-routed) entries:
        # the multi-query RPC coalesces legs before the remote routing
        # decision is known, so host-routed legs that used to arrive as
        # N parallel /internal/query requests must not serialize on the
        # one batch-handler thread
        self._direct_pool = None

    # ------------------------------------------------------------- entry
    def execute(
        self,
        index: str,
        query: "str | list[Call]",
        shards: list[int] | None = None,
    ) -> list[Any]:
        """Drop-in for Executor.execute: same signature, same results,
        same exceptions — batchable device-routed queries ride a shared
        wave, everything else runs direct."""
        # per-query deadline (docs/fault-tolerance.md): a query whose
        # budget is already spent must fail with the labeled 504 error
        # BEFORE enqueueing — joining a wave it can no longer wait for
        # would burn device work on an answer nobody is listening to.
        # Deferred import: parallel.resilience is a leaf over client.py,
        # but executor modules must not pull parallel/ in at import time.
        from pilosa_tpu_torch.parallel.resilience import current_deadline

        deadline = current_deadline()
        if deadline is not None and deadline.expired():
            raise deadline.exceeded("scheduler enqueue")
        executor = self._executor_fn()
        calls = parse(query) if isinstance(query, str) else query
        batchable, routes = self._batchable(executor, index, calls, shards)
        # re-fetch under the key build: a concurrent index deletion
        # between the batchability check and here must surface as the
        # canonical ExecutionError (the direct path raises it), never
        # an AttributeError from stack_token(None)
        idx = executor.holder.index(index) if batchable else None
        if not batchable or idx is None:
            with self._lock:
                self.direct_queries += 1
            return executor.execute(index, calls, shards=shards, routes=routes)
        item = _WorkItem(index, calls, shards, routes=routes)
        item.key = dedup_key(index, calls, shards, idx)
        item.trace_ctx = GLOBAL_TRACER.current_context()
        item.profile = tracing.current_profile()
        joined = False
        with self._cond:
            prime = self._inflight.get(item.key)
            if prime is not None and not prime.sealed:
                prime.followers.append(item)
                self.deduped_queries += 1
                joined = True
            else:
                self._inflight[item.key] = item
                self._queue.append(item)
                self._cond.notify_all()
        if joined and self.stats is not None:
            self.stats.count("queries_deduped")
        self._await(item)
        if item.error is not None:
            raise item.error
        return item.results  # type: ignore[return-value]

    def execute_many(
        self,
        requests: "list[tuple[str, str | list[Call], list[int] | None, tuple | None]]",
    ) -> list[Any]:
        """Execute several independent queries as ONE enqueue — the
        multi-query /internal RPC hands its coalesced legs here so they
        share a single device readback wave on this node too.  Each
        request is ``(index, query, shards, trace_ctx)``; the trace
        context (one per leg, propagated in the RPC body) replaces the
        submitter-thread capture ``execute()`` does.  Returns one
        element per request: the result list, or the exception that
        query raised (per-entry error isolation — callers must answer
        every leg)."""
        executor = self._executor_fn()
        out: list[Any] = [None] * len(requests)
        wave_items: list[tuple[int, _WorkItem]] = []
        futures: list[tuple[int, Any]] = []

        def run_direct(index, calls, shards, ctx, routes=None):
            try:
                dctx = ctx or (None, None)
                with GLOBAL_TRACER.detached(dctx[0], dctx[1]):
                    return executor.execute(
                        index, calls, shards=shards, routes=routes
                    )
            except Exception as exc:  # noqa: BLE001 — per-entry
                # isolation: the exception IS this slot's answer
                return exc

        for i, (index, query, shards, ctx) in enumerate(requests):
            try:
                calls = parse(query) if isinstance(query, str) else query
                batchable, _routes = self._batchable(
                    executor, index, calls, shards
                )
                idx = executor.holder.index(index) if batchable else None
                if not batchable or idx is None:
                    with self._lock:
                        self.direct_queries += 1
                    if len(requests) == 1:
                        out[i] = run_direct(index, calls, shards, ctx, _routes)
                    else:
                        # concurrent: these entries were independent
                        # RPCs before leg coalescing merged them into
                        # one envelope — they must stay parallel here
                        # (numpy and torch release the GIL)
                        futures.append(
                            (
                                i,
                                self._pool().submit(
                                    run_direct,
                                    index,
                                    calls,
                                    shards,
                                    ctx,
                                    _routes,
                                ),
                            )
                        )
                    continue
                item = _WorkItem(index, calls, shards, routes=_routes)
                item.key = dedup_key(index, calls, shards, idx)
                item.trace_ctx = ctx
                wave_items.append((i, item))
            except Exception as e:  # noqa: BLE001 — per-entry isolation:
                # a parse/validation failure answers its own slot only
                out[i] = e
        if wave_items:
            deduped = 0
            with self._cond:
                for _i, item in wave_items:
                    prime = self._inflight.get(item.key)
                    if prime is not None and not prime.sealed:
                        prime.followers.append(item)
                        self.deduped_queries += 1
                        deduped += 1
                    else:
                        self._inflight[item.key] = item
                        self._queue.append(item)
                self._cond.notify_all()
            if deduped and self.stats is not None:
                self.stats.count("queries_deduped", deduped)
            for i, item in wave_items:
                self._await(item)
                out[i] = item.error if item.error is not None else item.results
        for i, fut in futures:
            out[i] = fut.result()  # run_direct never raises
        return out

    def _pool(self):
        if self._direct_pool is None:
            with self._lock:
                if self._direct_pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    # sized to the leg batcher's MAX_LEGS (64): a full
                    # coalesced envelope of host-routed legs ran as 64
                    # parallel handler threads pre-batching and must
                    # not queue behind a smaller pool here
                    self._direct_pool = ThreadPoolExecutor(
                        max_workers=64, thread_name_prefix="batch-direct"
                    )
        return self._direct_pool

    def close(self) -> None:
        """Release the direct-entry pool (Server.close reaches here;
        embedded multi-server rigs must not leak 64 idle threads per
        scheduler that ever served a mixed batch envelope)."""
        pool = self._direct_pool
        if pool is not None:
            pool.shutdown(wait=False)

    # ------------------------------------------------------ wave harness
    def _batchable(
        self, executor, index, calls, shards
    ) -> "tuple[bool, list | None]":
        """(batchable, routes): routes carries the per-call (route,
        work) pairs this check computed, handed to Executor.dispatch/
        execute so the hot path never pays the work estimation twice.
        Routes come back None when the query contains a write (dispatch
        must classify those itself)."""
        if self.mode == "off":
            return False, None
        idx = executor.holder.index(index)
        if idx is None:
            return False, None  # direct path raises the canonical error
        any_device = False
        routes: list = []
        for c in calls:
            if unwrap_options(c).name in WRITE_CALLS:
                # writes keep strict per-request program order with
                # their neighbouring reads — never coalesced
                return False, None
            rw = executor._route(idx, c, shards)
            routes.append(rw)
            if rw[0] in ("device", "mesh"):
                any_device = True
        # host-routed calls bypass the window: no readback wave to
        # share, so queueing would only add latency (docs/query-batching.md)
        return any_device, routes

    def _await(self, item: _WorkItem) -> None:
        """Block until ``item`` completes — contending for wave
        leadership while waiting.  A leader runs exactly ONE wave and
        then releases leadership (waking the next contender): without
        the handoff, the first arrival would keep serving everyone
        else's waves while its own finished response sat undelivered —
        measured as c8 throughput BELOW c1 on the first cut of this
        scheduler."""
        while True:
            with self._cond:
                while not item.done.is_set() and (
                    self._leader_active or not self._queue
                ):
                    self._cond.wait()
                if item.done.is_set():
                    return
                self._leader_active = True
            try:
                self._run_one_wave()
            finally:
                with self._cond:
                    self._leader_active = False
                    self._cond.notify_all()

    def _run_one_wave(self) -> None:
        # resolve the executor AT WAVE TIME, not from whatever instance
        # the leading submitter captured at its enqueue
        executor = self._executor_fn()
        with self._cond:
            if not self._queue:
                return
            batch = [self._queue.popleft()]
            while self._queue and len(batch) < self.max_queries:
                batch.append(self._queue.popleft())
        if len(batch) >= self.max_queries:
            reason = "full"
        else:
            reason = self._wait_window(executor, batch)
        try:
            self._execute_wave(executor, batch, reason)
        except Exception as e:  # noqa: BLE001 — harness backstop: a
            # failure OUTSIDE the per-query isolation paths must
            # still wake every waiter, or their HTTP threads hang
            for it in batch:
                if not it.done.is_set():
                    self._finish(
                        it, error=ExecutionError(f"wave failed: {e!r}")
                    )

    def _wait_window(self, executor, batch: list[_WorkItem]) -> str:
        """First-arrival opened the window when the leader drained it;
        hold the wave open for stragglers up to the effective window,
        refilling from the queue as they land.  Returns the flush
        reason (``solo``/``drain`` when no window applied, ``timeout``
        when it expired, ``full`` when the wave filled first)."""
        eff = self._window_seconds(executor, len(batch))
        if eff <= 0:
            return "drain" if len(batch) > 1 else "solo"
        deadline = self._clock() + eff
        while len(batch) < self.max_queries:
            with self._cond:
                if not self._queue:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return "timeout"
                    self._wait_arrival(remaining)
                while self._queue and len(batch) < self.max_queries:
                    batch.append(self._queue.popleft())
            if len(batch) < self.max_queries and self._clock() >= deadline:
                return "timeout"
        return "full"

    def _wait_arrival(self, timeout: float) -> None:
        """Injectable for tests (fake clocks drive the window loop
        deterministically by pairing a scripted clock with a no-op
        wait).  Called holding ``_cond``; woken by enqueues."""
        self._cond.wait(timeout)

    def _window_seconds(self, executor, have: int) -> float:
        from pilosa_tpu_torch.parallel.resilience import current_deadline

        # the straggler window is bounded by the leader's own query
        # deadline: a wave must never hold its leader past the budget
        # the client was promised (retries upstream already consumed
        # their share — see docs/fault-tolerance.md)
        deadline = current_deadline()
        budget = deadline.remaining() if deadline is not None else None
        if budget is not None and budget <= 0:
            return 0.0
        if self.mode == "always":
            return (
                self.window_s if budget is None else min(self.window_s, budget)
            )
        # adaptive: solo traffic never pays the window (the c1 latency
        # guard); once waves coalesce — occupancy EWMA above the solo
        # threshold, or multiple queries already drained — wait for
        # stragglers, scaled to half the readback EWMA and capped at the
        # configured batch-window-us.
        router = executor.router
        occ = getattr(router, "wave_occupancy", None)
        occ_v = occ.value if occ is not None and occ.value else 1.0
        if occ_v <= _SOLO_OCCUPANCY and have <= 1:
            return 0.0
        eff = min(self.window_s, 0.5 * router.readback_s.value)
        return eff if budget is None else min(eff, budget)

    def _execute_wave(
        self, executor, batch: list[_WorkItem], reason: str
    ) -> None:
        # occupancy at dispatch time (span/profile tags); dedup
        # followers keep joining primes until each seals, so the FINAL
        # occupancy for the stats/EWMA is recounted after the wave
        n = len(batch) + sum(len(it.followers) for it in batch)
        # The wave span nests in the LEADER's trace (the leader is a
        # request thread); each batched query's own span joins ITS
        # submitter's trace via detached()+activate and carries the wave
        # span id, so a cross-query wave is navigable from either side.
        with GLOBAL_TRACER.span(
            "scheduler.wave", queries=n, reason=reason
        ) as wave_span:
            settled: list[_WorkItem] = []
            for it in batch:
                ctx = it.trace_ctx or (None, None)
                try:
                    with GLOBAL_TRACER.detached(ctx[0], ctx[1]):
                        with tracing.use_profile(it.profile):
                            with GLOBAL_TRACER.span(
                                "scheduler.query",
                                wave=wave_span.span_id,
                                queries=n,
                            ):
                                it.raw = executor.dispatch(
                                    it.index,
                                    it.calls,
                                    it.shards,
                                    routes=it.routes,
                                )
                    it.pendings = [
                        r for r in it.raw if isinstance(r, _Pending)
                    ]
                    settled.append(it)
                except Exception as e:  # noqa: BLE001 — error isolation:
                    # one bad query errors alone; wave-mates proceed
                    self._finish(it, error=e)
            all_pending = [p for it in settled for p in it.pendings]
            joint_ok = True
            fetch_seconds = 0.0
            if all_pending:
                try:
                    fetch_seconds = executor.fetch(all_pending)
                except Exception:  # noqa: BLE001 — a poisoned joint
                    # readback falls back to per-query fetches below so
                    # only the poisoned query errors
                    joint_ok = False
            for it in settled:
                try:
                    if not joint_ok and it.pendings:
                        fetch_seconds = executor.fetch(it.pendings)
                    for p in it.pendings:
                        p.resolve_fetched()
                    wave_info = {
                        "queries": n,
                        "shared": 1 + len(it.followers),
                        "flushReason": reason,
                    }
                    if it.profile is not None:
                        if it.pendings:
                            # the shared transfer's cost, attributed to
                            # every sharing query (?profile=true keeps
                            # its _readback line; the wave dict tells
                            # the reader it was amortized)
                            it.profile.add_call(
                                "_readback", fetch_seconds, None
                            )
                        it.profile.wave = wave_info
                    self._finish(
                        it,
                        results=finalize(it.raw),
                        readback=fetch_seconds if it.pendings else None,
                        wave=wave_info,
                    )
                except Exception as e:  # noqa: BLE001 — per-query
                    # isolation at settle: a finish() failure (bad
                    # attr, overflow) errors its own query only
                    self._finish(it, error=e)
        # final occupancy: every prime plus every follower it fanned
        # out to (followers can no longer join — all items sealed)
        n = len(batch) + sum(len(it.followers) for it in batch)
        self.waves += 1
        self.batched_queries += n
        executor.router.observe_wave(n)
        if self.stats is not None:
            self.stats.observe("queries_per_wave", float(n))
            self.stats.count("wave_flush_reason", tags={"reason": reason})

    def _finish(
        self,
        item: _WorkItem,
        results=None,
        error=None,
        readback: float | None = None,
        wave: dict | None = None,
    ) -> None:
        with self._cond:
            item.sealed = True
            if self._inflight.get(item.key) is item:
                del self._inflight[item.key]
            followers = list(item.followers)
            item.results = results
            item.error = error
            item.done.set()
            for f in followers:
                if f.profile is not None:
                    # dedup followers shared the prime's execution: their
                    # ?profile=true response still documents the wave
                    # (the docs promise the wave section for every
                    # sharing query) — stamped BEFORE done.set(), which
                    # releases the follower's thread to serialize it
                    if readback is not None:
                        f.profile.add_call("_readback", readback, None)
                    if wave is not None:
                        f.profile.wave = dict(wave)
                f.results = results
                f.error = error
                f.done.set()
            self._cond.notify_all()

    # ------------------------------------------------------ observability
    def snapshot(self) -> dict:
        """Live view for /debug/vars (queryBatching) and tests."""
        with self._lock:
            waves, batched = self.waves, self.batched_queries
            deduped, direct = self.deduped_queries, self.direct_queries
        return {
            "mode": self.mode,
            "windowUs": self.window_s * 1e6,
            "maxQueries": self.max_queries,
            "waves": waves,
            "batchedQueries": batched,
            "dedupedQueries": deduped,
            "directQueries": direct,
            "meanQueriesPerWave": (batched / waves) if waves else 0.0,
        }
