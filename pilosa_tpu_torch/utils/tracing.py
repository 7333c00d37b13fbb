"""Tracing: spans around executor calls, fragment ops, HTTP handlers —
with REAL trace identity and cross-node context propagation.

Reference: tracing/tracing.go (global Tracer, StartSpanFromContext) +
tracing/opentracing adapter (Jaeger span propagation across the per-shard
HTTP fan-out). OpenTracing/Jaeger isn't available here, so the Tracer
records spans in-process (ring buffer) and can dump them for inspection;
the API matches so an OTLP adapter can slot in later. What IS wire-real:

- every span carries a 128-bit ``trace_id`` and 64-bit ``span_id``
  (hex strings, Jaeger-sized);
- ``(trace_id, parent_span_id)`` travel node→node as HTTP headers
  (``X-Pilosa-Trace-Id`` / ``X-Pilosa-Parent-Span-Id``, injected by
  parallel/client.py and extracted by server/http.py), so one user query
  yields ONE coherent trace across coordinator and remote nodes;
- ``chrome_trace_stitched`` merges per-node span sets into one Chrome
  trace-event JSON (one pid per node) for Perfetto/chrome://tracing —
  the export story, with the coordinator fetching remote spans via
  ``GET /internal/trace``.

The module also hosts the per-query profile collector (``profile_query``
/ ``current_profile``): a thread-local sink the executor and cluster
fan-out write per-call / per-shard-group timing+bytes records into, so
``?profile=true`` can return a breakdown without threading a collector
through every router signature.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager

MAX_SPANS = 4096

# cross-node propagation headers (reference: the opentracing adapter's
# Inject/Extract over Jaeger's uber-trace-id; spelled out here so curl
# can join a trace too)
TRACE_HEADER = "X-Pilosa-Trace-Id"
PARENT_HEADER = "X-Pilosa-Parent-Span-Id"


def new_trace_id() -> str:
    """128-bit trace id, 32 hex chars (Jaeger-sized)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit span id, 16 hex chars."""
    return os.urandom(8).hex()


# one wall↔monotonic anchor so exported timestamps share a single
# monotonic timeline (mixing time.time starts with perf_counter
# durations lets child slices cross parent boundaries in trace viewers)
_PERF_EPOCH = time.time() - time.perf_counter()  # pilosa: allow(wall-clock)


class Span:
    __slots__ = (
        "name",
        "start",
        "start_perf",
        "duration",
        "tags",
        "parent",
        "tid",
        "trace_id",
        "span_id",
        "parent_id",
    )

    def __init__(
        self,
        name: str,
        parent: str | None = None,
        trace_id: str | None = None,
        parent_id: str | None = None,
    ):
        self.name = name
        self.parent = parent  # parent span NAME (human-readable)
        self.trace_id = trace_id or new_trace_id()
        self.span_id = new_span_id()
        self.parent_id = parent_id  # parent span ID (joinable)
        self.start = time.time()
        self.start_perf = time.perf_counter()
        self.duration = 0.0
        self.tags: dict = {}
        self.tid = threading.get_ident()

    def set_tag(self, k, v):
        self.tags[k] = v

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "parent": self.parent,
            "traceID": self.trace_id,
            "spanID": self.span_id,
            "parentSpanID": self.parent_id,
            "start": self.start,
            # wall-anchored monotonic start: chrome export needs ts and
            # dur on ONE clock, and remote spans arrive as these dicts
            "ts": self.start_perf + _PERF_EPOCH,
            "durationSeconds": self.duration,
            "tags": self.tags,
            "tid": self.tid,
        }


class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=MAX_SPANS)
        self._local = threading.local()

    @contextmanager
    def span(self, name: str, **tags):
        parent = getattr(self._local, "current", None)
        if parent is not None:
            s = Span(
                name,
                parent=parent.name,
                trace_id=parent.trace_id,
                parent_id=parent.span_id,
            )
        else:
            # no local parent: join a propagated (remote) context if one
            # was activated for this request, else start a fresh trace
            remote = getattr(self._local, "remote", None)
            if remote is not None:
                s = Span(name, trace_id=remote[0], parent_id=remote[1])
            else:
                s = Span(name)
        s.tags.update(tags)
        self._local.current = s
        try:
            yield s
        finally:
            # same sample as the exported ts — ts and dur must share one
            # clock origin or child slices cross parent edges in viewers
            s.duration = time.perf_counter() - s.start_perf
            self._local.current = parent
            with self._lock:
                self._spans.append(s)

    @contextmanager
    def activate(self, trace_id: str | None, parent_span_id: str | None):
        """Join a PROPAGATED trace context for the duration of a request:
        spans opened on this thread (with no local parent) adopt
        ``trace_id`` and parent onto ``parent_span_id`` — the server-side
        Extract half of cross-node propagation. A falsy trace_id is a
        no-op so call sites don't need to branch on header presence."""
        if not trace_id:
            yield
            return
        prev = getattr(self._local, "remote", None)
        self._local.remote = (trace_id, parent_span_id)
        try:
            yield
        finally:
            self._local.remote = prev

    @contextmanager
    def detached(self, trace_id: str | None, parent_span_id: str | None):
        """Run the body OUTSIDE this thread's current span stack,
        optionally joining a propagated context instead.  The wave
        scheduler (executor/scheduler.py) executes queued queries on
        the leader's thread: each query's spans must join the
        SUBMITTER's trace (captured at enqueue), not nest under the
        leader's own request span — otherwise every batched query's
        trace would collapse into whichever request happened to lead
        the wave."""
        prev_cur = getattr(self._local, "current", None)
        prev_rem = getattr(self._local, "remote", None)
        self._local.current = None
        self._local.remote = (trace_id, parent_span_id) if trace_id else None
        try:
            yield
        finally:
            self._local.current = prev_cur
            self._local.remote = prev_rem

    def current_context(self) -> tuple[str, str] | None:
        """(trace_id, span_id) to INJECT into an outbound request — the
        active span's identity, or the activated remote context when no
        span is open on this thread. None outside any trace."""
        cur = getattr(self._local, "current", None)
        if cur is not None:
            return (cur.trace_id, cur.span_id)
        remote = getattr(self._local, "remote", None)
        if remote is not None and remote[0]:
            return (remote[0], remote[1] or "")
        return None

    def current_trace_id(self) -> str | None:
        ctx = self.current_context()
        return ctx[0] if ctx else None

    def recent(self, n: int = 100) -> list[dict]:
        with self._lock:
            return [s.to_json() for s in list(self._spans)[-n:]]

    def depth(self) -> int:
        """Buffered span count (the /debug/resources tracer-ring row —
        counting must not pay for serializing 4k spans)."""
        with self._lock:
            return len(self._spans)

    def spans_for_trace(self, trace_id: str) -> list[dict]:
        """Every buffered span belonging to one trace (served to peers by
        GET /internal/trace for cross-node stitching)."""
        with self._lock:
            return [s.to_json() for s in self._spans if s.trace_id == trace_id]

    def chrome_trace(self, n: int = 1000) -> dict:
        """Spans as Chrome trace-event JSON — loadable in
        chrome://tracing / Perfetto (the trace-EXPORT story; the
        reference exports spans to Jaeger, unavailable here)."""
        with self._lock:
            spans = [s.to_json() for s in list(self._spans)[-n:]]
        return {
            "traceEvents": _chrome_events(spans, pid=1),
            "displayTimeUnit": "ms",
        }


def _chrome_events(spans: list[dict], pid: int) -> list[dict]:
    """Span dicts (Span.to_json shape — local or fetched from a peer) →
    Chrome trace-event "X" slices on one pid."""
    events = []
    for s in spans:
        args = dict(s.get("tags") or {})
        if s.get("parent"):
            args["parent"] = s["parent"]
        for key in ("traceID", "spanID", "parentSpanID"):
            if s.get(key):
                args[key] = s[key]
        events.append(
            {
                "name": s["name"],
                "ph": "X",
                # one monotonic timeline anchored to wall time — ts and
                # dur must share a clock or nesting breaks
                "ts": s["ts"] * 1e6,
                "dur": s["durationSeconds"] * 1e6,
                "pid": pid,
                "tid": s.get("tid", 1),
                "args": args,
            }
        )
    return events


def chrome_trace_stitched(spans_by_node: dict[str, list[dict]]) -> dict:
    """One coherent Chrome trace from per-node span sets: each node gets
    its own pid (named via process_name metadata), every event keeps its
    traceID/spanID/parentSpanID args, so a distributed query renders as
    the coordinating HTTP span with each remote node's spans time-nested
    inside it on their own process track."""
    events: list[dict] = []
    for pid, node in enumerate(sorted(spans_by_node), start=1):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"node {node}"},
            }
        )
        events.extend(_chrome_events(spans_by_node[node], pid=pid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


GLOBAL_TRACER = Tracer()


# --------------------------------------------------------- query profiles
class QueryProfile:
    """Per-query timing/bytes breakdown (the reference's query-profile
    analogue). Filled by the executor (per-PQL-call dispatch + readback)
    and the cluster fan-out (per-node shard groups, RPC latency + wire
    bytes); surfaced by ``?profile=true`` and mined by the long-query
    log to name the slow shard group. Single-threaded by construction:
    the HTTP handler thread drives the whole query synchronously."""

    __slots__ = (
        "trace_id",
        "total_seconds",
        "calls",
        "fanout",
        "wave",
        "mesh",
        "residency",
        "admission_wait",
        "deadline",
        "retries",
        "failovers",
        "_last_rpc_bytes",
    )

    def __init__(self):
        self.trace_id: str | None = None
        self.total_seconds = 0.0
        self.calls: list[dict] = []  # local executor per-call entries
        self.fanout: list[dict] = []  # per-node shard-group entries
        # seconds this request waited in the event front end's admission
        # queue before a worker picked it up (None on the threaded
        # listener, which has no admission lane) — the flight recorder's
        # "was it the queue or the query" attribution
        self.admission_wait: float | None = None
        # per-query deadline accounting at settle: {"budgetS",
        # "remainingS"} — how much of the promised budget the query
        # spent (docs/fault-tolerance.md)
        self.deadline: dict | None = None
        # retry/failover attribution (docs/fault-tolerance.md): the
        # resilient RPC chain notes each retry sleep it takes on this
        # query's behalf, and the fan-out notes each leg it re-planned
        # onto a surviving replica — tail latency from a flaky peer is
        # visible in the evidence, not just in global counters
        self.retries: list[dict] = []
        self.failovers: list[dict] = []
        # set by the wave scheduler when this query rode a shared wave:
        # {"queries": occupancy, "flushReason": ...} — the ?profile=true
        # surface for cross-query coalescing
        self.wave: dict | None = None
        # set by the executor when a call routed to the explicit-SPMD
        # mesh path: device count + mesh geometry (the ?profile=true
        # surface for multi-chip execution; per-call entries carry the
        # route tag already)
        self.mesh: dict | None = None
        # set by the executor when the query touched tiered compressed
        # residency (docs/device-residency.md): container tiers,
        # promotion/demotion counters — the ?profile=true surface for
        # the hot/cold row tier
        self.residency: dict | None = None
        self._last_rpc_bytes = 0

    def add_call(
        self,
        call: str,
        seconds: float,
        shards: list[int] | None,
        route: str | None = None,
    ) -> None:
        # shards is stored by REFERENCE, not copied: the collector runs
        # on every query (the long-query log mines it), so a thousands-
        # of-shards index must not pay a per-call list copy; callers
        # pass lists they do not mutate afterwards
        entry: dict = {"call": call, "seconds": seconds}
        if route is not None:
            # which engine the cost router picked (host | device) — the
            # ?profile=true surface for the routing decision
            entry["route"] = route
        if shards is not None:
            entry["shards"] = shards
        self.calls.append(entry)

    def add_fanout(
        self,
        call: str,
        node: str,
        shards: list[int] | None,
        seconds: float,
        bytes_: int,
    ) -> None:
        self.fanout.append(
            {
                "call": call,
                "node": node,
                "shards": shards,  # by reference — see add_call
                "seconds": seconds,
                "bytes": bytes_,
            }
        )

    def note_retry(self, method: str, node: str, attempt: int) -> None:
        """The resilient client reports each retry attempt it makes for
        an RPC issued under this query (docs/fault-tolerance.md)."""
        self.retries.append({"method": method, "node": node, "attempt": attempt})

    def note_failover(self, node: str, to_node: str, shards: list[int] | None) -> None:
        """The cluster fan-out reports each leg it re-planned from a
        failed peer onto a surviving replica."""
        self.failovers.append(
            {"node": node, "toNode": to_node, "shards": shards}
        )

    def note_rpc_bytes(self, n: int) -> None:
        """The internal client reports each response's size here; the
        fan-out reads it back to attribute wire bytes to the shard-group
        entry it is about to record (same thread, no nesting between the
        RPC return and the read)."""
        self._last_rpc_bytes = n

    def take_rpc_bytes(self) -> int:
        n, self._last_rpc_bytes = self._last_rpc_bytes, 0
        return n

    def slowest(self) -> dict | None:
        """The slowest shard-group (preferred — it names a node) or
        per-call entry, for the long-query log."""
        pool = self.fanout or self.calls
        if not pool:
            return None
        return max(pool, key=lambda e: e["seconds"])

    def to_json(self) -> dict:
        out: dict = {
            "totalSeconds": self.total_seconds,
            "calls": self.calls,
            "fanout": self.fanout,
        }
        if self.wave is not None:
            out["wave"] = self.wave
        if self.mesh is not None:
            out["mesh"] = self.mesh
        if self.residency is not None:
            out["residency"] = self.residency
        if self.admission_wait is not None:
            out["admissionWaitSeconds"] = self.admission_wait
        if self.deadline is not None:
            out["deadline"] = self.deadline
        if self.retries:
            out["retries"] = self.retries
        if self.failovers:
            out["failovers"] = self.failovers
        if self.trace_id:
            out["traceID"] = self.trace_id
        return out


_PROFILE = threading.local()


@contextmanager
def profile_query():
    """Install a QueryProfile as this thread's active collector."""
    prof = QueryProfile()
    prev = getattr(_PROFILE, "current", None)
    _PROFILE.current = prof
    try:
        yield prof
    finally:
        _PROFILE.current = prev


def current_profile() -> QueryProfile | None:
    return getattr(_PROFILE, "current", None)


@contextmanager
def use_profile(prof: QueryProfile | None):
    """Install a SPECIFIC profile (possibly None) as this thread's
    collector — the wave scheduler dispatches queued queries on the
    leader's thread, and each query's executor calls must land in the
    profile its own submitter installed, not the leader's."""
    prev = getattr(_PROFILE, "current", None)
    _PROFILE.current = prof
    try:
        yield prof
    finally:
        _PROFILE.current = prev
