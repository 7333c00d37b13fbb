"""Flight recorder: always-on, tail-based retention of slow/errored
query evidence.

The serving path has five decision-making subsystems — the host/device/
mesh cost router, the wave scheduler, tiered device residency, event-
loop admission control, and per-peer circuit breakers — whose choices
were invisible once a request completed: a p99 outlier could only be
diagnosed if ``?profile=true`` happened to be set BEFORE it ran.  The
profile collector already runs on every query (a handful of dict
appends, the long-query log's design), so the evidence exists at
settle time; what was missing is somewhere for it to go.

This module keeps bounded ring buffers of FULL query evidence — the
profile (per-call route + timing, fan-out legs, wave occupancy,
residency tiers, admission wait, retries/failovers, deadline spend) and
the trace's buffered spans — for every query that either ERRORED or
settled slower than a per-call-type rolling p95 threshold.  The
retention decision is made at settle time (tail-based sampling: by the
time we know the query was slow, the evidence is already collected), so
nothing about the request had to be special.  Upstream Pilosa's
long-query log (PAPER.md) is the ancestor; the rolling per-call-type
threshold replaces its one static ``long-query-time`` knob because a
healthy GroupBy and a healthy Count live an order of magnitude apart.

Surfaces: ``GET /debug/flightrec`` (summaries + thresholds),
``?trace_id=`` (one entry, full profile + spans),
``?trace_id=&format=perfetto`` (the retained spans as Chrome
trace-event JSON — loadable in Perfetto even after the tracer's own
ring buffer has rotated the spans out), and a structured slow-query
log line carrying the trace id emitted at retention time.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable

import bisect

from pilosa_tpu_torch.utils import sanitize
from pilosa_tpu_torch.utils.stats import DEFAULT_BUCKETS, Histogram

# observations per rolling window: the p95 threshold is computed over
# the current + previous windows, so it tracks roughly the last
# 1x-2x WINDOW queries per call type instead of all history — a
# workload shift re-baselines within one window
_WINDOW = 2048
# samples before the p95 threshold is trusted; until then only errors
# retain (a 3-sample "p95" would retain every third query at startup)
_MIN_SAMPLES = 30


class _RollingP95:
    """Per-call-type rolling latency quantile: two log-bucketed windows
    (current + previous) merged for the percentile, rotated when the
    current window fills.  Same bucket boundaries as every serving
    histogram, so the threshold and the dashboards agree."""

    __slots__ = ("cur", "prev", "_rotate_lock")

    def __init__(self):
        self.cur = Histogram()
        self.prev: Histogram | None = None
        self._rotate_lock = sanitize.make_lock("_RollingP95._rotate_lock", loop_safe=True)

    def observe(self, seconds: float) -> None:
        self.cur.observe(seconds)
        if self.cur.count >= _WINDOW:
            # rotation must be check-and-swap atomic: two settles racing
            # the boundary would otherwise both rotate, installing an
            # EMPTY histogram as prev — samples() drops under the
            # minimum and slow-query retention silently suspends
            with self._rotate_lock:
                if self.cur.count >= _WINDOW:
                    self.prev, self.cur = self.cur, Histogram()

    def samples(self) -> int:
        return self.cur.count + (self.prev.count if self.prev else 0)

    def percentile(self, q: float) -> float:
        if self.prev is None or self.prev.count == 0:
            return self.cur.percentile(q)
        merged = Histogram()
        with self.cur._lock, self.prev._lock:
            merged.counts = [
                a + b for a, b in zip(self.cur.counts, self.prev.counts)
            ]
            merged.count = self.cur.count + self.prev.count
            merged.sum = self.cur.sum + self.prev.sum
        return merged.percentile(q)


class FlightRecorder:
    """One recorder per serving front end, shared across request
    threads.  ``settle`` is the single entry: the handler calls it for
    EVERY public query (success or error) with a zero-cost evidence
    thunk; the thunk is only invoked when the query is retained, so the
    steady-state cost of the recorder is one histogram observe plus a
    threshold comparison."""

    def __init__(
        self,
        capacity: int = 256,
        min_latency_s: float = 0.025,
        stats=None,
        log: "Callable[[str], None] | None" = None,
        enabled: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.capacity = max(1, int(capacity))
        self.min_latency_s = float(min_latency_s)
        self.enabled = bool(enabled)
        self.stats = stats
        self.log = log
        self._clock = clock
        self._lock = sanitize.make_lock("FlightRecorder._lock", loop_safe=True)
        self._entries: deque[dict] = deque(maxlen=self.capacity)
        self._quantiles: dict[str, _RollingP95] = {}
        self._seq = 0
        self.retained = {"slow": 0, "error": 0}

    # ------------------------------------------------------------- intake
    def threshold(self, call_type: str) -> float | None:
        """The current retention threshold for one call type — the
        rolling p95, CEILINGED to the next histogram bucket boundary
        and floored at ``min_latency_s`` — or None while the window is
        still too thin to trust (only errors retain then).  The bucket
        ceiling matters: the interpolated p95 of a uniform latency
        profile lands just below the common value, and without the
        ceiling a perfectly healthy call type would retain nearly
        every one of its own queries.  Retention is strictly-greater
        (``settle``), so landing ON the boundary never retains."""
        with self._lock:
            q = self._quantiles.get(call_type)
        if q is None or q.samples() < _MIN_SAMPLES:
            return None
        p95 = q.percentile(0.95)
        i = bisect.bisect_left(DEFAULT_BUCKETS, p95)
        ceiling = (
            DEFAULT_BUCKETS[i] if i < len(DEFAULT_BUCKETS) else p95
        )
        return max(ceiling, self.min_latency_s)

    def settle(
        self,
        call_type: str,
        seconds: float,
        entry_fn: "Callable[[], dict]",
        error: "BaseException | None" = None,
    ) -> bool:
        """The tail-based retention decision, made once per query at
        settle time.  ``entry_fn`` builds the full evidence dict (the
        profile JSON, the trace's spans) and is invoked ONLY when the
        query is retained.  Returns whether the query was retained."""
        if not self.enabled:
            return False
        threshold = None
        if error is None:
            threshold = self.threshold(call_type)
            with self._lock:
                q = self._quantiles.get(call_type)
                if q is None:
                    q = self._quantiles[call_type] = _RollingP95()
            # errored latencies stay out of the window: a run of fast
            # failures would drag the p95 down and retain healthy traffic
            q.observe(seconds)
        retain = error is not None or (
            threshold is not None and seconds > threshold
        )
        if not retain:
            return False
        reason = "error" if error is not None else "slow"
        entry = entry_fn() or {}
        entry["reason"] = reason
        entry["callType"] = call_type
        entry["seconds"] = seconds
        if threshold is not None:
            entry["thresholdSeconds"] = threshold
        if error is not None:
            entry["error"] = f"{type(error).__name__}: {error}"
        entry["monotonicS"] = self._clock()
        # wall timestamp, never used in arithmetic — operators correlate
        # entries with external logs by it
        entry["recordedAt"] = time.time()
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._entries.append(entry)
            self.retained[reason] = self.retained.get(reason, 0) + 1
        if self.stats is not None:
            self.stats.count("flightrec_retained_total", tags={"reason": reason})
        if self.log is not None:
            # the structured slow-query log line: one JSON object so log
            # pipelines can index on traceId without regexes
            self.log(
                "flightrec "
                + json.dumps(
                    {
                        "event": "slow_query" if reason == "slow" else "query_error",
                        "traceId": entry.get("traceId"),
                        "index": entry.get("index"),
                        "call": call_type,
                        "seconds": round(seconds, 6),
                        "thresholdSeconds": (
                            round(threshold, 6) if threshold is not None else None
                        ),
                        "reason": reason,
                        "query": (entry.get("query") or "")[:200],
                        "error": entry.get("error"),
                        # workload linkage (docs/workload.md): this
                        # exact query's fingerprint + current heavy-
                        # hitter rank — "how often does this run" is
                        # one /debug/workload lookup away
                        "fingerprint": entry.get("fingerprint"),
                        "workloadRank": entry.get("workloadRank"),
                        # result-cache verdict (docs/result-cache.md):
                        # "why wasn't this slow query a cache hit"
                        "cache": (entry.get("resultCache") or {}).get(
                            "outcome"
                        ),
                    }
                )
            )
        return True

    # ------------------------------------------------------------ surface
    def entries(self) -> list[dict]:
        """Retained entries, oldest first (full evidence)."""
        with self._lock:
            return list(self._entries)

    def entry(self, trace_id: str) -> dict | None:
        with self._lock:
            for e in reversed(self._entries):
                if e.get("traceId") == trace_id:
                    return e
        return None

    def snapshot(self) -> dict:
        """The ``GET /debug/flightrec`` listing: entry SUMMARIES (the
        full profile/spans stay behind ``?trace_id=`` so the listing
        stays small), live thresholds, and retention counters."""
        with self._lock:
            entries = list(self._entries)
            retained = dict(self.retained)
            thresholds = {
                ct: q for ct, q in self._quantiles.items()
            }
        summaries = [
            {
                **{
                    k: e.get(k)
                    for k in (
                        "seq",
                        "traceId",
                        "index",
                        "callType",
                        "reason",
                        "seconds",
                        "thresholdSeconds",
                        "error",
                        "recordedAt",
                        "query",
                        "fingerprint",
                        "workloadRank",
                    )
                    if e.get(k) is not None
                },
                # compact result-cache verdict; the full dict (fill
                # outcome, skip reason) stays behind ?trace_id=
                **(
                    {"cache": e["resultCache"].get("outcome")}
                    if e.get("resultCache")
                    else {}
                ),
            }
            for e in reversed(entries)
        ]
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "minLatencySeconds": self.min_latency_s,
            "retained": retained,
            "entries": summaries,
            "thresholds": {
                ct: {
                    "samples": q.samples(),
                    "p95Seconds": self.threshold(ct),
                }
                for ct, q in thresholds.items()
            },
        }

    def perfetto(self, trace_id: str, node_id: str = "local") -> dict | None:
        """One retained entry's spans as Chrome trace-event JSON — the
        Perfetto export survives the tracer ring rotating the live spans
        out, because the recorder snapshotted them at retention time."""
        from pilosa_tpu_torch.utils import tracing

        e = self.entry(trace_id)
        if e is None:
            return None
        spans_by_node = e.get("spansByNode") or {node_id: e.get("spans") or []}
        return tracing.chrome_trace_stitched(spans_by_node)
