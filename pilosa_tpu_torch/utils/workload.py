"""Workload intelligence: continuous query capture, heavy-hitter
analysis, SLO burn-rate tracking, and capture→replay benching.

Traces, profiles and the flight recorder make INDIVIDUAL queries
observable; this module is the aggregate half — what the fleet of
queries looks like (docs/workload.md).  Analytics systems are
characterized by their operator mix and data-reuse profile (PIMDAL,
arXiv 2504.01948), and the ROADMAP's next perf levers (cross-query
result cache, wire-speed ingest, multi-process serving) are all sized
by claims about traffic shape — so the serving path measures its own
workload continuously instead of assuming:

- **Continuous capture** — every settled public query contributes one
  compact normalized record: a *fingerprint* (canonicalized PQL call
  tree + index + shard set — whitespace/keyword-order independent, so
  "the same segmentation query" hashes identically however a client
  formats it), the raw PQL, route, latency, result bytes, status, and
  trace id.  Records land in a bounded in-memory ring (sampled past
  ``workload-sample-rate``) with optional durable spill to size/age-
  bounded JSONL segments (``workload-capture-path``, written through
  ``utils/durable.py``).
- **Heavy-hitter analysis** — a SpaceSaving (Misra-Gries family) top-K
  sketch over fingerprints, with per-fingerprint latency/churn stats.
  The churn half feeds the *cachability estimate*: a repeat of a
  fingerprint whose mutation stamp (the same view-version stack token
  single-flight dedup keys on, executor/scheduler.py) is UNCHANGED is
  exactly a query a mutation-stamped result cache (ROADMAP item 2)
  would have served from cache — ``GET /debug/workload`` reports the
  QPS such a cache would have absorbed, measured, not assumed.
- **SLO engine** — per-call-type objectives (``slo-targets`` grammar:
  ``count:p95<50ms:99.9``) tracked as multi-window burn rates (5m/1h
  bucketed windows), exposed as ``slo_burn_rate{call,window}`` /
  ``slo_budget_remaining{call}`` gauges and ``GET /debug/slo`` — a
  burn rate over 1.0 spends error budget faster than the objective
  allows, alertable before users notice.
- **Capture→replay** — ``pilosa_tpu replay <capture>`` replays a
  captured workload against a live server preserving recorded arrival
  spacing (or scaled: ``--speed``/``--qps``/``--closed-loop``),
  reporting QPS/p50/p95/error rate and the divergence count vs the
  recorded statuses; ``make bench-workload`` gates capture overhead
  and replay fidelity on the config8 mix.

Steady-state cost per query: one cached-dict fingerprint lookup, one
sketch offer, one histogram observe, and (sampled) one ring append —
the ``bench-workload`` gate holds the whole plane at ≤3% c1 p50.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable

from pilosa_tpu_torch.utils import sanitize
from pilosa_tpu_torch.utils.stats import Histogram

# ring records keep the raw PQL truncated to this many characters —
# enough to replay every realistic query, bounded against a pathological
# megabyte query body ballooning the ring
_MAX_PQL = 2000
# fingerprint cache: raw (index, pql, shards) → fingerprint; cleared
# wholesale when full (the route-cache idiom — repeated traffic is the
# point of this plane, so the steady state is all hits)
_FP_CACHE_MAX = 4096


# ------------------------------------------------------------ fingerprint
def _render(v: Any) -> str:
    from pilosa_tpu_torch.pql.ast import Call, Condition, _render_value

    if isinstance(v, Call):
        return _canon_call(v)
    if isinstance(v, Condition):
        if v.op == "between":
            lo, hi = v.value
            return f"between[{_render(lo)},{_render(hi)}]"
        return f"{v.op}{_render(v.value)}"
    return _render_value(v)


def _canon_call(call) -> str:
    """Canonical text of one PQL call: children and positional args in
    place (operand order is semantics for Difference/Shift and harmless
    elsewhere), keyword args SORTED by name — ``Row(f=1)`` and a
    client that spells its options in another order fingerprint
    identically.  Whitespace never survives (this renders from the
    AST, not the source text)."""
    parts = [_canon_call(c) for c in call.children]
    parts += [_render(v) for v in call.pos_args]
    for k in sorted(call.args):
        parts.append(f"{k}={_render(call.args[k])}")
    return f"{call.name}({','.join(parts)})"


class Fingerprinter:
    """Query → stable 16-hex-char workload fingerprint.

    The fingerprint identifies "the same query against the same data
    scope": canonicalized call tree + index + explicit shard set.  Row
    values and call arguments are PART of the identity — the heavy-
    hitter report and the result-cache sizing both need ``Count(Row(
    cab=1))`` and ``Count(Row(cab=2))`` to be different queries.
    Lookups are cached on the RAW (index, pql, shards) key so the hot
    path pays a dict hit, not a parse."""

    def __init__(self):
        self._lock = sanitize.make_lock("Fingerprinter._lock", loop_safe=True)
        self._cache: dict[tuple, tuple[str, str]] = {}

    def fingerprint(
        self, index: str, pql, shards: list[int] | None
    ) -> tuple[str, str]:
        """(fingerprint, call_type) for one query.  ``pql`` is the raw
        string (HTTP path) or an already-parsed call list."""
        shard_key = tuple(sorted(set(shards))) if shards else None
        raw_key = None
        if isinstance(pql, str):
            raw_key = (index, pql, shard_key)
            with self._lock:
                hit = self._cache.get(raw_key)
            if hit is not None:
                return hit
        try:
            from pilosa_tpu_torch.pql import parse

            calls = parse(pql) if isinstance(pql, str) else pql
            canon = " ".join(_canon_call(c) for c in calls)
            call_type = calls[0].name if calls else "?"
        except Exception:  # noqa: BLE001 — an unparseable query still
            # deserves a stable identity (it shows up as an errored
            # heavy hitter); fall back to the raw text
            canon = pql if isinstance(pql, str) else repr(pql)
            call_type = str(canon).split("(", 1)[0].strip()[:32] or "?"
        scope = "all" if shard_key is None else ",".join(map(str, shard_key))
        digest = hashlib.blake2b(
            f"{index}|{scope}|{canon}".encode(), digest_size=8
        ).hexdigest()
        out = (digest, call_type)
        if raw_key is not None:
            with self._lock:
                if len(self._cache) >= _FP_CACHE_MAX:
                    self._cache.clear()
                self._cache[raw_key] = out
        return out


# ------------------------------------------------------- top-K sketch
class SpaceSaving:
    """SpaceSaving top-K heavy-hitter sketch (Metwally et al.; the
    Misra-Gries family): at most ``k`` counters; an unseen key past
    capacity REPLACES the minimum counter and inherits its count as
    overestimation error.  Guarantees: every true count is within
    [estimate - error, estimate], and any key with true frequency
    above N/k is tracked — exactly the shape needed for "which
    fingerprints dominate the workload" without unbounded state."""

    def __init__(self, k: int = 64):
        self.k = max(1, int(k))
        self._lock = sanitize.make_lock("SpaceSaving._lock", loop_safe=True)
        # key -> [count, error]
        self._counters: dict[str, list[int]] = {}
        self.observed = 0

    def offer(self, key: str, inc: int = 1) -> str | None:
        """Count one observation; returns the key EVICTED to make room
        (the caller drops its per-key stats), or None."""
        with self._lock:
            self.observed += inc
            c = self._counters.get(key)
            if c is not None:
                c[0] += inc
                return None
            if len(self._counters) < self.k:
                self._counters[key] = [inc, 0]
                return None
            victim = min(self._counters, key=lambda x: self._counters[x][0])
            floor = self._counters.pop(victim)[0]
            self._counters[key] = [floor + inc, floor]
            return victim

    def top(self, n: int | None = None) -> list[tuple[str, int, int]]:
        """[(key, estimated_count, max_overestimate)] sorted by count
        descending."""
        with self._lock:
            items = sorted(
                self._counters.items(), key=lambda kv: -kv[1][0]
            )
        out = [(k, c[0], c[1]) for k, c in items]
        return out[: n] if n else out

    def rank(self, key: str) -> int | None:
        """1-based heavy-hitter rank of ``key``, or None if untracked."""
        for i, (k, _c, _e) in enumerate(self.top()):
            if k == key:
                return i + 1
        return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._counters)


class _FpStats:
    """Per-fingerprint aggregate, kept only while the sketch tracks the
    fingerprint (bounded by top-K)."""

    __slots__ = (
        "index", "call", "example", "count", "errors", "bytes_total",
        "hist", "last_stamp", "unchanged_repeats", "cache_hits",
    )

    def __init__(self, index: str, call: str, example: str):
        self.index = index
        self.call = call
        self.example = example
        self.count = 0
        self.errors = 0
        self.bytes_total = 0
        self.hist = Histogram()
        self.last_stamp = None
        self.unchanged_repeats = 0
        self.cache_hits = 0

    def observe(
        self, seconds: float, nbytes: int, error: bool, stamp,
        byte_cap: int = 0,
    ) -> None:
        if (
            self.count > 0
            and stamp is not None
            and stamp == self.last_stamp
            and not (byte_cap > 0 and nbytes > byte_cap)
        ):
            # a repeat under an unchanged mutation stamp: the query a
            # stamped result cache would have served from cache.
            # Results over the cache's per-entry byte cap are excluded
            # — they would never be admitted, and counting them
            # overstated servable QPS for giant results
            self.unchanged_repeats += 1
        self.last_stamp = stamp
        self.count += 1
        if error:
            self.errors += 1
        self.bytes_total += int(nbytes)
        self.hist.observe(seconds)

    def to_json(self) -> dict:
        snap = self.hist.snapshot()
        return {
            "index": self.index,
            "call": self.call,
            "examplePql": self.example,
            "observed": self.count,
            "errors": self.errors,
            "resultBytesTotal": self.bytes_total,
            "meanMs": round(
                snap["totalSeconds"] / max(1, snap["count"]) * 1e3, 3
            ),
            "p95Ms": round(snap["p95"] * 1e3, 3),
            "repeats": max(0, self.count - 1),
            "repeatsUnchangedStamp": self.unchanged_repeats,
            # MEASURED cache serves vs the estimate above — estimator
            # drift reads directly off this pair (docs/result-cache.md)
            "cacheHits": self.cache_hits,
            "actualHitFraction": round(
                self.cache_hits / max(1, self.count), 4
            ),
            "stampChurn": round(
                1.0
                - self.unchanged_repeats / max(1, self.count - 1), 4
            ) if self.count > 1 else None,
        }


# ------------------------------------------------------------ SLO engine
_SLO_LAT_RE = re.compile(r"^p(\d{1,2})<(\d+(?:\.\d+)?)(ms|s)$")
# gauges republish at most this often — burn-rate math is a ~60-bucket
# scan and must not run per query on the hot path
_GAUGE_REPUBLISH_S = 1.0
WINDOWS = (("5m", 300.0, 30), ("1h", 3600.0, 60))
# distinct call types a WILDCARD target may track: call_type is derived
# from client-controlled PQL (unparseable queries fall back to raw
# text), so without a cap a garbage-spraying client would mint one
# permanent window pair + slo_burn_rate series per distinct string —
# unbounded memory and metric cardinality.  Explicitly-named targets
# are bounded by config and always tracked.
_MAX_SLO_CALLS = 64


class SLOTarget:
    """One parsed ``slo-targets`` entry — TWO objectives per target:

    ``<call>:p95<50ms:99.9`` — a latency quantile objective (the p95
    must sit under 50ms, i.e. at most 5% of queries may exceed it —
    the percentile IS the latency error budget) plus an availability
    objective (99.9% of queries must not error).  ``<call>:errors:
    99.9`` tracks availability only.  ``call`` matches the query's
    first call name case-insensitively; ``*`` matches any."""

    __slots__ = ("call", "threshold_s", "quantile", "objective", "spec")

    def __init__(self, spec: str):
        parts = spec.strip().split(":")
        if len(parts) != 3:
            raise ValueError(
                f"bad slo target {spec!r}: want <call>:<p95<50ms|errors>:"
                "<objective-pct>"
            )
        self.spec = spec.strip()
        self.call = parts[0].strip().lower()
        cond = parts[1].strip().lower()
        if cond in ("errors", "avail", "availability"):
            self.threshold_s = None
            self.quantile = None
        else:
            m = _SLO_LAT_RE.match(cond)
            if m is None:
                raise ValueError(
                    f"bad slo condition {parts[1]!r}: want pNN<MMms (or "
                    "'errors' for availability-only)"
                )
            scale = 1e-3 if m.group(3) == "ms" else 1.0
            self.threshold_s = float(m.group(2)) * scale
            q = float(m.group(1))
            if not 0.0 < q < 100.0:
                raise ValueError(
                    f"slo latency quantile must be in p1..p99, got p{m.group(1)}"
                )
            self.quantile = q / 100.0
        obj = float(parts[2])
        if not 0.0 < obj < 100.0:
            raise ValueError(
                f"slo objective must be in (0, 100), got {parts[2]!r}"
            )
        self.objective = obj / 100.0

    @property
    def avail_budget(self) -> float:
        """Allowed errored fraction (the availability error budget)."""
        return 1.0 - self.objective

    @property
    def latency_budget(self) -> float | None:
        """Allowed over-threshold fraction — 1 − quantile (5% for a
        p95 target), None for availability-only targets."""
        return None if self.quantile is None else 1.0 - self.quantile


def parse_slo_targets(raw: str) -> list[SLOTarget]:
    out = []
    for spec in re.split(r"[,;]", raw or ""):
        if spec.strip():
            out.append(SLOTarget(spec))
    return out


class _BucketWindow:
    """Total / over-threshold / errored counts over a rolling window of
    fixed-width buckets.  Buckets are addressed by ``clock() //
    bucket_s`` so stale slots self-invalidate lazily — no sweeper
    thread, O(1) add, O(buckets) read."""

    __slots__ = ("span_s", "n", "bucket_s", "total", "slow", "err", "epoch")

    def __init__(self, span_s: float, n: int):
        self.span_s = span_s
        self.n = n
        self.bucket_s = span_s / n
        self.total = [0] * n
        self.slow = [0] * n
        self.err = [0] * n
        self.epoch = [-1] * n

    def _slot(self, now: float) -> int:
        b = int(now // self.bucket_s)
        i = b % self.n
        if self.epoch[i] != b:
            self.epoch[i] = b
            self.total[i] = 0
            self.slow[i] = 0
            self.err[i] = 0
        return i

    def add(self, now: float, slow: bool, error: bool) -> None:
        i = self._slot(now)
        self.total[i] += 1
        if slow:
            self.slow[i] += 1
        if error:
            self.err[i] += 1

    def totals(self, now: float) -> tuple[int, int, int]:
        """(total, over_threshold, errored) within the window ending at
        ``now``."""
        cur = int(now // self.bucket_s)
        t = s = e = 0
        for i in range(self.n):
            if cur - self.epoch[i] < self.n:
                t += self.total[i]
                s += self.slow[i]
                e += self.err[i]
        return t, s, e


class SLOEngine:
    """Per-call-type SLO burn rates over multiple windows.

    ``observe`` classifies each settled query against BOTH of its call
    type's objectives — over-threshold (latency) and errored
    (availability) — and feeds every window.  Each objective burns its
    own budget: latency burn = over-threshold fraction / (1 −
    quantile), availability burn = errored fraction / (1 − objective);
    the reported burn rate is the MAX of the two — the binding
    constraint.  1.0 = spending exactly that budget, >1.0 = the
    objective will be missed if sustained (page-worthy at ~14x on the
    5m window per the standard multi-window alerting recipe).  Budget
    remaining is reported over the LONGEST window."""

    def __init__(
        self,
        targets: "list[SLOTarget] | str" = "",
        stats=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if isinstance(targets, str):
            targets = parse_slo_targets(targets)
        self.targets = targets
        self.stats = stats
        self._clock = clock
        self._lock = sanitize.make_lock("SLOEngine._lock", loop_safe=True)
        # call (lowercased) -> target; "*" is the fallback
        self._by_call = {t.call: t for t in targets}
        # call -> {window_name: _BucketWindow}
        self._windows: dict[str, dict[str, _BucketWindow]] = {}
        self._last_publish = 0.0

    @property
    def enabled(self) -> bool:
        return bool(self.targets)

    def target_for(self, call_type: str) -> SLOTarget | None:
        return self._by_call.get(call_type.lower()) or self._by_call.get("*")

    def observe(self, call_type: str, seconds: float, error: bool) -> None:
        t = self.target_for(call_type)
        if t is None:
            return
        slow = t.threshold_s is not None and seconds > t.threshold_s
        now = self._clock()
        key = call_type.lower()
        with self._lock:
            wins = self._windows.get(key)
            if wins is None:
                if (
                    key not in self._by_call
                    and len(self._windows) >= _MAX_SLO_CALLS
                ):
                    # a wildcard-matched call type past the cardinality
                    # cap: drop rather than mint another permanent
                    # window pair + gauge series for client-controlled
                    # input (explicit targets always track)
                    return
                wins = self._windows[key] = {
                    name: _BucketWindow(span, n) for name, span, n in WINDOWS
                }
            for w in wins.values():
                w.add(now, slow, error)
            publish = (
                self.stats is not None
                and now - self._last_publish >= _GAUGE_REPUBLISH_S
            )
            if publish:
                self._last_publish = now
        if publish:
            self.publish_gauges()

    @staticmethod
    def _burn(t: "SLOTarget | None", total: int, slow: int, err: int) -> dict:
        """Both burn components plus the binding max for one window."""
        if t is None or total == 0:
            return {"latency": 0.0, "availability": 0.0, "max": 0.0}
        avail = (err / total) / t.avail_budget
        lat = (
            (slow / total) / t.latency_budget
            if t.latency_budget is not None
            else 0.0
        )
        return {"latency": lat, "availability": avail, "max": max(lat, avail)}

    def burn_rates(self, call: str) -> dict:
        """{window: burn_rate} for one call type (0.0 when idle); the
        rate is the max over the latency and availability components —
        the binding constraint."""
        t = self.target_for(call)
        now = self._clock()
        out = {}
        with self._lock:
            wins = self._windows.get(call.lower(), {})
            for name, _span, _n in WINDOWS:
                w = wins.get(name)
                if w is None:
                    out[name] = 0.0
                    continue
                total, slow, err = w.totals(now)
                out[name] = self._burn(t, total, slow, err)["max"]
        return out

    def budget_remaining(self, call: str) -> float:
        """Fraction of the error budget left over the longest window
        (negative once overspent)."""
        rates = self.burn_rates(call)
        longest = WINDOWS[-1][0]
        return 1.0 - rates.get(longest, 0.0)

    def publish_gauges(self) -> None:
        if self.stats is None:
            return
        for call in list(self._windows):
            rates = self.burn_rates(call)
            for window, rate in rates.items():
                self.stats.gauge(
                    "slo_burn_rate",
                    round(rate, 6),
                    tags={"call": call, "window": window},
                )
            self.stats.gauge(
                "slo_budget_remaining",
                round(self.budget_remaining(call), 6),
                tags={"call": call},
            )

    def snapshot(self) -> dict:
        """The ``GET /debug/slo`` report."""
        now = self._clock()
        calls: dict[str, dict] = {}
        with self._lock:
            tracked = {
                c: dict(wins) for c, wins in self._windows.items()
            }
        for call, wins in tracked.items():
            t = self.target_for(call)
            per_window = {}
            for name, _span, _n in WINDOWS:
                w = wins.get(name)
                total, slow, err = (
                    w.totals(now) if w is not None else (0, 0, 0)
                )
                burn = self._burn(t, total, slow, err)
                per_window[name] = {
                    "total": total,
                    "overThreshold": slow,
                    "errors": err,
                    "latencyBurnRate": round(burn["latency"], 4),
                    "availabilityBurnRate": round(burn["availability"], 4),
                    "burnRate": round(burn["max"], 4),
                }
            calls[call] = {
                "target": t.spec if t is not None else None,
                "objectivePct": round(t.objective * 100, 4)
                if t is not None else None,
                "latencyQuantile": (
                    round(t.quantile * 100, 2)
                    if t is not None and t.quantile is not None
                    else None
                ),
                "latencyThresholdMs": (
                    round(t.threshold_s * 1e3, 3)
                    if t is not None and t.threshold_s is not None
                    else None
                ),
                "windows": per_window,
                "budgetRemaining": round(self.budget_remaining(call), 4),
            }
        return {
            "enabled": self.enabled,
            "targets": [t.spec for t in self.targets],
            "windows": {name: span for name, span, _n in WINDOWS},
            "calls": calls,
        }


# --------------------------------------------------------------- capture
class WorkloadPlane:
    """The always-on workload-intelligence plane: one per serving front
    end, fed by the HTTP layer at every public query's settle point
    (``record``).  Owns the fingerprint cache, the heavy-hitter sketch
    + per-fingerprint stats, the sampled capture ring with optional
    durable spill, and the SLO engine."""

    def __init__(
        self,
        enabled: bool = True,
        capacity: int = 4096,
        sample_rate: float = 1.0,
        top_k: int = 64,
        capture_path: str | None = None,
        spill_max_bytes: int = 4_000_000,
        spill_max_age_s: float = 60.0,
        spill_segments: int = 8,
        slo_targets: "str | list[SLOTarget]" = "",
        stats=None,
        log: Callable[[str], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.enabled = bool(enabled)
        self.capacity = max(1, int(capacity))
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        # deterministic modulo sampling: every Nth query lands in the
        # ring/spill (sketch + SLO always observe).  Deliberately not
        # randomized — replays want contiguous slices of traffic, and a
        # strictly periodic client would alias identically either way.
        # N = ceil(1/rate): the EFFECTIVE rate (1/N, reported in
        # vars_snapshot) never exceeds the configured one — round()
        # would silently sample 100% for any rate above 2/3.
        self._sample_every = (
            math.ceil(1.0 / self.sample_rate) if self.sample_rate > 0 else 0
        )
        self.capture_path = capture_path or None
        self.spill_max_bytes = int(spill_max_bytes)
        self.spill_max_age_s = float(spill_max_age_s)
        self.spill_segments = max(1, int(spill_segments))
        self.stats = stats
        self.log = log
        self._clock = clock
        self.fingerprints = Fingerprinter()
        self.sketch = SpaceSaving(top_k)
        # the result cache's per-entry byte cap (wired by Server.open):
        # repeats whose results exceed it are NOT servable and must not
        # inflate the cachability estimate; 0 = no cap known
        self.cache_byte_cap = 0
        # aggregate measured cache serves (per-fingerprint counts live
        # on _FpStats; this counts hits for evicted/untracked fps too)
        self.cache_hits = 0
        self.slo = SLOEngine(slo_targets, stats=stats, clock=clock)
        self._lock = sanitize.make_lock("WorkloadPlane._lock", loop_safe=True)
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._fp_stats: dict[str, _FpStats] = {}
        self.observed = 0
        self.sampled = 0
        self.dropped = 0  # observed but not ring-sampled
        self._started = clock()
        # spill state: records buffer + segment bookkeeping.  A restart
        # RESUMES the segment sequence (scanning the capture dir) so a
        # fresh process never overwrites the previous run's segments,
        # and pre-existing segments count against the retention cap.
        self._spill_buf: list[str] = []
        self._spill_bytes = 0
        self._spill_opened = clock()
        self._spill_seq = 0
        self._spill_paths: deque[str] = deque()
        if self.capture_path is not None:
            try:
                existing = sorted(
                    f
                    for f in os.listdir(self.capture_path)
                    if re.fullmatch(r"workload-\d+\.jsonl", f)
                )
            except OSError:
                existing = []
            for f in existing:
                self._spill_paths.append(
                    os.path.join(self.capture_path, f)
                )
            if existing:
                self._spill_seq = int(existing[-1][len("workload-"):-len(".jsonl")])

    # ------------------------------------------------------------ intake
    def fingerprint(
        self, index: str, pql, shards: list[int] | None
    ) -> tuple[str, str]:
        return self.fingerprints.fingerprint(index, pql, shards)

    def rank(self, fp: str) -> int | None:
        return self.sketch.rank(fp)

    def record(
        self,
        index: str,
        pql: str,
        fp: str,
        call_type: str,
        seconds: float,
        status: int,
        nbytes: int,
        route: str | None = None,
        trace_id: str | None = None,
        stamp=None,
        arrival: float | None = None,
        shards: list[int] | None = None,
        spill: bool = True,
    ) -> None:
        """One settled public query.  ``stamp`` is the index's current
        view-version mutation stamp (API.mutation_stamp) — the
        cachability signal; ``arrival`` the request's arrival monotonic
        time (event front end), so replay spacing reflects offered
        load, not completion times; ``shards`` the request's explicit
        shard scope (part of the fingerprint identity — replay must
        re-issue the same scope, not an all-shards variant).
        ``spill=False`` skips the durable spill file alone (the event
        loop settles cache hits on the loop thread, where file I/O has
        no place); the ring, sketch, and stats always observe."""
        if not self.enabled:
            return
        error = status >= 400
        self.slo.observe(call_type, seconds, error)
        with self._lock:
            self.observed += 1
            n = self.observed
            # offer + stats maintenance are ONE atomic step under the
            # plane lock (the sketch's own lock nests inside — same
            # order everywhere): two settles racing eviction could
            # otherwise install stats for an already-evicted key,
            # leaking entries until the bound blocked all new stats
            evicted = self.sketch.offer(fp)
            if evicted is not None:
                self._fp_stats.pop(evicted, None)
            st = self._fp_stats.get(fp)
            if st is None:
                st = self._fp_stats[fp] = _FpStats(
                    index, call_type, pql[:_MAX_PQL]
                )
            st.observe(
                seconds, nbytes, error, stamp,
                byte_cap=self.cache_byte_cap,
            )
            take = self._sample_every > 0 and (n % self._sample_every == 0)
            if not take:
                self.dropped += 1
                rec = None
            else:
                self.sampled += 1
                rec = {
                    "t": round(
                        arrival if arrival is not None else self._clock(), 6
                    ),
                    "fp": fp,
                    "index": index,
                    "call": call_type,
                    "pql": pql[:_MAX_PQL],
                    "route": route,
                    "latencyS": round(seconds, 6),
                    "bytes": int(nbytes),
                    "status": int(status),
                    "traceId": trace_id,
                }
                if shards:
                    rec["shards"] = sorted(set(shards))
                self._ring.append(rec)
        if self.stats is not None:
            self.stats.count("workload_observed_total")
            if rec is not None:
                self.stats.count("workload_sampled_total")
        if rec is not None and spill and self.capture_path is not None:
            self._spill(rec)

    def record_cache_hit(self, fp: str) -> None:
        """One result-cache serve for this fingerprint — the MEASURED
        half of the estimate-vs-actual pair /debug/workload reports
        (``servableFraction`` vs ``actualHitFraction``)."""
        if not self.enabled:
            return
        # loop_safe: two counter bumps, no I/O under the lock;
        # registered loop_safe with the sanitizer (make_lock)
        with self._lock:  # pilosa: allow(loop-purity)
            self.cache_hits += 1
            st = self._fp_stats.get(fp)
            if st is not None:
                st.cache_hits += 1

    # -------------------------------------------------------------- spill
    def _spill(self, rec: dict) -> None:
        """Buffer one record; cut a segment when the buffer exceeds the
        size bound or the open segment exceeds the age bound.  Segments
        are whole JSONL files written atomically (utils/durable.py,
        best-effort — capture loss must never cost a query), oldest
        deleted past ``spill_segments``."""
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        flush = False
        with self._lock:
            if not self._spill_buf:
                # age is measured from the FIRST buffered record, not
                # the last flush — otherwise the first record after an
                # idle gap would instantly cut a one-record segment and
                # erode the retention window.  The age cut itself is
                # evaluated at record time (no timer thread): an idle
                # server's buffered tail flushes at close(), documented
                # as the capture's best-effort contract.
                self._spill_opened = self._clock()
            self._spill_buf.append(line)
            self._spill_bytes += len(line)
            age = self._clock() - self._spill_opened
            if (
                self._spill_bytes >= self.spill_max_bytes
                or age >= self.spill_max_age_s
            ):
                flush = True
        if flush:
            self.flush_spill()

    def flush_spill(self) -> None:
        """Cut the open spill segment (also called at close)."""
        if self.capture_path is None:
            return
        from pilosa_tpu_torch.utils import durable

        with self._lock:
            if not self._spill_buf:
                return
            body = "".join(self._spill_buf)
            self._spill_buf = []
            self._spill_bytes = 0
            self._spill_opened = self._clock()
            self._spill_seq += 1
            seq = self._spill_seq
        try:
            os.makedirs(self.capture_path, exist_ok=True)
            path = os.path.join(
                self.capture_path, f"workload-{seq:06d}.jsonl"
            )
            durable.atomic_write_file(
                path, body, op="workload-spill", durable=False
            )
            drops = []
            with self._lock:
                self._spill_paths.append(path)
                while len(self._spill_paths) > self.spill_segments:
                    drops.append(self._spill_paths.popleft())
                if self.stats is not None:
                    self.stats.gauge(
                        "workload_spill_segments",
                        float(len(self._spill_paths)),
                    )
            for drop in drops:
                os.remove(drop)
        except OSError as e:
            if self.log is not None:
                self.log(f"workload spill failed (capture lost): {e}")

    def close(self) -> None:
        self.flush_spill()

    # ------------------------------------------------------------ surface
    def capture_records(self) -> list[dict]:
        """The ring's records, oldest first (the ``format=capture``
        export replay consumes)."""
        with self._lock:
            return list(self._ring)

    def report(self, top: int = 20) -> dict:
        """The ``GET /debug/workload`` report: top-K heavy hitters with
        per-fingerprint stats and the cachability estimate."""
        now = self._clock()
        elapsed = max(1e-9, now - self._started)
        with self._lock:
            observed = self.observed
            fp_stats = dict(self._fp_stats)
            cache_hits = self.cache_hits
        entries = []
        servable = 0
        tracked_observed = 0
        tracked_hits = 0
        for i, (fp, count, err) in enumerate(self.sketch.top(top)):
            st = fp_stats.get(fp)
            entry = {
                "rank": i + 1,
                "fingerprint": fp,
                "estimatedCount": count,
                "maxOverestimate": err,
            }
            if st is not None:
                entry.update(st.to_json())
            entries.append(entry)
        for st in fp_stats.values():
            servable += st.unchanged_repeats
            tracked_observed += st.count
            tracked_hits += st.cache_hits
        return {
            "enabled": self.enabled,
            "observed": observed,
            "distinctTracked": len(self.sketch),
            "sketchK": self.sketch.k,
            "windowSeconds": round(elapsed, 3),
            "topK": entries,
            # what the ROADMAP-item-2 mutation-stamped result cache
            # would have served from cache, measured from observed
            # repeats whose view-version stamp was unchanged
            "cachability": {
                "servableRepeats": servable,
                "trackedObserved": tracked_observed,
                "servableFraction": round(
                    servable / max(1, tracked_observed), 4
                ),
                "servableQps": round(servable / elapsed, 3),
                # the MEASURED result-cache serves next to the estimate
                # above — estimator drift is the gap between these
                # (docs/result-cache.md); actualHits counts every hit,
                # actualHitFraction only tracked fingerprints so it is
                # comparable to servableFraction
                "actualHits": cache_hits,
                "actualHitFraction": round(
                    tracked_hits / max(1, tracked_observed), 4
                ),
                "cacheByteCap": self.cache_byte_cap or None,
            },
            "slo": {"enabled": self.slo.enabled},
        }

    def vars_snapshot(self) -> dict:
        """The /debug/vars ``workload`` section (capture-plane health;
        the analysis itself lives at /debug/workload)."""
        with self._lock:
            ring_depth = len(self._ring)
            observed = self.observed
            sampled = self.sampled
            dropped = self.dropped
            spill_segments = len(self._spill_paths)
            spill_pending = len(self._spill_buf)
        if self.stats is not None:
            self.stats.gauge(
                "workload_fingerprints_tracked", float(len(self.sketch))
            )
        return {
            "enabled": self.enabled,
            "captureRingDepth": ring_depth,
            "captureRingCapacity": self.capacity,
            "observed": observed,
            "sampled": sampled,
            "dropped": dropped,
            "sampleRate": self.sample_rate,
            # 1/N after the every-Nth quantization — what the ring
            # actually receives (never above the configured rate)
            "effectiveSampleRate": (
                1.0 / self._sample_every if self._sample_every else 0.0
            ),
            "sketchSize": len(self.sketch),
            "sketchK": self.sketch.k,
            "spillPath": self.capture_path,
            "spillSegments": spill_segments,
            "spillPendingRecords": spill_pending,
            "sloEnabled": self.slo.enabled,
        }


# ---------------------------------------------------------------- replay
def load_capture(path: str) -> list[dict]:
    """Capture records from one JSONL file or a directory of spill
    segments.  Records sort by arrival time WITHIN each file (settle
    order can lag arrival order under concurrency); files concatenate
    in segment-sequence order, never by timestamp — ``t`` is a
    monotonic stamp that restarts with the process, so a capture
    directory spanning a server restart must keep its boot-local
    timelines in segment order (replay clamps the negative jump at the
    boundary to a zero gap)."""
    paths = [path]
    if os.path.isdir(path):
        paths = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith(".jsonl")
        )
        if not paths:
            raise ValueError(f"no .jsonl capture segments under {path!r}")
    records = []
    for p in paths:
        with open(p) as f:
            chunk = [json.loads(ln) for ln in f if ln.strip()]
        chunk.sort(key=lambda r: r.get("t", 0.0))
        records.extend(chunk)
    if not records:
        raise ValueError(f"capture {path!r} holds no records")
    return records


def _arrival_gaps(records: list[dict]) -> list[float]:
    """Inter-arrival gaps with negative jumps (a server-restart
    boundary between monotonic timelines) clamped to zero."""
    out = [0.0]
    for prev, cur in zip(records, records[1:]):
        out.append(max(0.0, cur.get("t", 0.0) - prev.get("t", 0.0)))
    return out


def recorded_summary(records: list[dict]) -> dict:
    """Per-call-type recorded counts/QPS/latency from a capture — the
    reference half of the fidelity comparison."""
    span = max(1e-9, sum(_arrival_gaps(records)))
    per_call: dict[str, dict] = {}
    for r in records:
        c = per_call.setdefault(
            r.get("call", "?"),
            {"sent": 0, "errors": 0, "hist": Histogram()},
        )
        c["sent"] += 1
        if r.get("status", 200) >= 400:
            c["errors"] += 1
        c["hist"].observe(float(r.get("latencyS", 0.0)))
    out = {}
    for call, c in per_call.items():
        out[call] = {
            "sent": c["sent"],
            "share": round(c["sent"] / len(records), 4),
            "qps": round(c["sent"] / span, 3),
            "p50Ms": round(c["hist"].percentile(0.5) * 1e3, 3),
            "p95Ms": round(c["hist"].percentile(0.95) * 1e3, 3),
            "errors": c["errors"],
        }
    return {"records": len(records), "spanSeconds": round(span, 3),
            "perCall": out}


class _ReplayClient:
    """One keep-alive connection per replay worker thread."""

    def __init__(self, base_uri: str, timeout: float, ssl_context=None):
        import http.client
        from urllib.parse import urlsplit

        u = urlsplit(base_uri if "//" in base_uri else f"http://{base_uri}")
        if u.scheme == "https":
            # the caller's context carries --tls-skip-verify; default
            # verification otherwise
            self._make = lambda: http.client.HTTPSConnection(
                u.hostname, u.port, timeout=timeout, context=ssl_context
            )
        else:
            self._make = lambda: http.client.HTTPConnection(
                u.hostname, u.port, timeout=timeout
            )
        self._conn = self._make()

    def query(self, index: str, pql: str, shards=None) -> int:
        import http.client

        path = f"/index/{index}/query"
        if shards:
            path += "?shards=" + ",".join(map(str, shards))
        for attempt in (0, 1):
            try:
                self._conn.request("POST", path, pql.encode())
                resp = self._conn.getresponse()
                resp.read()
                return resp.status
            except (OSError, http.client.HTTPException):
                # one transparent redial: the server's keep-alive idle
                # reap between bursts is not a replay failure.
                # HTTPException too (BadStatusLine from a non-HTTP
                # endpoint) — it must surface as a transport failure,
                # not kill the worker thread
                self._conn.close()
                self._conn = self._make()
                if attempt:
                    raise
        return 0  # pragma: no cover — loop always returns/raises

    def close(self) -> None:
        self._conn.close()


def replay(
    records: list[dict],
    base_uri: str,
    speed: float = 1.0,
    qps: float | None = None,
    closed_loop: int | None = None,
    workers: int = 8,
    timeout: float = 30.0,
    ssl_context=None,
) -> dict:
    """Replay a captured workload against a live server.

    Pacing modes (docs/workload.md):
    - default: recorded arrival spacing, scaled by ``speed``;
    - ``qps``: uniform arrivals at a fixed rate;
    - ``closed_loop``: N clients issue back-to-back (throughput mode —
      spacing is discarded).

    Open-loop arrivals are served by a worker pool so one slow reply
    cannot stall the offered load behind it.  Returns a bench-row-
    shaped report: QPS, p50/p95, error rate, and the DIVERGENCE count —
    replayed queries whose HTTP status differed from the recorded one
    (a replay against drifted data or a broken build shows up here,
    not as a silently different bench number)."""
    if not records:
        raise ValueError("empty capture")
    if closed_loop:
        n_workers = max(1, int(closed_loop))
        due = None
    else:
        n_workers = max(1, min(int(workers), len(records)))
        if qps:
            due = [i / float(qps) for i in range(len(records))]
        else:
            sp = max(1e-6, float(speed))
            due, acc = [], 0.0
            for gap in _arrival_gaps(records):
                acc += gap / sp
                due.append(acc)

    lock = threading.Lock()
    next_i = [0]
    results: list[tuple[str, float, int, int]] = []  # call, lat, status, rec
    failures: list[str] = []
    start = time.monotonic()

    def run_one(client: _ReplayClient, rec: dict) -> None:
        import http.client

        t1 = time.perf_counter()
        try:
            status = client.query(
                rec.get("index", ""), rec.get("pql", ""),
                rec.get("shards"),
            )
        except (OSError, http.client.HTTPException) as e:
            with lock:
                failures.append(f"{type(e).__name__}: {e}")
            return
        lat = time.perf_counter() - t1
        with lock:
            results.append(
                (rec.get("call", "?"), lat, status,
                 int(rec.get("status", 200)))
            )

    def worker() -> None:
        client = _ReplayClient(base_uri, timeout, ssl_context)
        try:
            while True:
                with lock:
                    i = next_i[0]
                    if i >= len(records):
                        return
                    next_i[0] += 1
                if due is not None:
                    delay = start + due[i] - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                run_one(client, records[i])
        finally:
            client.close()

    threads = [
        threading.Thread(target=worker, daemon=True, name=f"replay-worker-{i}")
        for i in range(n_workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = max(1e-9, time.monotonic() - start)

    overall = Histogram()
    per_call: dict[str, dict] = {}
    errors = divergence = 0
    for call, lat, status, rec_status in results:
        overall.observe(lat)
        c = per_call.setdefault(
            call, {"sent": 0, "errors": 0, "divergence": 0,
                   "hist": Histogram()},
        )
        c["sent"] += 1
        c["hist"].observe(lat)
        if status >= 400:
            errors += 1
            c["errors"] += 1
        if status != rec_status:
            divergence += 1
            c["divergence"] += 1
    mode = (
        f"closed-loop:{closed_loop}" if closed_loop
        else (f"qps:{qps:g}" if qps else f"speed:{speed:g}")
    )
    return {
        "mode": mode,
        "records": len(records),
        "completed": len(results),
        "transportFailures": len(failures),
        "elapsedSeconds": round(elapsed, 3),
        "qps": round(len(results) / elapsed, 3),
        "p50Ms": round(overall.percentile(0.5) * 1e3, 3),
        "p95Ms": round(overall.percentile(0.95) * 1e3, 3),
        "errorRate": round(errors / max(1, len(results)), 6),
        "divergence": divergence,
        "perCall": {
            call: {
                "sent": c["sent"],
                "share": round(c["sent"] / max(1, len(results)), 4),
                "qps": round(c["sent"] / elapsed, 3),
                "p50Ms": round(c["hist"].percentile(0.5) * 1e3, 3),
                "p95Ms": round(c["hist"].percentile(0.95) * 1e3, 3),
                "errors": c["errors"],
                "divergence": c["divergence"],
            }
            for call, c in sorted(per_call.items())
        },
    }
