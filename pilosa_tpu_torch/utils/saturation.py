"""Saturation probes: which in-process resource binds, measured.

BENCH_SWEEP_r07's loudest signal — ``sync_count_qps_c64`` collapsing to
0.96x c1 after scaling to 1.76x at c32 — was *asserted* to be "one event
loop + one GIL-bound worker pool" with no measured evidence for which
resource actually binds.  This module is that evidence, USE-style
(utilization / saturation / errors), feeding ``GET /debug/saturation``:

- **event-loop lag** — a periodic callback scheduled on the asyncio loop
  (server/eventloop.py's lag-probe task) records how late each wakeup
  fires.  A loop busy parsing heads or shipping responses wakes late;
  the lag histogram IS the loop's run-queue delay.
- **worker-pool utilization** — the same probe task samples each
  admission class's in-flight/limit fraction, so "the query lane spent
  the window at 100%" is a measured p95, not a guess from one scrape.
- **GIL-contention estimator** — a dedicated probe thread performs a
  no-op timed wait and measures how late the wakeup lands.  The OS
  marks the thread runnable on time; everything past the timer is time
  spent waiting to be *scheduled onto the interpreter* — dominated by
  the GIL under CPU-bound Python load (plus a bounded OS-scheduler
  term).  It is an estimator, not a GIL timer: calibrate against the
  idle baseline the bench row records.
- **lock contention** — ``ContendedLock`` wraps the hot serving locks
  (fragment, stack-cache, scheduler, holder) with a fast-path
  nonblocking attempt; only a *contended* acquire pays timing and
  emits ``lock_wait_seconds{lock}`` / ``lock_contended_total{lock}``.

``SaturationMonitor.report`` normalizes each probe into a pressure in
[0, 1] and names the binding resource for the window — the number the
multi-process PR (ROADMAP item 3) is sized from.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable

# module-level metrics sink, installed by Server.open (the hot locks are
# constructed deep inside core/executor where no StatsClient is in
# scope; a process serves one metrics registry, like GLOBAL_TRACER)
_stats = None


def set_stats(client) -> None:
    global _stats
    _stats = client


# pressure normalization constants (docs/profiling.md): the lag value at
# which a probe reports pressure 1.0.  Loop wakeups and GIL handoffs are
# sub-millisecond healthy; ~100ms loop lag / ~50ms GIL wait at p99 mean
# the resource is the bottleneck, not a blip (the GIL constant is 10
# switch intervals at the default 5ms sys.setswitchinterval).
LOOP_LAG_SATURATED_S = 0.100
GIL_WAIT_SATURATED_S = 0.050
# a lock family accumulating >= this many seconds of waiting per
# wall-clock second means roughly one full thread is parked on it
LOCK_WAIT_SATURATED_PER_S = 1.0
# pressures below this never name a binding resource — an idle process
# must report "none", not whichever probe's noise floor is highest
BINDING_FLOOR = 0.5


class LagRing:
    """Bounded ring of (monotonic, value) observations with windowed
    percentiles — the storage behind every saturation probe.  Appends
    are GIL-atomic deque ops; the windowed read copies then filters, so
    probes never block on a reporting scrape."""

    __slots__ = ("_events", "maxlen")

    def __init__(self, maxlen: int = 4096):
        self.maxlen = maxlen
        self._events: deque[tuple[float, float]] = deque(maxlen=maxlen)

    def observe(self, value: float, t: float | None = None) -> None:
        self._events.append(
            (t if t is not None else time.monotonic(), value)
        )

    def window(self, seconds: float) -> dict:
        """{count, p50, p95, p99, max, mean} over the last ``seconds``."""
        cutoff = time.monotonic() - seconds
        values = sorted(v for t, v in list(self._events) if t >= cutoff)
        n = len(values)
        if n == 0:
            return {"count": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "max": 0.0, "mean": 0.0}
        return {
            "count": n,
            "p50": values[n // 2],
            "p95": values[min(n - 1, int(n * 0.95))],
            "p99": values[min(n - 1, int(n * 0.99))],
            "max": values[-1],
            "mean": sum(values) / n,
        }


class LockFamily:
    """Aggregate contention counters for one NAMED lock family (every
    fragment's lock folds into the one "fragment" row — per-instance
    rows would be unreadable and unbounded).  Counter updates are plain
    ``+=`` on the GIL: a racing pair can lose one increment, never
    corrupt the value — the monitoring tradeoff Ewma documents."""

    __slots__ = ("name", "acquisitions", "contended", "wait_total_s", "events")

    def __init__(self, name: str):
        self.name = name
        self.acquisitions = 0
        self.contended = 0
        self.wait_total_s = 0.0
        self.events = LagRing(maxlen=2048)

    def record_contended(self, wait_s: float) -> None:
        self.contended += 1
        self.wait_total_s += wait_s
        self.events.observe(wait_s)
        if _stats is not None:
            _stats.count("lock_contended_total", tags={"lock": self.name})
            _stats.timing("lock_wait_seconds", wait_s, tags={"lock": self.name})

    def snapshot(self, window_s: float) -> dict:
        cutoff = time.monotonic() - window_s
        recent = [(t, v) for t, v in list(self.events._events) if t >= cutoff]
        return {
            "acquisitions": self.acquisitions,
            "contendedTotal": self.contended,
            "waitSecondsTotal": round(self.wait_total_s, 6),
            "windowContended": len(recent),
            "windowWaitSeconds": round(sum(v for _, v in recent), 6),
        }


_FAMILIES: dict[str, LockFamily] = {}
_families_lock = threading.Lock()


def lock_family(name: str) -> LockFamily:
    with _families_lock:
        fam = _FAMILIES.get(name)
        if fam is None:
            fam = _FAMILIES[name] = LockFamily(name)
        return fam


def lock_families_snapshot(window_s: float = 60.0) -> dict:
    with _families_lock:
        fams = list(_FAMILIES.values())
    return {f.name: f.snapshot(window_s) for f in fams}


class ContendedLock:
    """Drop-in Lock/RLock with per-family contention accounting.

    The uncontended path costs ONE extra nonblocking attempt (no clock
    read, no metric); only an acquire that actually blocks pays two
    monotonic reads and the family record.  Implements the full context
    protocol plus ``acquire``/``release``, so ``threading.Condition``
    wraps it unmodified (Condition's default ``_is_owned`` probes via
    ``acquire(False)``, which the fast path serves)."""

    __slots__ = ("_lock", "family")

    def __init__(self, name: str, reentrant: bool = False):
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self.family = lock_family(name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):  # pilosa: allow(raw-acquire) — the
            # shim IS the guard: callers hold via with/try-finally
            self.family.acquisitions += 1
            return True
        if not blocking:
            return False
        t0 = time.monotonic()
        ok = self._lock.acquire(True, timeout)  # pilosa: allow(raw-acquire)
        if ok:
            # a timed-out acquire is NOT an acquisition and must not
            # charge its full timeout into the contention window — it
            # would inflate the saturation verdict with waits that
            # never turned into holds
            self.family.acquisitions += 1
            self.family.record_contended(time.monotonic() - t0)
        return ok

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "ContendedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self._lock.release()
        return False


class GILProbe:
    """The GIL-contention estimator: a daemon thread performing a no-op
    timed wait per tick and recording how far past the timer the wakeup
    actually lands.  The wait itself releases the GIL; re-entering the
    interpreter after the timeout requires re-acquiring it, so the
    overshoot is cross-thread scheduling delay — GIL wait plus a small
    OS-scheduler term."""

    def __init__(self, interval_s: float = 0.05, stats=None,
                 clock: Callable[[], float] = time.monotonic):
        self.interval_s = interval_s
        self.stats = stats
        self.lag = LagRing()
        self._clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="gil-probe"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # restartable: a later start() must spawn a fresh probe instead
        # of silently serving a frozen lag window
        self._thread = None
        self._stop = threading.Event()

    def _run(self) -> None:
        stop = self._stop  # the Event THIS run was started with
        while True:
            t0 = self._clock()
            if stop.wait(self.interval_s):
                return
            lag = max(0.0, self._clock() - t0 - self.interval_s)
            self.lag.observe(lag)
            if self.stats is not None:
                self.stats.timing("gil_wait_seconds", lag)


class SaturationMonitor:
    """One per serving front end: owns the GIL probe, receives the event
    loop's lag/utilization samples, and assembles the USE verdict.  The
    listener records into it from the loop; ``report`` is called from a
    handler thread — all storage is LagRing (lock-free enough)."""

    def __init__(self, stats=None, enabled: bool = True,
                 gil_interval_s: float = 0.05):
        self.stats = stats
        self.enabled = enabled
        self.loop_lag = LagRing()
        self.worker_util: dict[str, LagRing] = {}
        self.gil = GILProbe(interval_s=gil_interval_s, stats=stats)
        self._started = False

    def start(self) -> None:
        """Start the probe thread (Server.open; embedded listeners that
        never call this still serve loop-lag and lock rows)."""
        if self.enabled and not self._started:
            self._started = True
            self.gil.start()

    def stop(self) -> None:
        if self._started:
            self.gil.stop()
            self._started = False

    # ------------------------------------------------------------ intake
    def observe_loop_lag(self, lag_s: float) -> None:
        self.loop_lag.observe(lag_s)
        if self.stats is not None:
            self.stats.timing("eventloop_lag_seconds", lag_s)

    def observe_worker_util(self, cls: str, frac: float) -> None:
        ring = self.worker_util.get(cls)
        if ring is None:
            ring = self.worker_util[cls] = LagRing()
        ring.observe(frac)
        if self.stats is not None:
            self.stats.gauge("worker_utilization", frac, tags={"class": cls})

    # ------------------------------------------------------------ report
    def report(self, window_s: float = 60.0, serving: dict | None = None) -> dict:
        loop = self.loop_lag.window(window_s)
        gil = self.gil.lag.window(window_s)
        workers = {
            # snapshot first: the event-loop probe inserts the first
            # per-class rings concurrently with a scrape, and sorting a
            # growing dict raises RuntimeError
            cls: ring.window(window_s)
            for cls, ring in sorted(dict(self.worker_util).items())
        }
        locks = lock_families_snapshot(window_s)

        pressures: dict[str, float] = {}
        # worker-pool pressure: the QUERY lane's p95 sampled utilization
        # (the lane serving the sweep; write/control lanes report but a
        # saturated control lane is a different disease)
        q = workers.get("query")
        if q is not None and q["count"] > 0:
            pressures["worker-pool"] = min(1.0, q["p95"])
        if loop["count"] > 0:
            pressures["event-loop"] = min(
                1.0, loop["p99"] / LOOP_LAG_SATURATED_S
            )
        if gil["count"] > 0:
            pressures["gil"] = min(1.0, gil["p99"] / GIL_WAIT_SATURATED_S)
        for name, row in locks.items():
            if row["windowContended"]:
                pressures[f"lock:{name}"] = min(
                    1.0,
                    row["windowWaitSeconds"]
                    / max(window_s, 1e-9)
                    / LOCK_WAIT_SATURATED_PER_S,
                )

        binding = "none"
        if pressures:
            top = max(pressures, key=lambda k: pressures[k])
            if pressures[top] >= BINDING_FLOOR:
                binding = top
        verdict = (
            "no probe reports saturation over the window"
            if binding == "none"
            else f"{binding} is the binding resource "
                 f"(pressure {pressures[binding]:.2f})"
        )
        # scale-out recommendation (docs/multiprocess.md): worker-pool
        # and GIL pressure are PER-INTERPRETER ceilings — more threads
        # cannot help, more processes can.  Name the remedy and size it
        # from the host's cores; on a core-starved box the suggestion
        # is recorded but waived, since N processes would time-share
        # the same core (the bench's MULTICHIP_r06 waiver precedent).
        recommendation = None
        if binding in ("worker-pool", "gil"):
            cores = os.cpu_count() or 1
            recommendation = {
                "remedy": "serving-processes",
                "why": (
                    f"{binding} saturation is per-process: N shard-"
                    "owning server processes multiply both lanes "
                    "(docs/multiprocess.md)"
                ),
                "hostCores": cores,
                "suggestedProcesses": max(2, min(cores, 8)),
            }
            if cores < 2:
                recommendation["gate"] = (
                    f"waived: {cores} core — serving processes would "
                    "time-share it; the remedy applies on a multi-core "
                    "host"
                )
        ms = lambda s: round(s * 1e3, 3)
        out = {
            "enabled": self.enabled,
            "probesStarted": self._started,
            "windowSeconds": window_s,
            "eventLoop": {
                "samples": loop["count"],
                "lagP50Ms": ms(loop["p50"]),
                "lagP99Ms": ms(loop["p99"]),
                "lagMaxMs": ms(loop["max"]),
            },
            "gil": {
                "samples": gil["count"],
                "probeIntervalMs": ms(self.gil.interval_s),
                "waitP50Ms": ms(gil["p50"]),
                "waitP99Ms": ms(gil["p99"]),
                "waitMaxMs": ms(gil["max"]),
            },
            "workers": {
                cls: {
                    "samples": w["count"],
                    "utilizationP50": round(w["p50"], 4),
                    "utilizationP95": round(w["p95"], 4),
                    "utilizationMax": round(w["max"], 4),
                }
                for cls, w in workers.items()
            },
            "locks": locks,
            "serving": serving or {},
            "pressures": {k: round(v, 4) for k, v in sorted(pressures.items())},
            "binding": binding,
            "verdict": verdict,
        }
        if recommendation is not None:
            out["recommendation"] = recommendation
        return out


# ------------------------------------------------------------- process RSS
def rss_bytes() -> int | None:
    """Resident set size of this process, or None when unreadable."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        # ru_maxrss is KiB on Linux, bytes on macOS — and a PEAK, not
        # current; the /proc path above is authoritative where it exists
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except (ImportError, OSError, ValueError):
        return None


def memory_limit_bytes() -> int | None:
    """The cgroup memory ceiling this process runs under, if any."""
    for path in (
        "/sys/fs/cgroup/memory.max",  # cgroup v2
        "/sys/fs/cgroup/memory/memory.limit_in_bytes",  # cgroup v1
    ):
        try:
            with open(path) as f:
                raw = f.read().strip()
            if raw and raw != "max":
                limit = int(raw)
                # v1 reports "unlimited" as a huge page-rounded number
                if limit < (1 << 60):
                    return limit
        except (OSError, ValueError):
            continue
    return None
