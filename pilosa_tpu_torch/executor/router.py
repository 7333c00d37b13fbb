"""Cost-based host/device query routing.

The north star is "as fast as the hardware allows" — which includes the
HOST hardware.  The device path pays a fixed dispatch + readback
overhead per sync query, which dominates small queries, while the
host path pays none but
scans at host memory bandwidth.  Per call, the router estimates work
(words the query touches, from fragment metadata already on hand) and
compares the two cost models:

    host_cost(w)   = host_overhead + w / host_wps
    device_cost(w) = dispatch + readback + w / device_wps

The crossover is ONLINE-CALIBRATED: ``dispatch`` and ``readback`` are
EWMAs over the MEDIANS of the router's own log-bucketed histograms of
measured per-call dispatch times and readback waves (the same
observation points the ``executor_call_seconds`` /
``executor_readback_seconds`` histograms record); in addition,
``refresh_from_stats`` periodically folds the live
``executor_readback_seconds`` registry p50 back in — that histogram is
device-only, so an executor restarted onto a warm stats registry
re-seeds its readback estimate from history (dispatch restarts from the
config seed: the registry has no device-only dispatch series);
``host_wps`` seeds from a one-shot microcalibration at first use and is
refined from every host-path call.  ``device_wps`` is a configured
roofline seed — device compute overlaps dispatch, so it is not
separately observable per call and only matters far above the
crossover, where the decision is not close.

Decisions are memoized per plan key (the call's structural repr + shard
count) and invalidated when calibration drifts: every parameter keeps a
snapshot of the value its current memo generation was computed with,
and a >25% move bumps the generation, emptying the memo lazily.

``mode`` pins the answer: "host" / "device" force every read down one
path ("host" is also what the server pins when the device probe fails —
the degraded engine); "auto" is the cost model.  All time sources are
injectable (``clock``) so tests drive calibration deterministically.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

import numpy as np

from pilosa_tpu_torch.utils import sanitize

from pilosa_tpu_torch.core import FIELD_INT, VIEW_STANDARD
from pilosa_tpu_torch.pql import Call
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD
from pilosa_tpu_torch.utils.stats import DEFAULT_BUCKETS, Ewma, Histogram

ROUTE_MODES = ("auto", "host", "device", "mesh")

# measured cost must exceed another candidate's ESTIMATE by this factor
# before the settle-time audit calls the decision a misroute — the
# estimates are models, and flagging every sub-2x disagreement would
# alert on noise instead of calibration drift
_MISROUTE_MARGIN = 2.0


class RouterAudit:
    """Settle-time scoring of routing decisions against measured
    reality (PIMDAL's operator-level cost accounting, arXiv 2504.01948,
    is the shape: every operator's estimate is compared with its
    measured cost so a drifting model is a signal, not a mystery).

    At dispatch the executor snapshots the cost estimates for EVERY
    candidate path; at settle (host calls immediately, device/mesh
    calls when their readback wave lands) the measured cost scores the
    chosen route:

    - ``router_estimate_error_ratio`` histogram per path — measured /
      estimated for the chosen route (1.0 = perfectly calibrated);
    - ``router_misroute_total{chosen,better}`` — settled calls whose
      measured cost exceeded another candidate's estimate by the
      misroute margin: the model said "chosen is cheapest" and reality
      disagreed by enough to have changed the decision;
    - the ``/debug/vars`` ``routerAudit`` section — per-path sample
      counts, error-ratio EWMAs and quantiles, and the misroute matrix,
      so a mis-calibrated crossover is an alertable drift signal
      instead of a silent regression.

    Lives on the QueryRouter so calibration history survives executor
    rebuilds (the late mesh attach) exactly like the EWMAs do."""

    def __init__(self, stats=None, enabled: bool = True, alpha: float = 0.1):
        self.stats = stats
        self.enabled = bool(enabled)
        self._lock = sanitize.make_lock("RouterAudit._lock")
        self._ratio_hists: dict[str, Histogram] = {}
        self._ratio_ewmas: dict[str, Ewma] = {}
        self._samples: dict[str, int] = {}
        self._misroutes: dict[tuple[str, str], int] = {}
        self._alpha = alpha

    def record(
        self, route: str, estimates: dict, measured_s: float
    ) -> None:
        """Score one settled call: ``estimates`` maps every candidate
        path to its modeled cost in seconds at decision time;
        ``measured_s`` is what the chosen ``route`` actually cost."""
        if not self.enabled or measured_s <= 0:
            return
        est = estimates.get(route)
        if not est or est <= 0:
            return
        ratio = measured_s / est
        with self._lock:
            hist = self._ratio_hists.get(route)
            if hist is None:
                hist = self._ratio_hists[route] = Histogram()
            ewma = self._ratio_ewmas.get(route)
            if ewma is None:
                ewma = self._ratio_ewmas[route] = Ewma(self._alpha)
            self._samples[route] = self._samples.get(route, 0) + 1
        hist.observe(ratio)
        ewma.update(ratio)
        if self.stats is not None:
            self.stats.observe(
                "router_estimate_error_ratio",
                ratio,
                tags={"path": route},
                buckets=DEFAULT_BUCKETS,
            )
        # misroute check: another candidate's ESTIMATE undercuts what
        # the chosen path measurably cost, by enough margin that the
        # router would have decided differently had it known
        better, best_est = None, None
        for path, e in estimates.items():
            if path == route or e is None or e <= 0:
                continue
            if best_est is None or e < best_est:
                better, best_est = path, e
        if better is not None and measured_s > best_est * _MISROUTE_MARGIN:
            with self._lock:
                key = (route, better)
                self._misroutes[key] = self._misroutes.get(key, 0) + 1
            if self.stats is not None:
                self.stats.count(
                    "router_misroute_total",
                    tags={"chosen": route, "better": better},
                )

    def snapshot(self) -> dict:
        """The ``/debug/vars`` ``routerAudit`` section."""
        with self._lock:
            samples = dict(self._samples)
            misroutes = dict(self._misroutes)
            hists = dict(self._ratio_hists)
            ewmas = {k: e.value for k, e in self._ratio_ewmas.items()}
        per_path = {}
        for path, n in samples.items():
            h = hists.get(path)
            per_path[path] = {
                "samples": n,
                # the drift signal: sustained departure from 1.0 means
                # this path's cost model no longer matches reality
                "errorRatioEwma": ewmas.get(path),
                "errorRatioP50": h.percentile(0.5) if h is not None else None,
                "errorRatioP95": h.percentile(0.95) if h is not None else None,
            }
        return {
            "enabled": self.enabled,
            "misrouteMargin": _MISROUTE_MARGIN,
            "perPath": per_path,
            "misroutes": [
                {"chosen": c, "better": b, "count": n}
                for (c, b), n in sorted(misroutes.items())
            ],
            "misrouteTotal": sum(misroutes.values()),
        }

# calibration drift that invalidates memoized decisions
_DRIFT = 0.25
# fold the live histograms back into the EWMAs every N observations
_STATS_REFRESH_EVERY = 256


class QueryRouter:
    """One router per Executor; shared across its threads."""

    def __init__(
        self,
        mode: str | None = None,
        stats=None,
        clock: Callable[[], float] = time.perf_counter,
        # seeds from chip_smoke.py's "router calibration" line on an
        # NVIDIA H100 80GB HBM3 (700 W) at 10,240 shards: the EWMAs after
        # its main path (2.356 ms, 2.193 ms). The online calibration
        # replaces them.
        dispatch_seed_s: float = 2.356e-3,
        readback_seed_s: float = 2.193e-3,
        device_wps: float = 25e9,
        host_wps: float | None = None,
        crossover_words: float = 0.0,
        alpha: float = 0.3,
        mesh_dispatch_seed_s: float = 2e-3,
        mesh_readback_seed_s: float = 2e-3,
        audit_enabled: bool = True,
    ):
        if mode is None:
            mode = os.environ.get("PILOSA_TPU_ROUTE_MODE", "") or "auto"
        if mode not in ROUTE_MODES:
            raise ValueError(
                f"route-mode must be one of {ROUTE_MODES}, got {mode!r}"
            )
        self.mode = mode
        self.stats = stats
        self._clock = clock
        self.dispatch_s = Ewma(alpha, dispatch_seed_s)
        self.readback_s = Ewma(alpha, readback_seed_s)
        self.host_overhead_s = Ewma(alpha, 20e-6)
        self.device_wps = float(device_wps)
        self.host_wps = Ewma(alpha, host_wps) if host_wps else Ewma(alpha)
        # >0 pins the crossover (config route-crossover-words); 0 = derived
        # raw device samples land in log-bucketed histograms and the
        # EWMAs track the histogram P50s, not the samples themselves: a
        # first-call COMPILE spike (seconds, vs ms of steady dispatch)
        # lands in the p99 tail and barely moves the median, so one cold
        # query cannot flip every subsequent routing decision
        self._dispatch_hist = Histogram()
        self._readback_hist = Histogram()
        # third path: explicit-SPMD mesh programs (docs/spmd.md). Its
        # own dispatch/readback EWMAs — shard_map programs pay different
        # issue overhead than single-program jit (collective setup) and
        # their readbacks gather replicated results — and a device-count
        # throughput multiplier: the per-word scan rate scales with the
        # chips actually working the query. mesh_devices stays 1 until a
        # MeshContext attaches (Executor/API set it), which disables the
        # mesh path entirely.
        self.mesh_devices = 1
        self.mesh_dispatch_s = Ewma(alpha, mesh_dispatch_seed_s)
        self.mesh_readback_s = Ewma(alpha, mesh_readback_seed_s)
        self._mesh_dispatch_hist = Histogram()
        self._mesh_readback_hist = Histogram()
        # cross-query wave occupancy (executor/scheduler.py feeds it):
        # when concurrent sync queries share readback waves, the per-
        # query device overhead is the wave total divided by occupancy —
        # without this the cost model keeps charging every query a full
        # dispatch+readback and over-routes to the host exactly when the
        # device path got cheap. Seeded at 1.0 (no sharing), so solo
        # traffic and batch-mode=off see the unamortized model unchanged.
        self.wave_occupancy = Ewma(alpha, 1.0)
        self.crossover_override = float(crossover_words)
        self._lock = sanitize.make_lock("QueryRouter._lock")
        self._memo: dict[tuple, tuple[int, str]] = {}
        self._gen = 0
        # drift baselines start at the seeds: the FIRST observation that
        # contradicts a seed by >25% must already invalidate memoized
        # decisions (they were computed against the seed)
        self._snapshots: dict[str, float] = {
            "dispatch": self.dispatch_s.value,
            "readback": self.readback_s.value,
            "host_overhead": self.host_overhead_s.value,
            "wave_occupancy": self.wave_occupancy.value,
            "mesh_dispatch": self.mesh_dispatch_s.value,
            "mesh_readback": self.mesh_readback_s.value,
        }
        if self.host_wps.value is not None:
            self._snapshots["host_wps"] = self.host_wps.value
        self._observes = 0
        # host_unported: host decisions (also counted under host) that
        # auto routing made because the call has no CUDA path yet
        self.decisions = {"host": 0, "device": 0, "mesh": 0, "host_unported": 0}
        # settle-time decision audit (docs/query-routing.md): lives here
        # so its history survives executor rebuilds like the EWMAs do
        self.audit = RouterAudit(stats=stats, enabled=audit_enabled)

    # ----------------------------------------------------------- calibration
    def _calibrate_host(self) -> float:
        """Measured host popcount throughput (words/s) over a ~1 MiB
        sample — microseconds of work, run once lazily so constructing a
        router (server boot) costs nothing."""
        n = 1 << 18
        a = np.ones(n, dtype=np.uint32)
        b = np.ones(n, dtype=np.uint32)
        best = float("inf")
        for _ in range(3):
            t0 = self._clock()
            int(np.bitwise_count(a & b).sum())
            best = min(best, self._clock() - t0)
        # the sample touches 2n words (two operands)
        return 2 * n / max(best, 1e-9)

    def _host_wps(self) -> float:
        v = self.host_wps.value
        if v is None:
            v = self.host_wps.update(self._calibrate_host())
            self._note_drift("host_wps", v)
        return v

    def observe(self, route: str, work_words: int, seconds: float) -> None:
        """Fold one executed call's measurement into the model.  Device
        observations are DISPATCH times (the async issue cost — device
        compute overlaps); the readback wave reports separately."""
        if seconds <= 0:
            return
        if route == "host":
            base = self._host_wps()
            if work_words >= 1 << 16:
                # clamp cold outliers: a first-touch stack build makes a
                # large call look 10-100x slower than the engine's real
                # throughput, and one unclamped fold would flip routing
                # back to the device until warm samples recover. A
                # genuine sustained slowdown still converges — every
                # sample may pull the estimate down by up to 4x.
                wps = max(work_words / seconds, base / 4)
                self._note_drift("host_wps", self.host_wps.update(wps))
            else:
                overhead = max(0.0, seconds - work_words / base)
                # steady-state host overhead is dict lookups + scratch
                # reuse — tens of microseconds by construction. An
                # ms-scale sample is a COLD call (first-touch stack
                # build, import), and folding it in once measurably
                # flipped the very next small query to the device path;
                # cold costs amortize, so they don't belong in the
                # per-call overhead term.
                if overhead < 1e-3:
                    self._note_drift(
                        "host_overhead", self.host_overhead_s.update(overhead)
                    )
        elif route == "device":
            self._dispatch_hist.observe(seconds)
            self._note_drift(
                "dispatch",
                self.dispatch_s.update(self._dispatch_hist.percentile(0.5)),
            )
        elif route == "mesh":
            self._mesh_dispatch_hist.observe(seconds)
            self._note_drift(
                "mesh_dispatch",
                self.mesh_dispatch_s.update(
                    self._mesh_dispatch_hist.percentile(0.5)
                ),
            )
        self._bump_observes()

    def observe_wave(self, queries: int) -> None:
        """Fold one wave's occupancy (queries sharing a readback) into
        the model; >25% drift re-evaluates memoized route decisions the
        same way a dispatch/readback move does."""
        if queries < 1:
            return
        self._note_drift(
            "wave_occupancy", self.wave_occupancy.update(float(queries))
        )

    def observe_readback(self, seconds: float, path: str = "device") -> None:
        if seconds <= 0:
            return
        if path == "mesh":
            self._mesh_readback_hist.observe(seconds)
            self._note_drift(
                "mesh_readback",
                self.mesh_readback_s.update(
                    self._mesh_readback_hist.percentile(0.5)
                ),
            )
            self._bump_observes()
            return
        self._readback_hist.observe(seconds)
        self._note_drift(
            "readback",
            self.readback_s.update(self._readback_hist.percentile(0.5)),
        )
        self._bump_observes()

    def _bump_observes(self) -> None:
        self._observes += 1
        if self.stats is not None and self._observes % _STATS_REFRESH_EVERY == 0:
            self.refresh_from_stats()

    def refresh_from_stats(self) -> None:
        """EWMA-fold the live ``executor_readback_seconds`` histogram
        p50 (utils/stats.py) back into the model — the registry
        outlives any one executor (mesh re-attach rebuilds the Executor
        but keeps the StatsClient), so the readback estimate survives
        engine swaps.  Readback is the only registry series that is
        device-only; ``executor_call_seconds`` mixes both routes, so
        dispatch calibrates purely from this router's own samples."""
        if self.stats is None:
            return
        h = self.stats.histogram("executor_readback_seconds")
        if h is not None and h.count:
            self._note_drift(
                "readback", self.readback_s.update(h.percentile(0.5))
            )

    def _note_drift(self, name: str, value: float) -> None:
        snap = self._snapshots.get(name)
        if snap is None:
            self._snapshots[name] = value
            return
        if abs(value - snap) > _DRIFT * max(snap, 1e-12):
            with self._lock:
                self._snapshots[name] = value
                self._gen += 1
                self._memo.clear()

    # -------------------------------------------------------------- decision
    def host_cost(self, work_words: float) -> float:
        return self.host_overhead_s.value + work_words / self._host_wps()

    def device_cost(self, work_words: float) -> float:
        # batch-aware: the wave scheduler shares ONE readback across a
        # wave, so the per-query readback cost is the wave total over
        # occupancy. Dispatch is NOT amortized — wave-mates' dispatches
        # issue serially on the leader thread, so each query still pays
        # its own (dividing it too would undercharge the device path
        # under load and flip small host-cheap queries back to the
        # device). Occupancy 1 (solo traffic,
        # batch-mode off) reduces to the plain model.
        occ = max(1.0, self.wave_occupancy.value or 1.0)
        return (
            self.dispatch_s.value
            + self.readback_s.value / occ
            + work_words / self.device_wps
        )

    def mesh_cost(self, work_words: float) -> float:
        """Explicit-SPMD path: its own measured dispatch/readback EWMAs,
        and the scan term divided by the device count — the mesh's whole
        point is that every chip reads a disjoint slice of the words.
        The readback amortizes over wave occupancy exactly like the
        device path (mesh pendings ride the same waves)."""
        occ = max(1.0, self.wave_occupancy.value or 1.0)
        return (
            self.mesh_dispatch_s.value
            + self.mesh_readback_s.value / occ
            + work_words / (self.device_wps * max(1, self.mesh_devices))
        )

    def crossover_words(self) -> float:
        """Work level where the two cost curves meet — the calibrated
        crossover the profile/debug surfaces report."""
        if self.crossover_override > 0:
            return self.crossover_override
        occ = max(1.0, self.wave_occupancy.value or 1.0)
        overhead = (
            self.dispatch_s.value
            + self.readback_s.value / occ
            - self.host_overhead_s.value
        )
        per_word = 1.0 / self._host_wps() - 1.0 / self.device_wps
        if per_word <= 0:
            return float("inf")  # host never slower per word: always host
        return max(0.0, overhead) / per_word

    def decide(
        self,
        key: tuple,
        work_words: int,
        mesh_ok: bool = False,
        device_extra_words: int = 0,
    ) -> str:
        if self.mode != "auto":
            return self.mode
        mesh_ok = mesh_ok and self.mesh_devices > 1
        # the work estimate is part of the memo identity (bucketed by
        # power of two): the same plan over grown data must re-evaluate
        # even when calibration hasn't drifted. mesh_ok joins the key —
        # the same plan may be mesh-eligible on one shard subset and not
        # another (divisibility), and the memo must not cross them.
        # device_extra_words (tiered residency: cold-row upload traffic
        # only the device path pays) joins bucketed too — the same plan
        # re-evaluates as its working set warms.
        key = key + (
            int(work_words).bit_length(),
            mesh_ok,
            int(device_extra_words).bit_length(),
        )
        memo = self._memo.get(key)
        if memo is not None and memo[0] == self._gen:
            return memo[1]
        # cold tiered rows are packed at HOST scan speed and uploaded
        # before the device program can run — charge the device (and
        # mesh) route that host-side time on top of its own model
        extra_s = (
            device_extra_words / self._host_wps() if device_extra_words else 0.0
        )
        if self.crossover_override > 0:
            route = (
                "host" if work_words <= self.crossover_override else "device"
            )
            if route == "device" and mesh_ok and self.mesh_cost(
                work_words
            ) < self.device_cost(work_words):
                route = "mesh"
        else:
            costs = [
                (self.host_cost(work_words), "host"),
                (self.device_cost(work_words) + extra_s, "device"),
            ]
            if mesh_ok:
                costs.append((self.mesh_cost(work_words) + extra_s, "mesh"))
            # stable min: ties keep the earlier (host-first) entry, so
            # the pre-mesh host/device behavior is unchanged bit for bit
            route = min(costs, key=lambda cr: cr[0])[1]
        with self._lock:
            if len(self._memo) >= 4096:
                self._memo.clear()
            self._memo[key] = (self._gen, route)
        return route

    def record(self, route: str) -> None:
        self.decisions[route] = self.decisions.get(route, 0) + 1

    def pin_host(self) -> None:
        """Degrade to the host engine (device probe failed / CPU pin).
        An explicit configured mode wins; only auto degrades."""
        if self.mode == "auto":
            self.mode = "host"
            with self._lock:
                self._gen += 1
                self._memo.clear()

    def snapshot(self) -> dict:
        """Observability view for /debug/vars and ?profile=true."""
        return {
            "mode": self.mode,
            "crossoverWords": self.crossover_words(),
            "dispatchSeconds": self.dispatch_s.value,
            "readbackSeconds": self.readback_s.value,
            "hostOverheadSeconds": self.host_overhead_s.value,
            "hostWordsPerSecond": self.host_wps.value,
            "deviceWordsPerSecond": self.device_wps,
            "waveOccupancy": self.wave_occupancy.value,
            "meshDevices": self.mesh_devices,
            "meshDispatchSeconds": self.mesh_dispatch_s.value,
            "meshReadbackSeconds": self.mesh_readback_s.value,
            "decisions": dict(self.decisions),
        }


# --------------------------------------------------------- work estimation
def estimate_words(idx, call: Call, n_shards: int) -> int:
    """Words of packed-bitmap traffic the call will read — from schema
    and fragment metadata already on hand (no data access).  The unit is
    one [S, W] row plane; BSI reads count their full slice block."""
    unit = max(1, n_shards) * WORDS_PER_SHARD
    return _est(idx, call, unit)


def _field_depth(idx, name: str | None) -> int:
    f = idx.field(name) if name else None
    if f is None or f.options.field_type != FIELD_INT:
        return 8
    return 2 + f.bit_depth


def _field_rows(idx, name: str | None) -> int:
    f = idx.field(name) if name else None
    if f is None:
        return 1
    view = f.view(VIEW_STANDARD)
    if view is None:
        return 1
    n = 1
    for frag in view.fragments.values():
        n = max(n, frag.n_rows())
    return n


def _call_field_name(call: Call) -> str | None:
    fname = call.arg("field")
    if fname is None and call.pos_args:
        fname = call.pos_args[0]
    return fname if isinstance(fname, str) else None


def _est(idx, call: Call, unit: int) -> int:
    name = call.name
    if name == "Options" and call.children:
        return _est(idx, call.children[0], unit)
    if name in ("Row", "Range"):
        cond = call.condition()
        if cond is not None:
            return _field_depth(idx, cond[0]) * unit
        return unit
    if name in ("Union", "Intersect", "Difference", "Xor"):
        return sum(_est(idx, ch, unit) for ch in call.children) or unit
    if name in ("Not", "All"):
        return unit + sum(_est(idx, ch, unit) for ch in call.children)
    if name in ("Count", "IncludesColumn", "Shift"):
        return sum(_est(idx, ch, unit) for ch in call.children) or unit
    if name in ("Sum", "Min", "Max"):
        depth = _field_depth(idx, _call_field_name(call))
        return depth * unit + sum(_est(idx, ch, unit) for ch in call.children)
    if name == "TopN":
        ids = call.arg("ids")
        rows = len(ids) if ids else _field_rows(idx, _call_field_name(call))
        return rows * unit + sum(_est(idx, ch, unit) for ch in call.children)
    if name == "GroupBy":
        # Σ over levels of (groups so far × candidate rows) pair planes,
        # times the passes each pair actually costs: the count pass reads
        # mask + row and the surviving pairs materialize their masks for
        # the next level — ~4 plane touches per pair, not 1 (estimating 1
        # made a pod-scale GroupBy look host-cheap and routed it below
        # the device fused path; measured 2026-08-03)
        total, groups = 0, 1
        for ch in call.children:
            ids = ch.arg("ids")
            rows = (
                len(ids) if ids else _field_rows(idx, _call_field_name(ch))
            )
            rlimit = ch.arg("limit")
            if rlimit is not None:
                rows = min(rows, rlimit)
            rows = max(1, rows)
            total += 4 * groups * rows
            groups *= rows
        agg = call.arg("aggregate")
        if isinstance(agg, Call):
            total += groups * _field_depth(idx, _call_field_name(agg))
        filt = call.arg("filter")
        extra = _est(idx, filt, unit) if isinstance(filt, Call) else 0
        return total * unit + extra
    # unknown / metadata-only calls: one plane
    return unit
