"""Always-on continuous sampling profiler: flame graphs one curl away.

``utils/profiling.py``'s ``sample_profile`` answers "what is the process
doing for the NEXT five seconds" — useless for the p99 spike that
already happened.  This module keeps a background sampler running for
the life of the server (config ``profiler-enabled``), aggregating
``sys._current_frames()`` samples into a bounded folded-stack table
held as a ring of rotating time segments, so ``GET /debug/profile``
serves a flame graph of the last minute (or any retained historical
segment) instantly — nothing to arm in advance, same philosophy as the
flight recorder's tail-based retention.

Design constraints, in order:

- **Bounded overhead.**  The c1 p50 gate is ≤1.03x with the sampler on
  (make bench-profile).  Two levers: low default rate (20 Hz — a 60 s
  segment still lands ~1200 samples), and a folded-stack CACHE keyed on
  the top frame object — a parked thread's stack is the *same frame
  objects* every sample, so the steady-state cost per idle thread is
  one dict lookup, not a frame walk.
- **Bounded memory.**  Each segment caps distinct stacks at
  ``max_stacks`` (overflow folds into ``<subsystem>;(other)``) and the
  ring caps retained segments; memory is O(segments × max_stacks).
- **Attribution by subsystem.**  Stacks are rooted at the sampled
  thread's NAME with trailing pool indices stripped ("http-worker_3" →
  "http-worker"), so the flame graph reads per subsystem — which is why
  every background thread in the package is named at spawn.

Formats: folded text (``stack count`` lines, flamegraph.pl /
inferno-ready) and speedscope JSON (https://speedscope.app), plus a
segment index for the historical ring.  The flight recorder stamps each
retained query with the segment ids overlapping its wall-clock window,
linking a slow query straight to the flame graph that contains it.
"""

from __future__ import annotations

import re
import sys
import threading
import time
from typing import Callable

from pilosa_tpu_torch.utils.profiling import _folded

# "http-worker_3" / "compactor-1" → "http-worker" / "compactor": pool
# members fold into one subsystem root
_POOL_SUFFIX = re.compile(r"[-_]\d+$")


def subsystem_of(thread_name: str) -> str:
    return _POOL_SUFFIX.sub("", thread_name) or thread_name


class _Segment:
    __slots__ = ("id", "start", "end", "samples", "counts")

    def __init__(self, seg_id: int, start: float):
        self.id = seg_id
        self.start = start
        self.end: float | None = None  # None while current
        self.samples = 0
        self.counts: dict[str, int] = {}

    def info(self) -> dict:
        return {
            "id": self.id,
            "startMonotonicS": self.start,
            "endMonotonicS": self.end,
            "samples": self.samples,
            "stacks": len(self.counts),
        }


class SamplingProfiler:
    """The background sampler + segment ring.  One instance per server
    process (Server.open constructs it from config and hands it to the
    listener for ``/debug/profile``)."""

    def __init__(
        self,
        hz: float = 20.0,
        segment_s: float = 60.0,
        segments: int = 16,
        max_stacks: int = 4096,
        stats=None,
        enabled: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.hz = max(1.0, min(float(hz), 250.0))
        self.segment_s = max(1.0, float(segment_s))
        self.max_stacks = max(16, int(max_stacks))
        self.enabled = bool(enabled)
        self.stats = stats
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: list[_Segment] = []
        self._ring_cap = max(1, int(segments))
        self._seq = 0
        self._current = _Segment(self._seq, self._clock())
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # folded-stack cache keyed on the top AND caller frame identity
        # (tid, id(frame), f_lasti, id(f_back), back f_lasti).  A parked
        # thread re-presents the identical frame objects every sample;
        # the hit turns its per-sample cost into a dict lookup.  The
        # caller frame is in the key because frame objects are
        # freelisted: a dead leaf frame's address can be recycled by a
        # NEW frame parked at the same f_lasti (every parked thread
        # leads in threading.wait), and the leaf identity alone would
        # then misattribute the whole stack until the cache cleared.
        self._folded_cache: dict[tuple, str] = {}
        self._names: dict[int, str] = {}

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        # restartable: stop() left _stop set; a reused flag would make
        # the new sampler exit on its first wait
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="profiler"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        interval = 1.0 / self.hz
        stop = self._stop  # the Event THIS run was started with
        while not stop.wait(interval):
            self.sample_once()

    # ------------------------------------------------------------ sampling
    def _thread_name(self, tid: int) -> str:
        name = self._names.get(tid)
        if name is None:
            self._names = {
                t.ident: t.name for t in threading.enumerate()
                if t.ident is not None
            }
            name = self._names.get(tid, f"thread-{tid}")
        return name

    def sample_once(self) -> None:
        """One pass over every live thread's stack (called by the
        sampler thread; public so tests drive it with a fake clock)."""
        me = threading.get_ident()
        now = self._clock()
        frames = sys._current_frames()
        cache = self._folded_cache
        if len(cache) > 8192:
            cache.clear()  # bound against frame-id churn
        with self._lock:
            cur = self._current
            for tid, frame in frames.items():
                if tid == me:
                    continue
                back = frame.f_back
                key = (
                    tid, id(frame), frame.f_lasti,
                    id(back), back.f_lasti if back is not None else -1,
                )
                stack = cache.get(key)
                if stack is None:
                    name = self._thread_name(tid)
                    stack = subsystem_of(name) + ";" + _folded(frame)
                    cache[key] = stack
                counts = cur.counts
                if stack in counts:
                    counts[stack] += 1
                elif len(counts) < self.max_stacks:
                    counts[stack] = 1
                else:
                    other = stack.split(";", 1)[0] + ";(other)"
                    counts[other] = counts.get(other, 0) + 1
            cur.samples += 1
            if now - cur.start >= self.segment_s:
                self._rotate_locked(now)
        if self.stats is not None:
            self.stats.count("profiler_samples_total")

    def _rotate_locked(self, now: float) -> None:
        self._current.end = now
        self._ring.append(self._current)
        if len(self._ring) > self._ring_cap:
            del self._ring[0]
        self._seq += 1
        self._current = _Segment(self._seq, now)

    # ------------------------------------------------------------- surface
    @property
    def current_segment_id(self) -> int:
        return self._current.id

    def segments_info(self) -> list[dict]:
        with self._lock:
            out = [s.info() for s in self._ring]
            out.append(self._current.info())
        return out

    def segments_overlapping(self, t0: float, t1: float) -> list[int]:
        """Segment ids whose [start, end) window intersects [t0, t1] —
        the flight-recorder linkage for a retained query's wall-clock
        span."""
        out = []
        with self._lock:
            for s in [*self._ring, self._current]:
                end = s.end if s.end is not None else float("inf")
                if s.start <= t1 and end >= t0:
                    out.append(s.id)
        return out

    def _window(
        self, seconds: float | None, segment: int | None
    ) -> tuple[dict[str, int], int, float, str]:
        """(merged counts, samples, span seconds, label) for a query:
        one historical segment by id, the segments covering the last
        ``seconds``, or (default) the whole retained ring."""
        now = self._clock()
        with self._lock:
            segs = [*self._ring, self._current]
            if segment is not None:
                segs = [s for s in segs if s.id == segment]
                if not segs:
                    raise KeyError(f"segment {segment} not retained")
                label = f"segment {segment}"
            elif seconds is not None:
                cutoff = now - seconds
                segs = [
                    s for s in segs
                    if (s.end if s.end is not None else now) >= cutoff
                ]
                label = f"last {seconds:g}s"
            else:
                label = "all retained segments"
            merged: dict[str, int] = {}
            samples = 0
            span = 0.0
            for s in segs:
                samples += s.samples
                span += (s.end if s.end is not None else now) - s.start
                for stack, n in s.counts.items():
                    merged[stack] = merged.get(stack, 0) + n
        return merged, samples, span, label

    def folded(
        self, seconds: float | None = None, segment: int | None = None
    ) -> str:
        """Folded-stack text (``a;b;c count``), heaviest first, with a
        header comment naming the window — flamegraph.pl input."""
        merged, samples, span, label = self._window(seconds, segment)
        lines = [
            f"# {samples} samples over {span:.1f}s at ~{self.hz:g} Hz"
            f" ({label})"
        ]
        for stack, n in sorted(merged.items(), key=lambda kv: -kv[1]):
            lines.append(f"{stack} {n}")
        return "\n".join(lines) + "\n"

    def speedscope(
        self, seconds: float | None = None, segment: int | None = None
    ) -> dict:
        """speedscope.app file: one sampled profile whose weights are
        sample counts scaled to seconds (count / hz)."""
        merged, samples, span, label = self._window(seconds, segment)
        frame_index: dict[str, int] = {}
        frames: list[dict] = []
        sample_stacks: list[list[int]] = []
        weights: list[float] = []
        dt = 1.0 / self.hz
        for stack, n in sorted(merged.items(), key=lambda kv: -kv[1]):
            idxs = []
            for part in stack.split(";"):
                i = frame_index.get(part)
                if i is None:
                    i = frame_index[part] = len(frames)
                    frames.append({"name": part})
                idxs.append(i)
            sample_stacks.append(idxs)
            weights.append(n * dt)
        total = sum(weights)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "exporter": "pilosa-tpu",
            "name": f"pilosa-tpu {label}",
            "shared": {"frames": frames},
            "profiles": [
                {
                    "type": "sampled",
                    "name": label,
                    "unit": "seconds",
                    "startValue": 0,
                    "endValue": total,
                    "samples": sample_stacks,
                    "weights": weights,
                }
            ],
            "activeProfileIndex": 0,
        }

    def snapshot(self) -> dict:
        """Meta view for /debug/profile?format=segments and the doctor
        bundle: config + the segment index."""
        t = self._thread
        return {
            "enabled": self.enabled,
            # liveness, not thread-object presence: a sampler that died
            # must not read as running while the ring silently freezes
            "running": t is not None and t.is_alive(),
            "hz": self.hz,
            "segmentSeconds": self.segment_s,
            "ringCapacity": self._ring_cap,
            "currentSegment": self.current_segment_id,
            "segments": self.segments_info(),
        }
