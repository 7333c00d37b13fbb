"""Profiling surface — the /debug/pprof analogue.

Reference: net/http/pprof mounted in http/handler.go (profile, heap,
goroutine). Python equivalents, dependency-free:

- ``sample_profile(seconds)``: a sampling wall-clock profiler over ALL
  threads (sys._current_frames at ~100 Hz), emitting folded-stack lines
  (``a;b;c count``) directly consumable by flamegraph tooling — the
  analogue of ``/debug/pprof/profile``. Sampling, not tracing: safe to
  run against a serving process.
- ``thread_dump()``: current stack of every live thread — the analogue of
  ``/debug/pprof/goroutine?debug=2``.
- ``heap_profile(top)``: top allocation sites via tracemalloc — the
  analogue of ``/debug/pprof/heap``. tracemalloc starts on the first
  call (a line notes when tracking began; earlier allocations are
  invisible, matching pprof's sampling-from-start caveat).
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter


def _folded(frame) -> str:
    parts: list[str] = []
    while frame is not None:
        code = frame.f_code
        parts.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno})")
        frame = frame.f_back
    return ";".join(reversed(parts))


def sample_profile(seconds: float = 5.0, hz: int = 100) -> str:
    """Sample every thread's stack for ``seconds``; return folded-stack
    text sorted by sample count (one line per distinct stack)."""
    seconds = min(float(seconds), 60.0)
    interval = 1.0 / max(1, hz)
    me = threading.get_ident()
    counts: Counter[str] = Counter()
    deadline = time.perf_counter() + seconds
    n_samples = 0
    while time.perf_counter() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            counts[_folded(frame)] += 1
        n_samples += 1
        time.sleep(interval)
    lines = [f"# {n_samples} samples over {seconds:.1f}s at ~{hz} Hz"]
    for stack, n in counts.most_common():
        lines.append(f"{stack} {n}")
    return "\n".join(lines) + "\n"


class WholeRunSampler:
    """Whole-run sampling profiler over ALL threads (the server
    command's cpu-profile flag): a daemon thread samples
    sys._current_frames at ``hz`` until stop(), then writes folded-stack
    lines to ``out`` (an open text file — opened by the caller so a bad
    path fails at startup). Memory is bounded by the number of DISTINCT
    stacks, not run length."""

    def __init__(self, out, hz: int = 50):
        self._out = out
        self._interval = 1.0 / max(1, hz)
        self._counts: Counter[str] = Counter()
        self._n = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="cpu-profile-sampler", daemon=True
        )
        self._t0 = time.perf_counter()

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.is_set():
            for tid, frame in sys._current_frames().items():
                if tid != me:
                    self._counts[_folded(frame)] += 1
            self._n += 1
            self._stop.wait(self._interval)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        elapsed = time.perf_counter() - self._t0
        with self._out as f:
            f.write(f"# {self._n} samples over {elapsed:.1f}s\n")
            for stack, n in self._counts.most_common():
                f.write(f"{stack} {n}\n")


def thread_dump() -> str:
    """Stack of every live thread (goroutine-dump analogue)."""
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in frames.items():
        t = by_id.get(tid)
        name = t.name if t else f"thread-{tid}"
        daemon = " daemon" if t is not None and t.daemon else ""
        out.append(f"--- {name} (id {tid}){daemon} ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


_heap_started_at: float | None = None


def heap_profile(top: int = 50) -> dict:
    """Top allocation sites since tracking began. Starts tracemalloc on
    first use (tracking adds overhead only from then on)."""
    import tracemalloc

    global _heap_started_at
    if not tracemalloc.is_tracing():
        tracemalloc.start()
        _heap_started_at = time.time()
        return {
            "startedAt": _heap_started_at,
            "note": "tracemalloc started now; call again for allocations",
            "top": [],
        }
    snapshot = tracemalloc.take_snapshot()
    stats = snapshot.statistics("lineno")[: int(top)]
    current, peak = tracemalloc.get_traced_memory()
    return {
        "startedAt": _heap_started_at,
        "currentBytes": current,
        "peakBytes": peak,
        "top": [
            {
                "site": str(s.traceback[0]) if s.traceback else "?",
                "bytes": s.size,
                "count": s.count,
            }
            for s in stats
        ],
    }
