"""The device's side of a traced run: ``torch.profiler`` (CUPTI) over
the traced window, read back from its exported trace, and the
arithmetic on its device intervals.

Only the CUDA activity is recorded: every kernel, copy and memset on
the card, whichever thread of the process launched it. The trace is
exported to a file in the run's temp dir, read and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(spans: list) -> float:
    """Length of the union of ``[(start, end)]`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(events: list) -> list:
    """The idle gaps between the union's pieces of ``[(start, end,
    name)]``: ``[(length, name of the op before, name of the op after)]``."""
    out = []
    end, last = None, None
    for a, b, name in sorted(events):
        if end is not None and a > end:
            out.append((a - end, last, name))
        if end is None or b > end:
            end, last = b, name
    return out


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 64 letters."""
    return name.split("(")[0].strip()[:64]


def breakdown(events: list, top: int = 10) -> dict:
    """``device_ops``: the ``top`` device operations by total seconds;
    ``idle_gaps``: the ``top`` kinds of idle gap by total seconds, each
    named by the operations on either side of it (before a readback's
    copy, the host was planning and launching; after it, finishing
    and answering)."""
    by_op: dict = {}
    for a, b, name in events:
        by_op[short(name)] = by_op.get(short(name), 0.0) + (b - a)
    by_gap: dict = {}
    for length, before, after in gaps(events):
        key = f"after {short(before)} before {short(after)}"
        by_gap[key] = by_gap.get(key, 0.0) + length
    rank = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}


class DeviceTrace:
    """``with DeviceTrace() as t: ...``; then ``t.events``:
    ``[(start_us, end_us, name)]`` of every device operation, and
    ``t.kernels``, the kernels' share of them."""

    def __init__(self):
        self.events: list = []
        self.kernels: list = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as fh:
                trace = json.load(fh)
        finally:
            os.remove(path)
        for e in trace.get("traceEvents", []):
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                ev = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), str(e.get("name", "")))
                self.events.append(ev)
                if e["cat"] == "kernel":
                    self.kernels.append(ev)
        return False
