"""The window's request latencies, from the clients' raw samples."""

from __future__ import annotations

import math


def window_ms(run) -> list:
    """Every request sent in the window, in ms, sorted; a failed request
    counts as slower than any answer (``inf``)."""
    return sorted((r[3] - r[2]) * 1e3 if r[4] == 200 else math.inf for r in run.window())


def nearest_rank(sorted_values: list, q: float):
    """The ``q``-quantile (0 < q <= 1) by nearest rank, or None."""
    if not sorted_values:
        return None
    return sorted_values[math.ceil(q * len(sorted_values)) - 1]


def p95(run):
    """The 95th percentile; None where it falls on a failed request
    (that run is not correct either)."""
    p = nearest_rank(window_ms(run), 0.95)
    return None if p is None or math.isinf(p) else p


def summary(run) -> dict:
    """Percentiles and mean of the answered requests, for diagnostics."""
    lat = [x for x in window_ms(run) if not math.isinf(x)]
    if not lat:
        return {}
    out = {f"p{int(q * 100)}": nearest_rank(lat, q) for q in (0.5, 0.9, 0.95, 0.99)}
    out["max"], out["mean"], out["n"] = lat[-1], sum(lat) / len(lat), len(lat)
    return out
