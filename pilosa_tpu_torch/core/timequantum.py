"""Time-quantum view naming and range cover.

Reference: time.go (TimeQuantum, viewsByTime, viewsByTimeRange) — time
fields materialize one view per calendar bucket (Y/M/D/H) so time-bounded
Row queries read a minimal set of pre-bucketed views instead of filtering.

View names: ``<base>_2018``, ``<base>_201801``, ``<base>_20180102``,
``<base>_2018010203`` for Y/M/D/H buckets.
"""

from __future__ import annotations

from datetime import datetime, timedelta

VALID_UNITS = "YMDH"
_FORMATS = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}
_NAME_LENGTHS = {4: "Y", 6: "M", 8: "D", 10: "H"}


def validate_quantum(q: str) -> str:
    """A quantum is a contiguous run of 'YMDH' (e.g. 'YMD', 'MDH', 'D')."""
    if not q:
        return q
    if q not in ("Y", "M", "D", "H", "YM", "MD", "DH", "YMD", "MDH", "YMDH"):
        raise ValueError(f"invalid time quantum {q!r}")
    return q


def view_by_time_unit(base: str, t: datetime, unit: str) -> str:
    return f"{base}_{t.strftime(_FORMATS[unit])}"


def views_by_time(base: str, t: datetime, quantum: str) -> list[str]:
    """All bucket views a timestamped write lands in (reference:
    viewsByTime) — one per unit present in the quantum."""
    return [view_by_time_unit(base, t, u) for u in quantum]


def _truncate(t: datetime, unit: str) -> datetime:
    if unit == "Y":
        return t.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "M":
        return t.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "D":
        return t.replace(hour=0, minute=0, second=0, microsecond=0)
    return t.replace(minute=0, second=0, microsecond=0)


def _next(t: datetime, unit: str) -> datetime:
    if unit == "Y":
        return t.replace(year=t.year + 1)
    if unit == "M":
        return (
            t.replace(year=t.year + 1, month=1)
            if t.month == 12
            else t.replace(month=t.month + 1)
        )
    if unit == "D":
        return t + timedelta(days=1)
    return t + timedelta(hours=1)


def parse_view_bucket(view_name: str, base: str) -> tuple[datetime, datetime] | None:
    """(bucket start, bucket end) of a time view name, or None for the
    standard / non-time views. Used to bound open-ended range queries to
    the data that actually exists."""
    prefix = base + "_"
    if not view_name.startswith(prefix):
        return None
    suffix = view_name[len(prefix) :]
    unit = _NAME_LENGTHS.get(len(suffix))
    if unit is None or not suffix.isdigit():
        return None
    try:
        t = datetime.strptime(suffix, _FORMATS[unit])
    except ValueError:
        return None
    return t, _next(t, unit)


def views_by_time_range(base: str, start: datetime, end: datetime, quantum: str) -> list[str]:
    """Minimal set of bucket views covering [start, end) (reference:
    viewsByTimeRange). Greedy: at each step take the coarsest quantum unit
    that is aligned at the cursor and fully contained in the range.
    Endpoints are truncated to the finest unit in the quantum.
    """
    if not quantum:
        raise ValueError("field has no time quantum")
    units = [u for u in VALID_UNITS if u in quantum]  # coarse → fine
    finest = units[-1]
    t = _truncate(start, finest)
    end = _truncate(end, finest) if end == _truncate(end, finest) else _next(
        _truncate(end, finest), finest
    )
    views: list[str] = []
    while t < end:
        for u in units:
            if _truncate(t, u) == t and _next(t, u) <= end:
                views.append(view_by_time_unit(base, t, u))
                t = _next(t, u)
                break
        else:
            # cursor not aligned even at the finest unit — cannot happen
            # after truncation, but guard against infinite loops
            t = _next(t, finest)
    return views
