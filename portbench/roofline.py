"""The yardstick of the kernels: the bytes a query needs from the
card's memory, reckoned from the query and the data's shapes alone,
whatever kernels the program runs it with, and the card's peak.

Each input byte is counted once, as one plane (one row over every
shard: shards × shard width / 8 bytes):

- Count: each distinct leaf's plane; a condition on an int field reads
  that field's BSI planes (exists, sign and its bits);
- TopN: the rows it ranks (every row of the field, or the ``ids`` in
  range) and the filter's planes, a plane that is both counted once;
- GroupBy: every row of each grouped field, the filter's planes and,
  with ``aggregate=Sum``, the summed field's BSI planes;
- Sum, Min, Max: the field's BSI planes and the filter's planes.

Outputs (counts, a few groups) are bytes the card writes once and are
left out: next to the planes they are nothing.
"""

from __future__ import annotations

from portbench.data import Dataset
from portbench.pql import Call, parse

# NVIDIA's data sheet for the H100 SXM: 80 GB of HBM3 at 3.35 TB/s
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
DEFAULT_PEAK_BYTES_PER_S = 3.35e12


def peak_bytes_per_s(card: str) -> float:
    return PEAK_BYTES_PER_S.get(card, DEFAULT_PEAK_BYTES_PER_S)


def _bsi_planes(data: Dataset, field: str) -> set:
    f = data.fields[field]
    return {(field, "bsi", k) for k in range(2 + f.depth)}


def _leaf_planes(data: Dataset, c: "Call | None") -> set:
    out: set = set()
    if c is None:
        return out
    if c.name == "Row":
        for name, arg in c.args.items():
            f = data.fields[name]
            if f.kind == "int":
                out |= _bsi_planes(data, name)
            elif 0 <= int(arg) < f.rows:
                out.add((name, int(arg)))
    for ch in c.children:
        out |= _leaf_planes(data, ch)
    return out


def planes(data: Dataset, c: Call) -> set:
    """The distinct planes the top-level call ``c`` needs."""
    if c.name == "Count":
        return _leaf_planes(data, c.children[0])
    if c.name == "TopN":
        f = data.fields[c.fields[0]]
        ids = c.args.get("ids")
        rows = range(f.rows) if ids is None else [r for r in ids if 0 <= r < f.rows]
        need = {(f.name, r) for r in rows}
        return need | _leaf_planes(data, c.children[0] if c.children else None)
    if c.name == "GroupBy":
        need = set()
        for ch in c.children:
            if ch.name == "Rows":
                f = data.fields[ch.fields[0]]
                need |= {(f.name, r) for r in range(f.rows)}
        need |= _leaf_planes(data, c.args.get("filter"))
        agg = c.args.get("aggregate")
        if agg is not None:
            need |= _bsi_planes(data, agg.args["field"])
        return need
    if c.name in ("Sum", "Min", "Max"):
        return _bsi_planes(data, c.args["field"]) | _leaf_planes(data, c.children[0] if c.children else None)
    raise ValueError(f"roofline: no byte count for {c.name}")


def query_bytes(data: Dataset, pql: str) -> int:
    """Bytes the query's last call needs from the card's memory."""
    return len(planes(data, parse(pql)[-1])) * data.plane_bytes()
