"""The plain reference: the answer to each query of the mixes, worked
out in NumPy from the seeded raw columns (``data.Dataset``), all blocks
at once along a leading block axis, each block's part counted once per
shard it fills.

It imports numpy and the benchmark's own parser and data, and nothing
of the program: it never reads what the program made (its stacks, its
planes, its answers other than to judge them).

The answers have the shapes the HTTP API gives in ``results``:
Count an int; TopN ``[{"id", "count"}]`` by count, then id; GroupBy
``[{"group": [{"field", "rowID"}...], "count"[, "sum"]}]`` in row-id
order, groups with a count only; Sum ``{"value", "count"}``; Min and
Max ``{"value", "count"}`` (the extreme and how many hold it).

``acc`` is the type that the per-block parts are summed in: int64 (the
guarantee, exact counts) or, for the control, float32, which rounds
counts and sums past 2^24.
"""

from __future__ import annotations

import numpy as np

from portbench.data import Dataset, pack, unpack
from portbench.pql import Call, parse

_BITWISE = {"Intersect": np.bitwise_and, "Union": np.bitwise_or, "Xor": np.bitwise_xor}
_CMP = {"lt": np.less, "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal,
        "eq": np.equal, "ne": np.not_equal}


def popcounts(words: np.ndarray) -> np.ndarray:
    """int64[G]: the set bits of each block's words ``uint32[G, W]``
    (counted as uint64 pairs: half the elements)."""
    w = np.ascontiguousarray(words).view(np.uint64)
    return np.add.reduce(np.bitwise_count(w), axis=1, dtype=np.int64)


class Reference:
    def __init__(self, data: Dataset, acc=np.int64):
        self.data = data
        self.acc = np.dtype(acc)
        self._keys: dict = {}  # grouped fields → each column's group number, per block
        self._sorted: dict = {}  # int field [and grouped fields] → values [and groups] in value order
        self._rows: dict = {}  # (field, row) → its packed words
        self._answers: dict = {}  # query text → its answer

    # ------------------------------------------------------------ sums
    def totals(self, parts) -> np.ndarray:
        """int64[n]: Σ_g mult[g] × parts[g, i] for each column i of
        ``parts[G, n]``, added block after block in ``acc``."""
        parts = np.asarray(parts, dtype=np.int64)
        s = np.zeros(parts.shape[1], dtype=self.acc)
        for m, p in zip(self.data.mult.tolist(), parts):
            s = (s + (int(m) * p).astype(self.acc)).astype(self.acc)
        return s.astype(np.int64)

    def total(self, parts) -> int:
        """Σ_g mult[g] × parts[g], as :meth:`totals` adds it."""
        return int(self.totals(np.asarray(parts, dtype=np.int64)[:, None])[0])

    # ---------------------------------------------------------- bitmaps
    def words(self, c: Call) -> np.ndarray:
        """uint32[G, W]: the columns each block selects under bitmap call ``c``."""
        d = self.data
        if c.name == "Row":
            ((name, arg),) = c.args.items()
            f = d.fields[name]
            if f.kind == "int":
                return pack(self.int_mask(f, arg))
            return self.row(f, int(arg))
        if c.name in _BITWISE:
            if not c.children:
                return np.zeros((d.blocks, d.words), dtype=np.uint32)
            out = self.words(c.children[0]).copy()
            for ch in c.children[1:]:
                _BITWISE[c.name](out, self.words(ch), out=out)
            return out
        if c.name == "Difference":
            out = self.words(c.children[0]).copy()
            for ch in c.children[1:]:
                out &= ~self.words(ch)
            return out
        raise ValueError(f"reference: no bitmap call {c.name}")

    def row(self, f, r: int) -> np.ndarray:
        """uint32[G, W]: row ``r`` of set field ``f`` in each block, packed
        once and kept."""
        if r < 0 or r >= f.rows:
            return np.zeros((self.data.blocks, self.data.words), dtype=np.uint32)
        if (f.name, r) not in self._rows:
            self._rows[(f.name, r)] = pack(f.cats == r)
        return self._rows[(f.name, r)]

    @staticmethod
    def int_mask(f, arg) -> np.ndarray:
        """bool[G, C]: the columns of int field ``f`` meeting condition ``arg``."""
        v, has = f.vals, f.has
        op = arg[0]
        if op == "between":
            lo, hi, lo_in, hi_in = arg[1:]
            return has & (v >= lo if lo_in else v > lo) & (v <= hi if hi_in else v < hi)
        if arg[1] is None:  # field == null / != null
            return ~has if op == "eq" else has
        return has & _CMP[op](v, arg[1])

    def mask(self, c: "Call | None") -> "np.ndarray | None":
        """bool[G, C] of filter ``c`` (None: no filter)."""
        if c is None:
            return None
        if c.name == "Row" and len(c.args) == 1:
            ((name, arg),) = c.args.items()
            f = self.data.fields[name]
            if f.kind == "int":
                return self.int_mask(f, arg)
        return unpack(self.words(c))

    # ------------------------------------------------------------ calls
    def answer(self, pql: str):
        """The answer of the query's last call, as the HTTP API gives it,
        worked out once for each text."""
        if pql not in self._answers:
            self._answers[pql] = self.call(parse(pql)[-1])
        return self._answers[pql]

    def call(self, c: Call):
        if c.name == "Count":
            (child,) = c.children
            return self.total(popcounts(self.words(child)))
        if c.name == "TopN":
            return self.topn(c)
        if c.name == "GroupBy":
            return self.group_by(c)
        if c.name == "Sum":
            vals, ok = self._values(c)
            return {"value": self.total(np.where(ok, vals, 0).sum(axis=1)), "count": self.total(ok.sum(axis=1))}
        if c.name in ("Min", "Max"):
            return self.extreme(c, c.name == "Max")
        raise ValueError(f"reference: no call {c.name}")

    def topn(self, c: Call) -> list:
        f = self.data.fields[c.fields[0]]
        fw = self.words(c.children[0]) if c.children else None
        ids = c.args.get("ids")
        counts = {}
        for r in dict.fromkeys(ids if ids is not None else f.row_ids()):
            if not 0 <= r < f.rows:
                continue
            w = self.row(f, r) if fw is None else self.row(f, r) & fw
            counts[r] = self.total(popcounts(w))
        pairs = sorted(((r, n) for r, n in counts.items() if n), key=lambda rn: (-rn[1], rn[0]))
        n = c.args.get("n")
        return [{"id": r, "count": k} for r, k in (pairs[: int(n)] if n else pairs)]

    def _key(self, fields: list) -> np.ndarray:
        """int64[G, C]: each column's group over categorical ``fields``,
        row ids in mixed radix, the first field most significant."""
        k = tuple(f.name for f in fields)
        if k not in self._keys:
            key = np.zeros((self.data.blocks, self.data.width), dtype=np.int64)
            for f in fields:
                key = key * f.rows + f.cats
            self._keys[k] = key
        return self._keys[k]

    def _band(self, filt: "Call | None"):
        """(int field, lo, hi) where ``filt`` is one condition that selects
        the values lo <= v <= hi of an int field, else None."""
        if filt is None or filt.name != "Row" or len(filt.args) != 1:
            return None
        ((name, arg),) = filt.args.items()
        f = self.data.fields[name]
        if f.kind != "int" or arg[1] is None and arg[0] != "between":
            return None
        op = arg[0]
        if op == "between":
            return f, arg[1] + (not arg[3]), arg[2] - (not arg[4])
        x = arg[1]
        bounds = {"lt": (f.min, x - 1), "le": (f.min, x), "gt": (x + 1, f.max), "ge": (x, f.max), "eq": (x, x)}
        return (f, *bounds[op]) if op in bounds else None

    def _banded_counts(self, fields: list, band: tuple, n: int, vf) -> tuple:
        """(counts[G, n], sums[G, n] or None) of categorical ``fields``
        over the columns whose value lies in ``band``: each block's
        columns with a value, sorted by it once, so a band is a slice."""
        f, lo, hi = band
        if f.name not in self._sorted:
            orders = []
            for g in range(self.data.blocks):
                idx = np.flatnonzero(f.has[g])
                orders.append(idx[np.argsort(f.vals[g][idx], kind="stable")])
            self._sorted[f.name] = [(f.vals[g][o], o) for g, o in enumerate(orders)]
        k = (f.name, tuple(x.name for x in fields))
        if k not in self._sorted:
            key = self._key(fields)
            self._sorted[k] = [(vals, key[g][o], o) for g, (vals, o) in enumerate(self._sorted[f.name])]
        counts = np.zeros((self.data.blocks, n), dtype=np.int64)
        sums = np.zeros((self.data.blocks, n), dtype=np.int64) if vf is not None else None
        for g, (vals, key, order) in enumerate(self._sorted[k]):
            a, b = np.searchsorted(vals, lo, "left"), np.searchsorted(vals, hi, "right")
            counts[g] = np.bincount(key[a:b], minlength=n)
            if vf is not None:
                cols = order[a:b]
                ok = vf.has[g][cols]
                sums[g] = np.rint(np.bincount(key[a:b][ok], weights=vf.vals[g][cols][ok].astype(np.float64),
                                              minlength=n)).astype(np.int64)
        return counts, sums

    def group_by(self, c: Call) -> list:
        d = self.data
        fields = [d.fields[ch.fields[0]] for ch in c.children if ch.name == "Rows"]
        agg = c.args.get("aggregate")
        vf = d.fields[agg.args["field"]] if agg is not None else None
        sizes = [f.rows for f in fields]
        n = int(np.prod(sizes))
        categorical = all(f.kind == "categorical" for f in fields)
        band = self._band(c.args.get("filter")) if categorical else None
        sel = None if band is not None else self.mask(c.args.get("filter"))
        if band is not None:
            counts, sums = self._banded_counts(fields, band, n, vf)
        elif categorical:
            # group g of block b at g + b·n: one bincount over every block
            key = self._key(fields) + (np.arange(d.blocks, dtype=np.int64) * n)[:, None]
            k = key.ravel() if sel is None else key[sel]
            counts = np.bincount(k, minlength=d.blocks * n).reshape(d.blocks, n)
            if vf is not None:
                ok = vf.has if sel is None else sel & vf.has
                v = vf.vals[ok]
                if np.abs(v).sum() >= 1 << 53:
                    raise ValueError("reference: a sum past float64's exact range")
                sums = np.rint(np.bincount(key[ok], weights=v.astype(np.float64),
                                           minlength=d.blocks * n)).astype(np.int64).reshape(d.blocks, n)
        else:
            counts = np.zeros((d.blocks, n), dtype=np.int64)
            sums = np.zeros((d.blocks, n), dtype=np.int64)
            for gid, rows in enumerate(np.ndindex(*sizes)):
                m = np.ones((d.blocks, d.width), dtype=bool) if sel is None else sel.copy()
                for f, r in zip(fields, rows):
                    m &= unpack(self.row(f, r))
                counts[:, gid] = m.sum(axis=1)
                if vf is not None:
                    sums[:, gid] = np.where(m & vf.has, vf.vals, 0).sum(axis=1)
        count = self.totals(counts)
        total_sum = self.totals(sums) if vf is not None else None
        out = []
        for gid in np.flatnonzero(count).tolist():
            rows = np.unravel_index(gid, sizes)
            item = {"group": [{"field": f.name, "rowID": int(r)} for f, r in zip(fields, rows)],
                    "count": int(count[gid])}
            if vf is not None:
                item["sum"] = int(total_sum[gid])
            out.append(item)
        limit = c.args.get("limit")
        return out[: int(limit)] if limit else out

    def _values(self, c: Call) -> tuple:
        """(int64[G, C] values, bool[G, C] counted) of an aggregate's field."""
        f = self.data.fields[c.args["field"]]
        ok = f.has if not c.children else f.has & self.mask(c.children[0])
        return f.vals, ok

    def extreme(self, c: Call, want_max: bool) -> dict:
        vals, ok = self._values(c)
        if not ok.any():
            return {"value": 0, "count": 0}
        best = int(vals[ok].max() if want_max else vals[ok].min())
        return {"value": best, "count": self.total((ok & (vals == best)).sum(axis=1))}
