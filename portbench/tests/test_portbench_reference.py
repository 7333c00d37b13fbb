"""The NumPy reference against a count made bit by bit, column by
column, at a tiny size, for every query kind of the three mixes."""

import numpy as np
import pytest

from portbench.data import Dataset
from portbench.pql import parse
from portbench.reference import Reference
from portbench.run import Bench
from portbench.traffic import Mix, read_spec


class Naive:
    """Each column of each shard on its own, in plain Python."""

    def __init__(self, d: Dataset):
        self.d = d
        self.cols = []  # (block, column) of every column of every shard
        for s in range(d.shards):
            self.cols += [(s % d.blocks, c) for c in range(d.width)]

    def value(self, name, g, c):
        f = self.d.fields[name]
        if f.kind == "int":
            return int(f.vals[g, c]) if f.has[g, c] else None
        return {int(f.cats[g, c])}

    def test(self, call, g, c) -> bool:
        if call.name == "Row":
            ((name, arg),) = call.args.items()
            v = self.value(name, g, c)
            if isinstance(arg, tuple):
                if arg[0] == "between":
                    lo, hi, lo_in, hi_in = arg[1:]
                    return v is not None and (v >= lo if lo_in else v > lo) and (v <= hi if hi_in else v < hi)
                op, x = arg
                if x is None:
                    return (v is None) == (op == "eq")
                return v is not None and {"lt": v < x, "le": v <= x, "gt": v > x, "ge": v >= x,
                                          "eq": v == x, "ne": v != x}[op]
            return arg in v
        kids = [self.test(ch, g, c) for ch in call.children]
        if call.name == "Intersect":
            return bool(kids) and all(kids)
        if call.name == "Union":
            return any(kids)
        if call.name == "Xor":
            return sum(kids) % 2 == 1
        if call.name == "Difference":
            return kids[0] and not any(kids[1:])
        raise ValueError(call.name)

    def answer(self, pql):
        call = parse(pql)[-1]
        if call.name == "Count":
            return sum(self.test(call.children[0], g, c) for g, c in self.cols)
        if call.name == "TopN":
            f = self.d.fields[call.fields[0]]
            counts = {}
            for g, c in self.cols:
                if call.children and not self.test(call.children[0], g, c):
                    continue
                for r in self.value(f.name, g, c):
                    counts[r] = counts.get(r, 0) + 1
            ids = call.args.get("ids")
            cand = [r for r in dict.fromkeys(ids) if 0 <= r < f.rows] if ids is not None else range(f.rows)
            pairs = sorted(((r, counts.get(r, 0)) for r in cand if counts.get(r, 0)), key=lambda p: (-p[1], p[0]))
            n = call.args.get("n")
            return [{"id": r, "count": k} for r, k in (pairs[:n] if n else pairs)]
        if call.name == "GroupBy":
            names = [ch.fields[0] for ch in call.children]
            agg = call.args.get("aggregate")
            groups = {}
            for g, c in self.cols:
                if "filter" in call.args and not self.test(call.args["filter"], g, c):
                    continue
                keys = [()]
                for name in names:
                    keys = [k + (r,) for k in keys for r in sorted(self.value(name, g, c))]
                for k in keys:
                    n, s = groups.get(k, (0, 0))
                    v = self.value(agg.args["field"], g, c) if agg else None
                    groups[k] = (n + 1, s + (v or 0))
            out = []
            for k in sorted(groups):
                item = {"group": [{"field": f, "rowID": r} for f, r in zip(names, k)], "count": groups[k][0]}
                if agg:
                    item["sum"] = groups[k][1]
                out.append(item)
            return out
        raise ValueError(call.name)


@pytest.mark.parametrize("cell", ["taxi-1b.rides-c1", "taxi-1b.topn-c16"])
def test_reference_equals_a_bit_by_bit_count(cell):
    bench = Bench()
    w = bench.cell(cell)
    spec = read_spec(bench.traffic_path(w["traffic"]))
    d = Dataset(bench.config(w["config"]), 3_000_000_021, shards=3, width_exp=9, only=spec["fields"])
    mix = Mix(spec, d.fields)
    plan = mix.plan(3_000_000_021, 0.5)
    ref, naive = Reference(d), Naive(d)
    kinds = {}
    for kind, q in zip(plan["kinds"][0], plan["queries"][0]):
        kinds.setdefault(kind, []).append(q)
    assert len(kinds) == len(mix.templates)  # every template drawn
    for qs in kinds.values():
        for q in qs[:3]:
            assert ref.answer(q) == naive.answer(q), q


@pytest.mark.parametrize("pql", [
    "Count(Row(total_amount > 5000))",
    "Count(Row(total_amount == null))",
    "Count(Intersect(Row(cab_type=0), Row(-500 <= total_amount < 2000)))",
    "Count(Intersect(Row(passenger_count=1), Row(pickup_year=2), Row(dist_miles=3)))",
    "Sum(Row(passenger_count=2), field=total_amount)",
    "Min(field=total_amount)",
    "Max(Row(cab_type=1), field=total_amount)",
    "GroupBy(Rows(cab_type), Rows(passenger_count), filter=Row(total_amount != 700))",
    "GroupBy(Rows(cab_type), aggregate=Sum(field=total_amount), filter=Row(total_amount >= 3000))",
    "GroupBy(Rows(pickup_year), limit=3)",
])
def test_reference_answers_the_calls_a_later_mix_may_send(pql):
    d = Dataset(Bench().config("taxi-1b"), 5, shards=2, width_exp=9)
    got = Reference(d).answer(pql)
    call = parse(pql)[-1]
    if call.name in ("Sum", "Min", "Max"):
        f = d.fields["total_amount"]
        sel = f.has.copy()
        if call.children:
            sel &= Reference(d).mask(call.children[0])
        v = f.vals[sel]
        if call.name == "Sum":
            assert got == {"value": int(v.sum()), "count": int(v.size)}
        else:
            best = int(v.max() if call.name == "Max" else v.min())
            assert got == {"value": best, "count": int((v == best).sum())}
        return
    want = Naive(d).answer(pql.replace(", limit=3", ""))
    assert got == (want[:3] if "limit" in pql else want)


def test_the_control_accumulates_in_float32_and_rounds():
    d = Dataset(Bench().config("taxi-1b"), 5, only=["cab_type"])  # the cells' own size
    q = "Count(Union(Row(cab_type=0), Row(cab_type=2)))"
    exact, low = Reference(d).answer(q), Reference(d, acc=np.float32).answer(q)
    assert exact > 1 << 29 and low != exact and abs(low - exact) < exact * 1e-6
