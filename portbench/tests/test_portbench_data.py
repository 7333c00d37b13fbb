"""The seeded generators (data and traffic) and the packing into the
program's layout."""

import collections

import numpy as np

from portbench.data import Dataset, one_hot_words, pack, padded_rows, unpack
from portbench.run import Bench
from portbench.traffic import Mix, read_spec


def tiny(name: str, seed: int, shards: int = 5) -> Dataset:
    cfg = Bench().config(name)
    return Dataset(cfg, seed, shards=shards, width_exp=10)


def arrays(d: Dataset) -> list:
    out = []
    for f in d.fields.values():
        out += [a for a in (f.cats, f.vals, f.has) if a is not None]
    return out


def test_a_seed_repeats_exactly_and_another_differs():
    a, b, c = tiny("taxi-1b", 3_000_000_001), tiny("taxi-1b", 3_000_000_001), tiny("taxi-1b", 3_000_000_002)
    assert all(np.array_equal(x, y) for x, y in zip(arrays(a), arrays(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(arrays(a), arrays(c)))


def test_blocks_cycle_over_the_shards():
    d = tiny("taxi-1b", 1, shards=5)
    assert d.blocks == 5 and d.mult.tolist() == [1] * 5
    full = Dataset(Bench().config("taxi-1b"), 1, width_exp=10, only=["cab_type"])
    assert full.blocks == 16 and full.mult.sum() == 1049 and sorted(set(full.mult.tolist())) == [65, 66]


def test_a_field_is_the_same_whichever_others_are_made():
    whole = tiny("taxi-1b", 7)
    part = Dataset(Bench().config("taxi-1b"), 7, shards=5, width_exp=10, only=["pickup_year", "total_amount"])
    assert list(part.fields) == ["pickup_year", "total_amount"]
    assert np.array_equal(part.fields["pickup_year"].cats, whole.fields["pickup_year"].cats)
    assert np.array_equal(part.fields["total_amount"].vals, whole.fields["total_amount"].vals)


def mix_of(cell: str, seed: int, seconds: float = 20.0) -> tuple:
    bench = Bench()
    w = bench.cell(cell)
    spec = read_spec(bench.traffic_path(w["traffic"]))
    d = Dataset(bench.config(w["config"]), seed, shards=2, width_exp=9, only=spec["fields"])
    mix = Mix(spec, d.fields)
    return mix, mix.plan(seed, seconds)


def test_a_plan_repeats_for_a_seed_and_another_seed_reorders_the_same_work():
    for cell in ("taxi-1b.rides-c1", "taxi-1b.topn-c16"):
        mix, a = mix_of(cell, 3_000_000_005)
        _, b = mix_of(cell, 3_000_000_005)
        _, c = mix_of(cell, 2**31 + 77)
        assert a == b and a["queries"] != c["queries"]
        # the same templates in the same numbers, client by client
        assert [sorted(k) for k in a["kinds"]] == [sorted(k) for k in c["kinds"]]
        assert len(a["queries"]) == mix.clients


# one client asking Q3's and Q4's group counts as Count(Intersect)
GROUP_COUNTS = {
    "name": "group-counts", "clients": 1, "fields": ["passenger_count", "pickup_year", "dist_miles"],
    "warmup": 4, "rate_cap": 500, "check": 0.1, "check_max": 200,
    "templates": [
        {"name": "q3_group", "weight": 1, "pql": "Count(Intersect(Row(passenger_count={p}), Row(pickup_year={y})))",
         "slots": {"p": {"kind": "row", "field": "passenger_count"}, "y": {"kind": "row", "field": "pickup_year"}}},
        {"name": "q4_group", "weight": 1,
         "pql": "Count(Intersect(Row(passenger_count={p}), Row(pickup_year={y}), Row(dist_miles={d})))",
         "slots": {"p": {"kind": "row", "field": "passenger_count"}, "y": {"kind": "row", "field": "pickup_year"},
                   "d": {"kind": "row", "field": "dist_miles"}}},
    ],
}


def test_a_grid_is_dealt_so_no_two_clients_send_one_text():
    d = Dataset(Bench().config("taxi-1b"), 11, shards=2, width_exp=9, only=GROUP_COUNTS["fields"])
    plan = Mix(GROUP_COUNTS, d.fields).plan(11, 20.0)
    (queries,) = plan["queries"]
    q4 = [q for q, k in zip(queries, plan["kinds"][0]) if k == 1]
    assert len(set(q4)) == len(q4) < 10 * 7 * 100  # Q4's 7,000 triples, none twice in a run
    mix, plan = mix_of("taxi-1b.topn-c16", 11)
    texts = [set(q) | set(w) for q, w in zip(plan["queries"], plan["warm"])]
    assert sum(len(t) for t in texts) == len(set().union(*texts)) == 10 * 7
    # each client repeats one text only after its whole share
    for w, q in zip(plan["warm"], plan["queries"]):
        q = w + q
        share = len(set(q))
        assert all(len(set(q[i:i + share])) == share for i in range(0, len(q) - share, share))


def test_the_rides_client_sends_the_four_published_queries_in_turn():
    mix, plan = mix_of("taxi-1b.rides-c1", 3)
    (queries,) = plan["queries"]
    assert set(queries) == {t["pql"] for t in mix.templates} and len(mix.templates) == 4
    assert all(n == len(queries) // 4 for n in collections.Counter(queries[: len(queries) // 4 * 4]).values())


def test_packed_categorical_rows_are_the_one_hot_columns():
    d = tiny("taxi-1b", 4)
    for name in ("cab_type", "passenger_count", "pickup_year", "dist_miles"):
        f = d.fields[name]
        for g in range(d.blocks):
            m = f.packed(g)
            assert m.shape == (padded_rows(f.rows), d.words)
            want = pack(f.cats[g][None, :] == np.arange(f.rows)[:, None])
            assert np.array_equal(m[: f.rows], want)
            assert not m[f.rows:].any()
            # every block holds every row (cover)
            assert np.bitwise_count(m[: f.rows]).sum(axis=1).min() >= 1


def test_one_hot_words_matches_packbits():
    rng = np.random.default_rng(0)
    cats = rng.integers(0, 100, 4096).astype(np.int16)
    assert np.array_equal(one_hot_words(cats, 100), pack(cats[None, :] == np.arange(100)[:, None]))


def test_bsi_planes_decode_to_the_values():
    d = tiny("taxi-1b", 6)
    f = d.fields["total_amount"]
    assert f.depth == 20
    for g in range(d.blocks):
        bits = unpack(f.packed(g))
        assert bits.shape[0] == 32 and not bits[22:].any()
        has = bits[0]
        mag = sum(bits[2 + k].astype(np.int64) << k for k in range(f.depth))
        vals = np.where(bits[1], -mag, mag)
        assert np.array_equal(has, f.has[g])
        assert np.array_equal(vals[has], f.vals[g][has])
    # the pinned extremes exist
    present = f.vals[f.has]
    assert present.max() == 1_000_000 and present.min() == -100_000


def test_positions_are_the_packed_bits():
    for field in ("cab_type", "dist_miles"):
        d = tiny("taxi-1b", 2)
        f = d.fields[field]
        pos = f.positions(1)
        bits = np.zeros((padded_rows(f.rows), d.width), dtype=bool)
        bits.reshape(-1)[pos.astype(np.int64)] = True
        assert np.array_equal(pack(bits), f.packed(1))
