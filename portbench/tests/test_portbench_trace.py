"""The byte counts behind kernels_roofline, the interval arithmetic of
device_idle_pct and the breakdown, and the metric readers on a
made-up run."""

import pytest

from portbench.data import Dataset
from portbench.roofline import query_bytes
from portbench.run import Bench, Run, reader
from portbench.trace import breakdown, gaps, union_length


@pytest.fixture(scope="module")
def taxi_data():
    return Dataset(Bench().config("taxi-1b"), 1, shards=4, width_exp=12)


def test_a_plane_is_a_row_over_every_shard():
    full = Dataset(Bench().config("taxi-1b"), 1, width_exp=12, only=["cab_type"])
    assert full.plane_bytes() == 1049 * (1 << 12) // 8


@pytest.mark.parametrize("pql, planes", [
    ("Count(Intersect(Row(passenger_count=1), Row(pickup_year=2), Row(dist_miles=3)))", 3),
    ("Count(Union(Row(cab_type=1), Difference(Row(cab_type=2), Row(cab_type=1)), Row(dist_miles=0)))", 3),
    ("Count(Xor(Row(cab_type=1), Row(cab_type=9)))", 1),  # a row past the field reads nothing
    ("TopN(dist_miles, Intersect(Row(passenger_count=1), Row(pickup_year=2)))", 100 + 2),
    ("TopN(dist_miles, Row(dist_miles=7), n=5)", 100),  # the filter is one of the ranked rows
    ("TopN(passenger_count, Row(cab_type=1), ids=[3, 4, 12])", 2 + 1),
])
def test_count_and_topn_bytes(taxi_data, pql, planes):
    assert query_bytes(taxi_data, pql) == planes * taxi_data.plane_bytes()


@pytest.mark.parametrize("pql, planes", [
    ("GroupBy(Rows(cab_type))", 3),
    ("GroupBy(Rows(passenger_count), aggregate=Sum(field=total_amount))", 10 + 22),
    ("GroupBy(Rows(passenger_count), Rows(pickup_year), Rows(dist_miles))", 10 + 7 + 100),
    ("GroupBy(Rows(cab_type), filter=Row(0 <= total_amount <= 5000))", 3 + 22),
    ("GroupBy(Rows(passenger_count), aggregate=Sum(field=total_amount), filter=Row(1 <= total_amount <= 9))", 10 + 22),
    ("GroupBy(Rows(passenger_count), Rows(pickup_year), Rows(dist_miles), filter=Row(0 <= total_amount <= 5))",
     10 + 7 + 100 + 22),
    ("Sum(Row(cab_type=1), field=total_amount)", 22 + 1),
])
def test_groupby_and_sum_bytes(taxi_data, pql, planes):
    assert query_bytes(taxi_data, pql) == planes * taxi_data.plane_bytes()


def test_union_and_gaps():
    spans = [(0, 10, "a"), (5, 12, "b"), (20, 25, "c"), (22, 23, "d"), (30, 31, "a")]
    assert union_length([(a, b) for a, b, _ in spans]) == 12 + 5 + 1
    assert gaps(spans) == [(8, "b", "c"), (5, "c", "a")]
    out = breakdown(spans)
    assert out["device_ops"][0] == ["a", 11e-6]
    assert out["idle_gaps"] == [["after b before c", 8e-6], ["after c before a", 5e-6]]


def made_up_run(data) -> Run:
    run = Run()
    run.seconds, run.card = 1.0, "NVIDIA H100 80GB HBM3"
    run.t_go, run.t_end, run.t_done = 100.0, 101.0, 101.0
    # 4 answered requests of 0.1 s, one failed
    run.records = [[0, i, 100.0 + 0.2 * i, 100.1 + 0.2 * i, 200] for i in range(4)] + [[1, 0, 100.5, 100.6, 500]]
    run.api_seconds = [0.06] * 4
    run.before = {"decisions": {"device": 10, "host": 0}, "scheduler": {"waves": 5, "batchedQueries": 10,
                                                                        "dedupedQueries": 0},
                  "launches": {"tree_eval": 10}}
    run.after = {"decisions": {"device": 14, "host": 0}, "scheduler": {"waves": 7, "batchedQueries": 14,
                                                                       "dedupedQueries": 0},
                 "launches": {"tree_eval": 18}}
    run.events = [(0.0, 250_000.0, "k"), (500_000.0, 600_000.0, "Memcpy DtoH")]
    run.kernels = [(0.0, 125_000.0, "k")] * 8
    run.query_bytes = int(3.35e12 * 0.1)
    return run


def test_readers_on_a_made_up_run(taxi_data):
    run = made_up_run(taxi_data)
    got = {n: reader(n)(run) for n in ("qps", "front_end_ms", "device_route_pct", "queries_per_wave",
                                         "launches_per_query", "kernels_roofline", "device_idle_pct")}
    assert got["qps"] == 4.0
    assert got["front_end_ms"] == pytest.approx(100.0 - 60.0)
    assert got["device_route_pct"] == 100.0
    assert got["queries_per_wave"] == 2.0
    assert got["launches_per_query"] == 2.0
    assert got["kernels_roofline"] == pytest.approx(80.0)  # 0.1 s of bytes over 0.125 s of kernels
    assert got["device_idle_pct"] == pytest.approx(65.0)  # 0.35 s busy of 1 s


def test_p95_counts_a_failed_request_as_slowest(taxi_data):
    run = made_up_run(taxi_data)
    assert reader("p95_ms")(run) is None  # 5 requests: the 95th is the failed one
    run.records[-1][4] = 200
    assert reader("p95_ms")(run) == pytest.approx(100.0)


def test_roofline_is_not_measured_where_a_query_skipped_the_device(taxi_data):
    run = made_up_run(taxi_data)
    run.after["decisions"]["host"] = 1
    run.after["decisions"]["device"] = 13
    assert reader("kernels_roofline")(run) is None
    run = made_up_run(taxi_data)
    run.after["scheduler"]["dedupedQueries"] = 1
    assert reader("kernels_roofline")(run) is None
    run = made_up_run(taxi_data)
    run.kernels = run.kernels[:7]  # fewer kernels traced than launched
    assert reader("kernels_roofline")(run) is None
