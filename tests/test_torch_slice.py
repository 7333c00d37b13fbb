"""The slice end to end: pilosa_tpu_torch's ``API.query`` against
pilosa_tpu's on one seeded data set (tests/_torch_parity.py).

The reference is pilosa_tpu on its single-device route
(``route_mode="device"``, no mesh); the port runs its plain torch
versions (``device="cpu"``). Every answer must be the same JSON.
"""

import threading

import numpy as np
import pytest

import pilosa_tpu.core as ref_core
import pilosa_tpu_torch.core as pt_core
from pilosa_tpu.executor.router import QueryRouter as RefRouter
from pilosa_tpu.roaring import Bitmap as RefBitmap
from pilosa_tpu.roaring import serialize as ref_serialize
from pilosa_tpu.server.api import API as RefAPI
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.executor.compile import QueryCompiler, StackCache
from pilosa_tpu_torch.server import API

from _torch_parity import fill

T_RANGE = "from='2020-02-01T00:00', to='2020-11-15T00:00'"

READS = [
    # Count
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Row(f=5))",
    "Count(Row(f=4))",
    "Count(Union())",
    "Count(Not(Union(Row(f=1), Row(g=0))))",
    # bitmap calls
    "Row(f=1)",
    "Row(f=9)",
    f"Row(t=1, {T_RANGE})",
    f"Range(t=2, {T_RANGE})",
    "Union(Row(f=1), Row(g=2))",
    "Intersect(Row(f=1), Row(f=5))",
    "Difference(Row(f=5), Row(f=3))",
    "Xor(Row(f=4), Row(f=5))",
    "Not(Row(f=1))",
    "All()",
    "Xor()",
    # TopN
    "TopN(f, n=3)",
    "TopN(f)",
    "TopN(f, Row(g=1), n=4)",
    "TopN(f, ids=[1, 3, 9, 2147483647])",
    "TopN(f, Row(g=0), ids=[0, 2, 4, 7], n=2)",
    # Rows, IncludesColumn, Options
    "Rows(f)",
    "Rows(f, limit=2)",
    "Rows(g, column=5)",
    "IncludesColumn(Row(f=5), column=3)",
    "IncludesColumn(Row(f=1), column=70000)",
    "Options(Count(Row(f=1)), shards=[0, 2])",
    "Options(Row(f=4), shards=[1])",
    "Options(Row(f=2), excludeColumns=true)",
    # several calls, one readback wave
    "Count(Row(f=1)) TopN(g, n=2) Row(g=1)",
]

# BSI conditions, Sum, Min, Max and GroupBy: K1's CMP, K4, K5 and K6
AGGREGATES = [
    "Row(v > 0)",
    "Row(v == null)",
    "Row(v != null)",
    "Row(-10 < v < 300)",
    "Row(v >< [-5, 5])",
    "Count(Intersect(Row(f=1), Row(v >= -250)))",
    "Count(Row(v == 2000))",
    "Count(Row(v < -1000))",
    "Sum(Row(f=2), field=v)",
    "Sum(Row(v < 0), field=v)",
    "Min(Row(g=1), field=v)",
    "Max(field=v)",
    "Min(Row(v > 100), field=v)",
    "GroupBy(Rows(f), Rows(g), filter=Row(v > 0))",
    "GroupBy(Rows(f), Rows(g), limit=5)",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    "GroupBy(Rows(f), Rows(g), Rows(t))",
    "GroupBy(Rows(g), Rows(f), filter=Row(v < 500), aggregate=Sum(field=v), limit=9)",
    "Count(Row(v > 0)) Sum(field=v) GroupBy(Rows(g)) Min(field=v)",
]

# the calls that ran only on the host engine before their device
# programs were ported; the case names stay as they were
HOST_ONLY = [
    "Sum(field=v)",
    "Min(field=v)",
    "Max(Row(f=1), field=v)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(g), aggregate=Sum(field=v))",
]


def _ref_api(holder, mode="device"):
    return RefAPI(holder, router=RefRouter(mode=mode))


@pytest.fixture(scope="module")
def apis():
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill(ref_core, ref_h)
    fill(pt_core, pt_h)
    return _ref_api(ref_h), API(pt_h, device="cpu", route_mode="device")


@pytest.mark.parametrize("pql", READS)
def test_query_matches_reference(apis, pql):
    ref, port = apis
    assert port.query("i", pql) == ref.query("i", pql)


@pytest.mark.parametrize("pql", AGGREGATES)
def test_bsi_and_groupby_queries_match_reference(apis, pql):
    ref, port = apis
    assert port.query("i", pql) == ref.query("i", pql)


@pytest.mark.parametrize("pql", HOST_ONLY)
def test_host_engine_calls_match_reference(pql):
    """Host, auto and device routes all give the reference's answer, and
    auto no longer counts them as unported."""
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill(ref_core, ref_h)
    fill(pt_core, pt_h)
    want = _ref_api(ref_h, "host").query("i", pql)
    assert _ref_api(ref_h, "device").query("i", pql) == want
    assert API(pt_h, device="cpu", route_mode="host").query("i", pql) == want
    auto = API(pt_h, device="cpu", route_mode="auto")
    assert auto.query("i", pql) == want
    assert auto.executor.router.decisions.get("host_unported", 0) == 0
    assert API(pt_h, device="cpu", route_mode="device").query("i", pql) == want


def test_shift_is_the_one_unported_call():
    """Shift was the last call without a device path: the device route
    now answers it as the reference's does, and under auto the router
    counts no decision as forced host-side by a missing port."""
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill(ref_core, ref_h)
    fill(pt_core, pt_h)
    pql = "Count(Shift(Row(f=1), n=3))"
    want = _ref_api(ref_h, "device").query("i", pql)
    assert API(pt_h, device="cpu", route_mode="device").query("i", pql) == want
    auto = API(pt_h, device="cpu", route_mode="auto")
    assert auto.query("i", pql) == want
    decisions = auto.executor.router.decisions
    assert decisions["host_unported"] == 0 and decisions["host"] + decisions["device"] == 1


def test_groupby_level_path_matches_reference(monkeypatch):
    """A mask budget of one plane turns the fused GroupBy off and cuts
    the level-synchronous path into one-pair chunks, on both packages."""
    from pilosa_tpu.executor.executor import Executor as RefExecutor

    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill(ref_core, ref_h)
    fill(pt_core, pt_h)
    plane = 3 * 65536 // 8
    monkeypatch.setattr(RefExecutor, "GROUPBY_MASK_BUDGET", plane)
    monkeypatch.setattr(Executor, "GROUPBY_MASK_BUDGET", plane)
    ref, port = _ref_api(ref_h), API(pt_h, device="cpu", route_mode="device")
    for pql in (
        "GroupBy(Rows(f), Rows(g))",
        "GroupBy(Rows(f), Rows(g), Rows(t), limit=11)",
        "GroupBy(Rows(g), Rows(f), filter=Row(v != null), aggregate=Sum(field=v))",
    ):
        assert port.query("i", pql) == ref.query("i", pql), pql


def test_groupby_padding_rows_count_nothing():
    """A field whose highest row is its stack's last padded row, with a
    row missing below it (rows 0-5 and 7 of 8): the port's padding row
    id -1 reads zeros, so the fused GroupBy equals the host engines.
    (The reference's device route wraps -1 to the last row there;
    ROADMAP.md §C.)"""
    def holder(core):
        h = core.Holder(None)
        idx = h.create_index("j")
        rng = np.random.default_rng(3)
        cols = rng.integers(0, 2 * 65536, 3000).astype(np.uint64)
        for name in ("a", "b"):
            idx.create_field(name).import_bulk(
                rng.choice([0, 1, 2, 3, 4, 5, 7], 3000).astype(np.uint64), cols
            )
        idx.mark_columns_exist(cols)
        return h

    pql = "GroupBy(Rows(a), Rows(b))"
    want = _ref_api(holder(ref_core), "host").query("j", pql)
    pt_h = holder(pt_core)
    assert API(pt_h, device="cpu", route_mode="device").query("j", pql) == want
    assert API(pt_h, device="cpu", route_mode="host").query("j", pql) == want


def test_set_then_count_takes_the_delta_path():
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill(ref_core, ref_h)
    fill(pt_core, pt_h)
    ref, port = _ref_api(ref_h), API(pt_h, device="cpu", route_mode="device")
    q = "Count(Row(f=1)) TopN(f, n=2)"
    assert port.query("i", q) == ref.query("i", q)
    stacks = port.executor.compiler.stacks
    restacks, deltas = stacks.full_restacks, stacks.delta_updates
    for col in (11, 65536 + 7, 2 * 65536 + 100):
        for pql in (f"Set({col}, f=1)", q):
            assert port.query("i", pql) == ref.query("i", pql)
    assert stacks.full_restacks == restacks
    assert stacks.delta_updates >= deltas + 3


def test_imports_match_reference():
    """import_bits and import_roaring through both façades."""
    rng = np.random.default_rng(3)
    apis = [_ref_api(ref_core.Holder(None)), API(pt_core.Holder(None), device="cpu", route_mode="device")]
    rows = rng.integers(0, 4, 800).tolist()
    cols = rng.integers(0, 3 * 65536, 800).tolist()
    positions = np.unique(rng.integers(0, 4 * 65536, 600)).astype(np.uint64)
    bm = RefBitmap()
    bm.add_many(positions)
    payload = ref_serialize(bm)
    answers = []
    for api in apis:
        api.create_index("j")
        api.create_field("j", "f")
        api.import_bits("j", "f", {"rowIDs": rows, "columnIDs": cols})
        assert api.import_roaring("j", "f", 2, payload) > 0
        answers.append(
            [api.query("j", q) for q in ("Count(Row(f=1))", "Row(f=2)", "TopN(f)", "Count(Not(Row(f=0)))")]
        )
    assert answers[0] == answers[1]


@pytest.mark.parametrize("writer", ["pilosa_tpu", "pilosa_tpu_torch"])
def test_a_data_directory_carries_across_packages(tmp_path, writer):
    """Roaring at rest is shared: each package opens what the other wrote."""
    path = str(tmp_path / "data")
    w_core = ref_core if writer == "pilosa_tpu" else pt_core
    h = w_core.Holder(path)
    h.open()
    fill(w_core, h)
    h.close()
    pt_h, ref_h = pt_core.Holder(path), ref_core.Holder(path)
    pt_h.open()
    ref_h.open()
    try:
        port, ref = API(pt_h, device="cpu", route_mode="device"), _ref_api(ref_h)
        for pql in ("Count(Row(f=1))", "TopN(f, n=3)", "Row(f=4)", "Not(Row(g=1))"):
            assert port.query("i", pql) == ref.query("i", pql)
    finally:
        pt_h.close()
        ref_h.close()


@pytest.mark.parametrize(
    "entry", [API, Executor, QueryCompiler, StackCache], ids=lambda c: c.__name__
)
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    """No device= means cuda, and without a card that raises: nothing
    drops to the CPU unless the caller names it."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    args = () if entry in (QueryCompiler, StackCache) else (pt_core.Holder(None),)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(*args)


def test_concurrent_queries_share_waves_and_match_solo_answers(apis):
    ref, _port = apis
    pt_h = pt_core.Holder(None)
    fill(pt_core, pt_h)
    port = API(pt_h, device="cpu", route_mode="device", batch_mode="always", batch_window_us=20000)
    queries = [f"Count(Intersect(Row(f={r}), Row(g={r % 3})))" for r in range(6)] * 2
    got: dict[int, dict] = {}

    def run(i):
        got[i] = port.query("i", queries[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert [got[i] for i in range(len(queries))] == [ref.query("i", q) for q in queries]
    snap = port.scheduler.snapshot()
    assert snap["batchedQueries"] + snap["dedupedQueries"] >= len(queries)
    assert snap["waves"] < len(queries)
