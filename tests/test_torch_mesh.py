"""The device-mesh engine of pilosa_tpu_torch against pilosa_tpu's.

Both packages fill the same holder (tests/_torch_parity.py fill_mesh,
the recipe of tests/test_mesh_spmd.py). The reference runs its mesh
executor on the 8 virtual XLA devices of conftest; the port runs its
mesh route on ``make_mesh(["cpu"] * 8, words_axis)``, eight positions on
one device, with the plain torch versions of the kernels. Both layouts:
8×1 (whole shards per position) and 4×2 (rows split over the words
axis). Every answer must be the same JSON; similarity scores must be the
same f32 bits and ids.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import pilosa_tpu.core as ref_core
import pilosa_tpu_torch.core as pt_core
from pilosa_tpu.executor.executor import Executor as RefExecutor
from pilosa_tpu.executor.row import RowResult as RefRowResult
from pilosa_tpu.parallel import mesh as ref_mesh
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.executor.compile import StackCache
from pilosa_tpu_torch.executor.executor import _Pending
from pilosa_tpu_torch.executor.router import QueryRouter
from pilosa_tpu_torch.executor.row import RowResult
from pilosa_tpu_torch.executor.scheduler import WaveScheduler, fetch_wave
from pilosa_tpu_torch.ops import similarity
from pilosa_tpu_torch.parallel import mesh
from pilosa_tpu_torch.parallel.mesh import MeshContext, MeshQueryEngine, make_mesh
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.server import API
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

from _torch_parity import MIXED_SHARDS, fill_mesh, fill_mixed

LAYOUTS = {"grid": 1, "split": 2}

# tests/test_mesh_spmd.py's READ_QUERIES: every PQL read call type
READ_QUERIES = [
    "Row(f=1)",
    "Row(f=999)",
    "Union(Row(f=1), Row(f=2), Row(g=0))",
    "Intersect(Row(f=1), Row(g=2))",
    "Difference(Row(f=1), Row(g=0))",
    "Xor(Row(f=1), Row(g=3))",
    "Not(Row(f=1))",
    "All()",
    "Shift(Row(f=1), n=5)",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=1), Row(f=2)))",
    "Count(Xor(Difference(Union(Row(f=1), Row(f=2)), Row(g=0)), Row(g=3)))",
    "Count(Not(Row(f=1)))",
    "Count(All())",
    "Count(Shift(Row(f=1), n=3))",
    "Count(Row(v > 100))",
    "Count(Row(v >= -50))",
    "Count(Row(v < 0))",
    "Count(Row(v <= 17))",
    "Count(Row(v == 7))",
    "Count(Row(v != 7))",
    "Count(Row(-100 < v < 100))",
    "Row(v > 250)",
    "TopN(f, n=3)",
    "TopN(f)",
    "TopN(f, ids=[1, 2, 5])",
    "TopN(f, n=3, Row(g=1))",
    "TopN(f, ids=[0, 3], Row(g=2))",
    "Sum(field=v)",
    "Sum(Row(g=1), field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Min(Row(g=2), field=v)",
    "Max(Row(g=2), field=v)",
    "Rows(f)",
    "Rows(f, limit=3)",
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), limit=7)",
    "GroupBy(Rows(f), Rows(g), filter=Row(f=1))",
    "GroupBy(Rows(g), aggregate=Sum(field=v))",
    "Row(t=1, from='2024-01-01T00:00', to='2024-02-20T00:00')",
    "Count(Row(t=2, from='2024-01-01T00:00', to='2024-12-30T00:00'))",
]


def _norm(results) -> str:
    out = [r.to_json() if isinstance(r, (RowResult, RefRowResult)) else r for r in results]
    return json.dumps(out, sort_keys=True, default=str)


def _port_mesh(words_axis: int, n: int = 8) -> MeshContext:
    return MeshContext(make_mesh(["cpu"] * n, words_axis=words_axis))


@pytest.fixture(scope="module")
def rigs():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill_mesh(ref_core, ref_h)
    fill_mesh(pt_core, pt_h)
    out = {"ref_host": RefExecutor(ref_h, route_mode="host"), "host": Executor(pt_h, device="cpu", route_mode="host")}
    for name, w in LAYOUTS.items():
        out["ref_" + name] = RefExecutor(
            ref_h, mesh_ctx=ref_mesh.MeshContext(ref_mesh.make_mesh(jax.devices(), words_axis=w)), route_mode="mesh",
        )
        out[name] = Executor(pt_h, mesh_ctx=_port_mesh(w), route_mode="mesh")
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("q", READ_QUERIES)
def test_mesh_matches_reference_mesh(rigs, layout, q):
    want = _norm(rigs["ref_" + layout].execute("eq", q))
    assert _norm(rigs[layout].execute("eq", q)) == want


def test_mesh_route_actually_taken(rigs):
    """The equivalence is vacuous if everything fell back: every program
    family ran on the mesh, and Shift is the only fallback."""
    for layout in LAYOUTS:
        ex = rigs[layout]
        for q in READ_QUERIES:
            ex.execute("eq", q)
        snap = ex.compiler.mesh_snapshot()
        assert snap["attached"] and snap["devices"] == 8
        assert snap["meshShape"] == {"shards": 8 // LAYOUTS[layout], "words": LAYOUTS[layout]}
        for fam in ("bitmap", "count", "topn", "sum", "minmax", "groupby"):
            assert snap["calls"].get(fam, 0) > 0, (layout, fam, snap["calls"])
        assert snap["fallbacks"] >= 1
        assert ex.router.decisions["mesh"] > 0


@pytest.mark.parametrize("q", ["Count(Row(f=1))", "Row(f=1)", "TopN(f, n=2)", "Sum(field=v)", "Min(Row(g=1), field=v)"])
def test_words_mode_on_an_indivisible_shard_subset(rigs, q):
    """Three shards do not divide the 8-row shards axis: the words axis
    spans every position (shards-major) and the bitmap reads back in that
    order."""
    ex = rigs["grid"]
    fallbacks = ex.compiler.mesh_engine.fallbacks
    got = _norm(ex.execute("eq", f"Options({q}, shards=[0, 1, 2])"))
    assert got == _norm(rigs["ref_grid"].execute("eq", f"Options({q}, shards=[0, 1, 2])"))
    assert got == _norm(rigs["host"].execute("eq", f"Options({q}, shards=[0, 1, 2])"))
    assert ex.compiler.mesh_mode(3) == "words"
    assert ex.compiler.mesh_engine.fallbacks == fallbacks


def test_words_mode_blocks_are_shards_major():
    """A words-mode placement hands out word slices in position order
    (i * words + j): assembling blocks transposed would keep counts and
    break bitmaps."""
    ctx = _port_mesh(2)
    arr = np.arange(3 * 16, dtype=np.uint32).reshape(3, 16)
    placed = ctx.place_rows(arr)
    assert placed.mode == "words"
    for i, j, blk in placed.items():
        p = i * 2 + j
        assert np.array_equal(blk.numpy().view(np.uint32), arr[:, 2 * p : 2 * p + 2])
    assert np.array_equal(placed.host().view(np.uint32), arr)
    assert np.array_equal(placed.gather().numpy().view(np.uint32), arr)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shift_falls_back_to_the_device_route_counted(rigs, layout):
    """Each routing of a Shift tree counts one fallback (the route cache
    then serves a repeated query string without routing it again)."""
    ex = rigs[layout]
    eng = ex.compiler.mesh_engine
    for q in ("Count(Shift(Row(f=1), n=7))", "Count(Intersect(Row(g=1), Shift(Row(f=1), n=40)))"):
        before, device = eng.fallbacks, ex.router.decisions["device"]
        assert _norm(ex.execute("eq", q)) == _norm(rigs["ref_" + layout].execute("eq", q))
        assert eng.fallbacks == before + 1
        assert ex.router.decisions["device"] == device + 1


def test_mesh_pendings_share_a_readback_wave(rigs):
    """Mesh aggregates stay pending on the lead device and settle in one
    transfer with the device route's pendings (a Shift fallback here)."""
    ex = rigs["split"]
    raw = ex.dispatch("eq", "Count(Row(f=1)) Sum(field=v) TopN(f, n=2) Count(Shift(Row(f=1), n=1))")
    pend = [r for r in raw if isinstance(r, _Pending)]
    assert [p.route for p in pend] == ["mesh", "mesh", "mesh", "device"]
    assert {a.device for p in pend for a in p.arrays} == {torch.device("cpu")}
    ex.settle(pend)
    want = rigs["host"].execute("eq", "Count(Row(f=1)) Sum(field=v) TopN(f, n=2) Count(Shift(Row(f=1), n=1))")
    assert [p.value for p in pend] == want
    sched = WaveScheduler(lambda: ex, mode="adaptive")
    batchable, routes = sched._batchable(ex, "eq", parse("Count(Row(f=1))"), None)
    assert batchable and routes[0][0] == "mesh"
    assert sched.execute("eq", "Count(Row(f=1))") == rigs["host"].execute("eq", "Count(Row(f=1))")


def test_fetch_wave_refuses_a_wave_over_several_devices():
    p = _Pending([torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.int64, device="meta")], lambda a: a)
    with pytest.raises(RuntimeError, match="several devices"):
        fetch_wave([p])


def test_auto_router_can_choose_mesh(rigs):
    r = QueryRouter(mode="auto", host_wps=1e9)
    r.mesh_devices = 8
    big = 10**9
    assert r.decide(("k",), big, mesh_ok=True) == "mesh"
    assert r.decide(("k",), big, mesh_ok=False) == "device"
    r2 = QueryRouter(mode="auto", host_wps=1e9)
    assert r2.decide(("k",), big, mesh_ok=True) == "device"
    assert r.decide(("k2",), 10, mesh_ok=True) == "host"
    ex = Executor(rigs["grid"].holder, mesh_ctx=_port_mesh(1), route_mode="auto")
    idx = ex.holder.index("eq")
    assert ex.router.mesh_devices == 8
    assert ex._route(idx, parse("Count(Row(f=1))")[0], None)[2] is True
    assert ex._route(idx, parse("Count(Shift(Row(f=1), n=1))")[0], None)[2] is False


@pytest.mark.parametrize("q", ["Count(Row(f=1))", "TopN(f, n=2)", "Count(Shift(Row(f=1), n=1))", "Rows(f)"])
def test_explain_call_mesh_block(rigs, q):
    ex, ref = rigs["grid"], rigs["ref_grid"]
    got = ex.explain_call(ex.holder.index("eq"), parse(q)[0], None)
    want = ref.explain_call(ref.holder.index("eq"), ref_mesh_parse(q), None)
    assert got.get("mesh") == want.get("mesh")
    assert got["route"] == want["route"]


def ref_mesh_parse(q):
    from pilosa_tpu.pql import parse as ref_parse

    return ref_parse(q)[0]


def test_mesh_profile_reports_devices(rigs):
    from pilosa_tpu_torch.utils import tracing

    prof = tracing.QueryProfile()
    with tracing.use_profile(prof):
        rigs["grid"].execute("eq", "Count(Row(f=1))")
    j = prof.to_json()
    assert j["mesh"]["devices"] == 8
    assert any(c.get("route") == "mesh" for c in j["calls"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_set_then_count_takes_per_block_deltas(layout, monkeypatch):
    """A point write patches only the blocks that hold its shard, one K3
    launch each, with no restack; answers track the reference's."""
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill_mesh(ref_core, ref_h)
    fill_mesh(pt_core, pt_h)
    ref = RefExecutor(ref_h, route_mode="host")
    port = Executor(pt_h, mesh_ctx=_port_mesh(LAYOUTS[layout]), route_mode="mesh")
    q = "Count(Row(f=1)) TopN(f, n=2) Count(Intersect(Row(f=1), Row(g=2)))"
    assert _norm(port.execute("eq", q)) == _norm(ref.execute("eq", q))
    launches = []
    real = ops.apply_stack_delta
    monkeypatch.setattr(ops, "apply_stack_delta", lambda m, i, r, **kw: launches.append(tuple(m.shape)) or real(m, i, r, **kw))
    stacks = port.compiler.stacks
    restacks, deltas = stacks.full_restacks, stacks.delta_updates
    for col in (11, 3 * SHARD_WIDTH + 7, 7 * SHARD_WIDTH + 100):
        for pql in (f"Set({col}, f=1)", q):
            assert _norm(port.execute("eq", pql)) == _norm(ref.execute("eq", pql))
    assert stacks.full_restacks == restacks
    assert stacks.delta_updates == deltas + 3  # f's stack, once per write
    # one launch per touched block: the shard's row of positions
    assert len(launches) == 3 * LAYOUTS[layout]
    w = LAYOUTS[layout]
    assert {s[1:] for s in launches} == {(w, WORDS_PER_SHARD // w)}


def test_a_tiered_field_under_a_mesh_equals_the_host_engine(monkeypatch):
    """A field over a tight budget serves through tiered residency on the
    lead device: trees that touch it fall back to the device route,
    counted, and every answer equals the host engine's."""
    monkeypatch.setattr(StackCache, "STACK_BYTES_BUDGET", 48 * MIXED_SHARDS * WORDS_PER_SHARD * 4)
    h = pt_core.Holder(None)
    fill_mixed(pt_core, h)
    em = Executor(h, mesh_ctx=_port_mesh(1), route_mode="mesh")
    eh = Executor(h, device="cpu", route_mode="host")
    reads = [
        "Count(Row(f=7))", "Count(Union(Row(f=7), Row(f=10), Row(f=11)))", "Row(f=10)",
        "Count(Intersect(Row(f=11), Row(v > 500)))", "Sum(Row(f=11), field=v)", "Max(field=v)",
        "TopN(f, n=5)", "GroupBy(Rows(f, limit=4), Rows(f, limit=3), filter=Row(f=11))",
    ]
    for _ in range(3):  # cold, promoted, resident
        for q in reads:
            assert _norm(em.execute("res", q)) == _norm(eh.execute("res", q)), q
    assert em.compiler.stacks.residency_snapshot()["rowsPromoted"] > 0
    # six trees route to the device route once each; the over-budget
    # TopN streams on each of its three runs
    assert em.compiler.mesh_engine.fallbacks == 6 + 3
    assert em.compiler.mesh_snapshot()["calls"].get("sum", 0) == 0


def test_groupby_padding_rows_count_nothing_on_the_mesh():
    """Rows 0-5 and 7 of an 8-row stack: GroupBy pads the row list with
    -1, which the reference's mesh program takes with jnp.take(mode=
    "fill") and wraps to row 7 (ROADMAP.md §C). The port's K6 reads -1 as
    zeros: its mesh answer is the host engine's."""
    def holder(core):
        h = core.Holder(None)
        idx = h.create_index("j")
        rng = np.random.default_rng(3)
        cols = rng.integers(0, 8 * SHARD_WIDTH, 3000).astype(np.uint64)
        for name in ("a", "b"):
            idx.create_field(name).import_bulk(rng.choice([0, 1, 2, 3, 4, 5, 7], 3000).astype(np.uint64), cols)
        idx.mark_columns_exist(cols)
        return h

    pql = "GroupBy(Rows(a), Rows(b))"
    want = _norm(RefExecutor(holder(ref_core), route_mode="host").execute("j", pql))
    pt_h = holder(pt_core)
    for w in LAYOUTS.values():
        assert _norm(Executor(pt_h, mesh_ctx=_port_mesh(w), route_mode="mesh").execute("j", pql)) == want
    assert _norm(Executor(pt_h, device="cpu", route_mode="host").execute("j", pql)) == want


def test_api_takes_a_mesh_context():
    h = pt_core.Holder(None)
    fill_mesh(pt_core, h)
    api = API(h, mesh_ctx=_port_mesh(2), route_mode="mesh")
    assert api.executor.device == torch.device("cpu")
    host = API(h, device="cpu", route_mode="host")
    for q in ("Count(Row(f=1))", "TopN(f, n=3)", "Row(g=2)"):
        assert api.query("eq", q) == host.query("eq", q)
    assert api.executor.router.decisions["mesh"] == 3
    assert API(h, device="cpu", mesh_ctx="auto").mesh_ctx is None  # no card here


def test_mesh_supported_mirrors_the_reference():
    assert mesh.MESH_PROGRAMS == ref_mesh.MESH_PROGRAMS
    assert mesh.MESH_AGGREGATES == ref_mesh.MESH_AGGREGATES
    assert mesh.MESH_FALLBACK_CALLS == ref_mesh.MESH_FALLBACK_CALLS
    from pilosa_tpu.pql import parse as ref_parse

    for q in READ_QUERIES + ["Count(Intersect(Row(f=1), Shift(Row(f=2), n=1)))", "GroupBy(Rows(f), filter=Shift(Row(f=1), n=1))",
                             "IncludesColumn(Row(f=1), column=3)", "Options(Count(Row(f=1)), shards=[1])"]:
        assert mesh.mesh_supported(parse(q)[0]) == ref_mesh.mesh_supported(ref_parse(q)[0]), q


def test_make_mesh_and_auto():
    m = make_mesh(["cpu"] * 8, words_axis=4)
    assert m.shape == {"shards": 2, "words": 4} and m.size == 8 and m.lead == torch.device("cpu")
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 6, words_axis=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(["cuda"] * 2)
    assert MeshContext.auto() is None
    assert MeshContext.auto(devices=["cpu"]) is None
    ctx = _port_mesh(2)
    assert ctx.mode_for(8, 2048) == "grid" and ctx.mode_for(3, 2048) == "words" and ctx.mode_for(3, 4) == "replicate"


# --------------------------------------------------------------- similarity
SIM_S, SIM_R = 512, 16  # 2^25 bits per row: counts past 2^24


def _fingerprints():
    """uint32[R, S, W] rows with counts past 2^24 (all ones, 3/4 and
    random dense), a tie block (rows 4-7 equal), a zero row, and sparse
    rows; the query is a dense row."""
    rng = np.random.default_rng(5)
    w = WORDS_PER_SHARD
    m = rng.integers(0, 2**32, (SIM_R, SIM_S, w), dtype=np.uint32)
    m[1] |= rng.integers(0, 2**32, (SIM_S, w), dtype=np.uint32)
    m[2] = 0xFFFFFFFF
    m[3] = 0
    m[5] = m[6] = m[7] = m[4]
    m[9] &= rng.integers(0, 2**32, (SIM_S, w), dtype=np.uint32) & rng.integers(0, 2**32, (SIM_S, w), dtype=np.uint32)
    m[10] = m[1]
    q = m[1] | rng.integers(0, 2**32, (SIM_S, w), dtype=np.uint32)
    return m, q


@pytest.fixture(scope="module")
def fingerprints():
    return _fingerprints()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
def test_mesh_search_matches_reference_bitwise(fingerprints, layout, metric):
    m, q = fingerprints
    w = LAYOUTS[layout]
    rmesh = ref_mesh.make_mesh(jax.devices(), words_axis=w)
    reng = ref_mesh.MeshQueryEngine(rmesh)
    rm = jax.device_put(m, NamedSharding(rmesh, P(None, "shards", "words")))
    rq = jax.device_put(q, NamedSharding(rmesh, P("shards", "words")))
    ctx = _port_mesh(w)
    eng = MeshQueryEngine(ctx.mesh)
    pm, pq = ctx.place_stack(m), ctx.place_rows(q)
    assert pm.mode == "grid"
    for k in (1, 5, SIM_R, SIM_R + 3):
        r_scores, r_ids = (np.asarray(x) for x in getattr(reng, metric)(rm, rq, k))
        scores, ids = getattr(eng, metric)(pm, pq, k)
        assert np.array_equal(scores.numpy().view(np.uint32), r_scores.view(np.uint32)), (k, scores, r_scores)
        assert np.array_equal(ids.numpy(), r_ids)
    assert eng.snapshot()["calls"] == {metric: 4}


def test_mesh_sim_keys_plain_rounds_as_f32():
    """K12's plain search entry against numpy's f32 arithmetic (IEEE, the
    reference's order) on counts far past 2^24: the key's score bits and
    its row."""
    rng = np.random.default_rng(9)
    n = 4096
    row_pop = rng.integers(0, 2**40, n)
    inter = (row_pop * rng.random(n)).astype(np.int64)
    inter[:5] = row_pop[:5] = [0, 0, 2**24 + 1, 2**33 + 3, 7]
    q_pop = np.int64(2**41 + 5)  # a set's intersections are at most its count
    f = np.float32
    fi, fr, fq = inter.astype(f), row_pop.astype(f), f(q_pop)
    union = (fr + fq) - fi
    denom = np.sqrt(fr * fq)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = {
            "tanimoto": np.where(union > 0, fi / union, f(0)),
            "cosine": np.where(denom > 0, fi / denom, f(0)),
        }
    for metric, scores in want.items():
        keys, hist = similarity.mesh_sim_keys(
            torch.from_numpy(inter), torch.from_numpy(row_pop), torch.tensor([q_pop]), metric
        )
        k = keys.numpy()
        assert np.array_equal((k >> 32).astype(np.uint32), scores.astype(np.float32).view(np.uint32)), metric
        assert np.array_equal(k & 0xFFFFFFFF, 0xFFFFFFFF - np.arange(n))
        assert np.array_equal(hist.numpy(), np.bincount(k >> similarity.SELECT_SHIFTS[0], minlength=4096))
    # a count past its set's: the 64-bit digits put any f32 score's key
    # in the histogram, in the bin of its top digit
    keys, hist = similarity.mesh_sim_keys(*(torch.tensor(v, dtype=torch.int64) for v in ([9], [1], [1])), "cosine")
    digit = keys.item() >> similarity.SELECT_SHIFTS[0]
    assert keys.item() >> 32 == np.float32(9).view(np.uint32) and hist[digit].item() == 1 and hist.sum().item() == 1


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_pairwise_matches_reference_bitwise(layout):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2**32, (16, 64), dtype=np.uint32) & rng.integers(0, 2**32, (16, 64), dtype=np.uint32)
    b = rng.integers(0, 2**32, (24, 64), dtype=np.uint32)
    a[0], a[1], b[2] = 0, 0xFFFFFFFF, 0
    b[3] = a[5]
    w = LAYOUTS[layout]
    reng = ref_mesh.MeshQueryEngine(ref_mesh.make_mesh(jax.devices(), words_axis=w))
    ra, rb = reng.place_allpairs(a, b)
    eng = MeshQueryEngine(make_mesh(["cpu"] * 8, words_axis=w))
    pa, pb = eng.place_allpairs(a, b)
    for metric in ("tanimoto", "cosine"):
        want = np.asarray(getattr(reng, "pairwise_" + metric)(ra, rb))
        got = getattr(eng, "pairwise_" + metric)(pa, pb)
        assert got.mode == "rows" and got.shape == (16, 24)
        assert np.array_equal(got.host().view(np.uint32), want.view(np.uint32)), metric
        assert np.array_equal(got.gather().numpy().view(np.uint32), want.view(np.uint32))
    with pytest.raises(ValueError, match="shards axis"):
        eng.place_allpairs(a[:5], b)
