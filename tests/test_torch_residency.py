"""Over-budget residency in pilosa_tpu_torch against pilosa_tpu.

Both packages get the same holder (tests/_torch_parity.py fill_mixed) and
the same tight stack budget, so the same field goes over budget in both
and serves through residency: the default tiered mode (cold one-shot
planes, promotion into dense, sparse and run container stores, LRU
demotion) and the legacy slots mode. Answers, and the residency
counters, must be the reference's exactly. The port runs its plain
torch versions (``device="cpu"``).
"""

import gc
import json
import weakref

import numpy as np
import pytest
import torch

import pilosa_tpu.core as ref_core
import pilosa_tpu_torch.core as pt_core
from pilosa_tpu import ops as ref_ops
from pilosa_tpu.executor import Executor as RefExecutor
from pilosa_tpu.executor import residency as ref_residency
from pilosa_tpu.executor.compile import StackCache as RefStackCache
from pilosa_tpu.executor.hostpath import decode_container as ref_decode
from pilosa_tpu.executor.router import QueryRouter as RefRouter
from pilosa_tpu.pql import parse as ref_parse
from pilosa_tpu.server.api import API as RefAPI
from pilosa_tpu.utils import tracing as ref_tracing
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.executor import ExecutionError, Executor, residency
from pilosa_tpu_torch.executor.compile import StackCache
from pilosa_tpu_torch.executor.hostpath import decode_container
from pilosa_tpu_torch.ops import bitwise, containers, stack
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.server import API
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD
from pilosa_tpu_torch.utils import tracing

from _torch_parity import MIXED_SHARDS, fill_mixed

PLANE_WORDS = MIXED_SHARDS * WORDS_PER_SHARD
# 48 planes: well below f's 256-row padded stack, above v's BSI stack
BUDGET = 48 * PLANE_WORDS * 4

# the read surface: Count, bitmap calls, Shift, BSI conditions, TopN
# plain and ids=, Sum, Min, Max, GroupBy with and without aggregate
READS = [
    "Row(f=10)",
    "Count(Row(f=7))",
    "Count(Row(f=10))",
    "Count(Row(f=11))",
    "Count(Union(Row(f=7), Row(f=10), Row(f=11)))",
    "Count(Difference(Row(f=11), Row(f=10)))",
    "Count(Not(Row(f=11)))",
    "Count(Shift(Row(f=10), n=5))",
    "Count(Intersect(Row(f=11), Row(v > 500)))",
    "Count(Row(v != null))",
    "Sum(Row(f=11), field=v)",
    "Min(Row(f=10), field=v)",
    "Max(field=v)",
    "TopN(f, n=5)",
    "TopN(f, Row(f=11), n=3, ids=[7, 10, 11, 9999])",
    "GroupBy(Rows(f, limit=12))",
    "GroupBy(Rows(f, limit=4), Rows(f, limit=3), filter=Row(f=11))",
    "GroupBy(Rows(f, limit=6), aggregate=Sum(field=v))",
]


def _ref_api(holder):
    return RefAPI(holder, router=RefRouter(mode="device"))


def _answer(api, pql):
    try:
        return api.query("res", pql)
    except Exception as e:  # both packages must fail alike, as ExecutionError
        return f"error: {type(e).__name__}"


@pytest.fixture
def tight(monkeypatch):
    monkeypatch.setattr(RefStackCache, "STACK_BYTES_BUDGET", BUDGET)
    monkeypatch.setattr(StackCache, "STACK_BYTES_BUDGET", BUDGET)


@pytest.fixture(scope="module")
def _built():
    return {}


@pytest.fixture
def surfaces(_built, tight, monkeypatch):
    """Per residency mode: the reference API and the port's API over the
    same holder, kept across the module's tests, under the tight budget
    and the mode for the test that asks."""

    def get(mode):
        monkeypatch.setattr(RefStackCache, "RESIDENCY_MODE", mode)
        monkeypatch.setattr(StackCache, "RESIDENCY_MODE", mode)
        if mode not in _built:
            ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
            fill_mixed(ref_core, ref_h)
            fill_mixed(pt_core, pt_h)
            _built[mode] = (_ref_api(ref_h), API(pt_h, device="cpu", route_mode="device"))
        return _built[mode]

    return get


def _pair(n_rows=200):
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill_mixed(ref_core, ref_h, n_rows=n_rows)
    fill_mixed(pt_core, pt_h, n_rows=n_rows)
    return (
        RefExecutor(ref_h, route_mode="device"),
        Executor(pt_h, device="cpu", route_mode="device"),
    )


def _same(ref, port, pql):
    want = ref.execute("res", pql)[0]
    got = port.execute("res", pql)[0]
    if hasattr(want, "columns"):
        assert got.columns().tolist() == want.columns().tolist(), pql
    else:
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), pql
    return got


_SNAP_KEYS = ("rowsPromoted", "rowsDemoted", "coldUploads", "residentRows", "bytesByContainer", "tiers", "evictions")


def _snapshots_equal(ref, port):
    want = ref.compiler.stacks.residency_snapshot()
    got = port.compiler.stacks.residency_snapshot()
    assert {k: got[k] for k in _SNAP_KEYS} == {k: want[k] for k in _SNAP_KEYS}
    return got


# ------------------------------------------------- containers and chooser
def _planes():
    rng = np.random.default_rng(3)
    shape = (MIXED_SHARDS, WORDS_PER_SHARD)
    empty = np.zeros(shape, np.uint32)
    sparse = np.zeros(shape, np.uint32)
    flat = sparse.reshape(-1)
    flat[rng.choice(flat.size, 200, replace=False)] = np.uint32(1) << rng.integers(0, 32, 200).astype(np.uint32)
    flat[0], flat[-1] = 0x80000001, 0x80000000  # bit 0, bit 31, the plane's last bit
    run = np.zeros(shape, np.uint32)
    run[0, 10:200] = 0xFFFFFFFF
    run[0, 9] = 0xFFFF0000  # a run's partial head word
    run[0, 200] = 0x0000000F  # and its partial tail
    run[0, -1] = 0x80000000  # a run across the shard boundary
    run[1, 0:7] = 0xFFFFFFFF
    run[1, 100] = 0x0FF00000  # a run inside one word
    dense = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return {"empty": empty, "sparse": sparse, "run": run, "dense": dense}


def test_chooser_picks_each_kind_as_the_reference():
    expected = {"empty": "run", "sparse": "sparse", "run": "run", "dense": "dense"}
    for name, plane in _planes().items():
        got = residency.choose_container(*residency.analyze_plane(plane), PLANE_WORDS)
        want = ref_residency.choose_container(*ref_residency.analyze_plane(plane), PLANE_WORDS)
        assert got == want == expected[name], name
    for const in ("SPARSE_MAX_IDS", "RUN_MAX_INTERVALS", "PROMOTE_TOUCHES", "MAX_TOUCH_ROWS", "_MAX_PLANE_BITS"):
        assert getattr(residency, const) == getattr(ref_residency, const)
    # past 2^31 bits a plane stays dense: int32 ids could not name its bits
    assert residency.choose_container(1, 1, (1 << 26) + 1) == "dense"


@pytest.mark.parametrize("kind", ["sparse", "run", "dense"])
def test_container_decodes_match_reference(kind):
    plane = _planes()["run" if kind == "run" else kind]
    payload = residency.pack_container(kind, plane)
    assert np.array_equal(payload, ref_residency.pack_container(kind, plane))
    for decode in (decode_container, ref_decode):
        assert np.array_equal(decode(kind, payload, MIXED_SHARDS, WORDS_PER_SHARD), plane)
    if kind == "dense":
        return
    # the store layout: a fixed capacity with the kind's padding
    cap = residency.SPARSE_MAX_IDS if kind == "sparse" else residency.RUN_MAX_INTERVALS
    padded = np.full((cap,) + payload.shape[1:], -1 if kind == "sparse" else 0, np.int32)
    padded[: payload.shape[0]] = payload
    t = torch.from_numpy(padded)
    if kind == "sparse":
        got = containers.sparse_plane(t, MIXED_SHARDS, WORDS_PER_SHARD)
        want = ref_ops.containers.sparse_plane(padded, MIXED_SHARDS, WORDS_PER_SHARD)
        count, ref_count = containers.sparse_count(t), ref_ops.containers.sparse_count(padded)
    else:
        got = containers.run_plane(t, MIXED_SHARDS, WORDS_PER_SHARD)
        want = ref_ops.containers.run_plane(padded, MIXED_SHARDS, WORDS_PER_SHARD)
        count, ref_count = containers.run_count(t), ref_ops.containers.run_count(padded)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    assert np.array_equal(got.numpy().view(np.uint32), plane)
    assert int(count) == int(ref_count) == int(np.bitwise_count(plane).sum())
    # K8's wrapper: a slot of a store, and a slot outside it counts 0
    store = torch.stack([torch.full_like(t, -1 if kind == "sparse" else 0), t])
    assert int(ops.container_count(store.contiguous(), 1)) == int(count)
    assert int(ops.container_count(store.contiguous(), 0)) == 0
    assert int(ops.container_count(store.contiguous(), -1)) == 0
    assert int(ops.container_count(store.contiguous(), 2)) == 0


def test_tree_eval_decodes_container_leaves():
    """K1's plain interpreter with LOAD_SPARSE and LOAD_RUN leaves (and a
    slot outside the store) against numpy over the decoded planes."""
    planes = _planes()
    sp = residency.pack_container("sparse", planes["sparse"])
    rn = residency.pack_container("run", planes["run"])
    sparse_store = torch.full((3, residency.SPARSE_MAX_IDS), -1, dtype=torch.int32)
    sparse_store[1, : sp.size] = torch.from_numpy(sp)
    run_store = torch.zeros((2, residency.RUN_MAX_INTERVALS, 2), dtype=torch.int32)
    run_store[0, : rn.shape[0]] = torch.from_numpy(rn)
    dense = torch.from_numpy(planes["dense"].view(np.int32)[None].copy())
    L, LS, LR = bitwise.OP_LOAD, bitwise.OP_LOAD_SPARSE, bitwise.OP_LOAD_RUN
    A, O, X = bitwise.OP_AND, bitwise.OP_OR, bitwise.OP_XOR
    stacks = [dense, sparse_store, run_store]
    leaves = [(0, 0), (1, 1), (2, 0), (1, 7)]
    prog = [(L, 0), (LS, 1), (O, 0), (LR, 2), (X, 0), (LS, 3), (O, 0)]
    want = (planes["dense"] | planes["sparse"]) ^ planes["run"]
    words = ops.tree_eval(stacks, leaves, prog, MIXED_SHARDS, count=False)
    assert np.array_equal(words.numpy().view(np.uint32), want)
    count = ops.tree_eval(stacks, leaves, [(LS, 1), (LR, 2), (A, 0)], MIXED_SHARDS, count=True)
    assert int(count) == int(np.bitwise_count(planes["sparse"] & planes["run"]).sum())
    with pytest.raises(ValueError, match="not \\[R"):
        ops.tree_eval(stacks, [(1, 1)], [(L, 0)], MIXED_SHARDS, count=True)


def test_container_opcodes_are_the_sources():
    """LOAD_SPARSE, LOAD_RUN and the two capacities in TreeArgs mirror
    csrc/tree_interp.cuh, and the parameter stays within 4 KB."""
    import ctypes
    import re

    from pilosa_tpu_torch.ops import _cuda

    with open(_cuda.CSRC + "/tree_interp.cuh") as fh:
        src = fh.read()
    assert int(re.search(r"TE_LOAD_SPARSE = (\d+)", src).group(1)) == bitwise.OP_LOAD_SPARSE
    assert int(re.search(r"TE_LOAD_RUN = (\d+)", src).group(1)) == bitwise.OP_LOAD_RUN
    fields = [f for f, _t in bitwise._TreeArgs._fields_]
    assert fields[fields.index("n_conds") + 1 : fields.index("op")] == ["sparse_cap", "run_cap"]
    assert re.search(r"int n_conds;\s*int sparse_cap;[^\n]*\n\s*int run_cap;", src)
    assert ctypes.sizeof(bitwise._TreeArgs) == 3608


@pytest.mark.parametrize("kind", ["dense", "sparse", "run"])
def test_scatter_rows_plain_matches_a_row_loop(kind):
    """K3 in row mode: store[idx[k]] = rows[k] on a copy; an entry out of
    range drops, the later of two entries wins, the input is untouched."""
    rng = np.random.default_rng(5)
    shape = {"dense": (6, MIXED_SHARDS, WORDS_PER_SHARD), "sparse": (6, 2048), "run": (6, 128, 2)}[kind]
    store = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32))
    before = store.clone()
    idx = torch.tensor([4, stack.OOB, 1, -1, 4, 0], dtype=torch.int32)
    rows = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, (6,) + shape[1:], dtype=np.int64).astype(np.int32))
    got = ops.scatter_rows(store, idx, rows)
    want = before.clone()
    for k, slot in enumerate(idx.tolist()):
        if 0 <= slot < shape[0]:
            want[slot] = rows[k]
    assert torch.equal(got, want)
    assert torch.equal(store, before)


# ------------------------------------------------------------ read surface
@pytest.mark.parametrize("pql", READS)
def test_tiered_reads_match_reference(surfaces, pql):
    """Three touches per query: cold, promote, resident."""
    ref, port = surfaces("tiered")
    for _touch in range(3):
        assert _answer(port, pql) == _answer(ref, pql)


@pytest.mark.parametrize("pql", READS)
def test_slots_reads_match_reference(surfaces, pql):
    ref, port = surfaces("slots")
    for _touch in range(2):
        assert _answer(port, pql) == _answer(ref, pql)


@pytest.mark.parametrize("mode", ["tiered", "slots"])
def test_residency_counters_match_reference(surfaces, mode):
    """After the sweep above: every container kind resident (tiered) and
    the counters equal; the slot stack served the slots mode."""
    ref, port = surfaces(mode)
    got = _snapshots_equal(ref.executor, port.executor)
    stats = port.executor.compiler.stacks.stats_snapshot()
    if mode == "tiered":
        assert got["rowsPromoted"] > 0 and got["coldUploads"] > 0
        for _ in range(2):
            port.query("res", "Count(Union(Row(f=7), Row(f=10), Row(f=11)))")
        kinds = {k for t in port.executor.compiler.stacks.residency_snapshot()["tiers"] for k, n in t["rows"].items() if n}
        assert kinds >= {"dense", "sparse", "run"}
    else:
        assert stats["hotEntries"] == 1 and stats["hotRowUploads"] > 0


def test_over_budget_bsi_in_slots_mode_fails_like_the_reference(tight, monkeypatch):
    """Slots mode serves only set rows: a BSI stack over budget fails
    with ExecutionError on both packages, as the reference's slots mode
    surfaces it."""
    monkeypatch.setattr(RefStackCache, "RESIDENCY_MODE", "slots")
    monkeypatch.setattr(StackCache, "RESIDENCY_MODE", "slots")
    monkeypatch.setattr(RefStackCache, "STACK_BYTES_BUDGET", 4 * PLANE_WORDS * 4)
    monkeypatch.setattr(StackCache, "STACK_BYTES_BUDGET", 4 * PLANE_WORDS * 4)
    ref, port = _pair(n_rows=40)
    for pql in ("Sum(field=v)", "Count(Row(v > 0))"):
        with pytest.raises(Exception) as want:
            ref.execute("res", pql)
        with pytest.raises(ExecutionError):
            port.execute("res", pql)
        assert type(want.value).__name__ == "ExecutionError"
    _same(ref, port, "Count(Row(f=11))")


# ------------------------------------------------------- tier life cycle
def test_working_set_cycles_like_the_reference(tight):
    """cold → promote → resident → demote → re-warm, with the residency
    counters equal to the reference's at every step."""
    ref, port = _pair(n_rows=400)
    idx, f = port.holder.index("res"), port.holder.index("res").field("f")
    stacks = port.compiler.stacks
    shards = list(range(MIXED_SHARDS))
    set_a = list(range(20, 30))  # one scattered bit each: all sparse
    for touch in range(2):
        for r in set_a:
            _same(ref, port, f"Count(Row(f={r}))")
        snap = _snapshots_equal(ref, port)
        if touch == 0:
            assert snap["coldUploads"] == len(set_a) and snap["rowsPromoted"] == 0
    assert snap["rowsPromoted"] == len(set_a)
    assert all(stacks.tiered_resident(idx, f, "standard", shards, r) for r in set_a)
    # a shifted working set as large as the sparse store demotes set_a
    cap = stacks._tiered[("tier", "res", "f", "standard", tuple(shards))].stores["sparse"]["h"]
    for _ in range(2):
        for r in range(100, 100 + cap):
            _same(ref, port, f"Count(Row(f={r}))")
    snap = _snapshots_equal(ref, port)
    assert snap["rowsDemoted"] >= len(set_a)
    assert not any(stacks.tiered_resident(idx, f, "standard", shards, r) for r in set_a)
    # demoted rows answer from a cold plane, then re-warm on their history
    for r in set_a[:3]:
        _same(ref, port, f"Count(Row(f={r}))")
    assert all(stacks.tiered_resident(idx, f, "standard", shards, r) for r in set_a[:3])
    _snapshots_equal(ref, port)


def test_write_drops_a_resident_row(tight):
    ref, port = _pair()
    for _ in range(2):
        _same(ref, port, "Count(Row(f=10))")
    base = _same(ref, port, "Count(Row(f=10))")
    demoted = port.compiler.stacks.rows_demoted
    for e in (ref, port):
        e.execute("res", "Set(3, f=10)")
    assert _same(ref, port, "Count(Row(f=10))") == base + 1
    assert port.compiler.stacks.rows_demoted == demoted + 1
    _same(ref, port, "Count(Row(f=10))")  # re-promoted
    _snapshots_equal(ref, port)


def test_a_promotion_frees_the_store_it_replaced(tight):
    """A promotion scatters into a new store; once the query that read
    the old one is done, nothing keeps the old one alive — without the
    cyclic collector's help (a plan must not form a reference cycle)."""
    _ref, port = _pair()
    key = ("tier", "res", "f", "standard", tuple(range(MIXED_SHARDS)))
    gc.disable()
    try:
        for _ in range(2):
            port.execute("res", "Count(Union(Row(f=7), Row(f=10), Row(f=11)))")
        stores = port.compiler.stacks._tiered[key].stores
        old = {kind: weakref.ref(st["dev"]) for kind, st in stores.items()}
        assert set(old) == {"dense", "sparse", "run"}
        for _ in range(2):
            port.execute("res", "Count(Union(Row(f=8), Row(f=12)))")
        assert old["sparse"]() is None  # rows 8 and 12 promoted into a new sparse store
        assert old["dense"]() is not None and old["run"]() is not None
    finally:
        gc.enable()


def test_cold_union_of_one_row_twice_is_not_aliased(tight):
    """A duplicate-row union (one cold array) and a distinct-row union
    (two), in both orders (reference test_cold_program_structure_not_aliased)."""
    ref, port = _pair()
    for pql in (
        "Count(Union(Row(f=50), Row(f=50)))",
        "Count(Union(Row(f=51), Row(f=52)))",
        "Count(Union(Row(f=53), Row(f=54)))",
        "Count(Union(Row(f=55), Row(f=55)))",
    ):
        _same(ref, port, pql)


def test_count_of_one_container_reads_the_payload(tight, monkeypatch):
    """Count(Row) over a resident sparse or run row takes the direct
    count (K8) and no tree program."""
    ref, port = _pair()
    calls = []
    real = ops.container_count
    monkeypatch.setattr(ops, "container_count", lambda *a: calls.append(a) or real(*a))
    for pql in ("Count(Row(f=7))", "Count(Row(f=10))"):
        for _ in range(3):
            _same(ref, port, pql)
    # the second touch promotes each row and the third finds it resident:
    # two direct counts of the sparse row 7, then two of the run row 10
    assert [a[0].dim() for a in calls] == [2, 2, 3, 3]


def test_router_sees_cold_then_resident_like_the_reference(tight):
    ref, port = _pair()
    for pql in ("Count(Row(f=7))", "Sum(Row(f=10), field=v)"):
        ref_call = ref_parse(pql)[0]
        call = parse(pql)[0]
        pt_idx, ref_idx = port.holder.index("res"), ref.holder.index("res")
        for _ in range(3):
            want = ref._residency_info(ref_idx, ref_call, None)
            got = port._residency_info(pt_idx, call, None)
            assert got == want
            _same(ref, port, pql)
    assert got[0] and got[1] == 0  # tiered, nothing cold any more
    ref_x = ref.explain_call(ref_idx, ref_call, None)
    got_x = port.explain_call(pt_idx, call, None)
    assert got_x["residency"] == ref_x["residency"]
    assert got_x["route"] == "device" and got_x["estimatedWorkWords"] == ref_x["estimatedWorkWords"]


def test_auto_router_charges_cold_uploads(tight):
    """Under auto the device route pays each cold row's upload: the cold
    count costs more words on the device than the same count resident."""
    _ref, port = _pair()
    auto = Executor(port.holder, device="cpu", route_mode="auto")
    route, work, _mesh_ok, cold = auto._route(auto.holder.index("res"), parse("Count(Row(f=7))")[0], None)
    assert cold == PLANE_WORDS and route in ("host", "device")
    for _ in range(2):
        port.execute("res", "Count(Row(f=7))")
    # the port's own device executor promoted the row; auto's cache is its own
    assert auto._residency_info(auto.holder.index("res"), parse("Row(f=7)")[0], None) == (True, PLANE_WORDS)
    assert auto.router.decisions["host_unported"] == 0


def test_profile_carries_the_residency_block(tight):
    ref, port = _pair()
    prof, ref_prof = tracing.QueryProfile(), ref_tracing.QueryProfile()
    for _ in range(2):
        with tracing.use_profile(prof):
            port.execute("res", "Count(Union(Row(f=7), Row(f=10), Row(f=11)))")
        with ref_tracing.use_profile(ref_prof):
            ref.execute("res", "Count(Union(Row(f=7), Row(f=10), Row(f=11)))")
    got, want = prof.to_json()["residency"], ref_prof.to_json()["residency"]
    assert {k: got[k] for k in _SNAP_KEYS} == {k: want[k] for k in _SNAP_KEYS}
    assert got["rowsPromoted"] == 3
