"""The port's postfix planner and StackCache against pilosa_tpu's
QueryCompiler, on one seeded holder per package (tests/_torch_parity.py).

Random call trees mix Union, Intersect, Difference, Xor, Not, All, empty
Union/Xor, time-view Rows and rows outside the stack; the count and the
words of each must equal the reference's exactly.
"""

import numpy as np
import pytest

import pilosa_tpu.core as ref_core
import pilosa_tpu_torch.core as pt_core
from pilosa_tpu.executor.compile import QueryCompiler as RefCompiler
from pilosa_tpu.pql import parse as ref_parse
from pilosa_tpu_torch.executor import ExecutionError, Executor
from pilosa_tpu_torch.executor.compile import PlanError, QueryCompiler, StackCache
from pilosa_tpu_torch.ops import bitwise
from pilosa_tpu_torch.pql import parse

from _torch_parity import N_SHARDS, fill

SHARDS = list(range(N_SHARDS))


@pytest.fixture(scope="module")
def pair():
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    return (
        fill(ref_core, ref_h),
        fill(pt_core, pt_h),
        RefCompiler(),
        QueryCompiler(device="cpu"),
    )


def _leaf(rng):
    kind = rng.integers(0, 6)
    if kind == 0:
        return f"Row(t={int(rng.integers(0, 3))}, from='2020-03-04T00:00', to='2021-02-11T00:00')"
    if kind == 1:
        return f"Row(g={int(rng.integers(0, 3))})"
    if kind == 2:
        return f"Row(f={int(rng.choice([7, 1000, 2**31 - 1]))})"  # past the stack
    return f"Row(f={int(rng.integers(0, 6))})"


def _tree(rng, depth):
    if depth == 0 or rng.random() < 0.25:
        return _leaf(rng)
    name = rng.choice(["Union", "Intersect", "Difference", "Xor", "Not", "All", "Empty"])
    if name == "All":
        return "All()"
    if name == "Empty":
        return str(rng.choice(["Union()", "Xor()"]))
    if name == "Not":
        return f"Not({_tree(rng, depth - 1)})"
    kids = [_tree(rng, depth - 1) for _ in range(int(rng.integers(1, 4)))]
    return f"{name}({', '.join(kids)})"


def _trees():
    rng = np.random.default_rng(11)
    return [_tree(rng, 3) for _ in range(24)]


@pytest.mark.parametrize("pql", _trees())
def test_random_tree_matches_reference_compiler(pair, pql):
    ref_idx, pt_idx, ref_c, pt_c = pair
    ref_call, pt_call = ref_parse(pql)[0], parse(pql)[0]
    want_count = int(ref_c.count_async(ref_idx, ref_call, SHARDS))
    want_words = np.asarray(ref_c.bitmap_words(ref_idx, ref_call, SHARDS))
    assert int(pt_c.count_async(pt_idx, pt_call, SHARDS)) == want_count
    assert np.array_equal(pt_c.bitmap_words(pt_idx, pt_call, SHARDS), want_words)


def test_one_program_serves_every_row_id(pair):
    """Row ids are launch arguments: every row of one query shape gets
    the same program, and only the leaves carry the ids."""
    _ref_idx, pt_idx, _ref_c, pt_c = pair
    progs, row_ids = set(), []
    for r in range(4):
        _stacks, leaves, prog, _conds = pt_c._plan(
            pt_idx, parse(f"Intersect(Row(f={r}), Row(g=1))")[0], SHARDS
        )
        progs.add(tuple(prog))
        row_ids.append([rid for _si, rid in leaves])
    assert len(progs) == 1
    assert row_ids == [[r, 1] for r in range(4)]


def test_stack_depth_over_the_kernel_limit_is_a_plan_error(pair):
    _ref_idx, pt_idx, _ref_c, pt_c = pair
    deep = "Row(f=1)"
    for _ in range(bitwise.TREE_MAX_STACK):
        deep = f"Intersect(Row(f=2), {deep})"
    with pytest.raises(PlanError, match="stack depth 33 exceeds its limit of 32"):
        pt_c.count_async(pt_idx, parse(deep)[0], SHARDS)
    ok = "Row(f=1)"
    for _ in range(bitwise.TREE_MAX_STACK - 1):
        ok = f"Intersect(Row(f=2), {ok})"
    assert int(pt_c.count_async(pt_idx, parse(ok)[0], SHARDS)) >= 0


@pytest.mark.parametrize(
    "pql",
    [
        "Count(Shift(Row(f=1), n=3))",
        "Count(Intersect(Row(v > 10), Shift(Row(f=2))))",
        "Sum(Shift(Row(g=1), n=2), field=v)",
    ],
)
def test_unported_device_programs_raise(pql):
    """These Shift trees raised before Shift was ported; now the device
    route answers them as the reference's device route does."""
    h, ref_h = pt_core.Holder(None), ref_core.Holder(None)
    fill(pt_core, h)
    fill(ref_core, ref_h)
    from pilosa_tpu.executor import Executor as RefExecutor

    e = Executor(h, device="cpu", route_mode="device")
    assert e.execute("i", pql) == RefExecutor(ref_h, route_mode="device").execute("i", pql)


def test_over_budget_stack_raises_execution_error(monkeypatch):
    """A 1 KB budget puts every stack over budget: the tiered mode serves
    set rows and BSI blocks as the reference does; the slots mode serves
    set rows and raises ExecutionError for a BSI stack, as the
    reference's slots mode does."""
    from pilosa_tpu.executor import Executor as RefExecutor
    from pilosa_tpu.executor.compile import StackCache as RefStackCache

    h, ref_h = pt_core.Holder(None), ref_core.Holder(None)
    fill(pt_core, h)
    fill(ref_core, ref_h)
    monkeypatch.setattr(StackCache, "STACK_BYTES_BUDGET", 1024)
    monkeypatch.setattr(RefStackCache, "STACK_BYTES_BUDGET", 1024)
    e = Executor(h, device="cpu", route_mode="device")
    ref = RefExecutor(ref_h, route_mode="device")
    for pql in ("Count(Row(f=1))", "Sum(Row(f=1), field=v)"):
        assert e.execute("i", pql) == ref.execute("i", pql)
    monkeypatch.setattr(StackCache, "RESIDENCY_MODE", "slots")
    e = Executor(h, device="cpu", route_mode="device")
    assert e.execute("i", "Count(Row(f=1))") == ref.execute("i", "Count(Row(f=1))")
    with pytest.raises(ExecutionError, match="dense stack"):
        e.execute("i", "Sum(field=v)")


def test_byte_ledger_evicts_to_the_budget(monkeypatch):
    h = pt_core.Holder(None)
    idx = fill(pt_core, h)
    sc = StackCache(device="cpu")
    one = sc.matrix(idx, idx.field("f"), "standard", SHARDS)[0]
    nbytes = one.numel() * 4
    monkeypatch.setattr(StackCache, "STACK_BYTES_BUDGET", nbytes + nbytes // 2)
    sc.matrix(idx, idx.field("g"), "standard", SHARDS)
    snap = sc.stats_snapshot()
    assert snap["evictions"] == 1 and snap["entries"] == 1
    assert snap["residentBytes"] <= nbytes + nbytes // 2


def test_point_writes_take_the_delta_path():
    h = pt_core.Holder(None)
    fill(pt_core, h)
    ref_h = ref_core.Holder(None)
    fill(ref_core, ref_h)
    from pilosa_tpu.executor import Executor as RefExecutor

    e = Executor(h, device="cpu", route_mode="device")
    ref = RefExecutor(ref_h, route_mode="device")
    stacks = e.compiler.stacks
    e.execute("i", "Count(Row(f=1)) Count(Not(Row(f=1)))")
    restacks = stacks.full_restacks
    for col in (3, 70000, 140001):
        q = f"Set({col}, f=1) Count(Row(f=1)) Count(Not(Row(f=1)))"
        assert e.execute("i", q) == ref.execute("i", q)
    assert stacks.full_restacks == restacks
    assert stacks.delta_updates >= 3
