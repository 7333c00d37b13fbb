"""Filters fused into the filtered TopN, Sum, Min and Max (B-filter).

The reference evaluates a filter's call tree inside the aggregate's own
program (pilosa_tpu/executor/executor.py:1019 ``_filter_plan``). The
port hands the aggregate's kernel (K2, K4, K5) the planned tree, a
``PlannedFilter``, which its fused mode evaluates word by word: no
[S, W] filter is written and no K1 words launch runs for it. On the CPU
the fused ops take their plain versions (the filter's plain words, then
the aggregate's plain version), and this file holds them against
pilosa_tpu, exactly:

- ``API.query``'s JSON for filtered TopN (plain and ids=), Sum, Min and
  Max over every filter kind, on one device, on a ``["cpu"] * 8`` mesh
  in both layouts, and with over-budget (sparse and run container)
  filter leaves;
- which op gets which filter: a planned one, with no K1 words call,
  except for the streamed TopN and GroupBy, which build their filter
  plane as the reference does;
- the fused ops' plain versions against the reference's
  ``matrix_filter_counts``, ``bsi.sum_counts`` and ``bsi.min_max`` under
  the reference compiler's filter words.
"""

import numpy as np
import pytest
import torch

import pilosa_tpu.core as ref_core
import pilosa_tpu_torch.core as pt_core
from pilosa_tpu import ops as ref_ops
from pilosa_tpu.executor.compile import QueryCompiler as RefCompiler
from pilosa_tpu.executor.compile import StackCache as RefStackCache
from pilosa_tpu.executor.router import QueryRouter as RefRouter
from pilosa_tpu.pql import parse as ref_parse
from pilosa_tpu.server.api import API as RefAPI
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.executor.compile import QueryCompiler, StackCache
from pilosa_tpu_torch.ops import bitwise
from pilosa_tpu_torch.parallel.mesh import MeshContext, make_mesh
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.server import API
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

from _torch_parity import MIXED_SHARDS, N_SHARDS, fill, fill_mesh, fill_mixed

# every filter kind: a row, an Intersect of two, Not, a BSI condition, a
# between, an empty Union(), a row past the field's rows, and rows of
# all-ones words (f=5 of fill, f=6 of the mesh holder) and of words with
# only bit 31 set (f=4, f=7)
FILTERS = [
    "Row(g=1)",
    "Intersect(Row(f=1), Row(g=2))",
    "Not(Row(g=0))",
    "Row(v > 100)",
    "Row(-300 < v < 400)",
    "Union()",
    "Row(g=9)",
]
ONE_DEVICE_FILTERS = FILTERS + ["Row(f=5)", "Row(f=4)", "Shift(Row(g=1), n=3)"]
MESH_FILTERS = FILTERS + ["Row(f=6)", "Row(f=7)"]


def _queries(filt: str) -> list[str]:
    return [
        f"TopN(f, {filt}, n=3)",
        f"TopN(f, {filt}, ids=[0, 2, 5, 99])",
        f"Sum({filt}, field=v)",
        f"Min({filt}, field=v)",
        f"Max({filt}, field=v)",
    ]


ONE_DEVICE = [q for f in ONE_DEVICE_FILTERS for q in _queries(f)]
MESH = [q for f in MESH_FILTERS for q in _queries(f)]
LAYOUTS = {"8x1": 1, "4x2": 2}


def _ref_api(holder):
    return RefAPI(holder, router=RefRouter(mode="device"))


def _mesh_edges(core, idx):
    """The mesh holder's edge words, through the package's own Field
    API: f=6 all ones across shard 0, f=7 only bit 31 of each word of
    shard 1, both with existence marked."""
    full = np.arange(SHARD_WIDTH, dtype=np.uint64)
    high = np.arange(SHARD_WIDTH + 31, 2 * SHARD_WIDTH, 32, dtype=np.uint64)
    idx.field("f").import_bulk(
        np.concatenate([np.full(full.size, 6, np.uint64), np.full(high.size, 7, np.uint64)]),
        np.concatenate([full, high]),
    )
    idx.mark_columns_exist(np.concatenate([full, high]))


@pytest.fixture(scope="module")
def one_device():
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill(ref_core, ref_h)
    fill(pt_core, pt_h)
    return _ref_api(ref_h), API(pt_h, device="cpu", route_mode="device")


@pytest.fixture(scope="module")
def mesh_rigs():
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    _mesh_edges(ref_core, fill_mesh(ref_core, ref_h))
    _mesh_edges(pt_core, fill_mesh(pt_core, pt_h))
    ports = {
        name: API(pt_h, mesh_ctx=MeshContext(make_mesh(["cpu"] * 8, words_axis=w)), route_mode="mesh")
        for name, w in LAYOUTS.items()
    }
    return _ref_api(ref_h), ports, {}


@pytest.mark.parametrize("pql", ONE_DEVICE)
def test_one_device_matches_reference(one_device, pql):
    ref, port = one_device
    assert port.query("i", pql) == ref.query("i", pql)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("pql", MESH)
def test_mesh_matches_reference(mesh_rigs, layout, pql):
    ref, ports, wants = mesh_rigs
    if pql not in wants:
        wants[pql] = ref.query("eq", pql)
    assert ports[layout].query("eq", pql) == wants[pql]


# ------------------------------------------------------- residency leaves
BUDGET = 48 * MIXED_SHARDS * WORDS_PER_SHARD * 4  # f of fill_mixed goes over it
# f=7 is one scattered bit (a sparse container once resident), f=10 a run
# across the shard boundary, f=11 a random half of the columns (dense)
RESIDENT_FILTERS = ["Row(f=7)", "Row(f=10)", "Union(Row(f=7), Row(f=10), Row(f=11))"]


def _residency_pair():
    """fill_mixed's holder with a small set field ``s`` beside the
    over-budget ``f``, so a TopN of ``s`` is served from its dense stack
    under a filter of ``f``'s container rows."""
    rng = np.random.default_rng(3)
    cols = rng.integers(0, MIXED_SHARDS * SHARD_WIDTH, 3000).astype(np.uint64)
    rows = rng.integers(0, 4, 3000).astype(np.uint64)
    runs = (np.arange(3000) + SHARD_WIDTH - 1500).astype(np.uint64)  # under f=10
    apis = []
    for core, make in ((ref_core, _ref_api), (pt_core, lambda h: API(h, device="cpu", route_mode="device"))):
        h = core.Holder(None)
        idx = fill_mixed(core, h)
        s = idx.create_field("s")
        s.import_bulk(np.concatenate([rows, np.full(runs.size, 2, np.uint64)]), np.concatenate([cols, runs]))
        apis.append(make(h))
    return apis


@pytest.fixture
def tight(monkeypatch):
    monkeypatch.setattr(RefStackCache, "STACK_BYTES_BUDGET", BUDGET)
    monkeypatch.setattr(StackCache, "STACK_BYTES_BUDGET", BUDGET)


@pytest.mark.parametrize("filt", RESIDENT_FILTERS)
def test_container_leaves_match_reference(tight, monkeypatch, filt):
    """Each query three times: the filter's rows cold, promoting, then
    resident as sparse and run containers that the fused kernel decodes
    in place (LOAD_SPARSE, LOAD_RUN)."""
    ref, port = _residency_pair()
    seen = []
    real = bitwise.PlannedFilter.plain

    def plain(self, device, plane):
        seen.append({op for op, _a in self.ops})
        return real(self, device, plane)

    monkeypatch.setattr(bitwise.PlannedFilter, "plain", plain)
    queries = [q.replace("TopN(f,", "TopN(s,") for q in _queries(filt)]
    for _ in range(3):
        for pql in queries:
            assert port.query("res", pql) == ref.query("res", pql), pql
    last = set().union(*seen[-len(queries):])
    if "f=7" in filt:
        assert bitwise.OP_LOAD_SPARSE in last
    if "f=10" in filt:
        assert bitwise.OP_LOAD_RUN in last


# ------------------------------------------------------------- the spy
@pytest.fixture
def spy(monkeypatch):
    """Counts K1's words and count calls and records the filter each
    aggregate op is handed."""
    log = {"words": 0, "count": 0, "filters": []}
    real = {n: getattr(ops, n) for n in ("tree_eval", "row_counts", "bsi_sum", "bsi_min_max")}

    def tree_eval(*a, **kw):
        log["count" if kw["count"] else "words"] += 1
        return real["tree_eval"](*a, **kw)

    def agg(name, pos):
        def fn(*a, **kw):
            log["filters"].append((name, a[pos] if len(a) > pos else None))
            return real[name](*a, **kw)

        return fn

    monkeypatch.setattr(ops, "tree_eval", tree_eval)
    monkeypatch.setattr(ops, "row_counts", agg("row_counts", 1))
    monkeypatch.setattr(ops, "bsi_sum", agg("bsi_sum", 2))
    monkeypatch.setattr(ops, "bsi_min_max", agg("bsi_min_max", 2))

    def reset():
        log.update(words=0, count=0, filters=[])
        return log

    return reset


def test_fused_calls_pass_a_planned_filter_on_one_device(one_device, spy):
    _ref, port = one_device
    for filt in ONE_DEVICE_FILTERS:
        for pql in _queries(filt):
            log = spy()
            port.query("i", pql)
            assert [type(f) for _n, f in log["filters"]] == [ops.PlannedFilter], pql
            # Shift's sub-program is the one K1 words launch a filter makes
            assert log["words"] == (1 if "Shift" in filt else 0), pql


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fused_calls_pass_a_planned_filter_per_block(mesh_rigs, spy, layout):
    _ref, ports, _wants = mesh_rigs
    for filt in MESH_FILTERS:
        for pql in _queries(filt):
            log = spy()
            ports[layout].query("eq", pql)
            kinds = {type(f) for _n, f in log["filters"]}
            assert len(log["filters"]) == 8 and kinds == {ops.PlannedFilter}, pql
            assert log["words"] == 0, pql


def test_streamed_topn_and_groupby_still_build_their_filter(one_device, tight, spy):
    _ref, port = one_device
    log = spy()
    port.query("i", "GroupBy(Rows(f), filter=Row(g=1))")
    assert log["words"] == 1
    _ref2, rport = _residency_pair()
    log = spy()
    rport.query("res", "TopN(f, Row(s=2), n=3)")  # f over budget: streamed
    assert log["words"] == 1
    assert log["filters"] and all(isinstance(f, torch.Tensor) for _n, f in log["filters"])


# ------------------------------------- plain versions vs the reference ops
def _padded(stack: np.ndarray, depth: int) -> np.ndarray:
    out = np.zeros((2 + depth,) + stack.shape[1:], dtype=np.uint32)
    n = min(stack.shape[0], 2 + depth)
    out[:n] = stack[:n]
    return out


@pytest.fixture(scope="module")
def compilers():
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    return fill(ref_core, ref_h), fill(pt_core, pt_h), RefCompiler(), QueryCompiler(device="cpu")


@pytest.mark.parametrize("filt", ONE_DEVICE_FILTERS)
def test_fused_plain_versions_match_reference_ops(compilers, filt):
    ref_idx, pt_idx, ref_c, pt_c = compilers
    shards = list(range(N_SHARDS))
    words = np.asarray(ref_c.bitmap_words(ref_idx, ref_parse(filt)[0], shards)).reshape(N_SHARDS, -1)
    planned = pt_c.planned_filter(pt_idx, parse(filt)[0], shards)
    assert isinstance(planned, ops.PlannedFilter) and planned.n_shards == N_SHARDS
    # TopN: K2 rows and ids modes
    matrix = pt_c.stacks.matrix(pt_idx, pt_idx.field("f"), "standard", shards)[0]
    m = matrix.numpy().view(np.uint32)
    want = sum(np.asarray(ref_ops.matrix_filter_counts(m[:, s], words[s])).astype(np.int64) for s in range(N_SHARDS))
    assert ops.row_counts(matrix, planned).tolist() == want.tolist()
    ids = torch.tensor([3, -1, 0, matrix.shape[0], 5], dtype=torch.int32)
    got = ops.row_counts(matrix, planned, ids).tolist()
    assert got == [int(want[i]) if 0 <= i < matrix.shape[0] else 0 for i in ids.tolist()]
    # Sum, Min and Max: K4 one mask, K5
    field = pt_idx.field("v")
    depth = field.bit_depth
    stack = pt_c.stacks.dense(pt_idx, field, "bsi", shards)[0]
    planes = _padded(stack.numpy().view(np.uint32), depth)
    pos, neg, n = ops.bsi_sum(stack, depth, planned)
    rp, rn, rc = (0, 0, 0)
    for s in range(N_SHARDS):
        p, q, c = ref_ops.bsi.sum_counts(planes[:, s], words[s])
        rp, rn, rc = rp + np.asarray(p).astype(np.int64), rn + np.asarray(q).astype(np.int64), rc + int(c)
    assert pos[0].tolist() == rp.tolist() and neg[0].tolist() == rn.tolist() and int(n[0]) == rc
    for want_max in (False, True):
        values, counts = ops.bsi_min_max(stack, depth, planned, want_max)
        for s in range(N_SHARDS):
            rv, rcount = ref_ops.bsi.min_max(planes[:, s], words[s], want_max)
            assert (int(values[s]), int(counts[s])) == (int(rv), int(rcount)), (s, want_max)


def test_planned_filter_checks_its_plane_and_device(compilers):
    _ref_idx, pt_idx, _ref_c, pt_c = compilers
    shards = list(range(N_SHARDS))
    planned = pt_c.planned_filter(pt_idx, parse("Row(g=1)")[0], shards)
    matrix = pt_c.stacks.matrix(pt_idx, pt_idx.field("f"), "standard", shards)[0]
    with pytest.raises(ValueError, match="filter over"):
        ops.row_counts(matrix[:, :2].contiguous(), planned)
    with pytest.raises(ValueError, match="filter plane on"):
        planned.check(torch.device("meta"), (N_SHARDS, WORDS_PER_SHARD))



def test_a_changed_header_makes_its_kernels_stale(tmp_path, monkeypatch):
    """A library is rebuilt when its source or any header under csrc/
    (common.cuh, tree_interp.cuh) is newer than it."""
    import os

    from pilosa_tpu_torch.ops import _cuda

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    for f in ("row_counts.cu", "common.cuh", "tree_interp.cuh"):
        (csrc / f).write_text("//\n")
        os.utime(csrc / f, (1000, 1000))
    monkeypatch.setattr(_cuda, "CSRC", str(csrc))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(build))
    assert _cuda._stale("row_counts")  # never built
    (build / "librow_counts.so").write_text("")
    os.utime(build / "librow_counts.so", (2000, 2000))
    assert not _cuda._stale("row_counts")
    os.utime(csrc / "tree_interp.cuh", (3000, 3000))
    assert _cuda._stale("row_counts")
