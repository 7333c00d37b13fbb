"""``API.import_values`` and the public count ops of pilosa_tpu_torch,
against pilosa_tpu.

The import runs through both packages' ``API`` on tests/_torch_parity.py's
holder (the reference on its single-device route, the port on its plain
torch versions); the queries after it must give the same JSON. The word
ops and counts are held against pilosa_tpu.ops on all-ones and high-bit
words, and their CUDA branches are checked to name K1 or K2.
"""

import inspect

import numpy as np
import pytest
import torch

import pilosa_tpu.core as ref_core
from pilosa_tpu import ops as ref_ops
from pilosa_tpu.executor.router import QueryRouter as RefRouter
from pilosa_tpu.server.api import API as RefAPI
import pilosa_tpu_torch.core as pt_core
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.ops import _cuda, bitwise, topn
from pilosa_tpu_torch.server import API
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

from _torch_parity import N_SHARDS, fill

QUERIES = [
    "Sum(field=v)",
    "Min(field=v)",
    "Max(field=v)",
    "Count(Row(v > 10))",
    "Count(Row(-50 <= v <= 50))",
    "Sum(Row(f=1), field=v)",
    "Count(Row(v == null))",
]


@pytest.fixture()
def apis():
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill(ref_core, ref_h)
    fill(pt_core, pt_h)
    return RefAPI(ref_h, router=RefRouter(mode="device")), API(pt_h, device="cpu", route_mode="device")


def _same(ref, port, index, queries=QUERIES):
    for pql in queries:
        assert port.query(index, pql) == ref.query(index, pql), pql


def test_import_values_by_id(apis):
    ref, port = apis
    rng = np.random.default_rng(3)
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, 700, replace=False)
    payload = {"columnIDs": cols.tolist(), "values": rng.integers(-1000, 1001, cols.size).tolist()}
    for api in (ref, port):
        api.import_values("i", "v", payload)
    _same(ref, port, "i")
    assert port.query("i", "Count(Row(v != null))") == ref.query("i", "Count(Row(v != null))")


def test_import_values_by_key(apis):
    ref, port = apis
    rng = np.random.default_rng(4)
    keys = [f"ride-{i}" for i in range(300)]
    values = rng.integers(-1000, 1001, len(keys)).tolist()
    for api in (ref, port):
        api.create_index("k", {"keys": True})
        api.create_field("k", "v", {"type": "int", "min": -1000, "max": 1000})
        api.create_field("k", "f")
        api.import_values("k", "v", {"columnKeys": keys, "values": values})
    _same(ref, port, "k", [q for q in QUERIES if "f=1" not in q])
    assert port.query("k", "Count(All())") == ref.query("k", "Count(All())") == {"results": [300]}


def test_import_values_clear(apis):
    ref, port = apis
    rng = np.random.default_rng(5)
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, 500, replace=False)
    values = rng.integers(1, 9, cols.size).tolist()
    for api in (ref, port):
        api.import_values("i", "v", {"columnIDs": cols.tolist(), "values": values})
    gone = cols[::3].tolist()
    for api in (ref, port):
        # values are not read on clear
        api.import_values("i", "v", {"columnIDs": gone, "values": [1], "clear": True})
    _same(ref, port, "i")


def test_import_values_length_mismatch(apis):
    ref, port = apis
    payload = {"columnIDs": [1, 2, 3], "values": [4, 5]}
    with pytest.raises(Exception) as ref_err:
        ref.import_values("i", "v", payload)
    with pytest.raises(Exception) as port_err:
        port.import_values("i", "v", payload)
    assert type(port_err.value).__name__ == type(ref_err.value).__name__ == "ExecutionError"
    assert str(port_err.value) == str(ref_err.value) == "columnIDs and values length mismatch"
    _same(ref, port, "i")  # nothing was written


# ------------------------------------------------------------ public counts


def _edge_pair(rng, shape):
    a = rng.integers(0, 2**32, shape, dtype=np.uint32)
    b = rng.integers(0, 2**32, shape, dtype=np.uint32)
    a[..., ::4] = 0xFFFFFFFF
    b[..., 1::4] = 0x80000000
    a[..., 2::8] = 0x80000000
    b[..., 3::8] = 0xFFFFFFFF
    return a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("name", ["w_and", "w_or", "w_xor", "w_andnot"])
def test_word_ops_match_reference(name):
    a, b = _edge_pair(np.random.default_rng(6), (3, 64))
    got = getattr(ops, name)(_t(a), _t(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(getattr(ref_ops, name)(a, b)))


def test_w_not_matches_reference():
    a, _ = _edge_pair(np.random.default_rng(7), (2, 64))
    assert np.array_equal(ops.w_not(_t(a)).numpy().view(np.uint32), np.asarray(ref_ops.w_not(a)))


@pytest.mark.parametrize("name", ["count_and", "count_or", "count_xor", "count_andnot"])
def test_counts_match_reference(name):
    a, b = _edge_pair(np.random.default_rng(8), (4, 128))
    got = getattr(ops, name)(_t(a), _t(b))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(getattr(ref_ops, name)(a, b))


def test_popcounts_match_reference():
    a, b = _edge_pair(np.random.default_rng(9), (5, 128))
    assert int(ops.popcount(_t(a))) == int(ref_ops.popcount(a))
    rows = ops.popcount_rows(_t(a))
    assert rows.dtype == torch.int32 and rows.tolist() == np.asarray(ref_ops.popcount_rows(a)).tolist()
    got = ops.matrix_filter_counts(_t(a), _t(b[0]))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(ref_ops.matrix_filter_counts(a, b[0])).tolist()
    cube = _t(np.stack([a, b]))
    assert ops.popcount_rows(cube).tolist() == np.asarray(ref_ops.popcount_rows(np.stack([a, b]))).tolist()


def test_counts_route_through_kernels_on_cuda():
    """On the CPU the counts take the SWAR and launch nothing; their CUDA
    branches go through K1 (``tree_eval``) or K2 (``row_counts``), the
    wrappers that name TREE_EVAL and ROW_COUNTS."""
    for k in _cuda.KERNELS.values():
        k.reset()
    a, b = _edge_pair(np.random.default_rng(10), (2, 64))
    ta, tb = _t(a), _t(b)
    for fn in (ops.popcount, ops.popcount_rows):
        fn(ta)
    for fn in (ops.count_and, ops.count_or, ops.count_xor, ops.count_andnot, ops.matrix_filter_counts):
        fn(ta, tb if fn is not ops.matrix_filter_counts else tb[0])
    assert {n: k.launches for n, k in _cuda.KERNELS.items() if k.launches} == {}
    k2 = ("row_counts(",)
    k1 = ("_k1_count(",)
    routes = {
        bitwise.popcount_rows: k2, bitwise.count_and: k2, bitwise.matrix_filter_counts: k2,
        bitwise.popcount: k1, bitwise.count_or: k1, bitwise.count_xor: k1, bitwise.count_andnot: k1,
    }
    for fn, names in routes.items():
        src = inspect.getsource(fn)
        cuda_branch = src.split('device.type == "cpu"', 1)[1]
        assert any(n in cuda_branch for n in names), fn.__name__
    assert "tree_eval(" in inspect.getsource(bitwise._k1_count)
    assert "_cuda.TREE_EVAL.launch" in inspect.getsource(bitwise.tree_eval)
    assert "_cuda.ROW_COUNTS.launch" in inspect.getsource(topn.row_counts)
