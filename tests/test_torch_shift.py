"""PQL Shift in pilosa_tpu_torch against pilosa_tpu.

The plain ``shift_words`` (K7's plain version) must equal the reference's
``ops.shift_words`` bit for bit, and ``API.query`` must answer Shift on
the device route as the reference's device route does (the port splits
the program at each Shift: K1 words, K7, then the outer program).
"""

import numpy as np
import pytest
import torch

import pilosa_tpu.core as ref_core
import pilosa_tpu_torch.core as pt_core
from pilosa_tpu import ops as ref_ops
from pilosa_tpu.executor.router import QueryRouter as RefRouter
from pilosa_tpu.server.api import API as RefAPI
from pilosa_tpu_torch.executor import ExecutionError
from pilosa_tpu_torch.ops import bitwise
from pilosa_tpu_torch.server import API
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

from _torch_parity import fill

W = WORDS_PER_SHARD
SHIFTS = [0, 1, 31, 32, 33, 63, W * 32 - 1, W * 32, W * 32 + 5]


def _words():
    """Three shards: random words, all-ones words, and words with only
    bit 31 set, whose last word carries out of the shard."""
    rng = np.random.default_rng(17)
    w = rng.integers(0, 2**32, (3, W), dtype=np.uint32)
    w[1] = 0xFFFFFFFF
    w[2] = 0x80000000
    return w


@pytest.mark.parametrize("n", SHIFTS)
def test_plain_shift_matches_reference(n):
    w = _words()
    want = np.asarray(ref_ops.shift_words(w, n))
    got = bitwise.shift_words(torch.from_numpy(w.view(np.int32).copy()), n)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # bit 31 of every word of shard 2 moves to 32 k + 31 + n: the bits
    # that pass the shard's end drop, none reaches another shard
    kept = sum(1 for k in range(W) if 32 * k + 31 + n < 32 * W)
    assert int(np.bitwise_count(got.numpy().view(np.uint32)[2]).sum()) == kept


def test_negative_shift_raises():
    with pytest.raises(ValueError):
        bitwise.shift_words(torch.zeros((1, W), dtype=torch.int32), -1)


QUERIES = [
    "Count(Shift(Row(f=1), n=1))",
    "Count(Shift(Row(f=5), n=33))",
    "Count(Intersect(Shift(Row(f=1), n=33), Row(f=2)))",
    "Count(Shift(Shift(Row(f=4), n=3), n=40))",
    "Shift(Row(f=4), n=1)",
    "Shift(Row(f=5), n=65535)",
    "Union(Shift(Row(g=1), n=0), Row(f=3))",
    "Count(Not(Shift(Row(f=5), n=7)))",
    "Count(Shift(Union(Row(f=1), Row(v > 0)), n=2))",
    "Sum(Shift(Row(g=1), n=2), field=v)",
    "TopN(f, Shift(Row(g=0), n=9), n=3)",
    "Options(Count(Shift(Row(f=2), n=100)), shards=[1, 2])",
    "Count(Shift(Row(f=1)))",
]


@pytest.fixture(scope="module")
def apis():
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill(ref_core, ref_h)
    fill(pt_core, pt_h)
    return RefAPI(ref_h, router=RefRouter(mode="device")), API(pt_h, device="cpu", route_mode="device"), pt_h


@pytest.mark.parametrize("pql", QUERIES)
def test_shift_queries_match_reference_device_route(apis, pql):
    ref, port, _h = apis
    assert port.query("i", pql) == ref.query("i", pql)


@pytest.mark.parametrize("pql", ["Count(Shift(Row(f=1), n=-1))", "Count(Shift(Row(f=1), Row(f=2)))"])
def test_bad_shift_is_an_execution_error(apis, pql):
    _ref, port, _h = apis
    with pytest.raises(ExecutionError, match="Shift"):
        port.query("i", pql)


def test_auto_router_serves_shift_without_unported_decisions(apis):
    ref, _port, pt_h = apis
    auto = API(pt_h, device="cpu", route_mode="auto")
    for pql in QUERIES[:4]:
        assert auto.query("i", pql) == ref.query("i", pql)
    assert auto.executor.router.decisions["host_unported"] == 0
