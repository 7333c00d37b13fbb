"""The mesh engine's demo and bench programs, the ingest step and their
one-device twins, against pilosa_tpu on the CPU.

The reference runs ``MeshQueryEngine`` on conftest's 8 virtual XLA
devices; the port runs on ``make_mesh(["cpu"] * 8, words_axis)``, eight
positions on one device, with the plain torch versions of the kernels
(K2, K4, K13, K12's count keys, K10's int mode). Both layouts: 8x1 and
4x2. Inputs come from one numpy seed. Every integer must be equal, and
Tanimoto scores the same f32 bits.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from pilosa_tpu import ops as ref_ops
from pilosa_tpu.parallel import mesh as ref_mesh
from pilosa_tpu.roaring import pack_positions
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.ops import _cuda, similarity
from pilosa_tpu_torch.parallel.mesh import MeshArray, MeshQueryEngine, make_mesh
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"8x1": 1, "4x2": 2}
W = WORDS_PER_SHARD


@pytest.fixture(scope="module")
def engines():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    out = {}
    for name, w in LAYOUTS.items():
        out[name] = (
            ref_mesh.MeshQueryEngine(ref_mesh.make_mesh(jax.devices(), words_axis=w)),
            MeshQueryEngine(make_mesh(["cpu"] * 8, words_axis=w)),
        )
    return out


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def edge_words(rng, shape) -> np.ndarray:
    """Random uint32 words with all-ones and high-bit (0x80000000) words
    in the first two entries of the leading axis."""
    x = rng.integers(0, 2**32, shape, dtype=np.uint32)
    x[0, ..., ::3] = 0xFFFFFFFF
    x[1, ..., 1::4] = 0x80000000
    return x


def random_stack(rng, s, density=0.2):
    cols = [np.flatnonzero(rng.random(SHARD_WIDTH) < density).astype(np.int64) for _ in range(s)]
    return np.stack([pack_positions(c, SHARD_WIDTH) for c in cols]), cols


# ------------------------------------------- tests/test_mesh.py:32-104, ported


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_count_and(engines, layout):
    ref, eng = engines[layout]
    rng = np.random.default_rng(1)
    a, _ = random_stack(rng, 8)
    b, _ = random_stack(rng, 8)
    b[0, ::5] = 0xFFFFFFFF
    a[1, ::3] = 0x80000000
    want = int(ref.count_and(ref.place_row(a), ref.place_row(b)))
    got = eng.count_and(eng.place_row(a), eng.place_row(b))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want == int(np.bitwise_count(a & b).sum())
    assert eng.snapshot()["calls"]["count_and"] >= 1


@pytest.mark.parametrize("k", [1, 4, 16, 19])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_topn(engines, layout, k):
    """k of 1, 4, R and past R (clamped); rows 3, 7 and 12 have equal
    counts, so the lower row wins the tie."""
    ref, eng = engines[layout]
    rng = np.random.default_rng(2)
    n_rows, n_shards = 16, 8
    matrix = (rng.random((n_rows, n_shards, W)) < 0.5).astype(np.uint32) * rng.integers(
        0, 2**32, (n_rows, n_shards, W), dtype=np.uint32
    )
    matrix[7] = matrix[3]
    matrix[12] = matrix[3]
    filt = edge_words(rng, (n_shards, W))
    rv, ri = ref.topn(ref.place_matrix(matrix), ref.place_row(filt), k)
    gv, gi = eng.topn(eng.place_matrix(matrix), eng.place_row(filt), k)
    assert gv.dtype == torch.int64 and gi.dtype == torch.int32
    assert gv.tolist() == np.asarray(rv).tolist()
    assert gi.tolist() == np.asarray(ri).tolist()
    assert len(gi) == min(k, n_rows)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bsi_sum(engines, layout):
    """Negative values, and an exists plane of all-ones words and a sign
    plane of high-bit words."""
    ref, eng = engines[layout]
    rng = np.random.default_rng(3)
    n_shards, depth = 8, 10
    slices = np.zeros((2 + depth, n_shards, W), dtype=np.uint32)
    oracle_sum = oracle_n = 0
    filt, fcols = random_stack(rng, n_shards, density=0.5)
    for s in range(n_shards):
        if s == 0:
            cols = np.arange(SHARD_WIDTH // 2, dtype=np.int64)  # all-ones exists words
            vals = rng.integers(-500, 500, cols.size)
            vals[31::32] = -np.abs(vals[31::32]) - 1  # every high bit of the sign words
        else:
            cols = np.sort(rng.choice(SHARD_WIDTH, 2000, replace=False)).astype(np.int64)
            vals = rng.integers(-500, 500, cols.size)
        slices[0, s] = pack_positions(cols, SHARD_WIDTH)
        slices[1, s] = pack_positions(cols[vals < 0], SHARD_WIDTH)
        for kb in range(depth):
            slices[2 + kb, s] = pack_positions(cols[(np.abs(vals) >> kb) & 1 == 1], SHARD_WIDTH)
        keep = np.isin(cols, fcols[s])
        oracle_sum += int(vals[keep].sum())
        oracle_n += int(keep.sum())
    r_total, r_n = ref.bsi_sum(jax.device_put(slices, ref.spec_matrix()), ref.place_row(filt))
    total, n = eng.bsi_sum(eng.place_matrix(slices), eng.place_row(filt))
    assert (int(total), int(n)) == (int(r_total), int(r_n)) == (oracle_sum, oracle_n)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ingest_and_aggregate(engines, layout):
    ref, eng = engines[layout]
    n_rows, n_shards = 8, 8
    rng = np.random.default_rng(4)
    matrix = np.zeros((n_rows, n_shards, W), dtype=np.uint32)
    matrix[0, 0, 0] = 0b1011
    matrix[2] = rng.integers(0, 2**32, (n_shards, W), dtype=np.uint32)
    delta = np.zeros_like(matrix)
    delta[0, 1, 0] = 0b0100
    delta[3, 0, 1] = 0b1
    delta[5, 2, ::7] = 0xFFFFFFFF
    delta[6, 3, 5::9] = 0x80000000
    filt = np.full((n_shards, W), 0xFFFFFFFF, dtype=np.uint32)
    filt[1, 1::2] = 0x80000000
    r_m, r_counts, r_total = ref.ingest_and_aggregate(
        ref.place_matrix(matrix), ref.place_matrix(delta), ref.place_row(filt)
    )
    m_dev = eng.place_matrix(matrix)
    blocks = [b for _i, _j, b in m_dev.items()]
    new_m, counts, total = eng.ingest_and_aggregate(m_dev, eng.place_matrix(delta), eng.place_row(filt))
    assert new_m is m_dev and [b for _i, _j, b in new_m.items()] == blocks  # in place, same handle
    assert np.array_equal(new_m.host().view(np.uint32), matrix | delta)
    assert np.array_equal(new_m.host().view(np.uint32), np.asarray(r_m))
    assert counts.tolist() == np.asarray(r_counts).tolist()
    assert int(total) == int(r_total) == int(np.asarray(r_counts).sum())
    assert counts[0] == 4 and counts[3] == 1


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_placed_block_by_block(engines, layout):
    _ref, eng = engines[layout]
    rng = np.random.default_rng(5)
    a, _ = random_stack(rng, 8)
    placed = eng.place_row(a)
    assert isinstance(placed, MeshArray) and placed.mode == eng.spec_row() == "grid"
    nw = LAYOUTS[layout]
    assert {tuple(b.shape) for _i, _j, b in placed.items()} == {(8 // (8 // nw), W // nw)}
    assert sum(1 for _ in placed.items()) == 8
    assert np.array_equal(placed.host().view(np.uint32), a)
    slices = eng.place_matrix(rng.integers(0, 2**32, (5, 8, W), dtype=np.uint32))
    assert slices.shape == (5, 8, W) and eng.spec_matrix() == "grid"
    with pytest.raises(ValueError):
        eng.place_row(a[:3])  # 3 shards do not divide the shards axis
    bad = (2, 4, W) if nw == 1 else (2, 8, W - 1)  # S past the shards axis, or W odd over 2
    with pytest.raises(ValueError):
        eng.place_matrix(np.zeros(bad, dtype=np.uint32))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ingest_and_aggregate_checks_placement(engines, layout):
    _ref, eng = engines[layout]
    m = eng.place_matrix(np.zeros((2, 8, W), dtype=np.uint32))
    f = eng.place_row(np.zeros((8, W), dtype=np.uint32))
    with pytest.raises(ValueError):
        eng.ingest_and_aggregate(m, eng.place_matrix(np.zeros((3, 8, W), dtype=np.uint32)), f)
    other = MeshQueryEngine(make_mesh(["cpu"] * 8, words_axis=LAYOUTS[layout]))
    with pytest.raises(ValueError):
        eng.ingest_and_aggregate(m, other.place_matrix(np.zeros((2, 8, W), dtype=np.uint32)), f)


# ---------------------------------- __graft_entry__.py's sequences, both packages


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dryrun_multichip_sequence(engines, layout):
    """__graft_entry__.py:136-170 with its seed and shapes: ingest,
    topn, bsi_sum, count_and and tanimoto on the ingested matrix."""
    ref, eng = engines[layout]
    n_shards = ref.mesh.shape["shards"] * 2
    rows, depth = 8, 6
    rng = np.random.default_rng(0)
    matrix = rng.integers(0, 2**32, (rows, n_shards, W), dtype=np.uint32)
    delta = np.zeros_like(matrix)
    delta[0, :, 0] = 0b101
    filt = rng.integers(0, 2**32, (n_shards, W), dtype=np.uint32)
    slices = rng.integers(0, 2**32, (2 + depth, n_shards, W), dtype=np.uint32)

    r_f = ref.place_row(filt)
    r_m, r_counts, r_total = ref.ingest_and_aggregate(ref.place_matrix(matrix), ref.place_matrix(delta), r_f)
    r_vals, r_ids = ref.topn(r_m, r_f, 4)
    r_bsi = ref.bsi_sum(jax.device_put(slices, ref.spec_matrix()), r_f)
    r_pair = ref.count_and(ref.place_row(matrix[0]), ref.place_row(matrix[1]))
    r_ts, r_ti = ref.tanimoto(r_m, r_f, 4)

    calls0 = dict(eng.snapshot()["calls"])
    f_dev = eng.place_row(filt)
    new_m, counts, total = eng.ingest_and_aggregate(eng.place_matrix(matrix), eng.place_matrix(delta), f_dev)
    vals, ids = eng.topn(new_m, f_dev, 4)
    bsi_total, bsi_n = eng.bsi_sum(eng.place_matrix(slices), f_dev)
    pair = eng.count_and(eng.place_row(matrix[0]), eng.place_row(matrix[1]))
    t_vals, t_ids = eng.tanimoto(new_m, f_dev, 4)

    assert counts.tolist() == np.asarray(r_counts).tolist() and int(total) == int(r_total) > 0
    assert vals.tolist() == np.asarray(r_vals).tolist() and ids.tolist() == np.asarray(r_ids).tolist()
    assert (int(bsi_total), int(bsi_n)) == (int(r_bsi[0]), int(r_bsi[1]))
    assert int(pair) == int(r_pair)
    assert np.array_equal(t_vals.numpy().view(np.uint32), np.asarray(r_ts).view(np.uint32))
    assert t_ids.tolist() == np.asarray(r_ti).tolist()
    calls = eng.snapshot()["calls"]
    for name in ("ingest_and_aggregate", "topn", "bsi_sum", "count_and"):
        assert calls[name] == calls0.get(name, 0) + 1


def test_entry_query_step_on_one_device():
    """entry()'s query_step (m | delta, matrix_filter_counts, the int64
    sum, top_k 4) against ops.ingest_counts + select_top_counts."""
    sys.path.insert(0, REPO)
    import __graft_entry__

    fn, (matrix, delta, filt) = __graft_entry__.entry()
    r_m, r_total, r_vals, r_ids = jax.jit(fn)(matrix, delta, filt)
    m = t(matrix)[:, None].clone()
    new_m, counts, total = ops.ingest_counts(m, t(delta)[:, None].contiguous(), t(filt)[None].contiguous())
    vals, ids = ops.select_top_counts(counts, 4)
    assert new_m is m
    assert np.array_equal(new_m[:, 0].numpy().view(np.uint32), np.asarray(r_m))
    assert int(total) == int(r_total)
    assert vals.tolist() == np.asarray(r_vals).tolist() and ids.tolist() == np.asarray(r_ids).tolist()


def test_ingest_counts_edge_words():
    """K13's plain version over all-ones and high-bit words, against
    numpy."""
    rng = np.random.default_rng(6)
    matrix = edge_words(rng, (4, 3, W))
    delta = (rng.random((4, 3, W)) < 0.01) * edge_words(rng, (4, 3, W))
    delta = delta.astype(np.uint32)
    delta[2, 1] = 0x80000000
    filt = edge_words(rng, (3, W))
    m, counts, total = ops.ingest_counts(t(matrix).clone(), t(delta), t(filt))
    want = np.bitwise_count((matrix | delta) & filt[None]).sum(axis=(1, 2))
    assert np.array_equal(m.numpy().view(np.uint32), matrix | delta)
    assert counts.tolist() == want.tolist() and int(total) == int(want.sum())
    assert _cuda.INGEST_COUNTS.launches == 0  # the CPU takes the plain version


# ------------------------------------------------------ the one-device twins


def test_top_rows_matches_reference():
    """tests/test_ops.py:134's recipe."""
    rng = np.random.default_rng(42)
    bits = W * 32
    mats = [
        pack_positions(np.flatnonzero(rng.random(bits) < rng.uniform(0.01, 0.5)).astype(np.int64), bits)
        for _ in range(50)
    ]
    matrix = np.stack(mats)
    matrix[20] = matrix[11]  # a tie: the lower row first
    filt = pack_positions(np.flatnonzero(rng.random(bits) < 0.7).astype(np.int64), bits)
    for k in (1, 10, 50, 60):
        rv, ri = ref_ops.topn.top_rows(matrix, filt, k)
        gv, gi = ops.top_rows(t(matrix), t(filt), k)
        assert gv.dtype == torch.int32 and gi.dtype == torch.int32
        assert gv.tolist() == np.asarray(rv).tolist() and gi.tolist() == np.asarray(ri).tolist()
    with pytest.raises(ValueError):  # one fragment, as the reference's
        ops.top_rows(t(matrix)[:, None], t(filt)[None], 4)


def test_sum_device_matches_reference():
    """tests/test_ops.py:105's recipe, with a high-bit sign word."""
    rng = np.random.default_rng(42)
    bits = W * 32
    cols = np.sort(rng.choice(bits, size=4000, replace=False)).astype(np.int64)
    vals = rng.integers(-1000, 1001, size=cols.size)
    depth = max(int(abs(int(v)).bit_length()) for v in vals) or 1
    slices = np.zeros((2 + depth, W), dtype=np.uint32)
    slices[0] = pack_positions(cols, bits)
    slices[1] = pack_positions(cols[vals < 0], bits)
    for kb in range(depth):
        slices[2 + kb] = pack_positions(cols[(np.abs(vals) >> kb) & 1 == 1], bits)
    slices[1, 3] |= 0x80000000
    slices[0, 3] |= 0x80000000
    filt = pack_positions(np.flatnonzero(rng.random(bits) < 0.5).astype(np.int64), bits)
    r_sum, r_n = ref_ops.bsi.sum_device(slices, filt)
    got_sum, got_n = ops.sum_device(t(slices), t(filt))
    assert got_sum.dtype == torch.int64 and got_n.dtype == torch.int64
    assert (int(got_sum), int(got_n)) == (int(r_sum), int(r_n))


def test_select_top_counts_range():
    """Counts at 2^(62 - b) (b = max(1, bit length of R - 1), where the
    keys of count << b | row ended), at 2^62 - 1 and up to 2^63 - 1,
    negative counts, and ties at the k-th value: the answer is the
    reference's ``lax.top_k`` of the same int64 counts, ties to the lower
    row. K12's keys are the count alone, so there is no range left."""
    ref_ops.popcount  # the reference package enables jax's int64
    rng = np.random.default_rng(5)
    for n in (1, 2, 8, 4097):
        b = similarity.count_key_bits(n)
        assert b == max(1, (n - 1).bit_length())
        for top in (1 << (62 - b), (1 << 62) - 1, 2**63 - 1):
            c = rng.integers(0, 3, n).astype(np.int64) * (top // 4)
            rows = rng.choice(n, min(n, 5), replace=False)
            c[rows[:3]] = top  # ties at the largest value
            c[rows[3:]] = top - 1
            if n > 8:
                c[rng.choice(n, 4, replace=False)] = -(2**63)
            for k in sorted({1, 2, 3, 4, min(n, 9), n}):
                rv, ri = jax.lax.top_k(jax.numpy.asarray(c), min(k, n))
                vals, ids = ops.select_top_counts(torch.from_numpy(c), k)
                assert vals.tolist() == np.asarray(rv).tolist(), (n, top, k)
                assert ids.tolist() == np.asarray(ri).tolist(), (n, top, k)
    # the old key's boundary exactly, one count past every other, a tie
    counts = torch.tensor([5, 1 << 61, 1 << 61, (1 << 61) - 1, -1], dtype=torch.int64)
    vals, ids = ops.select_top_counts(counts, 3)
    assert vals.tolist() == [1 << 61, 1 << 61, (1 << 61) - 1] and ids.tolist() == [1, 2, 3]
    vals, ids = ops.select_top_counts(torch.tensor([3, -1]), 2)
    assert vals.tolist() == [3, -1] and ids.tolist() == [0, 1]


def test_select_top_counts_ties_and_merge_sizes():
    """Ties to the lower row, k clamped to R, and 4,097 keys (K10's merge
    size) against numpy's stable argsort."""
    rng = np.random.default_rng(8)
    for n, k in ((8, 8), (8, 12), (4097, 4097), (4097, 5)):
        c = rng.integers(0, 40, n).astype(np.int64) * (1 << 30)
        vals, ids = ops.select_top_counts(torch.from_numpy(c), k)
        order = np.argsort(-c, kind="stable")[: min(k, n)]
        assert ids.tolist() == order.tolist() and vals.tolist() == c[order].tolist()
