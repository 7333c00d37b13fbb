"""K10's routes and K11's launch plan, and the top-k against pilosa_tpu.

The route rule (``select_route``) is a pure function of (n, k,
int_bits). The integer top-k and the search are held against the
reference's ``jax.lax.top_k`` and ``tanimoto_search`` at the edge of the
one-block route (4,096 keys) exactly: counts and ids equal, f32 scores
bit-equal. On ``meta`` tensors (shapes without data) the wrappers take
their kernel path, so with the C entries replaced by recorders the tests
read which kernel each call launches, on which route, with which
buffers; nothing runs.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pilosa_tpu.ops import similarity as ref
from pilosa_tpu.parallel import mesh as ref_mesh
from pilosa_tpu_torch import ops
from pilosa_tpu_torch.ops import _cuda, topn
from pilosa_tpu_torch.ops import similarity as sim
from pilosa_tpu_torch.parallel.mesh import MeshContext, MeshQueryEngine, make_mesh


@pytest.mark.parametrize("int_bits", [0, 13])
@pytest.mark.parametrize("k_of", ["0", "1", "n"])
@pytest.mark.parametrize("n", [1, 4096, 4097])
def test_select_route_is_a_function_of_n_k_and_int_bits(n, k_of, int_bits):
    k = {"0": 0, "1": 1, "n": n}[k_of]
    route = sim.select_route(n, k, int_bits)
    if k == 0:
        assert route == "none"
        return
    want = "small" if n <= sim.SELECT_TILE else "tile" if k <= sim.SELECT_TILE else "radix"
    assert route == want + (" int" if int_bits else "")
    assert route.split(" ")[0] in sim.SELECT_ROUTES


def test_select_work_bytes():
    # the tile route: the k keys and, in the int mode, their rows
    assert sim.select_work_bytes(4096, 0, "tile") == 8 * 4096
    assert sim.select_work_bytes(4096, 13, "tile int") == 12 * 4096
    # the radix route: both buffers and a [256, blocks] table of int32
    blocks = -(-4097 // sim.RADIX_TILE)
    assert sim.select_work_bytes(4097, 0, "radix") == 16 * 4097 + 4 * 256 * blocks
    assert sim.select_work_bytes(4097, 13, "radix int") == 24 * 4097 + 4 * 256 * blocks


def test_select_layout_is_the_sources_defines():
    """K10's buffers and route numbers in Python are the ones
    similarity_scan.cu sizes and reads: the launch passes no sizes, so a
    drift would write past ``zeroed`` or ``work`` on the card."""
    import re

    src = ""
    for name in ("common.cuh", "similarity_scan.cu"):
        with open(f"{_cuda.CSRC}/{name}") as fh:
            src += fh.read()
    d = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\b", src)}
    assert sim.SELECT_BITS == d["SIM_BITS"] and sim.SELECT_TILE == d["SIM_TILE"]
    assert sim.SELECT_SHIFTS[0] == d["SIM_FIRST_SHIFT"] and len(sim.SELECT_SHIFTS) == d["SIM_LEVELS"]
    # the zeroed buffer: a histogram of SIM_BINS int32 a level, then the state
    assert len(sim.SELECT_SHIFTS) - 1 + sim.SELECT_ROW_LEVELS == d["SIM_HIST_LEVELS"]
    assert sim.SELECT_ZEROED_WORDS == d["SIM_HIST_LEVELS"] * (1 << d["SIM_BITS"]) // 2 + d["SIM_STATE_WORDS"]
    assert sim.RADIX_BINS == d["RS_BINS"] and sim.RADIX_TILE == d["PT_BLOCK"] * d["RS_ITEMS"]
    assert sim.SELECT_ROUTES == {
        "small": d["SIM_SMALL"], "small counts": d["SIM_SMALL_COUNTS"], "tile": d["SIM_TILE_ROUTE"], "radix": d["SIM_RADIX"],
        "small sim": d["SIM_SMALL_SIM"]}
    # work: the k keys (twice, then the [RS_BINS, blocks] int32 table, on
    # the radix route) in int64 words, then the rows (twice on the radix route)
    for k in (1, 4096, 4097, 1 << 20):
        blocks = -(-k // (d["PT_BLOCK"] * d["RS_ITEMS"]))
        for bits in (0, 21):
            rows = 4 * k if bits else 0
            if k <= d["SIM_TILE"]:
                assert sim.select_work_bytes(k, bits, "tile") == 8 * k + rows
            assert sim.select_work_bytes(k, bits, "radix") == 8 * (2 * k + d["RS_BINS"] // 2 * blocks) + 2 * rows


def _counts(rng, n: int) -> np.ndarray:
    """int64[n]: a few distinct values, so ties at the k-th count, with
    negative counts, -2^63 and 2^63 - 1 where they fit."""
    c = rng.integers(-3, 4, n).astype(np.int64) * (1 << 40)
    if n >= 8:
        c[[1, 5]] = 2**63 - 1
        c[[2, 6]] = -(2**63)
        c[7] = -1
    return c


@pytest.mark.parametrize("n", [1, 8, 4096, 4097])
def test_select_top_counts_matches_lax_top_k(n):
    """Exact: the counts and the ids equal ``lax.top_k``'s, ties to the
    lower row, on both sides of the one-launch route (4,096 counts)."""
    ref.tanimoto_search  # the reference package enables jax's int64
    c = _counts(np.random.default_rng(n), n)
    for k in sorted({1, min(n, 3), n}):
        want_v, want_i = jax.lax.top_k(jax.numpy.asarray(c), k)
        for fn in (topn.select_top_counts, topn.select_top_counts_plain):
            vals, ids = fn(torch.from_numpy(c), k)
            assert vals.tolist() == np.asarray(want_v).tolist(), (fn.__name__, n, k)
            assert ids.tolist() == np.asarray(want_i).tolist(), (fn.__name__, n, k)
    if n <= sim.SELECT_TILE:  # the one-launch route's own entry, every count
        vals, ids = sim.select_counts(torch.from_numpy(c), n)
        assert (vals.tolist(), ids.tolist()) == (np.asarray(want_v).tolist(), np.asarray(want_i).tolist())


@pytest.mark.parametrize("n_rows", [4096, 4097])
def test_search_at_the_one_block_edge_matches_reference(n_rows):
    """Exact: ids equal and f32 scores bit-equal to the reference's
    search, at 4,096 keys (one block) and 4,097 (the select)."""
    rng = np.random.default_rng(n_rows)
    m = rng.integers(0, 2**32, (n_rows, 8), dtype=np.uint32) & rng.integers(0, 2**32, (n_rows, 8), dtype=np.uint32)
    m[1] = m[0]
    m[2] = 0xFFFFFFFF
    m[3] = 0x80000000
    m[4] = 0
    for k, threshold in ((10, 0.0), (n_rows, 0.3)):
        want_s, want_i = ref.tanimoto_search(m, m[0], k=k, threshold=threshold)
        got_s, got_i = sim.tanimoto_search(m, m[0], k=k, threshold=threshold, device="cpu")
        assert np.array_equal(got_i.numpy(), np.asarray(want_i))
        assert np.array_equal(got_s.numpy().view(np.uint32), np.asarray(want_s).view(np.uint32))


# ------------------------------------------- the mesh search's finish
SIM_SHARDS, SIM_WORDS = 4, 8  # a row's shards and words a shard: one shard and 4 words a position


def _sim_rows(n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """uint32[R, 4, 8] fingerprints and a uint32[4, 8] query: random rows
    with ties (rows 1-3 equal row 0), an empty row (4), a full one (5)
    and the query itself (6) where R allows."""
    rng = np.random.default_rng(n_rows)
    shape = (n_rows, SIM_SHARDS, SIM_WORDS)
    m = rng.integers(0, 2**32, shape, dtype=np.uint32) & rng.integers(0, 2**32, shape, dtype=np.uint32)
    q = rng.integers(0, 2**32, shape[1:], dtype=np.uint32)
    m[1:4] = m[0]
    m[4:5] = 0
    m[5:6] = 0xFFFFFFFF
    m[6:7] = q
    return m, q


def _pop(x: np.ndarray) -> np.ndarray:
    """Set bits of each row of ``x`` (any leading shape) as int64."""
    return np.unpackbits(x.reshape(*x.shape[:-2], -1).view(np.uint8), axis=-1).sum(axis=-1).astype(np.int64)


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("n_rows", [1, 8, 4096, 4097])
def test_select_sim_equals_the_keys_select_and_the_reference_mesh_search(n_rows, metric):
    """Bit for bit: ``select_sim`` and its plain version, on numpy's
    counts of the rows, against K12's plain keys and K10's plain select
    and against the reference's mesh search on its 8 CPU devices, at k =
    0, 1 and R, on both sides of the one-launch route (4,096 rows); and
    up to 8 rows the port's mesh search (``make_mesh(["cpu"] * 8,
    words_axis=2)``, whose plain row counts loop over the rows) too.
    Ties take the lower row; an empty query makes every union of an
    empty row and every cosine denominator 0."""
    m, q = _sim_rows(n_rows)
    rmesh = ref_mesh.make_mesh(jax.devices(), words_axis=2)
    reng = ref_mesh.MeshQueryEngine(rmesh)
    rm = jax.device_put(m, NamedSharding(rmesh, P(None, "shards", "words")))
    ctx = MeshContext(make_mesh(["cpu"] * 8, words_axis=2))
    eng = MeshQueryEngine(ctx.mesh)
    pm = ctx.place_stack(m)
    assert pm.mode == "grid"
    for query in (q, np.zeros_like(q)):
        inter = torch.from_numpy(_pop(m & query[None]))
        row_pop, q_pop = torch.from_numpy(_pop(m)), torch.from_numpy(_pop(query[None]))
        rq = jax.device_put(query, NamedSharding(rmesh, P("shards", "words")))
        pq = ctx.place_rows(query)
        for k in sorted({0, 1, n_rows}):
            want = sim.select_top_plain(sim.mesh_sim_keys_plain(inter, row_pop, q_pop, metric)[0], k)
            r_scores, r_ids = (np.asarray(x) for x in getattr(reng, metric)(rm, rq, k))
            gots = [sim.select_sim(inter, row_pop, q_pop, metric, k), sim.select_sim_plain(inter, row_pop, q_pop, metric, k)]
            if n_rows <= 8:
                gots.append(getattr(eng, metric)(pm, pq, k))
            for got in gots:
                assert np.array_equal(got[0].numpy().view(np.uint32), want[0].numpy().view(np.uint32)), (k, got, want)
                assert np.array_equal(got[1].numpy(), want[1].numpy()), (k, got, want)
                assert np.array_equal(got[0].numpy().view(np.uint32), r_scores.view(np.uint32)), k
                assert np.array_equal(got[1].numpy(), r_ids), k
    if n_rows >= 8:
        # the tie block comes out in row order, and an empty row scores 0
        scores, ids = sim.select_sim_plain(inter, row_pop, q_pop, metric, n_rows)
        assert (scores == 0).all()  # the empty query: every score is 0, the rows in order
        assert ids.tolist() == list(range(n_rows))
    with pytest.raises(ValueError):
        sim.select_sim(inter, row_pop, q_pop, metric, n_rows + 1)
    with pytest.raises(ValueError):
        sim.select_sim(inter, row_pop, q_pop, "jaccard", 1)


# ------------------------------------------------- the launch plans on meta


@pytest.fixture
def launches(monkeypatch):
    """The C entries replaced by recorders: (kernel name, mode, args) per
    launch."""
    calls = []
    for name in ("sim_select", "count_keys", "pairwise", "mesh_sim_keys"):
        kern = _cuda.KERNELS[name]
        monkeypatch.setattr(kern, "launch", lambda dev, *args, mode="", _n=name: calls.append((_n, mode, args)))
    return calls


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_top_k_of_a_few_counts_is_one_launch(launches):
    vals, ids = ops.select_top_counts(_meta(8, torch.int64), 4)
    assert vals.shape == (4,) and vals.dtype == torch.int64 and ids.dtype == torch.int32
    assert [(n, m) for n, m, _a in launches] == [("sim_select", "small int")]
    args = launches[0][2]
    # keys, n, hist, zeroed, work, k, int_bits, route: the counts
    # themselves, no histogram, no scratch
    assert args[1] == 8 and args[2] is None and args[3] is None and args[4] is None
    assert args[5:8] == (4, sim.count_key_bits(8), sim.SELECT_ROUTES["small counts"])
    launches.clear()
    ops.select_top_counts(_meta(4096, torch.int64), 4096)
    assert [(n, m) for n, m, _a in launches] == [("sim_select", "small int")]
    launches.clear()
    # past the tile: K12's keys, then the select and a tile or radix sort
    ops.select_top_counts(_meta(8192, torch.int64), 4)
    ops.select_top_counts(_meta(8192, torch.int64), 5000)
    assert [(n, m) for n, m, _a in launches] == [
        ("count_keys", ""), ("sim_select", "tile int"), ("count_keys", ""), ("sim_select", "radix int")]
    assert launches[1][2][7] == sim.SELECT_ROUTES["tile"] and launches[3][2][7] == sim.SELECT_ROUTES["radix"]
    launches.clear()
    ops.select_top_counts(_meta(8192, torch.int64), 0)
    assert launches == []


def test_score_keys_take_their_route(launches):
    hist = _meta(sim.SELECT_BINS, torch.int32)
    for n, k, mode in ((8, 5, "small"), (4096, 4096, "small"), (4097, 10, "tile"), (5000, 4097, "radix")):
        scores, ids = sim.select_top(_meta(n, torch.int64), hist, k)
        assert scores.shape == (k,) and scores.dtype == torch.float32
        name, got_mode, args = launches[-1]
        assert (name, got_mode) == ("sim_select", mode)
        assert args[7] == sim.SELECT_ROUTES[mode] and (args[3] is None) == (mode == "small")
    # count_keys' keys on the small route count apart from the counts route
    counts, ids = sim.select_top(_meta(8, torch.int64), hist, 4, sim.count_key_bits(8))
    assert counts.dtype == torch.int64 and ids.shape == (4,)
    name, got_mode, args = launches[-1]
    assert (name, got_mode) == ("sim_select", "small int keys") and args[7] == sim.SELECT_ROUTES["small"]


def test_mesh_search_finish_is_one_launch_up_to_the_tile(launches):
    """``select_sim``: K10's small sim route alone up to 4,096 rows (the
    reduced counts, with |row|, |query| and the metric beside them, and
    no histogram or scratch); past that K12's keys and K10's select."""
    for n, k, metric in ((8, 8, "tanimoto"), (4096, 1, "cosine")):
        launches.clear()
        scores, ids = sim.select_sim(_meta(n, torch.int64), _meta(n, torch.int64), _meta(1, torch.int64), metric, k)
        assert scores.shape == (k,) and scores.dtype == torch.float32 and ids.dtype == torch.int32
        ((name, mode, args),) = launches
        assert (name, mode) == ("sim_select", "small sim") and args[1] == n
        assert args[2:5] == (None, None, None) and args[5:8] == (k, 0, sim.SELECT_ROUTES["small sim"])
        assert args[8] is not None and args[9] is not None and args[10] == sim.MESH_METRICS[metric]
    launches.clear()
    sim.select_sim(_meta(4097, torch.int64), _meta(4097, torch.int64), _meta(1, torch.int64), "cosine", 10)
    assert [(n, m) for n, m, _a in launches] == [("mesh_sim_keys", "cosine"), ("sim_select", "tile")]
    launches.clear()
    sim.select_sim(_meta(8, torch.int64), _meta(8, torch.int64), _meta(1, torch.int64), "tanimoto", 0)
    assert launches == []


def test_pairwise_takes_any_int32_row_count(launches):
    """C3: N past the old grid's 65,535 x 64 rows goes to the kernel."""
    n = 65535 * 64 + 65
    out = sim.pairwise(_meta((n, 64), torch.int32), _meta((8, 64), torch.int32), "tanimoto")
    assert out.shape == (n, 8)
    (name, mode, args), = launches
    assert (name, mode) == ("pairwise", "tanimoto") and args[1] == n and args[3] == 8
    assert args[6] == 1  # 16 B copies: W % 4 == 0, aligned rows
    sim.pairwise(_meta((3, 7), torch.int32), _meta((2, 7), torch.int32), "inter")
    assert launches[-1][2][6] == 0  # W = 7: 4 B copies
