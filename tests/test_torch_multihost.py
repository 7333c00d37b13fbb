"""Multi-process meshes (B16m) against pilosa_tpu on the CPU.

The device grid is a pure function of (process_index, id), so fake
device records check the layout across hosts (the port's counterparts of
tests/test_multihost.py:39-79). Then two real processes join a gloo
group on 127.0.0.1, build a 4x2 mesh of 4 CPU positions each
(words_axis=2), place only their own global shards
(tests/_torch_multihost_child.py) and run the mesh programs: both ranks
must return the same answers, equal to the reference's single-process
MeshQueryEngine over conftest's 8 devices on the same global data and
to numpy. Last, Server.open joins the group its config names.
"""

import json
import os
import re
import socket
import subprocess
import sys
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_multihost_child import DEPTH, K, N_ROWS, global_data
from pilosa_tpu.parallel import mesh as ref_mesh
from pilosa_tpu_torch.ops import bitwise
from pilosa_tpu_torch.parallel import multihost
from pilosa_tpu_torch.parallel.mesh import BlockPlan, MeshContext, MeshQueryEngine, make_mesh
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_multihost_child.py")
W = WORDS_PER_SHARD


@dataclass(frozen=True)
class FakeDev:
    id: int
    process_index: int


def fleet(hosts: int, per_host: int):
    return [FakeDev(id=h * per_host + i, process_index=h) for h in range(hosts) for i in range(per_host)]


def test_grid_keeps_words_axis_within_host():
    grid = multihost.multihost_device_grid(fleet(hosts=4, per_host=4), words_axis=4)
    assert (len(grid), len(grid[0])) == (4, 4)
    for row in grid:
        assert len({d.process_index for d in row}) == 1


def test_grid_splits_host_into_multiple_word_groups():
    grid = multihost.multihost_device_grid(fleet(hosts=2, per_host=8), words_axis=4)
    assert (len(grid), len(grid[0])) == (4, 4)
    assert [row[0].process_index for row in grid] == [0, 0, 1, 1]
    # shuffled records come out in (process, id) order
    grid2 = multihost.multihost_device_grid(list(reversed(fleet(hosts=2, per_host=8))), words_axis=4)
    assert grid2 == grid


def test_grid_rejects_cross_host_words_axis():
    with pytest.raises(ValueError, match="not divisible by words_axis=4"):
        multihost.multihost_device_grid(fleet(hosts=4, per_host=2), words_axis=4)


def test_single_process_mesh_executes():
    """Without a group the multi-host mesh is the local one: 8 CPU
    positions in a 4x2 grid, one process, and a count equal to the
    reference's over its 8 devices."""
    mesh = multihost.make_multihost_mesh(words_axis=2, devices=["cpu"] * 8)
    assert mesh.shape == {"shards": 4, "words": 2} and not mesh.multiprocess
    engine = MeshQueryEngine(mesh)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (8, W), dtype=np.uint32)
    b = rng.integers(0, 2**32, (8, W), dtype=np.uint32)
    got = int(engine.count_and(engine.place_row(a), engine.place_row(b)))
    ref = ref_mesh.MeshQueryEngine(ref_mesh.make_mesh(jax.devices(), words_axis=2))
    assert got == int(ref.count_and(ref.place_row(a), ref.place_row(b))) == int(np.bitwise_count(a & b).sum())


def test_init_distributed_noop_without_coordinator():
    import torch.distributed as dist

    multihost.init_distributed(None)  # must not raise or initialize
    multihost.init_distributed("")
    assert not dist.is_initialized()


def test_init_distributed_needs_world_and_rank(monkeypatch):
    """torch cannot infer the group's size or this rank from the
    coordinator: without them, and without torchrun's variables, it
    raises before any rendezvous."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        multihost.init_distributed("127.0.0.1:1", None, 0)
    with pytest.raises(ValueError, match="RANK"):
        multihost.init_distributed("127.0.0.1:1", 2, -1)
    with pytest.raises(ValueError, match="out of range"):
        multihost.init_distributed("127.0.0.1:1", 2, 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env() -> dict:
    return dict(os.environ, PILOSA_TPU_SHARD_WIDTH_EXP=os.environ["PILOSA_TPU_SHARD_WIDTH_EXP"],
                GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")


def _result(out: str) -> dict:
    m = re.search(r"^RESULT (.*)$", out, re.M)
    assert m, out[-3000:]
    return json.loads(m.group(1))


@pytest.fixture(scope="module")
def ranks():
    """The two ranks' answers, run once for the module."""
    port = str(_free_port())
    procs = [
        subprocess.Popen([sys.executable, CHILD, "programs", str(r), port], cwd=REPO, env=_child_env(),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    return [_result(o) for o in outs]


@pytest.fixture(scope="module")
def data():
    return global_data(W)


@pytest.fixture(scope="module")
def reference(data):
    """The reference's single-process 4x2 MeshQueryEngine on the global
    data, over conftest's 8 devices."""
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    ref = ref_mesh.MeshQueryEngine(ref_mesh.make_mesh(jax.devices(), words_axis=2))
    m, f = ref.place_matrix(data["matrix"]), ref.place_row(data["filt"])
    out = {"count_and": int(ref.count_and(ref.place_row(data["matrix"][0]), ref.place_row(data["matrix"][1])))}
    prog = ref.count_tree(lambda arrays, scalars: arrays[0][1] & arrays[0][2], "grid")
    out["count_tree"] = int(prog((m,), jnp.zeros((0,), jnp.int32)))
    vals, ids = ref.topn(m, f, K)
    out["topn"] = [np.asarray(vals).tolist(), np.asarray(ids).tolist()]
    total, n = ref.bsi_sum(jax.device_put(data["slices"], ref.spec_matrix()), f)
    out["bsi_sum"] = [int(total), int(n)]
    scores, sids = ref.tanimoto(m, f, 3)
    out["tanimoto"] = [np.asarray(scores).view(np.int32).tolist(), np.asarray(sids).tolist()]
    _new, counts, total = ref.ingest_and_aggregate(m, ref.place_matrix(data["delta"]), f)
    out["ingest"] = [True, np.asarray(counts).tolist(), int(total)]
    slices = jax.device_put(data["slices"], ref.spec_matrix())
    for name, want_max in (("min", False), ("max", True)):
        values, counts = ref.minmax_tree(want_max, "grid")(slices, f)
        out[name] = [np.asarray(values).tolist(), np.asarray(counts).tolist()]
    return out


def _numpy(data) -> dict:
    m, f, d = data["matrix"], data["filt"], data["delta"]
    pc = lambda x: int(np.bitwise_count(x).sum())  # noqa: E731
    counts = [pc(m[r] & f) for r in range(N_ROWS)]
    order = sorted(range(N_ROWS), key=lambda r: (-counts[r], r))[:K]
    inter = np.array([pc(m[r] & f) for r in range(N_ROWS)], dtype=np.float32)
    union = np.array([pc(m[r]) for r in range(N_ROWS)], dtype=np.float32) + np.float32(pc(f)) - inter
    scores = np.where(union > 0, inter / union, np.float32(0))
    top = sorted(range(N_ROWS), key=lambda r: (-scores[r], r))[:3]
    keep = data["has"] & np.unpackbits(f.view(np.uint8), axis=-1, bitorder="little").astype(bool)
    new = m | d
    # Min/Max: per block (i, j) of the 4x2 grid, in position order i * 2 + j,
    # each of its 2 shards' extreme value over the block's half of the
    # columns and how many columns hold it
    ext = {"min": ([], []), "max": ([], [])}
    half = W * 16
    for i in range(4):
        for j in range(2):
            for sh in (2 * i, 2 * i + 1):
                v = data["vals"][sh, j * half : (j + 1) * half][keep[sh, j * half : (j + 1) * half]]
                for name, (ext_values, ext_counts) in ext.items():
                    e = int(v.max() if name == "max" else v.min())
                    ext_values.append(e)
                    ext_counts.append(int((v == e).sum()))
    return {
        "count_and": pc(m[0] & m[1]),
        "count_tree": pc(m[1] & m[2]),
        "topn": [[counts[r] for r in order], order],
        "bsi_sum": [int(data["vals"][keep].sum()), int(keep.sum())],
        "tanimoto": [scores[top].view(np.int32).tolist(), top],
        "ingest": [True, [pc(new[r] & f) for r in range(N_ROWS)], sum(pc(new[r] & f) for r in range(N_ROWS))],
        "count_and_after_ingest": pc(new[0] & new[1]),
        "min": [list(ext["min"][0]), list(ext["min"][1])],
        "max": [list(ext["max"][0]), list(ext["max"][1])],
    }


def test_two_ranks_hold_their_own_shards(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["shape"] == {"shards": 4, "words": 2} and r["owners"] == [0, 0, 1, 1] for r in ranks)
    assert ranks[0]["held"] == [[i, j] for i in (0, 1) for j in (0, 1)]
    assert ranks[1]["held"] == [[i, j] for i in (2, 3) for j in (0, 1)]
    assert all(r["loaded"] == [] for r in ranks)


@pytest.mark.parametrize(
    "program",
    ["count_and", "count_tree", "topn", "bsi_sum", "tanimoto", "ingest", "count_and_after_ingest", "min", "max"],
)
def test_two_ranks_equal_reference_and_numpy(ranks, reference, data, program):
    """Each program's answer on both ranks, the reference's one-process
    mesh's (count_and_after_ingest: the ingested matrix, numpy only) and
    numpy's, exactly; Tanimoto scores to the f32 bit; Min and Max as
    every block's per-shard extremes and their counts, gathered in
    position order (each count is nonzero, so every value is defined)."""
    want = _numpy(data)[program]
    if program in ("min", "max"):
        assert all(c > 0 for c in want[1])
    assert ranks[0][program] == ranks[1][program] == want
    if program in reference:
        assert reference[program] == want


def test_two_ranks_minmax_gathers_in_position_order(ranks, data):
    """Min and Max all-gather every block's per-shard extremes in the
    one-process order, position i * W + j: both ranks equal the
    single-process port mesh on the global slices and filter."""
    eng = MeshQueryEngine(make_mesh(["cpu"] * 8, words_axis=2))
    s, f = eng.place_matrix(data["slices"]), eng.place_row(data["filt"])
    for name, want_max in (("min", False), ("max", True)):
        want = [t.tolist() for t in eng.minmax_tree(want_max, "grid", f)(s, DEPTH)]
        assert ranks[0][name] == ranks[1][name] == want


def test_two_ranks_refuse_what_spans_processes(ranks):
    """A non-uniform S raises the count list on every rank; the
    gather of an array that spans processes and a compressed store
    raise; the stack cache serves over-budget fields through the slots."""
    for r in ranks:
        assert "uniform per-process shard count; got [4, 3]" in r["errors"]["uneven"]
        assert "spans 2 processes" in r["errors"]["gather"]
        assert "multi-host mesh" in r["errors"]["place_block"]
        assert r["residency_mode"] == "slots"
        snap = r["snapshot"]
        assert snap["processes"] == 2 and snap["rank"] == r["rank"] and snap["collectives"] > 0


def test_multihost_context_in_one_process():
    """``MeshContext(mesh, multihost=True)`` over a one-process mesh
    places its share as the whole array, in grid mode only, and places no
    compressed store."""
    ctx = MeshContext(make_mesh(["cpu"] * 4, words_axis=2), multihost=True)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 2**32, (4, W), dtype=np.uint32)
    placed = ctx.place_rows(rows)
    assert placed.mode == "grid" and np.array_equal(placed.host().view(np.uint32), rows)
    with pytest.raises(ValueError, match="shards axis sharded"):
        ctx.place_rows(rows[:3])
    with pytest.raises(ValueError, match="multi-host mesh"):
        ctx.place_block(torch.zeros(3, dtype=torch.int32))
    eng = MeshQueryEngine(ctx.mesh)
    plan = BlockPlan([(bitwise.OP_LOAD, 0)], [(0, 0)], [], 4, W)
    assert int(eng.count_tree(plan, "grid")([placed[None]])) == int(np.bitwise_count(rows).sum())


def test_server_open_joins_process_group(tmp_path, monkeypatch):
    """coordinator_address → multihost.init_distributed during
    Server.open(), and the serving mesh stays local."""
    from pilosa_tpu_torch.server import Server
    from pilosa_tpu_torch.utils.config import Config

    calls = []
    monkeypatch.setattr(multihost, "init_distributed", lambda addr, n, pid: calls.append((addr, n, pid)))
    s = Server(Config(bind="127.0.0.1:0", data_dir=str(tmp_path / "mh"), anti_entropy_interval=0,
                      coordinator_address="127.0.0.1:9999", num_processes=1, process_id=0), device="cpu")
    s.open()
    try:
        assert calls == [("127.0.0.1:9999", 1, 0)]
        assert s.wait_mesh(30) and s.api.executor.compiler.mesh_ctx is None
    finally:
        s.close()


def test_server_open_joins_a_real_group(tmp_path):
    """For real: a one-process gloo group at the configured coordinator,
    joined in open(), and the server answers a Count on its local
    executor."""
    out = subprocess.run(
        [sys.executable, CHILD, "server", str(_free_port()), str(tmp_path / "d")], cwd=REPO, env=_child_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    got = _result(out.stdout)
    assert got == {"initialized": True, "world": 1, "rank": 0, "backend": "gloo", "count": 2,
                   "serving_mesh": False, "loaded": []}
