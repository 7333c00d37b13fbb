"""One rank of a two-process mesh on the CPU, for tests/test_torch_multihost.py.

    python _torch_multihost_child.py programs <rank> <port>
    python _torch_multihost_child.py server <port> <data_dir>

``programs``: joins a two-process gloo group at 127.0.0.1:<port>, builds
a 4x2 mesh (4 CPU positions a rank, words_axis=2), places only this
rank's global shards of ``global_data()`` and runs the mesh programs;
prints one JSON line of answers. ``server``: a port ``Server`` whose
config names a coordinator, in a one-process group; prints one JSON line.
Imports neither jax nor pilosa_tpu.
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 12
N_SHARDS = 8  # global: 4 shard rows of the 4x2 grid, 2 shards each
N_ROWS = 6
DEPTH = 6
K = 4
PROCESSES = 2
POSITIONS = 4  # a rank
WORDS_AXIS = 2


def global_data(words: int) -> dict:
    """The global arrays, from one numpy seed: a row matrix with a tie
    (rows 4 and 2), a filter with all-ones and bit-31 words, BSI slices
    of values in [-40, 40] (exists, sign, 6 magnitude planes) and a
    sparse ingest delta."""
    rng = np.random.default_rng(SEED)
    shape = (N_SHARDS, words)
    matrix = rng.integers(0, 2**32, (N_ROWS,) + shape, dtype=np.uint32)
    matrix &= rng.integers(0, 2**32, (N_ROWS,) + shape, dtype=np.uint32)
    matrix[4] = matrix[2]
    matrix[5] = 0
    filt = rng.integers(0, 2**32, shape, dtype=np.uint32)
    filt[0, ::3] = 0xFFFFFFFF
    filt[1, 1::4] = 0x80000000
    vals = rng.integers(-40, 41, (N_SHARDS, words * 32))
    has = rng.random((N_SHARDS, words * 32)) < 0.3

    def plane(bits: np.ndarray) -> np.ndarray:
        return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)

    slices = np.stack([plane(has), plane(has & (vals < 0))] + [plane(has & ((np.abs(vals) >> b) & 1 == 1)) for b in range(DEPTH)])
    delta = np.where(rng.random((N_ROWS,) + shape) < 0.05, rng.integers(0, 2**32, (N_ROWS,) + shape, dtype=np.uint32), 0)
    delta = delta.astype(np.uint32)
    return {"matrix": matrix, "filt": filt, "slices": slices, "delta": delta, "vals": vals, "has": has}


def local_share(arr: np.ndarray, rank: int) -> np.ndarray:
    """This rank's share of the shards axis (the second to last)."""
    s = arr.shape[-2] // PROCESSES
    return np.ascontiguousarray(arr[..., rank * s : (rank + 1) * s, :])


def programs(rank: int, port: int) -> dict:
    import torch

    from pilosa_tpu_torch.executor.compile import StackCache
    from pilosa_tpu_torch.ops import bitwise
    from pilosa_tpu_torch.parallel import multihost
    from pilosa_tpu_torch.parallel.mesh import BlockPlan, MeshContext, MeshQueryEngine
    from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

    torch.set_num_threads(1)
    multihost.init_distributed(f"127.0.0.1:{port}", PROCESSES, rank)
    multihost.init_distributed(f"127.0.0.1:{port}", PROCESSES, rank)  # the same group: a no-op
    mesh = multihost.make_multihost_mesh(words_axis=WORDS_AXIS, devices=["cpu"] * POSITIONS)
    ctx = MeshContext(mesh, multihost=True)
    eng = MeshQueryEngine(mesh)
    data = global_data(WORDS_PER_SHARD)
    m = ctx.place_stack(local_share(data["matrix"], rank))
    f = ctx.place_rows(local_share(data["filt"], rank))
    s = ctx.place_stack(local_share(data["slices"], rank))
    d = ctx.place_stack(local_share(data["delta"], rank))
    L, A = bitwise.OP_LOAD, bitwise.OP_AND
    plan = BlockPlan([(L, 0), (L, 1), (A, 0)], [(0, 1), (0, 2)], [], N_SHARDS, WORDS_PER_SHARD)
    out = {
        "rank": rank,
        "shape": dict(mesh.shape),
        "owners": mesh.owners,
        "held": [[i, j] for i, j, _b in m.items()],
        "count_and": int(eng.count_and(m.row(0), m.row(1))),
        "count_tree": int(eng.count_tree(plan, "grid")([m])),
    }
    vals, ids = eng.topn(m, f, K)
    out["topn"] = [vals.tolist(), ids.tolist()]
    total, n = eng.bsi_sum(s, f)
    out["bsi_sum"] = [int(total), int(n)]
    scores, sids = eng.tanimoto(m, f, 3)
    out["tanimoto"] = [scores.view(torch.int32).tolist(), sids.tolist()]
    for name, want_max in (("min", False), ("max", True)):
        out[name] = [t.tolist() for t in eng.minmax_tree(want_max, "grid", f)(s, DEPTH)]
    new_m, counts, total = eng.ingest_and_aggregate(m, d, f)
    out["ingest"] = [new_m is m, counts.tolist(), int(total)]
    out["count_and_after_ingest"] = int(eng.count_and(m.row(0), m.row(1)))
    errors = {}
    try:
        m.gather()
    except ValueError as e:
        errors["gather"] = str(e)
    try:  # rank 1 offers one shard fewer: every rank sees the counts
        ctx.place_rows(local_share(data["filt"], rank)[: 4 - rank])
    except ValueError as e:
        errors["uneven"] = str(e)
    try:
        ctx.place_block(torch.zeros(4, dtype=torch.int32))
    except ValueError as e:
        errors["place_block"] = str(e)
    out["errors"] = errors
    out["residency_mode"] = StackCache("cpu", mesh_ctx=ctx).residency_mode()
    out["snapshot"] = eng.snapshot()
    return out


def server(port: int, data_dir: str) -> dict:
    import json as _json
    import urllib.request

    import torch.distributed as dist

    from pilosa_tpu_torch.server import Server
    from pilosa_tpu_torch.utils.config import Config

    srv = Server(Config(bind="127.0.0.1:0", data_dir=data_dir, anti_entropy_interval=0, profiler_enabled=False,
                        diagnostics_interval=0, coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                        process_id=0), device="cpu")
    srv.open()
    try:
        srv.wait_mesh(60)

        def post(path, body):
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                return _json.loads(r.read())

        post("/index/i", b"{}")
        post("/index/i/field/f", b"{}")
        post("/index/i/query", b"Set(3, f=1) Set(70000, f=1)")
        count = post("/index/i/query", b"Count(Row(f=1))")["results"][0]
        return {
            "initialized": dist.is_initialized(),
            "world": dist.get_world_size(),
            "rank": dist.get_rank(),
            "backend": dist.get_backend(),
            "count": count,
            "serving_mesh": srv.api.executor.compiler.mesh_ctx is not None,
        }
    finally:
        srv.close()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "programs":
        result = programs(int(sys.argv[2]), int(sys.argv[3]))
    else:
        result = server(int(sys.argv[2]), sys.argv[3])
    result["loaded"] = sorted(
        m for m in sys.modules if m in ("jax", "pilosa_tpu") or m.startswith(("jax.", "pilosa_tpu."))
    )
    print("RESULT " + json.dumps(result), flush=True)
