"""Compare checkouts of pilosa_tpu_torch on one CUDA card, in turns.

    python3 chip_ab.py ROOT_A ROOT_B [ROOT_C ...]

Each ROOT is a directory that holds a ``pilosa_tpu_torch/`` package: a
checkout, or a commit unpacked with ``git archive``. The roots run in
the order given and then in reverse (A B B A), each in a process of its
own that builds that root's kernels, and each run prints one JSON line:

- ``host``: the sync p50 in ms (host clock around a query that ends in
  its readback, 30 queries after 3) of a Count, a TopN and a filtered
  TopN through ``API.query``, on one device and on 8 positions of the
  card (8x1 and 4x2), over 2,048 shards of chip_smoke's main recipe,
  and of the main path's Count over all 10,240 shards on one device;
  and of the taxi path's GroupBy with aggregate=Sum and its fused
  two-level GroupBy over 1,024 shards of random blocks, with their
  answers;
- ``kernels``: the device time in ms (CUDA events, 20 launches after
  one) of K2, K4 and K5 under Row(cab_type=1) at chip_smoke's taxi
  shapes (1,024 shards, depth 20; random words), fused where the root
  has the fused modes (``ops.PlannedFilter``) and as two launches (K1
  words, then the filter-plane mode), with a digest of the fused
  results; K4 over every column and under 16 masks (grouped), and K6's
  counts of 4 masks against 16 ids, with a digest; then K10's top-k of 8 counts and of 5 of 8 score keys (200
  calls: the host's rate, where the device waits for the host) beside
  ``torch.topk``, K10 over all 4,882,813 keys of a search, and K11 at
  16,384^2 x 2048 bits, with a digest of their answers; then K1's count
  of an Intersect over the main path's stack [8, 10240, 32768] and over
  one 4x2 block [8, 2560, 16384], K3's delta on that 10 GiB stack (7
  entries: _OOB ones and a repeat) and its row scatter of one row into a
  2 GiB run store, with a digest of each answer.

Compare roots only within one call: the host's load and the card's
clocks differ from one call to the next.
"""

import json
import os
import subprocess
import sys
import time


def taxi_holder(n_shards: int):
    """chip_smoke.py's taxi holder in short: 16 random blocks cycled over
    the shards, cab_type (3 rows) and passenger_count (10 rows) one row a
    column, total_amount of depth 20 from random planes; the last shard
    holds its rows as true bits, which Rows() reads."""
    import numpy as np

    from pilosa_tpu_torch.core import VIEW_BSI, FieldOptions, Holder
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH as SW
    from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD as W

    rng = np.random.default_rng(13)

    def one_hot(n_rows: int, pad: int) -> np.ndarray:
        m = np.zeros((pad, W), np.uint32)
        bits = rng.integers(0, n_rows, SW)[None] == np.arange(n_rows)[:, None]
        m[:n_rows] = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
        return m

    mats = []
    for _ in range(16):
        bsi = np.zeros((32, W), np.uint32)  # a fragment pads its 22 rows to 32
        bsi[:22] = rng.integers(0, 2**32, (22, W), dtype=np.uint32)
        bsi[1] &= rng.integers(0, 2**32, W, dtype=np.uint32)
        mats.append({"cab": one_hot(3, 8), "pc": one_hot(10, 16), "bsi": bsi})
    h = Holder(None)
    idx = h.create_index("taxi")
    amt = idx.create_field("total_amount", FieldOptions(field_type="int", min=-100_000, max=1_000_000))
    views = [(idx.create_field("cab_type").create_view_if_not_exists("standard"), "cab", True),
             (idx.create_field("passenger_count").create_view_if_not_exists("standard"), "pc", True),
             (amt.create_view_if_not_exists(VIEW_BSI), "bsi", False)]
    for s in range(n_shards):
        for view, key, rows in views:
            frag = view.create_fragment_if_not_exists(s)
            m = mats[s % 16][key]
            if rows and s == n_shards - 1:
                r, c = np.nonzero(np.unpackbits(m.view(np.uint8), axis=1, bitorder="little"))
                frag.union_positions(r.astype(np.uint64) * SW + c.astype(np.uint64))
                continue
            frag._np_matrix = m
            frag._all_dirty = False
    return h


def measure(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.environ["PILOSA_TPU_SHARD_WIDTH_EXP"] = "20"
    import numpy as np
    import torch

    from pilosa_tpu_torch import ops
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.ops import _cuda, bitwise
    from pilosa_tpu_torch.ops import similarity as sim
    from pilosa_tpu_torch.parallel import MeshContext, make_mesh
    from pilosa_tpu_torch.server import API
    from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD as W

    if not _cuda.__file__.startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not the package under {root}")
    _cuda.build(_cuda.SOURCES, force=True)
    out = {"root": os.path.basename(root.rstrip("/")) or root, "host": {}, "kernels": {}}

    # ---------------------------------------------------------------- host
    n_shards, rows, g = 2048, 8, 64
    rng = np.random.default_rng(7)
    blocks = [rng.integers(0, 2**32, (rows, W), dtype=np.uint32) & rng.integers(0, 2**32, (rows, W), dtype=np.uint32)
              for _ in range(g)]
    exists = []
    for b in blocks:
        e = np.zeros((rows, W), np.uint32)
        e[0] = np.bitwise_or.reduce(b, axis=0)
        exists.append(e)
    def holder(shards):
        h = Holder(None)
        idx = h.create_index("bench")
        view = idx.create_field("f").create_view_if_not_exists("standard")
        ex_view = idx.existence_field().create_view_if_not_exists("standard")
        for s in range(shards):
            for v, src in ((view, blocks), (ex_view, exists)):
                frag = v.create_fragment_if_not_exists(s)
                frag._np_matrix = src[s % g]  # packed-matrix injection, as chip_smoke's main path
                frag._all_dirty = False
        return h

    def p50(api, q, index="bench"):
        for _ in range(3):
            api.query(index, q)
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            api.query(index, q)
            lat.append(time.perf_counter() - t0)
        return float(np.median(lat)) * 1e3

    h = holder(n_shards)
    queries = ["Count(Intersect(Row(f=1), Row(f=2)))", "TopN(f, n=5)", "TopN(f, Row(f=1), n=5)"]
    positions = ["cuda:0"] * 8
    for name, make in (("one", lambda: API(h, device="cuda", route_mode="device")),
                       ("8x1", lambda: API(h, mesh_ctx=MeshContext(make_mesh(positions, words_axis=1)), route_mode="mesh")),
                       ("4x2", lambda: API(h, mesh_ctx=MeshContext(make_mesh(positions, words_axis=2)), route_mode="mesh"))):
        api = make()
        for q in queries:
            out["host"][f"{name} {q}"] = p50(api, q)
        del api
        torch.cuda.empty_cache()
    # the main path's Count: all 10,240 shards, one device
    api = API(holder(10240), device="cuda", route_mode="device")
    out["host"][f"one, 10,240 shards, {queries[0]}"] = p50(api, queries[0])
    out["host"]["main Count answer"] = api.query("bench", queries[0])
    del api, h
    torch.cuda.empty_cache()

    # the taxi path's two GroupBys over 1,024 shards: the aggregate=Sum
    # (K6 counts, K6 masks, K4 grouped) and the fused two-level one
    api = API(taxi_holder(1024), device="cuda", route_mode="device")
    for q in ("GroupBy(Rows(passenger_count), aggregate=Sum(field=total_amount))",
              "GroupBy(Rows(cab_type), Rows(passenger_count))"):
        out["host"][f"taxi {q}"] = p50(api, q, "taxi")
        out["host"][f"taxi {q} answer"] = api.query("taxi", q)["results"][0]
    del api
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- kernels
    s, depth, dev = 1024, 20, torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def words(*shape):
        return torch.randint(-(2**31), 2**31 - 1, shape, generator=gen, dtype=torch.int32, device=dev)

    stack = words(2 + depth, s, W)
    stack[1] &= words(s, W)  # fewer negative values
    cab, pc = words(8, s, W), words(16, s, W)
    load = [(bitwise.OP_LOAD, 0)]

    def filt():
        return ops.tree_eval([cab], [(0, 1)], load, s, count=False, device=dev)

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    k = out["kernels"]
    k["K2 two launches"] = ms(lambda: ops.row_counts(pc, filt()))
    k["K4 two launches"] = ms(lambda: ops.bsi_sum(stack, depth, filt()[None]))
    k["K5 max two launches"] = ms(lambda: ops.bsi_min_max(stack, depth, filt(), True))
    if hasattr(ops, "PlannedFilter"):
        pf = ops.PlannedFilter([cab], [(0, 1)], load, [], s, W)
        k["K2 rows+tree"] = ms(lambda: ops.row_counts(pc, pf))
        k["K4 one+tree"] = ms(lambda: ops.bsi_sum(stack, depth, pf))
        k["K5 max+tree"] = ms(lambda: ops.bsi_min_max(stack, depth, pf, True))
        got = [ops.row_counts(pc, pf), *ops.bsi_sum(stack, depth, pf), *ops.bsi_min_max(stack, depth, pf, True)]
        k["fused digest"] = [int(t.sum()) for t in got]
    # K4 over all columns; its grouped mode under the aggregate GroupBy's
    # 16 masks; K6's counts of the fused GroupBy's 4 masks against 16 ids
    # (10 rows, 6 of -1)
    masks16 = words(16, s, W)
    ids16 = torch.tensor(list(range(10)) + [-1] * 6, dtype=torch.int32, device=dev)
    k["K4 all"] = ms(lambda: ops.bsi_sum(stack, depth))
    k["K4 grouped, 16 masks"] = ms(lambda: ops.bsi_sum(stack, depth, masks16), 10)
    k["K6 gb_counts, 4 masks x 16 ids"] = ms(lambda: ops.gb_counts(masks16[:4], pc, ids16))
    got = [*ops.bsi_sum(stack, depth), *ops.bsi_sum(stack, depth, masks16), ops.gb_counts(masks16[:4], pc, ids16)]
    # the sums, and the sums weighted by position (a moved count shows)
    k["K4 K6 digest"] = [int(t.sum()) for t in got] + [
        int((t.flatten() * torch.arange(1, t.numel() + 1, device=dev)).sum()) for t in got]
    del stack, cab, pc, masks16
    # K10: the integer top-k of 8 counts (the graft step's), the mesh
    # search's 5 of 8 score keys, and all 4,882,813 keys of a search; K11
    # at 16,384^2 x 2048 bits; with a digest of the answers
    c8 = torch.tensor([5, 9, 9, 0, 3, 9, 1 << 40, 0], dtype=torch.int64, device=dev)
    k8, h8 = sim.mesh_sim_keys(c8, c8 + 9, c8[1:2].contiguous() + 9, "tanimoto")
    k["K10 select_top_counts, 4 of 8"] = ms(lambda: ops.select_top_counts(c8, 4), 200)
    k["K10 select_top, 5 of 8 score keys"] = ms(lambda: sim.select_top(k8, h8, 5), 200)
    k["torch.topk, 4 of 8"] = ms(lambda: torch.topk(c8, 4), 200)
    fps = words(4_882_813, 64)
    fps &= words(4_882_813, 64)
    keys, hist = sim.search_keys(fps, fps[17], 0.0)
    k["K10 select_top, every one of 4,882,813 keys"] = ms(lambda: sim.select_top(keys, hist, keys.shape[0]), 3)
    blk = fps[:16384]
    k["K11 tanimoto, 16,384^2 x 2048 bits"] = ms(lambda: sim.pairwise(blk, blk, "tanimoto"), 5)
    top = [ops.select_top_counts(c8, 4), sim.select_top(k8, h8, 5), sim.select_top(keys, hist, keys.shape[0])]
    k["K10 K11 digest"] = [int(t.view(torch.int32).long().sum()) for pair in top for t in pair] + [
        int(sim.pairwise(blk, blk, "tanimoto").view(torch.int32).long().sum())]
    del fps, keys, hist, blk, top
    torch.cuda.empty_cache()
    # K1 and K3 at the main path's and a 4x2 block's shapes
    big, blk = words(8, 10240, W), words(8, 2560, W // 2)
    inter = [(bitwise.OP_LOAD, 0), (bitwise.OP_LOAD, 1), (bitwise.OP_AND, 0)]
    k1_main = lambda: ops.tree_eval([big], [(0, 1), (0, 2)], inter, 10240, count=True)  # noqa: E731
    k1_block = lambda: ops.tree_eval([blk], [(0, 1), (0, 2)], inter, 2560, count=True, n_words=W // 2)  # noqa: E731
    k["K1 count Intersect, [8, 10240, 32768]"] = ms(k1_main)
    k["K1 count Intersect, 4x2 block [8, 2560, 16384]"] = ms(k1_block)
    k["K1 digest"] = [int(k1_main()), int(k1_block())]
    oob = 2**30
    didx = torch.tensor([[1, 0], [oob, oob], [7, 10239], [2, oob], [-1, 1], [0, 5120], [1, 0]], dtype=torch.int32, device=dev)
    drows = words(7, W)
    k["K3 delta, 10 GiB stack"] = ms(lambda: ops.apply_stack_delta(big, didx, drows), 5)
    # int64 sums wrap alike on both roots: a digest of every word
    k["K3 delta digest"] = int(ops.apply_stack_delta(big, didx, drows).view(torch.int64).sum())
    del big, blk
    torch.cuda.empty_cache()
    run = words(2 << 20, 128, 2)  # a 2 GiB run store of 1 KB rows
    one, row = torch.tensor([3], dtype=torch.int32, device=dev), words(1, 128, 2)
    k["K3 rows, 2 GiB run store"] = ms(lambda: ops.scatter_rows(run, one, row), 5)
    k["K3 rows digest"] = int(ops.scatter_rows(run, one, row).view(torch.int64).sum())
    return out


def main(roots: list) -> int:
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for root in roots + roots[::-1]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
