"""Drive pilosa_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout. In order:

1. build the three kernels from ``pilosa_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc process each, all started together;
2. two paths, each with every kernel's launch count set to 0 just
   before it and read just after, and printed on a line of its own:
   - the main path: ``API(holder, device="cuda", route_mode="device")``
     over 10,240 shards × 8 rows (10.7 B columns; bench.py's default
     scale and data recipe: 64 distinct random blocks cycled over the
     shards, a 10 GiB int32 stack per field) serves Count/Intersect,
     Union, Difference, Xor, Not, TopN with and without a filter and an
     Options shard subset through ``API.query``, each answer checked
     against numpy over the same blocks; then a Set into one shard and
     Counts that must move by the write and ride the delta scatter on the
     10 GiB stacks. Every kernel must launch here;
   - the write phase, on a small holder built with ``API.import_roaring``
     and ``API.import_bits``: Set, then Count, which must move and ride
     the delta scatter;
3. each kernel against its plain torch version on the card at the main
   path's shapes (all-ones and bit-31 words, rows -1 and >= R, _OOB
   delta entries, an empty Union()), exact equality, and its time beside
   its bound and the plain version's;
4. print the card (nvidia-smi name and power limit), the launch counts,
   the router's calibration after the main path, the times, the kernel
   JSON line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises, and the script then exits non-zero without the last
line. It needs one CUDA card; without one it exits 1 at once.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_SHARDS = 10240
R_PAD = 8
G = 64  # distinct random blocks cycled over the shards (bench.py:118-137)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one
    warm-up (host clock for a CPU rehearsal)."""
    fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, a, b) -> int:
    """max |a - b| over every element, one leading slice at a time."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dim() <= 2:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
    return max(max_abs_err(torch, a[i], b[i]) for i in range(a.shape[0]))


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def main(device: str = "cuda", n_shards: int = N_SHARDS) -> int:
    """``device="cpu"`` with a small ``n_shards`` rehearses the same
    steps on the plain versions, without the card lines or the ok line."""
    import torch

    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        # the main path runs at the production shard width (2^20 columns)
        os.environ["PILOSA_TPU_SHARD_WIDTH_EXP"] = "20"
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pilosa_tpu_torch import ops
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.ops import _cuda, bitwise, stack, topn
    from pilosa_tpu_torch.roaring import Bitmap, serialize
    from pilosa_tpu_torch.server import API
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

    W = WORDS_PER_SHARD
    N_SHARDS = n_shards  # noqa: N806 — the module constant, or a rehearsal's
    if on_card:
        log("card:", card_line())
        log("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))
        t0 = time.perf_counter()
        build_s = _cuda.build(list(_cuda.KERNELS), force=True)
        log(f"kernel build: {time.perf_counter() - t0:.3f} s wall, per source {json.dumps(build_s)}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ------------------------------------------------------------ data
    rng = np.random.default_rng(7)
    blocks = []
    for _ in range(G):
        blk = rng.integers(0, 2**32, (R_PAD, W), dtype=np.uint32)
        blk &= rng.integers(0, 2**32, (R_PAD, W), dtype=np.uint32)
        blk &= rng.integers(0, 2**32, (R_PAD, W), dtype=np.uint32)
        blocks.append(blk)
    exists = []
    for blk in blocks:
        ex = np.zeros((R_PAD, W), dtype=np.uint32)
        ex[0] = np.bitwise_or.reduce(blk, axis=0)
        exists.append(ex)
    h = Holder(None)
    idx = h.create_index("bench")
    f = idx.create_field("f")
    view = f.create_view_if_not_exists("standard")
    ex_view = idx.existence_field().create_view_if_not_exists("standard")
    # the main path's write lands in the last shard: its fragments hold
    # the block in their roaring storage, so a Set repacks a true row
    write_shard = N_SHARDS - 1
    for s in range(N_SHARDS):
        for v, src in ((view, blocks), (ex_view, exists)):
            frag = v.create_fragment_if_not_exists(s)
            if s == write_shard:
                bits = np.unpackbits(src[s % G].view(np.uint8), axis=1, bitorder="little")
                r, c = np.nonzero(bits)
                frag.union_positions(r.astype(np.uint64) * SHARD_WIDTH + c.astype(np.uint64))
                continue
            # packed-matrix injection, as bench.py does it: the loading
            # path is not what this run measures
            frag._np_matrix = src[s % G]
            frag._all_dirty = False
    shards = list(range(N_SHARDS))

    def expect_count(fn, shard_list=shards) -> int:
        per_block = [int(np.bitwise_count(fn(blocks[g], exists[g][0])).sum()) for g in range(G)]
        return sum(per_block[s % G] for s in shard_list)

    def expect_topn(filt_row, n) -> list:
        counts = []
        for r in range(R_PAD):
            c = expect_count(
                lambda b, e, r=r: b[r] if filt_row is None else b[r] & b[filt_row]
            )
            if c:
                counts.append((r, c))
        counts.sort(key=lambda rc: (-rc[1], rc[0]))
        return [{"id": r, "count": c} for r, c in counts[:n]]

    api = API(h, device=device, route_mode="device")
    sub = list(range(0, N_SHARDS, 97))
    checks = [
        ("Count(Intersect(Row(f=1), Row(f=2)))", expect_count(lambda b, e: b[1] & b[2])),
        ("Count(Union(Row(f=1), Row(f=2)))", expect_count(lambda b, e: b[1] | b[2])),
        ("Count(Difference(Row(f=3), Row(f=4)))", expect_count(lambda b, e: b[3] & ~b[4])),
        ("Count(Xor(Row(f=5), Row(f=6)))", expect_count(lambda b, e: b[5] ^ b[6])),
        ("Count(Not(Row(f=1)))", expect_count(lambda b, e: e & ~b[1])),
        ("TopN(f, n=5)", expect_topn(None, 5)),
        ("TopN(f, Row(f=1), n=5)", expect_topn(1, 5)),
        (
            f"Options(Count(Intersect(Row(f=1), Row(f=7))), shards=[{', '.join(map(str, sub))}])",
            expect_count(lambda b, e: b[1] & b[7], sub),
        ),
    ]

    # ------------------------------------------------------- main path
    for k in _cuda.KERNELS.values():
        k.launches = 0
    times = {}
    t0 = time.perf_counter()
    api.executor.compiler.stacks.matrix(idx, f, "standard", shards)
    sync()
    times["stack_upload_s"] = time.perf_counter() - t0
    headline = checks[0][0]
    t0 = time.perf_counter()
    first = api.query("bench", headline)["results"][0]
    times["first_query_s"] = time.perf_counter() - t0
    if first != checks[0][1]:
        raise AssertionError(f"{headline}: {first} != numpy {checks[0][1]}")
    for pql, want in checks:
        got = api.query("bench", pql)["results"][0]
        if got != want:
            raise AssertionError(f"{pql}: {got} != numpy {want}")
        log(f"ok  {pql[:60]}  -> {json.dumps(got)[:80]}")
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        api.query("bench", headline)
        lat.append(time.perf_counter() - t0)
    times["sync_count_p50_ms"] = float(np.median(lat)) * 1e3
    n_pipe = 64
    t0 = time.perf_counter()
    pend = [p for _ in range(n_pipe) for p in api.executor.dispatch("bench", headline)]
    api.executor.settle(pend)
    times["pipelined_count_qps"] = n_pipe / (time.perf_counter() - t0)
    if any(p.value != checks[0][1] for p in pend):
        raise AssertionError("pipelined Count disagrees with numpy")
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        api.query("bench", "TopN(f, n=5)")
        lat.append(time.perf_counter() - t0)
    times["topn_p50_ms"] = float(np.median(lat)) * 1e3
    # a point write: one Set into the write shard, at a column that is in
    # no row of its block, so Row(f=1) gains one bit and Not(Row(f=1))
    # keeps its count (the column joins the existence row too)
    g_w = write_shard % G
    free_bits = np.flatnonzero(np.unpackbits(exists[g_w][0].view(np.uint8), bitorder="little") == 0)
    col = write_shard * SHARD_WIDTH + int(free_bits[0])
    stacks_ = api.executor.compiler.stacks
    restacks, deltas = stacks_.full_restacks, stacks_.delta_updates
    after_write = [
        ("Count(Row(f=1))", expect_count(lambda b, e: b[1]) + 1),
        ("Count(Not(Row(f=1)))", expect_count(lambda b, e: e & ~b[1])),
    ]
    api.query("bench", f"Set({col}, f=1)")
    t0 = time.perf_counter()
    for pql, want in after_write:
        got = api.query("bench", pql)["results"][0]
        if got != want:
            raise AssertionError(f"after Set({col}, f=1): {pql}: {got} != numpy {want}")
        log(f"ok  after Set: {pql}  -> {got}")
    times["write_then_counts_s"] = time.perf_counter() - t0
    if stacks_.full_restacks != restacks or stacks_.delta_updates != deltas + 2:
        raise AssertionError(f"the main path's write did not take the delta path: {stacks_.stats_snapshot()}")
    sync()
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    log("launches on the main path:", json.dumps(launches))
    if on_card and any(n <= 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    router = api.executor.router
    log("router calibration after the main path:", json.dumps(
        {"dispatch_s": router.dispatch_s.value, "readback_s": router.readback_s.value}))

    # write phase: a small holder loaded through the import entry points
    for k in _cuda.KERNELS.values():
        k.launches = 0
    wh = Holder(None)
    wapi = API(wh, device=device, route_mode="device")
    wapi.create_index("w")
    wapi.create_field("w", "f")
    wrng = np.random.default_rng(11)
    positions = np.unique(wrng.integers(0, 4 * SHARD_WIDTH, 50_000)).astype(np.uint64)
    bm = Bitmap()
    bm.add_many(positions)
    wapi.import_roaring("w", "f", 0, serialize(bm))
    cols = np.unique(wrng.integers(SHARD_WIDTH, 3 * SHARD_WIDTH, 20_000))
    for lo in range(0, cols.size, 5000):  # max_writes per request
        part = cols[lo : lo + 5000].tolist()
        wapi.import_bits("w", "f", {"rowIDs": [1] * len(part), "columnIDs": part})
    row1 = set((positions[(positions >= SHARD_WIDTH) & (positions < 2 * SHARD_WIDTH)] - SHARD_WIDTH).tolist())
    row1 |= set(cols.tolist())
    before = wapi.query("w", "Count(Row(f=1))")["results"][0]
    if before != len(row1):
        raise AssertionError(f"write phase: Count {before} != {len(row1)}")
    wstacks = wapi.executor.compiler.stacks
    restacks, deltas = wstacks.full_restacks, wstacks.delta_updates
    free = next(c for c in range(3 * SHARD_WIDTH) if c not in row1)
    wapi.query("w", f"Set({free}, f=1)")
    after = wapi.query("w", "Count(Row(f=1))")["results"][0]
    if after != before + 1:
        raise AssertionError(f"write phase: Count {after} after Set, want {before + 1}")
    if wstacks.full_restacks != restacks or wstacks.delta_updates <= deltas:
        raise AssertionError(f"write phase did not take the delta path: {wstacks.stats_snapshot()}")
    sync()
    write_launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    log("launches on the write phase (4-shard holder):", json.dumps(write_launches))
    if on_card and (write_launches["stack_delta"] <= 0 or write_launches["tree_eval"] <= 0):
        raise AssertionError(f"the write phase did not run through its kernels: {write_launches}")

    # ------------------------------------------- kernels vs plain versions
    dev = api.executor.device
    fm = api.executor.compiler.stacks.matrix(idx, f, "standard", shards)[0]
    em = api.executor.compiler.stacks.matrix(idx, idx.existence_field(), "standard", shards)[0]
    edge = torch.empty((2, N_SHARDS, W), dtype=torch.int32, device=dev)
    edge[0].fill_(-1)  # all-ones words
    edge[1].fill_(-(2**31))  # only bit 31 set
    L, Z = bitwise.OP_LOAD, bitwise.OP_ZERO
    A, O, X, N = bitwise.OP_AND, bitwise.OP_OR, bitwise.OP_XOR, bitwise.OP_ANDNOT
    tree_cases = [
        # (stacks, leaves, program)
        ([fm], [(0, 1), (0, 2)], [(L, 0), (L, 1), (A, 0)]),  # the headline
        ([fm, em], [(1, 0), (0, 1)], [(L, 0), (L, 1), (N, 0)]),  # Not
        ([fm], [(0, -1), (0, R_PAD), (0, 3)], [(L, 0), (L, 1), (O, 0), (L, 2), (X, 0)]),
        ([fm], [], [(Z, 0)]),  # empty Union()
        ([edge, fm], [(0, 0), (0, 1), (1, 5)], [(L, 0), (L, 1), (A, 0), (L, 0), (L, 2), (N, 0), (X, 0)]),
    ]
    errs = {"tree_eval": 0, "row_counts": 0, "stack_delta": 0}
    for stacks_, leaves, prog in tree_cases:
        for count in (True, False):
            got = ops.tree_eval(stacks_, leaves, prog, N_SHARDS, count=count, device=dev)
            want = bitwise.tree_eval_plain(stacks_, leaves, prog, N_SHARDS, count, dev)
            errs["tree_eval"] = max(errs["tree_eval"], max_abs_err(torch, got, want))
            del got, want
    filt = ops.tree_eval([fm], [(0, 1)], [(L, 0)], N_SHARDS, count=False, device=dev)
    ids = torch.tensor([-1, 0, 3, 7, R_PAD, 2**30], dtype=torch.int32, device=dev)
    for m, fl, ii in ((fm, None, None), (fm, filt, None), (fm, filt, ids), (edge, None, None), (edge, edge[1].contiguous(), ids)):
        got = ops.row_counts(m, fl, ii)
        want = topn.row_counts_plain(m, fl, ii)
        errs["row_counts"] = max(errs["row_counts"], max_abs_err(torch, got, want))
    widx = wh.index("w")
    wm = wstacks.matrix(widx, widx.field("f"), "standard", sorted(widx.available_shards()))[0]
    oob = stack.OOB
    delta_cases = []
    for m in (wm, fm):
        r_n, s_n = m.shape[0], m.shape[1]
        didx = torch.tensor(
            # the last entry repeats the first: the later one wins
            [[1, 0], [oob, oob], [r_n - 1, s_n - 1], [2, oob], [-1, 1], [0, s_n // 2], [1, 0]],
            dtype=torch.int32, device=dev,
        )
        drows = torch.randint(-(2**31), 2**31 - 1, (didx.shape[0], W), dtype=torch.int32, device=dev)
        delta_cases.append((m, didx, drows))
        got = ops.apply_stack_delta(m, didx, drows)
        want = stack.apply_stack_delta_plain(m, didx, drows)
        errs["stack_delta"] = max(errs["stack_delta"], max_abs_err(torch, got, want))
        del got, want
        torch.cuda.empty_cache()
    log("max |kernel - plain|:", json.dumps(errs))
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: {errs}")
    del delta_cases[0]

    # --------------------------------------------------------- timings
    plane = N_SHARDS * W * 4
    head_stacks, head_leaves, head_prog = tree_cases[0]
    # each distinct in-range leaf plane is read once; nothing else moves
    head_planes = {(si, r) for si, r in head_leaves if 0 <= r < head_stacks[si].shape[0]}
    k1 = dict(
        ms=cuda_ms(torch, lambda: ops.tree_eval(head_stacks, head_leaves, head_prog, N_SHARDS, count=True, device=dev), 20),
        plain_ms=cuda_ms(torch, lambda: bitwise.tree_eval_plain(head_stacks, head_leaves, head_prog, N_SHARDS, True, dev), 2),
        bound_ms=bound_ms(len(head_planes) * plane),
        library_ms=None,
    )
    words_ms = cuda_ms(torch, lambda: ops.tree_eval([fm], [(0, 1)], [(L, 0)], N_SHARDS, count=False, device=dev), 20)
    k2 = dict(
        ms=cuda_ms(torch, lambda: ops.row_counts(fm), 10),
        plain_ms=cuda_ms(torch, lambda: topn.row_counts_plain(fm), 1),
        bound_ms=bound_ms(fm.shape[0] * plane),
        library_ms=None,
    )
    k2_filtered_ms = cuda_ms(torch, lambda: ops.row_counts(fm, filt), 10)
    dm, didx, drows = delta_cases[0]
    keep = ((didx[:, 0] >= 0) & (didx[:, 0] < dm.shape[0]) & (didx[:, 1] >= 0) & (didx[:, 1] < dm.shape[1]))
    r_ok, s_ok, rows_ok = didx[keep, 0].long(), didx[keep, 1].long(), drows[keep]
    k3 = dict(
        ms=cuda_ms(torch, lambda: ops.apply_stack_delta(dm, didx, drows), 5),
        plain_ms=cuda_ms(torch, lambda: stack.apply_stack_delta_plain(dm, didx, drows), 2),
        # the stack read once and written once, each kept row and the
        # (row, shard) pairs read once
        bound_ms=bound_ms(2 * dm.numel() * 4 + int(keep.sum()) * W * 4 + didx.numel() * 4),
        library_ms=cuda_ms(torch, lambda: torch.index_put(dm, (r_ok, s_ok), rows_ok), 5),
    )
    log("times:", json.dumps({**times, "tree_eval_words_ms": words_ms, "row_counts_filtered_ms": k2_filtered_ms,
                              "row_counts_filtered_bound_ms": bound_ms((R_PAD + 1) * plane)}))
    kernels = []
    for name, t in (("tree_eval", k1), ("row_counts", k2), ("stack_delta", k3)):
        k = _cuda.KERNELS[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": t["library_ms"],
        })
    for t in kernels:
        log(f"{t['name']}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms at 3.35 TB/s, plain {t['plain_ms']:.4f} ms)")
    print(json.dumps({"kernels": kernels}))
    if not on_card:
        log("rehearsal on the CPU: no card, no result")
        return 0
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
