"""Drive pilosa_tpu_torch's paths on one CUDA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout. In order:

1. build the kernels from ``pilosa_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc process per source, all started together, and count
   the tensor-core instructions in the SASS of K11, K4 and K6 (the
   binary MMAs of ``pairwise.cu`` and of the split-K core that K4's
   grouped mode and K6's gb_counts run; ``cuobjdump``; none fails);
2. the paths, each with every kernel's launch count set to 0 just
   before it and read just after, and printed on a line of its own:
   - the main path: ``API(holder, device="cuda", route_mode="device")``
     over 10,240 shards × 8 rows (10.7 B columns; bench.py's default
     scale and data recipe: 64 distinct random blocks cycled over the
     shards, a 10 GiB int32 stack per field) serves Count/Intersect,
     Union, Difference, Xor, Not, Shift, TopN with and without a filter
     and an Options shard subset through ``API.query``, each answer
     checked against numpy over the same blocks; then a Set into one
     shard and Counts that must move by the write and ride the delta
     scatter on the 10 GiB stacks. K1, K2, K3 and K7 must launch here;
   - the write phase, on a small holder built with ``API.import_roaring``
     and ``API.import_bits``: Set, then Count, which must move and ride
     the delta scatter;
   - the serving phase: the port's HTTP ``Server(config, device)`` on a
     temp data dir and 127.0.0.1:0, after its CUDA probe, with the main
     path's blocks and an int field injected into its holder over the
     same shards; over HTTP/JSON the headline Count, TopN plain and
     filtered, Sum, one tree past each of K1's fixed limits (C4: 17
     BSI conditions, a stack 33 deep, 300 leaves; and a TopN under the
     300 leaves), a Set then the Count (K3's delta), /import-roaring and
     /import-value each followed by a Count or Sum, every answer against
     numpy and the kernels each query launched asserted with the result
     cache off; the C4 trees in K1's count and words modes through the
     server's compiler; the HTTP sync p50s beside ``API.query``'s, 64
     Counts from 8 keep-alive clients, the device busy share of an HTTP
     Count, cache hits timed apart, and the probe's wall time;
   - the taxi path, on a holder shaped after Pilosa's NYC-taxi demo
     (1,024 shards × 2^20 = 1.07 B rides; cab_type, passenger_count and
     an int total_amount of depth 20; 16 synthetic blocks cycled over
     the shards): BSI conditions, Sum, Min, Max and GroupBy (fused, with
     filter= and limit=, and aggregate=Sum) through ``API.query``, each
     answer checked against numpy. K1, K4 (its grouped mode too), K5
     and K6 must launch here;
   - the residency path, on the same holder: two fields over the card's
     own stack budget (70 % of its memory), ``pickup_day`` (one row per
     day over six years, each a run of rides) and ``dropoff_cell`` (a
     4,096-cell grid with Zipf rows), served through tiered residency —
     each query cold, then promoted, then resident, in dense, sparse and
     run container stores — with direct container counts, a Sum with a
     tiered filter, the streamed TopN ids= and GroupBy level (with and
     without aggregate=Sum), a Set that drops a resident row, and one
     Count in the legacy slots mode, each answer checked against numpy.
     K1 (container leaves), K2, K3 (row and hot modes), K4 (its grouped
     mode too), K6 and K8 must launch here;
   - the similarity path: BASELINE config 5 on one card, 4,882,813
     fingerprints of 2048 bits (10.0 Gbit, a 1.25 GB matrix; the
     chemical-similarity demo's recipe), searched through
     ``ops.similarity.tanimoto_search`` for molecule 17 (k = 10 at
     threshold 0, k = 1,000 at threshold 0.3, every row of a 1,000-row
     slice at threshold 0.3), each answer checked against numpy, with the sync p50 of 20
     searches; the demo's 2048 x 2048 all-pairs block in the three modes
     and a 16,384 x 16,384 Tanimoto block, each checked against the plain
     version and 64 rows against numpy. K9, K10 and K11 must launch here;
   - the mesh path (B16): the main and taxi holders again, served by
     ``API(holder, mesh_ctx=MeshContext(make_mesh(devices, words_axis)),
     route_mode="mesh")`` over 8 positions (``cuda:(i % cards)``, all
     on the one card here) in the 8x1 and 4x2 layouts, the one-device
     stacks freed first: the main path's Counts, a blocked readback of
     a whole row, TopN plain, filtered and ids=, a 3-shard Options
     subset (words mode), Shift (one counted fallback to the device
     route), a Set and a Clear riding K3 per block; the taxi path's
     queries with a level-synchronous GroupBy; the mesh Tanimoto and
     cosine search of row 1 against the main holder's rows; the 2048²
     all-pairs block in both modes and the 16,384² Tanimoto block, each
     answer against numpy and the one-device route, with the sync p50
     of Count, TopN, Sum and GroupBy beside the one-device p50. K1-K6
     (K4's grouped mode too), K10, K11 and K12 must launch here;
   on the main, taxi, residency and mesh paths (8x1 and 4x2), a
   fused-filter phase: filtered TopN (plain and ids=), Sum, Min and Max
   under every filter kind (a row, an Intersect, Not, a BSI condition, a
   between, an empty Union(), a row >= R; container leaves on the
   residency path, a Shift on one device), each answer against numpy and
   against the unfused composition (K1 words, then the aggregate's
   filter-plane mode), with the fused launches counted exactly and no
   K1 words launch but a Shift's;
3. each kernel against its plain torch version on the card at its
   path's shapes (all-ones and bit-31 words, rows -1 and >= R, _OOB
   delta entries, an empty Union(); BSI constants 0, negative and
   |c| >= 2^D, lo > hi, a stack with fewer planes than 2 + D, a shard
   with no value; group padding; K4's grouped mode at 2, 16, 17, 32 and
   40 masks and depths 5, 20, 24, 25, 30 and 63, on the edge stack and a
   plane that ends half-way through a 256-bit step, K6 past one pass of
   masks and of ids; shifts by 1, 31, 32, 33 and 32 W - 1;
   K1 at its limits on small planes (a program of 256 leaves, 16
   conditions of depth 63, a stack 32 deep, null leaves, container
   leaves, W of 4 words); K3 deltas with K = 0, duplicates and _OOB
   entries, on the main stack, per block and in row mode into every
   store kind;
   container payloads at a plane's edges, slots -1 and past the store;
   fingerprints with all-ones, bit-31, zero and duplicate rows, a zero
   query, W of 1, 3 and 512 and rows off a 16 B boundary, k of 1, 10,
   1,000, 4,096, 4,097, 50,000, 65,536 and R (K10's tile and radix
   routes) and every k of 1, 8 and 4,096 keys (its small route); K11 at
   W of 1, 7, 8, 9, 33 and 64 with N, M of 1, 63, 65 and 129, on rows
   off a 16 B boundary, and at N = 4,194,368 rows (past the old grid);
   the integer top-k at 1, 8, 4,096, 4,097 and 8,192 counts, of
   2^(62 - b), 2^62 - 1, 2^63 - 1 and -2^63, negative, with ties at the
   k-th;
   the fused filters' kernels under planned trees; the mesh path's
   kernels at its 4x2 blocks, W = 16,384), exact equality, and its time
   beside its bound (bytes over 3.35 TB/s; K11's too: its binary MMA has
   no published rate and runs past the int8 figure), the plain version's,
   and for K10, K11 and the per-block K1 and K3 the device time of the
   same calls replayed from a CUDA graph, without the host's launch rate;
4. print the card (nvidia-smi name and power limit), the launch counts,
   the router's calibration after the main path, the times, the kernel
   JSON line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises, and the script then exits non-zero without the last
line. It needs one CUDA card; without one it exits 1 at once.
"""

import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

N_SHARDS = 10240
R_PAD = 8
G = 64  # distinct random blocks cycled over the shards (bench.py:118-137)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
# the taxi path: Pilosa's NYC-taxi demo (~1.1 B rides) as 1,024 shards of
# 2^20 columns, one ride per column
T_SHARDS = 1024
T_G = 16  # distinct shard blocks cycled over the shards
T_MIN, T_MAX = -100_000, 1_000_000  # total_amount in cents: depth 20
# the residency path's over-budget fields on the taxi holder
R_DAYS = 2190  # pickup_day: one row per day over six years
R_CELLS = 4096  # dropoff_cell: a location grid
ZIPF_S = 2.0  # dropoff_cell's row skew: p(cell k) ∝ (k + 1)^-2
# the similarity path: BASELINE config 5, "Tanimoto/cosine similarity on
# 10B-bit sparse feature matrix", as 2048-bit fingerprints on one card
SIM_ROWS = 4_882_813  # x 2048 bits = 10.0 Gbit, a 1.25 GB matrix
SIM_BLOCK = 16_384  # the all-pairs clustering block: a 1 GiB f32 output
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor rate (NVIDIA data sheet)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# the sources whose SASS must hold binary MMAs: K11, and the split-K core
# in K4's grouped mode and K6's gb_counts
TENSOR_CORE_SOURCES = ("pairwise", "bsi_sum", "groupby")


def tensor_ops(stem: str) -> dict:
    """The tensor-core instructions in the SASS of ``lib<stem>.so``
    (``cuobjdump --dump-sass`` of the built library), by opcode: BMMA,
    IMMA, HMMA or the GMMA family."""
    from pilosa_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", _cuda._lib_path(stem)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    ops = {}
    for m in re.finditer(r"\b(?:[BIH]MMA|[A-Z]*GMMA)(?:\.\w+)*", sass):
        ops[m.group(0)] = ops.get(m.group(0), 0) + 1
    return ops


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


def graph_ms(torch, fn, reps: int):
    """Device ms per call of ``fn`` with ``reps`` calls captured in one
    CUDA graph and the graph replayed: the host's launch rate is not in
    it, as it is in ``cuda_ms`` for a call of a few microseconds. None
    without a card."""
    if not torch.cuda.is_available():
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up builds and loads what fn needs
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def split_ms(ex, index: str, pql: str, reps: int = 10) -> dict:
    """p50 host ms of one query's dispatch (routing, planning and the
    launches, which return before the device finishes) and of its
    settle (the wait for the device and the one readback)."""
    dispatch, settle = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        pend = [r for r in ex.dispatch(index, pql) if hasattr(r, "arrays")]
        t1 = time.perf_counter()
        ex.settle(pend)
        dispatch.append(t1 - t0)
        settle.append(time.perf_counter() - t1)
    return {"dispatch_p50_ms": float(np.median(dispatch)) * 1e3, "settle_p50_ms": float(np.median(settle)) * 1e3}


def device_busy(torch, fn, wrapper: str, kernel: str, reps: int = 10) -> dict:
    """Wall ms per call of ``fn`` over ``reps`` synchronised calls under
    torch.profiler, and the device's busy ms per call: the union of the
    trace's device intervals (kernels and copies). The calls launch the
    kernel ``kernel`` (a substring of its name) through the wrapper
    ``wrapper``, on whatever thread serves them; the wrapper's count
    says how often. A trace holding fewer of the kernel's events than
    that has missed device work, and then no busy share is given (None),
    as where there is no card. ``kernel_ms`` is the kernel's device time
    per call."""
    if not torch.cuda.is_available():
        return {"wall_ms": None, "device_busy_ms": None, "busy_share": None}
    from torch.profiler import ProfilerActivity, profile

    from pilosa_tpu_torch.ops import _cuda

    fn()
    torch.cuda.synchronize()
    counter = _cuda.KERNELS[wrapper]
    before = counter.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counter.launches - before
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    mine = [e for e in device if kernel in e.name]
    out = {
        "wall_ms": wall / reps * 1e3,
        "kernel": kernel,
        "launches": launched,
        "kernel_events": len(mine),
        "kernel_ms": sum(e.time_range.end - e.time_range.start for e in mine) / 1e3 / reps,
        "device_events": len(device),
    }
    if not launched or len(mine) < launched:
        return {**out, "device_busy_ms": None, "busy_share": None}
    busy_ms = busy / 1e3 / reps
    return {**out, "device_busy_ms": busy_ms, "busy_share": busy_ms / out["wall_ms"]}


def max_abs_err(torch, a, b) -> int:
    """max |a - b| over every element, one leading slice at a time."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dim() <= 2:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
    return max(max_abs_err(torch, a[i], b[i]) for i in range(a.shape[0]))


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def ops_ms(n_ops: int) -> float:
    """``n_ops`` operations of an unpacked-bit product at the card's dense
    int8 tensor rate: a yardstick, not K11's bound. K11's binary MMA has
    no published rate and runs past this figure (the inter mode at
    16,384² takes less), so its bound is its bytes."""
    return n_ops / INT8_OPS_PER_S * 1e3


def kernel_entry(k, launches: dict, err: int, t: dict, path: str) -> dict:
    """One kernel's entry of the JSON line: its launches on ``path``, the
    path it is measured for, and its counts on every path beside them; a
    kernel timed at more than one shape or mode has an entry for each,
    its ``shape`` telling them apart."""
    return {
        "name": k.name,
        "route": "cuda",
        "source": k.source,
        "replaces": t.get("replaces", k.replaces),
        "launches": launches[path],
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t.get("bound_by", "bytes"),
        "library_ms": t["library_ms"],
        # the same calls captured in a CUDA graph: device time without the
        # host's launch rate (None where not measured)
        "graph_ms": t.get("graph_ms"),
        "library_graph_ms": t.get("library_graph_ms"),
        "path": path,
        "shape": t.get("shape"),
        "launches_by_path": launches,
    }


def kernel_modes(torch) -> dict:
    """Every kernel's launches by mode; a launch without a mode under ""."""
    from pilosa_tpu_torch.ops import _cuda

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = {}
    for n, k in _cuda.KERNELS.items():
        modes = dict(k.modes)
        rest = k.launches - sum(modes.values())
        if rest:
            modes[""] = rest
        out[n] = modes
    return out


def modes_since(torch, before: dict) -> dict:
    """The launches by kernel and mode made since ``before``
    (``kernel_modes``), without the zeros."""
    out = {}
    for n, modes in kernel_modes(torch).items():
        d = {m: c - before[n].get(m, 0) for m, c in modes.items() if c != before[n].get(m, 0)}
        if d:
            out[n] = d
    return out


class unfused:  # noqa: N801 — used as a context manager
    """The executor's filtered TopN, Sum, Min and Max as two launches, the
    port's form before the filters were fused: K1's words write the [S, W]
    filter, then the aggregate reads it in its tensor-filter mode (on the
    mesh, a placed filter plane, K1 words per block)."""

    def __init__(self, ex):
        self.ex = ex

    def __enter__(self):
        from pilosa_tpu_torch import ops

        ex = self.ex
        ex._filter_tree = ex._filter_device
        ex._filter_plan = lambda idx, call, shards, mode: (
            ex.compiler.mesh_bitmap_device(idx, call.children[0], shards) if call.children else None)
        # K4 takes a filter plane as its one mask, [1, S, W]
        self.bsi_sum = real = ops.bsi_sum
        ops.bsi_sum = lambda stack, depth, masks=None: real(
            stack, depth, masks[None] if masks is not None and getattr(masks, "dim", lambda: 3)() == 2 else masks)
        return ex

    def __exit__(self, *exc):
        from pilosa_tpu_torch import ops

        ops.bsi_sum = self.bsi_sum
        del self.ex._filter_tree, self.ex._filter_plan


def fused_phase(torch, api, index: str, cases: list, label: str, want_modes: dict) -> dict:
    """The fused-filter phase of a path: each (PQL, numpy answer) of
    ``cases`` through ``API.query``, its answer against numpy, then
    against the unfused composition on the same device (K1 words, then
    the aggregate's tensor-filter mode), exactly. The launches the fused
    queries made, by kernel and mode, must be ``want_modes`` on the card:
    the fused modes at their predicted counts and K1's words only for a
    Shift's sub-program. Returns those launches."""
    before = kernel_modes(torch)
    got = {}
    for pql, want in cases:
        got[pql] = api.query(index, pql)["results"][0]
        if got[pql] != want:
            raise AssertionError(f"{label}: {pql}: {json.dumps(got[pql])[:300]} != numpy {json.dumps(want)[:300]}")
    made = modes_since(torch, before)
    log(f"launches of the {len(cases)} fused {label} queries:", json.dumps(made))
    if torch.cuda.is_available() and made != want_modes:
        raise AssertionError(f"{label}: the fused queries launched {made}, not {want_modes}")
    with unfused(api.executor):
        for pql, _want in cases:
            two = api.query(index, pql)["results"][0]
            if two != got[pql]:
                raise AssertionError(f"{label}: {pql}: fused {json.dumps(got[pql])[:300]} != unfused {json.dumps(two)[:300]}")
    log(f"ok  fused {label}: {len(cases)} filtered TopN, Sum, Min and Max equal to numpy and to the unfused composition")
    return made


def fused_modes(blocks: int, topn: int, ids: int, sums: int = 0, mins: int = 0, maxs: int = 0,
                shift: int = 0) -> dict:
    """The launches a fused phase must make: per block, one fused launch
    per query (rows+tree, ids+tree, one+tree, min+tree, max+tree), and a
    Shift filter's sub-program, K1 words then K7."""
    want = {}
    for kernel, mode, n in (("row_counts_tree", "rows+tree", topn), ("row_counts_tree", "ids+tree", ids),
                            ("bsi_sum_tree", "one+tree", sums), ("bsi_minmax_tree", "min+tree", mins),
                            ("bsi_minmax_tree", "max+tree", maxs)):
        if n:
            want.setdefault(kernel, {})[mode] = n * blocks
    if shift:
        want["tree_eval"] = {"words": shift}
        want["shift_words"] = {"": shift}
    return want


def fused_check(torch, errs: dict, name: str, got, want) -> None:
    """Fold max |fused kernel - its plain version| of one case into
    ``errs[name]``; tuples compare element by element."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    errs[name] = max([errs.get(name, 0)] + [max_abs_err(torch, a, b) for a, b in zip(got, want)])


def fused_plan_bytes(pf, plane_bytes: int, counted=()) -> int:
    """The bytes a planned filter reads once beyond the tensors in
    ``counted`` (the aggregate's own rows or planes, which its bound
    counts already): each distinct in-range dense leaf plane, each
    condition's planes (2 + D, at most the stack's height), and each
    container leaf's payload."""
    from pilosa_tpu_torch.ops import bitwise

    seen, total = set(), 0
    for op, arg in pf.ops:
        if op in (bitwise.OP_LOAD, bitwise.OP_LOAD_SPARSE, bitwise.OP_LOAD_RUN):
            si, row = pf.leaves[arg]
            m = pf.arrays[si]
            if any(m is c for c in counted):
                continue
            if 0 <= row < m.shape[0] and (si, row) not in seen:
                seen.add((si, row))
                total += m[0].numel() * 4
        elif op == bitwise.OP_CMP:
            si, depth, _op, _c = pf.conds[arg]
            if ("cmp", si) not in seen and not any(pf.arrays[si] is c for c in counted):
                seen.add(("cmp", si))
                total += min(2 + depth, pf.arrays[si].shape[0]) * plane_bytes
    return total


def tree_limit_cases(torch, dev) -> list:
    """K1 at its limits on small planes: a program of 256 leaves, 16
    conditions of depth 63, a stack 32 deep, null leaves (rows -1, R and
    _OOB), a condition over a stack with fewer planes than 2 + D and a
    constant past 2^D, container leaves at a plane's edges, and planes
    of W = 4 words. → [(stacks, leaves, program, conds, S, W)]."""
    from pilosa_tpu_torch.executor.residency import RUN_MAX_INTERVALS, SPARSE_MAX_IDS
    from pilosa_tpu_torch.ops import bitwise, bsi
    from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD as W  # noqa: N811

    L, Z, C = bitwise.OP_LOAD, bitwise.OP_ZERO, bitwise.OP_CMP  # noqa: N806
    LS, LR = bitwise.OP_LOAD_SPARSE, bitwise.OP_LOAD_RUN  # noqa: N806
    A, O, X, N = bitwise.OP_AND, bitwise.OP_OR, bitwise.OP_XOR, bitwise.OP_ANDNOT  # noqa: N806
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def words(*shape):
        return torch.randint(-(2**31), 2**31 - 1, shape, generator=gen, dtype=torch.int32, device=dev)

    values = [0, 1, -1, 5, -(2**62), 2**62 + 3, 2**63 - 1, -77]
    conds = [(1, 63, bsi.CMP_OPS[i % 6], values[i % len(values)]) for i in range(bitwise.TREE_MAX_CONDS)]
    cond_prog = [(C, 0)] + [op for i in range(1, len(conds)) for op in ((C, i), (O if i % 3 else A, 0))]
    wide = [(0, 1 + i % 7) for i in range(bitwise.TREE_MAX_LEAVES)]
    wide_prog = [(L, 0)] + [op for i in range(1, len(wide)) for op in ((L, i), (O if i % 5 else X, 0))]
    deep = [(0, i % 8) for i in range(bitwise.TREE_MAX_STACK)]
    deep_prog = [(L, i) for i in range(len(deep))] + [(A if i % 3 else O, 0) for i in range(len(deep) - 1)]
    cases = []
    for s, w in ((5, W), (3, 4)):
        m = words(8, s, w)
        m[0].fill_(-1)  # all-ones words
        m[1].fill_(-(2**31))  # only bit 31
        bs = words(65, s, w)
        cases += [
            ([m], wide, wide_prog, [], s, w),
            ([m, bs], [], cond_prog, conds, s, w),
            ([m], deep, deep_prog, [], s, w),
            ([m], [(0, -1), (0, R_PAD), (0, 2**30), (0, 3)],
             [(L, 0), (L, 3), (O, 0), (L, 1), (N, 0), (L, 2), (X, 0), (Z, 0), (O, 0)], [], s, w),
            ([m, bs[:10].contiguous()], [(0, 2)], [(C, 0), (C, 1), (A, 0), (L, 0), (O, 0)],
             [(1, 20, ">", 5000), (1, 20, "<", 2**40)], s, w),
        ]
    # container leaves: ids and runs at the plane's first and last bits
    s = 3
    bits = s * W * 32
    sp = torch.full((3, SPARSE_MAX_IDS), -1, dtype=torch.int32, device=dev)
    ids = torch.randint(0, bits, (SPARSE_MAX_IDS - 8,), generator=gen, device=dev).unique().to(torch.int32)
    sp[1, : ids.numel()] = ids
    sp[2, :5] = torch.tensor([0, 31, 32, 127, bits - 1], dtype=torch.int32, device=dev)
    rn = torch.zeros((3, RUN_MAX_INTERVALS, 2), dtype=torch.int32, device=dev)
    starts = torch.arange(100, dtype=torch.int32, device=dev) * (bits // 101) + 7
    rn[1, :100] = torch.stack([starts, starts + 700], 1)
    rn[2, :2] = torch.tensor([[3, 5], [bits - 65, bits]], dtype=torch.int32, device=dev)
    m = words(4, s, W)
    cases += [
        ([m, sp, rn], [(0, 1), (1, 1), (2, 1)], [(L, 0), (LS, 1), (O, 0), (LR, 2), (O, 0)], [], s, W),
        ([m, sp, rn], [(1, 2), (2, 2), (1, -1), (0, 2)], [(LS, 0), (LR, 1), (X, 0), (LS, 2), (O, 0), (L, 3), (A, 0)], [], s, W),
    ]
    return cases


def np_shift(words: np.ndarray, n: int) -> np.ndarray:
    """PQL Shift of uint32[..., W] words by numpy, one shard per last
    axis: bit p moves to p + n and bits past the end drop."""
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    out = np.zeros_like(bits)
    if n < bits.shape[-1]:
        out[..., n:] = bits[..., : bits.shape[-1] - n]
    return np.packbits(out, axis=-1, bitorder="little").view(np.uint32)


def digest(segments: dict, shards: list) -> str:
    """A hash of a row's per-shard words, in shard order."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for s in shards:
        h.update(np.ascontiguousarray(segments[s]).data)
    return h.hexdigest()


def pack(bits: np.ndarray) -> np.ndarray:
    """bool[..., n] → uint32[..., n / 32], column c at bit c % 32 of word
    c // 32 (the fragments' packed layout)."""
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)


def taxi_blocks(rng, width: int) -> list[dict]:
    """T_G blocks of ``width`` rides each: cab_type (3 rows), passenger
    count (0-9, mostly 1) and total_amount in cents (mostly 500-6,000,
    8 % up to 100,000, 0.1 % refunds down to -100,000, 0.5 % without a
    fare). Block 3 holds the field's max (1,000,000), block 5 its min
    (-100,000); every block holds 2,000, 5,000, 10,000 and 0."""
    blocks = []
    for g in range(T_G):
        cab = rng.choice(3, width, p=[0.62, 0.30, 0.08])
        pc = rng.choice(10, width, p=[0.02, 0.62, 0.14, 0.05, 0.04, 0.05, 0.04, 0.02, 0.01, 0.01])
        amt = rng.integers(500, 6001, width)
        tail = rng.random(width) < 0.08
        amt[tail] = rng.integers(6001, 100_001, int(tail.sum()))
        refund = rng.random(width) < 0.001
        amt[refund] = -rng.integers(1, 100_001, int(refund.sum()))
        has = rng.random(width) >= 0.005
        amt[:6] = [T_MAX if g == 3 else T_MAX - 1, T_MIN if g == 5 else T_MIN + 1, 2000, 5000, 10_000, 0]
        has[:6] = True
        blocks.append({"cab": cab, "pc": pc, "amt": amt.astype(np.int64), "has": has})
    return blocks


def np_shift_bits(sel: np.ndarray, n: int) -> np.ndarray:
    """PQL Shift of one shard's bool column mask by ``n``."""
    out = np.zeros_like(sel)
    out[n:] = sel[: sel.size - n]
    return out


def taxi_filters(one_device: bool = True) -> list:
    """The taxi holder's filter kinds: (PQL, numpy column mask of a block
    under it, ``sel(block)``): a row, an Intersect of two, Not (every
    column is a ride), a BSI condition, a between, an empty Union(), a
    row past the field's rows, and on one device a Shift."""
    none = lambda b: np.zeros(b["cab"].size, dtype=bool)  # noqa: E731
    out = [
        ("Row(cab_type=1)", lambda b: b["cab"] == 1),
        ("Intersect(Row(cab_type=0), Row(passenger_count=1))", lambda b: (b["cab"] == 0) & (b["pc"] == 1)),
        ("Not(Row(cab_type=2))", lambda b: b["cab"] != 2),
        ("Row(total_amount > 5000)", lambda b: (b["amt"] > 5000) & b["has"]),
        ("Row(-500 <= total_amount <= 2000)", lambda b: (b["amt"] >= -500) & (b["amt"] <= 2000) & b["has"]),
        ("Union()", none),
        ("Row(cab_type=9)", none),
    ]
    if one_device:
        out.append(("Shift(Row(cab_type=1), n=1)", lambda b: np_shift_bits(b["cab"] == 1, 1)))
    return out


def taxi_fused_cases(blocks: list, mult: np.ndarray) -> list:
    """(PQL, numpy answer) of the filtered TopN (plain and ids=, an id
    past the rows), Sum, Min and Max under every taxi filter kind."""

    def tot(fn) -> int:
        return sum(int(mult[g]) * int(fn(b)) for g, b in enumerate(blocks) if mult[g])

    cases = []
    for filt, sel in taxi_filters():
        masks = [sel(b) if mult[g] else None for g, b in enumerate(blocks)]
        count = lambda fn: sum(int(mult[g]) * int(fn(b, masks[g])) for g, b in enumerate(blocks) if mult[g])  # noqa: E731
        pc = {r: count(lambda b, m, r=r: ((b["pc"] == r) & m).sum()) for r in range(10)}
        for pql, n, ids in ((f"TopN(passenger_count, {filt}, n=3)", 3, None),
                            (f"TopN(passenger_count, {filt}, ids=[1, 0, 5, 99])", None, [1, 0, 5, 99])):
            pairs = sorted(((r, pc.get(r, 0)) for r in (ids if ids is not None else range(10)) if pc.get(r, 0)),
                           key=lambda rc: (-rc[1], rc[0]))
            cases.append((pql, [{"id": r, "count": c} for r, c in (pairs[:n] if n else pairs)]))
        cases.append((f"Sum({filt}, field=total_amount)", {
            "value": count(lambda b, m: b["amt"][m & b["has"]].sum()), "count": count(lambda b, m: (m & b["has"]).sum())}))
        for name, want_max in (("Min", False), ("Max", True)):
            vals = [b["amt"][masks[g] & b["has"]] for g, b in enumerate(blocks) if mult[g]]
            vals = [v for v in vals if v.size]
            if not vals:
                want = {"value": 0, "count": 0}
            else:
                best = (max if want_max else min)(int(v.max() if want_max else v.min()) for v in vals)
                want = {"value": best, "count": count(lambda b, m, x=best: ((b["amt"] == x) & m & b["has"]).sum())}
            cases.append((f"{name}({filt}, field=total_amount)", want))
    return cases


def taxi_path(torch, device: str, n_shards: int) -> list:
    """The NYC-taxi aggregates on their own holder: BSI conditions, Sum,
    Min, Max and GroupBy through ``API.query``, each answer held against
    numpy over the blocks; then K1's CMP, K4, K5 and K6 against their
    plain versions at this path's shapes. Returns the kernel entries of
    K4-K6 as {name: (max |kernel - plain|, times)}, the path's launch
    counts, and the holder with its API for the residency path."""
    from pilosa_tpu_torch import ops
    from pilosa_tpu_torch.core import VIEW_BSI, FieldOptions, Holder
    from pilosa_tpu_torch.executor.executor import _Pending
    from pilosa_tpu_torch.ops import _cuda, bitwise, bsi, groupby, topn
    from pilosa_tpu_torch.server import API
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

    on_card = device == "cuda"
    W = WORDS_PER_SHARD

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ------------------------------------------------------------ data
    t0 = time.perf_counter()
    blocks = taxi_blocks(np.random.default_rng(13), SHARD_WIDTH)
    depth = max(abs(T_MIN).bit_length(), abs(T_MAX).bit_length())  # 20
    mats = []
    for b in blocks:
        cab = np.zeros((8, W), np.uint32)
        cab[:3] = pack(b["cab"][None, :] == np.arange(3)[:, None])
        pc = np.zeros((16, W), np.uint32)
        pc[:10] = pack(b["pc"][None, :] == np.arange(10)[:, None])
        ex = np.zeros((8, W), np.uint32)
        ex[0] = 0xFFFFFFFF  # every column is a ride
        bits = np.empty((2 + depth, SHARD_WIDTH), dtype=bool)
        bits[0] = b["has"]
        bits[1] = b["has"] & (b["amt"] < 0)
        mag = np.abs(b["amt"])
        for k in range(depth):
            bits[2 + k] = b["has"] & (((mag >> k) & 1) == 1)
        # a fragment pads its 22 BSI rows to 32, as host_matrix does
        bs = np.zeros((32, W), np.uint32)
        bs[: 2 + depth] = pack(bits)
        mats.append({"cab": cab, "pc": pc, "ex": ex, "bsi": bs})
    h = Holder(None)
    idx = h.create_index("taxi")
    cab_f = idx.create_field("cab_type")
    pc_f = idx.create_field("passenger_count")
    amt_f = idx.create_field("total_amount", FieldOptions(field_type="int", min=T_MIN, max=T_MAX))
    if amt_f.bit_depth != depth:
        raise AssertionError(f"total_amount depth {amt_f.bit_depth} != {depth}")
    views = [
        (cab_f.create_view_if_not_exists("standard"), "cab", True),
        (pc_f.create_view_if_not_exists("standard"), "pc", True),
        (amt_f.create_view_if_not_exists(VIEW_BSI), "bsi", False),
        (idx.existence_field().create_view_if_not_exists("standard"), "ex", False),
    ]
    for s in range(n_shards):
        for view, key, real in views:
            frag = view.create_fragment_if_not_exists(s)
            m = mats[s % T_G][key]
            if real and s == n_shards - 1:
                # Rows() reads row ids from roaring storage: the last
                # shard holds its set rows as true bits
                r, c = np.nonzero(np.unpackbits(m.view(np.uint8), axis=1, bitorder="little"))
                frag.union_positions(r.astype(np.uint64) * SHARD_WIDTH + c.astype(np.uint64))
                continue
            frag._np_matrix = m
            frag._all_dirty = False
    shards = list(range(n_shards))
    times = {"taxi_data_s": time.perf_counter() - t0}

    # numpy answers over the blocks, each block counted once per shard
    mult = np.bincount(np.arange(n_shards) % T_G, minlength=T_G)

    def tot(fn) -> int:
        return sum(int(mult[g]) * int(fn(b)) for g, b in enumerate(blocks) if mult[g])

    def extreme(sel, want_max: bool) -> dict:
        vals = [b["amt"][sel(b) & b["has"]] for g, b in enumerate(blocks) if mult[g]]
        best = (max if want_max else min)(int(v.max() if want_max else v.min()) for v in vals if v.size)
        return {"value": best, "count": tot(lambda b: ((b["amt"] == best) & sel(b) & b["has"]).sum())}

    def group_by(sel=None, limit=None) -> list:
        counts = np.zeros(30, dtype=np.int64)
        for g, b in enumerate(blocks):
            key = b["cab"] * 10 + b["pc"]
            counts += int(mult[g]) * np.bincount(key if sel is None else key[sel(b)], minlength=30)
        out = [
            {"group": [{"field": "cab_type", "rowID": c // 10}, {"field": "passenger_count", "rowID": c % 10}],
             "count": int(counts[c])}
            for c in np.flatnonzero(counts).tolist()
        ]
        return out[:limit] if limit else out

    has = lambda b: b["has"]  # noqa: E731
    gb_agg = [
        {"group": [{"field": "passenger_count", "rowID": p}],
         "count": tot(lambda b, p=p: (b["pc"] == p).sum()),
         "sum": tot(lambda b, p=p: b["amt"][(b["pc"] == p) & b["has"]].sum())}
        for p in range(10)
    ]
    gb_q = "GroupBy(Rows(cab_type), Rows(passenger_count))"
    agg_q = "GroupBy(Rows(passenger_count), aggregate=Sum(field=total_amount))"
    checks = [
        ("Sum(field=total_amount)", {"value": tot(lambda b: b["amt"][b["has"]].sum()), "count": tot(lambda b: b["has"].sum())}),
        ("Sum(Row(cab_type=1), field=total_amount)", {
            "value": tot(lambda b: b["amt"][(b["cab"] == 1) & b["has"]].sum()),
            "count": tot(lambda b: ((b["cab"] == 1) & b["has"]).sum())}),
        ("Min(field=total_amount)", extreme(has, False)),
        ("Max(Row(passenger_count=2), field=total_amount)", extreme(lambda b: b["pc"] == 2, True)),
        ("Count(Row(total_amount > 5000))", tot(lambda b: ((b["amt"] > 5000) & b["has"]).sum())),
        ("Count(Row(total_amount < 0))", tot(lambda b: ((b["amt"] < 0) & b["has"]).sum())),
        ("Count(Intersect(Row(cab_type=0), Row(-500 <= total_amount <= 2000)))",
         tot(lambda b: ((b["cab"] == 0) & (b["amt"] >= -500) & (b["amt"] <= 2000) & b["has"]).sum())),
        ("Count(Row(total_amount != null))", tot(lambda b: b["has"].sum())),
        ("Count(Row(total_amount == 2000000))", 0),
        (gb_q, group_by()),
        (gb_q[:-1] + ", filter=Row(total_amount > 10000))", group_by(lambda b: (b["amt"] > 10_000) & b["has"])),
        (gb_q[:-1] + ", limit=5)", group_by(limit=5)),
        (agg_q, gb_agg),
    ]
    times["taxi_expect_s"] = time.perf_counter() - t0 - times["taxi_data_s"]

    # ------------------------------------------------------- taxi path
    for k in _cuda.KERNELS.values():
        k.reset()
    api = API(h, device=device, route_mode="device")
    comp = api.executor.compiler
    t0 = time.perf_counter()
    bm = comp.stacks.matrix(idx, amt_f, VIEW_BSI, shards)[0]
    cabm = comp.stacks.matrix(idx, cab_f, "standard", shards)[0]
    pcm = comp.stacks.matrix(idx, pc_f, "standard", shards)[0]
    comp.stacks.matrix(idx, idx.existence_field(), "standard", shards)
    sync()
    times["taxi_stack_upload_s"] = time.perf_counter() - t0
    answers = {}
    for pql, want in checks:
        got = api.query("taxi", pql)["results"][0]
        if got != want:
            raise AssertionError(f"{pql}: {json.dumps(got)[:300]} != numpy {json.dumps(want)[:300]}")
        answers[pql] = got
        log(f"ok  {pql[:70]}  -> {json.dumps(got)[:80]}")
    # the fused GroupBy is one deferred [G, K] readback
    fused = api.executor.dispatch("taxi", gb_q)
    if not isinstance(fused[0], _Pending) or list(fused[0].arrays[0].shape) != [4, 16]:
        raise AssertionError(f"{gb_q} did not take the fused path: {fused}")
    api.executor.settle(fused)
    if fused[0].value != checks[9][1]:
        raise AssertionError(f"{gb_q} deferred: {fused[0].value} != numpy")
    for key, pql in (
        ("sum", "Sum(field=total_amount)"),
        ("min", "Min(field=total_amount)"),
        ("count_condition", "Count(Row(total_amount > 5000))"),
        ("groupby_fused", gb_q),
        ("groupby_sum", agg_q),
    ):
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            api.query("taxi", pql)
            lat.append(time.perf_counter() - t0)
        times[f"taxi_{key}_p50_ms"] = float(np.median(lat)) * 1e3
    # the fused filters: each filter evaluated inside K2, K4 or K5
    n_f = len(taxi_filters())
    fused_cases = taxi_fused_cases(blocks, mult)
    times["fused_launches"] = fused_phase(
        torch, api, "taxi", fused_cases, "taxi",
        fused_modes(1, topn=n_f, ids=n_f, sums=n_f, mins=n_f, maxs=n_f, shift=5))
    sync()
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    log("launches on the taxi path:", json.dumps(launches))
    log("launches on the taxi path by mode:", json.dumps({n: k.modes for n, k in _cuda.KERNELS.items() if k.modes}))
    path_kernels = ("tree_eval", "bsi_sum", "bsi_minmax", "gb_counts", "gb_masks")
    if on_card and (any(launches[n] <= 0 for n in path_kernels) or _cuda.BSI_SUM.modes.get("grouped", 0) <= 0):
        raise AssertionError(f"a kernel of the taxi path never launched: {launches}")

    # ------------------------------------------- kernels vs plain versions
    dev = api.executor.device
    D = depth  # noqa: N806
    # an edge BSI stack of 12 planes (the other 10 of 2 + D read zero):
    # all-ones and bit-31 words, shard 0 without any value
    edge = torch.full((12, n_shards, W), -1, dtype=torch.int32, device=dev)
    edge[0, 0].zero_()
    edge[1].fill_(-(2**31))
    for p in range(3, 12, 3):
        edge[p].fill_(-(2**31))
    edge[7] = torch.randint(-(2**31), 2**31 - 1, (n_shards, W), dtype=torch.int32, device=dev)
    errs = {"tree_eval": 0, "bsi_sum": 0, "bsi_minmax": 0, "gb_counts": 0, "gb_masks": 0,
            "row_counts_tree": 0, "bsi_sum_tree": 0, "bsi_minmax_tree": 0}
    C, L, A = bitwise.OP_CMP, bitwise.OP_LOAD, bitwise.OP_AND
    top = (1 << D) - 1
    cmp_cases = []
    for st in (bm, edge):
        for op, c in ((">", 5000), ("<", 0), ("==", 0), (">=", -500), ("<=", 2000), ("!=", 2000),
                      ("==", 2_000_000), ("<", -2_000_000), (">", top), ("<=", -top), ("==", -99_999)):
            cmp_cases.append(([st], [], [(C, 0)], [(0, D, op, c)]))
        # between with lo > hi selects nothing
        cmp_cases.append(([st], [], [(C, 0), (C, 1), (A, 0)], [(0, D, ">=", 2000), (0, D, "<=", -500)]))
    cmp_cases.append(([cabm, bm], [(0, 0)], [(L, 0), (C, 0), (A, 0)], [(1, D, ">=", -500)]))
    for stacks_, leaves, prog, conds in cmp_cases:
        for count in (True, False):
            got = ops.tree_eval(stacks_, leaves, prog, n_shards, count=count, device=dev, conds=conds)
            want = bitwise.tree_eval_plain(stacks_, leaves, prog, n_shards, count, dev, conds)
            errs["tree_eval"] = max(errs["tree_eval"], max_abs_err(torch, got, want))
            del got, want
    ones = comp.ones(n_shards)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    rows16 = i32(list(range(10)) + [-1] * 6)
    rows_c = i32([0, 1, 2, -1])
    # the aggregate GroupBy's 16 group masks (6 of them padding) and the
    # fused GroupBy's 4 level-0 masks (1 padding)
    masks16 = ops.gb_masks(ones[None], pcm, i32([0] * 16), rows16)
    masks4 = ops.gb_masks(ones[None], cabm, i32([0] * 4), rows_c)
    # the grouped mode's tensor-core product at the edges of its passes:
    # 2, 16, 17 (a third mask octet), 32 and 40 masks (a second pass of
    # masks), depths 5, 20, 24, 25 (a second pass of columns), 30 and 63,
    # the edge stack, and a tail shape (3 shards of 36 words: the plane
    # ends half-way through a 256-bit step); the one-mask kernel at depth
    # 40 takes its second plane pass
    masks40 = torch.cat([masks16, masks4, masks16, masks4])
    masks2, masks17, masks32 = masks4[:2], masks40[:17], masks40[:32]
    tail = torch.randint(-(2**31), 2**31 - 1, (22, 3, 36), dtype=torch.int32, device=dev)
    tail_masks = torch.randint(-(2**31), 2**31 - 1, (17, 3, 36), dtype=torch.int32, device=dev)
    for st, d, m in ((bm, D, None), (bm, D, masks16), (bm, 5, None), (edge, D, None), (edge, D, masks4),
                     (bm, 30, masks4), (bm, 40, None), (bm, D, masks2), (bm, 24, masks17), (bm, 25, masks32),
                     (bm, 30, masks40), (bm, 5, masks17), (edge, 63, masks16), (edge, D, masks2),
                     (tail, D, tail_masks), (tail, 63, tail_masks[:2])):
        got = ops.bsi_sum(st, d, m)
        want = bsi.bsi_sum_plain(st, d, m)
        errs["bsi_sum"] = max([errs["bsi_sum"]] + [max_abs_err(torch, a, b) for a, b in zip(got, want)])
    filt = ops.tree_eval([cabm], [(0, 1)], [(L, 0)], n_shards, count=False, device=dev)
    filt0 = filt.clone()
    filt0[0].zero_()  # a shard with nothing under the filter
    for st, f, want_max in ((bm, None, False), (bm, None, True), (bm, filt, True), (bm, filt0, False),
                            (edge, None, True), (edge, None, False), (edge, filt, True)):
        got = ops.bsi_min_max(st, D, f, want_max)
        want = bsi.bsi_min_max_plain(st, D, f, want_max)
        errs["bsi_minmax"] = max([errs["bsi_minmax"]] + [max_abs_err(torch, a, b) for a, b in zip(got, want)])
    edge2 = edge[:2].contiguous()
    # and past one pass each way: 40 masks against 67 ids (16 rows four
    # times, -1, R and 2^30), and the tail shape
    for m, mat, rows in ((masks4, pcm, rows16), (masks4, pcm, i32([9, -1, 16, 2**30, 0, 3])),
                         (masks16, cabm, rows_c), (edge2, pcm, rows16),
                         (masks40, pcm, i32(list(range(16)) * 4 + [-1, 16, 2**30])),
                         (tail_masks, tail, i32([0, 21, -1, 22, 5]))):
        got = ops.gb_counts(m, mat, rows)
        want = groupby.gb_counts_plain(m, mat, rows)
        errs["gb_counts"] = max(errs["gb_counts"], max_abs_err(torch, got, want))
    for m, mat, g_idx, row_sel in ((ones[None], cabm, i32([0] * 4), rows_c),
                                   (masks4, pcm, i32([0, 1, 2, 3, 0, 1, 7]), i32([1, -1, 9, 2, 16, 0, 3])),
                                   (edge2, pcm, i32([1, 0]), i32([2, -1]))):
        got = ops.gb_masks(m, mat, g_idx, row_sel)
        want = groupby.gb_masks_plain(m, mat, g_idx, row_sel)
        errs["gb_masks"] = max(errs["gb_masks"], max_abs_err(torch, got, want))
        del got, want
    # the fused filters of K2, K4 and K5: a row and a condition, all-ones
    # (edge plane 2) and bit-31 (plane 3) words, an empty Union(), over
    # the taxi stacks and the edge stack, each against the filter's plain
    # words then the aggregate's plain version
    PF = ops.PlannedFilter  # noqa: N806
    plane2 = (n_shards, W)
    pf_cab = PF([cabm], [(0, 1)], [(L, 0)], [], *plane2)
    pf_cond = PF([cabm, bm], [(0, 0)], [(L, 0), (C, 0), (A, 0)], [(1, D, ">=", -500)], *plane2)
    pf_edge = PF([edge, cabm], [(0, 2), (0, 3), (1, 1)], [(L, 0), (L, 1), (bitwise.OP_XOR, 0), (L, 2), (bitwise.OP_OR, 0)],
                 [], *plane2)
    pf_none = PF([], [], [(bitwise.OP_ZERO, 0)], [], *plane2)
    ids_t = i32([1, -1, 0, 15, 16, 2**30, 9])
    for m, pf, ii in ((pcm, pf_cab, None), (pcm, pf_cond, ids_t), (cabm, pf_edge, None), (pcm, pf_none, ids_t)):
        fused_check(torch, errs, "row_counts_tree", ops.row_counts(m, pf, ii), topn.row_counts_plain(m, pf.plain(dev, plane2), ii))
    for st, pf in ((bm, pf_cab), (bm, pf_cond), (edge, pf_edge), (edge, pf_cab), (bm, pf_none)):
        fused_check(torch, errs, "bsi_sum_tree", ops.bsi_sum(st, D, pf), bsi.bsi_sum_plain(st, D, pf.plain(dev, plane2)[None]))
        for want_max in (False, True):
            fused_check(torch, errs, "bsi_minmax_tree", ops.bsi_min_max(st, D, pf, want_max),
                        bsi.bsi_min_max_plain(st, D, pf.plain(dev, plane2), want_max))
    log("max |kernel - plain| on the taxi path's shapes:", json.dumps(errs))
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: {errs}")
    del edge, edge2, filt0, masks40, masks2, masks17, tail, tail_masks, pf_edge
    if on_card:
        torch.cuda.empty_cache()

    # --------------------------------------------------------- timings
    plane = n_shards * W * 4
    gt5000 = [(0, D, ">", 5000)]
    zeros16 = i32([0] * 16)
    k1c = dict(
        ms=cuda_ms(torch, lambda: ops.tree_eval([bm], [], [(C, 0)], n_shards, True, device=dev, conds=gt5000), 20),
        plain_ms=cuda_ms(torch, lambda: bitwise.tree_eval_plain([bm], [], [(C, 0)], n_shards, True, dev, gt5000), 2),
        bound_ms=bound_ms((2 + D) * plane),
    )
    k4 = dict(
        ms=cuda_ms(torch, lambda: ops.bsi_sum(bm, D), 20),
        plain_ms=cuda_ms(torch, lambda: bsi.bsi_sum_plain(bm, D), 2),
        bound_ms=bound_ms((2 + D) * plane),
        library_ms=None,
    )
    # the aggregate GroupBy's 16 masks, and 32 (the mask budget's chunk
    # at 1,024 shards): one pass each, every plane and mask read once
    k4g = dict(
        ms=cuda_ms(torch, lambda: ops.bsi_sum(bm, D, masks16), 10),
        plain_ms=cuda_ms(torch, lambda: bsi.bsi_sum_plain(bm, D, masks16), 1),
        bound_ms=bound_ms((2 + D + 16) * plane), library_ms=None,
        shape=f"grouped, 16 masks x [{2 + D}, {n_shards}, {W}], {len(bsi.grouped_passes(16, D))} pass",
        replaces="pilosa_tpu/executor/executor.py:1088",
    )
    k4g32 = dict(
        ms=cuda_ms(torch, lambda: ops.bsi_sum(bm, D, masks32), 10),
        plain_ms=cuda_ms(torch, lambda: bsi.bsi_sum_plain(bm, D, masks32), 1),
        bound_ms=bound_ms((2 + D + 32) * plane), library_ms=None,
        shape=f"grouped, 32 masks x [{2 + D}, {n_shards}, {W}], {len(bsi.grouped_passes(32, D))} pass",
        replaces="pilosa_tpu/executor/executor.py:1088",
    )
    del masks32
    k5 = dict(
        ms=cuda_ms(torch, lambda: ops.bsi_min_max(bm, D, None, False), 20),
        plain_ms=cuda_ms(torch, lambda: bsi.bsi_min_max_plain(bm, D, None, False), 2),
        bound_ms=bound_ms((2 + D) * plane),
        library_ms=None,
    )
    # the fused GroupBy's last level: 4 masks and the 10 rows that exist
    # (padding rows read nothing)
    k6c = dict(
        ms=cuda_ms(torch, lambda: ops.gb_counts(masks4, pcm, rows16), 20),
        plain_ms=cuda_ms(torch, lambda: groupby.gb_counts_plain(masks4, pcm, rows16), 2),
        bound_ms=bound_ms((4 + 10) * plane),
        library_ms=None,
        shape="4 masks x 10 rows (16 ids)",
    )
    # the other way round: the aggregate GroupBy's 16 masks against cab_type's 3 rows
    times["gb_counts_16x3_ms"] = cuda_ms(torch, lambda: ops.gb_counts(masks16, cabm, rows_c), 20)
    times["gb_counts_16x3_bound_ms"] = bound_ms((16 + 3) * plane)
    # the aggregate GroupBy's level: 1 base mask and 10 rows in, 16 masks out
    k6m = dict(
        ms=cuda_ms(torch, lambda: ops.gb_masks(ones[None], pcm, zeros16, rows16), 10),
        plain_ms=cuda_ms(torch, lambda: groupby.gb_masks_plain(ones[None], pcm, zeros16, rows16), 2),
        bound_ms=bound_ms((1 + 10 + 16) * plane),
        library_ms=None,
    )
    # the fused filters at the taxi queries' shapes: under Row(cab_type=1),
    # the bound counts the planes and the filter's one leaf plane
    fused_bytes = fused_plan_bytes(pf_cab, plane)
    k2t = dict(
        replaces="pilosa_tpu/executor/executor.py:1019",
        ms=cuda_ms(torch, lambda: ops.row_counts(pcm, pf_cab), 20),
        plain_ms=cuda_ms(torch, lambda: topn.row_counts_plain(pcm, pf_cab.plain(dev, plane2)), 1),
        bound_ms=bound_ms(pcm.shape[0] * plane + fused_bytes), library_ms=None,
        shape=f"rows+tree, [{pcm.shape[0]}, {n_shards}, {W}] (10 rows set) under Row(cab_type=1)",
    )
    k4t = dict(
        replaces="pilosa_tpu/executor/executor.py:1019",
        ms=cuda_ms(torch, lambda: ops.bsi_sum(bm, D, pf_cab), 20),
        plain_ms=cuda_ms(torch, lambda: bsi.bsi_sum_plain(bm, D, pf_cab.plain(dev, plane2)[None]), 2),
        bound_ms=bound_ms((2 + D) * plane + fused_bytes), library_ms=None,
        shape=f"one+tree, [{2 + D}, {n_shards}, {W}] under Row(cab_type=1)",
    )
    k5t = dict(
        replaces="pilosa_tpu/executor/executor.py:1019",
        ms=cuda_ms(torch, lambda: ops.bsi_min_max(bm, D, pf_cab, True), 20),
        plain_ms=cuda_ms(torch, lambda: bsi.bsi_min_max_plain(bm, D, pf_cab.plain(dev, plane2), True), 2),
        bound_ms=bound_ms((2 + D) * plane + fused_bytes), library_ms=None,
        shape=f"max+tree, [{2 + D}, {n_shards}, {W}] under Row(cab_type=1)",
    )
    cab1 = lambda: ops.tree_eval([cabm], [(0, 1)], [(L, 0)], n_shards, count=False, device=dev)  # noqa: E731
    times.update({
        "row_counts_two_launches_ms (K1 words, then K2 filtered)": cuda_ms(torch, lambda: ops.row_counts(pcm, cab1()), 20),
        "bsi_sum_two_launches_ms (K1 words, then K4 filtered)": cuda_ms(torch, lambda: ops.bsi_sum(bm, D, cab1()[None]), 20),
        "bsi_minmax_two_launches_ms (K1 words, then K5 filtered)": cuda_ms(
            torch, lambda: ops.bsi_min_max(bm, D, cab1(), True), 20),
    })
    times.update({
        "tree_eval_cmp_ms": k1c["ms"], "tree_eval_cmp_plain_ms": k1c["plain_ms"],
        "tree_eval_cmp_bound_ms": k1c["bound_ms"], "tree_eval_taxi_launches": launches["tree_eval"],
    })
    log("taxi times:", json.dumps(times))
    results = {"bsi_sum": k4, "bsi_sum grouped16": k4g, "bsi_sum grouped32": k4g32, "bsi_minmax": k5,
               "gb_counts": k6c, "gb_masks": k6m, "row_counts_tree": k2t, "bsi_sum_tree": k4t, "bsi_minmax_tree": k5t}
    taxi = {
        "holder": h, "index": idx, "api": api, "blocks": blocks, "mult": mult, "checks": checks, "answers": answers,
        "depth": depth, "p50": {"sum": times["taxi_sum_p50_ms"], "groupby": times["taxi_groupby_fused_p50_ms"]},
        "fused": [(pql, want) for pql, want in fused_cases if "Shift" not in pql],
    }
    return {name: (errs[name.split()[0]], t) for name, t in results.items()}, launches, taxi


def bitmap_of_runs(ranges):
    """A roaring bitmap of [start, stop) position ranges, one run
    container per 2^16 key; no two ranges may share a key."""
    from pilosa_tpu_torch.roaring import Bitmap
    from pilosa_tpu_torch.roaring import containers as ct

    bm = Bitmap()
    for a, b in ranges:
        for key in range(a >> 16, ((b - 1) >> 16) + 1):
            lo, hi = max(a, key << 16) - (key << 16), min(b, (key + 1) << 16) - 1 - (key << 16)
            bm._containers[key] = ct.run_container(np.array([[lo, hi]], dtype=np.uint16))
    return bm


def residency_path(torch, device: str, taxi: dict, budget: "int | None" = None) -> tuple:
    """Over-budget fields on the taxi holder, served through tiered
    residency on the card's own budget: ``pickup_day`` (one row per day
    over six years; rides in time order, so each row is one run of
    ~490 k columns) and ``dropoff_cell`` (a location grid of R_CELLS
    cells with Zipf rows: dense head rows, sparse tail rows; its shard
    blocks cycle as the taxi recipe's do). Each query runs cold, then
    promotes, then resident, against numpy; a Set drops a resident row;
    one Count runs in the legacy slots mode. Then K1's container leaves,
    K8 and K3's row mode against their plain versions. Returns the
    kernel entries and the path's launch counts. ``budget`` lowers the
    stack budget for a rehearsal on the CPU; on the card the fields are
    over the card's own budget (70 % of its memory)."""
    from pilosa_tpu_torch import ops
    from pilosa_tpu_torch.executor.compile import StackCache
    from pilosa_tpu_torch.executor.residency import RUN_MAX_INTERVALS, SPARSE_MAX_IDS
    from pilosa_tpu_torch.ops import _cuda, bitwise, bsi, containers, stack, topn
    from pilosa_tpu_torch.pql import parse
    from pilosa_tpu_torch.roaring import Bitmap
    from pilosa_tpu_torch.server import API
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

    on_card = device == "cuda"
    W, SW = WORDS_PER_SHARD, SHARD_WIDTH  # noqa: N806
    h, idx, api, blocks, mult = (taxi[k] for k in ("holder", "index", "api", "blocks", "mult"))
    n_shards = len(idx.available_shards())
    shards = list(range(n_shards))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ------------------------------------------------------------ data
    t0 = time.perf_counter()
    rpd = -(-(n_shards * SW) // R_DAYS)  # rides per day
    day_f = idx.create_field("pickup_day")
    view = day_f.create_view_if_not_exists("standard")
    for s in shards:
        c0, c1 = s * SW, (s + 1) * SW
        ranges = []
        for d in range(c0 // rpd, (c1 - 1) // rpd + 1):
            a, b = max(d * rpd, c0), min((d + 1) * rpd, c1)
            ranges.append((d * SW + a - c0, d * SW + b - c0))
        frag = view.create_fragment_if_not_exists(s)
        frag.bitmap = bitmap_of_runs(ranges)
        frag._mark_all_dirty()
    rng = np.random.default_rng(29)
    p = np.arange(1, R_CELLS + 1, dtype=np.float64) ** -ZIPF_S
    cells = [rng.choice(R_CELLS, SW, p=p / p.sum()) for _ in range(T_G)]
    cell_f = idx.create_field("dropoff_cell")
    cview = cell_f.create_view_if_not_exists("standard")
    shared = []
    for g in range(T_G):
        bm = Bitmap()
        bm.add_many(cells[g].astype(np.uint64) * np.uint64(SW) + np.arange(SW, dtype=np.uint64))
        shared.append(bm)
    for s in shards:
        # read-only blocks, shared by the shards that cycle over them
        frag = cview.create_fragment_if_not_exists(s)
        frag.bitmap = shared[s % T_G]
        frag._mark_all_dirty()
    times = {"residency_data_s": time.perf_counter() - t0}

    # ------------------------------------------------- numpy answers
    per_block = np.stack([np.bincount(c, minlength=R_CELLS) for c in cells])  # [T_G, R_CELLS]
    totals = (mult[:, None] * per_block).sum(axis=0)
    head = 9  # dense: ~1 % of the rides
    tail = int(np.flatnonzero((totals > 0) & (totals <= SPARSE_MAX_IDS))[np.argmax(
        totals[(totals > 0) & (totals <= SPARSE_MAX_IDS)])])  # sparse: the fullest row that fits
    day = R_DAYS // 2

    def day_slices(d: int):
        """(shard, local column slice) of each shard day ``d`` covers."""
        a, b = d * rpd, min((d + 1) * rpd, n_shards * SW)
        for s in range(a // SW, (b - 1) // SW + 1):
            yield s, slice(max(a, s * SW) - s * SW, min(b, (s + 1) * SW) - s * SW)

    def on_day(fn) -> int:
        return sum(int(fn(s, sl)) for s, sl in day_slices(day))

    ht = [(c == head) | (c == tail) for c in cells]
    union_want = int(sum(mult[g] * ht[g].sum() for g in range(T_G))) + on_day(
        lambda s, sl: (~ht[s % T_G][sl]).sum())
    ids = list(range(32, 96))
    topn_want = sorted(((i, int(totals[i])) for i in ids if totals[i]), key=lambda rc: (-rc[1], rc[0]))[:5]
    gb_days = 16
    gb = np.zeros(3 * gb_days, dtype=np.int64)
    day_sum = np.zeros(gb_days, dtype=np.int64)  # the days' total_amount, for the aggregate
    for s in range(-(-(gb_days * rpd) // SW)):
        cols = np.arange(SW, dtype=np.int64)[: max(0, min(SW, gb_days * rpd - s * SW))]
        dd = (s * SW + cols) // rpd
        b = blocks[s % T_G]
        gb += np.bincount(b["cab"][: cols.size] * gb_days + dd, minlength=3 * gb_days)
        has_c = b["has"][: cols.size]
        np.add.at(day_sum, dd[has_c], b["amt"][: cols.size][has_c])
    gb_want = [
        {"group": [{"field": "cab_type", "rowID": k // gb_days}, {"field": "pickup_day", "rowID": k % gb_days}],
         "count": int(gb[k])}
        for k in np.flatnonzero(gb).tolist()
    ]
    # GroupBy's aggregate over the streamed level's 16 masks (K4 grouped)
    day_n = gb.reshape(3, gb_days).sum(axis=0)
    gb_sum_want = [{"group": [{"field": "pickup_day", "rowID": d}], "count": int(day_n[d]), "sum": int(day_sum[d])}
                   for d in range(gb_days) if day_n[d]]
    queries = [  # (name, PQL, numpy's answer)
        ("count_cab_day", f"Count(Intersect(Row(cab_type=1), Row(pickup_day={day})))",
         on_day(lambda s, sl: (blocks[s % T_G]["cab"][sl] == 1).sum())),
        ("count_day", f"Count(Row(pickup_day={day}))", on_day(lambda s, sl: sl.stop - sl.start)),
        ("count_tail", f"Count(Row(dropoff_cell={tail}))", int(totals[tail])),
        ("count_union3", f"Count(Union(Row(dropoff_cell={head}), Row(dropoff_cell={tail}), Row(pickup_day={day})))",
         union_want),
        ("sum_day", f"Sum(Row(pickup_day={day}), field=total_amount)", {
            "value": on_day(lambda s, sl: blocks[s % T_G]["amt"][sl][blocks[s % T_G]["has"][sl]].sum()),
            "count": on_day(lambda s, sl: blocks[s % T_G]["has"][sl].sum())}),
        ("topn_ids", f"TopN(dropoff_cell, n=5, ids=[{', '.join(map(str, ids))}])",
         [{"id": r, "count": c} for r, c in topn_want]),
        ("groupby_day", f"GroupBy(Rows(cab_type), Rows(pickup_day, limit={gb_days}))", gb_want),
        ("groupby_day_sum", f"GroupBy(Rows(pickup_day, limit={gb_days}), aggregate=Sum(field=total_amount))",
         gb_sum_want),
    ]
    # the fused filters over container leaves: the day's run row and the
    # tail's sparse row as the filters of a TopN (plain and ids=), a Min
    # and a Max; with sum_day above, K2, K4 and K5 evaluate them in place
    tail_sel = [c == tail for c in cells]
    cab_day = {r: on_day(lambda s, sl, r=r: (blocks[s % T_G]["cab"][sl] == r).sum()) for r in range(3)}
    cab_tail = {r: sum(int(mult[g]) * int((tail_sel[g] & (blocks[g]["cab"] == r)).sum()) for g in range(T_G))
                for r in range(3)}
    tail_vals = [blocks[g]["amt"][tail_sel[g] & blocks[g]["has"]] for g in range(T_G) if mult[g]]
    tail_min = min(int(v.min()) for v in tail_vals if v.size)
    day_max = max(int(blocks[s % T_G]["amt"][sl][blocks[s % T_G]["has"][sl]].max()) for s, sl in day_slices(day))

    def top_pairs(counts: dict, n=None, want_ids=None) -> list:
        pairs = sorted(((r, counts.get(r, 0)) for r in (want_ids if want_ids is not None else counts)
                        if counts.get(r, 0)), key=lambda rc: (-rc[1], rc[0]))
        return [{"id": r, "count": c} for r, c in (pairs[:n] if n else pairs)]

    fused_q = [
        ("topn_cab_day", f"TopN(cab_type, Row(pickup_day={day}), n=3)", top_pairs(cab_day, 3)),
        ("topn_ids_cab_tail", f"TopN(cab_type, Row(dropoff_cell={tail}), ids=[2, 0, 9])", top_pairs(cab_tail, None, [2, 0, 9])),
        ("min_tail", f"Min(Row(dropoff_cell={tail}), field=total_amount)", {
            "value": tail_min, "count": sum(int(mult[g]) * int((tail_sel[g] & blocks[g]["has"] & (blocks[g]["amt"] == tail_min)).sum())
                                            for g in range(T_G))}),
        ("max_day", f"Max(Row(pickup_day={day}), field=total_amount)", {
            "value": day_max, "count": on_day(lambda s, sl: (blocks[s % T_G]["has"][sl] & (blocks[s % T_G]["amt"][sl] == day_max)).sum())}),
    ]
    queries += fused_q
    times["residency_expect_s"] = time.perf_counter() - t0 - times["residency_data_s"]

    # -------------------------------------------------- residency path
    for k in _cuda.KERNELS.values():
        k.reset()
    stacks_ = api.executor.compiler.stacks
    if budget is not None:
        stacks_._budget = budget
    for f in (day_f, cell_f):
        r_pad = stacks_._projected_rows(f.view("standard"), shards)
        need = n_shards * r_pad * W * 4
        log(f"{f.name}: dense stack of {r_pad} padded rows would need {need / 2**30:.1f} GiB, "
            f"budget {stacks_.STACK_BYTES_BUDGET / 2**30:.1f} GiB")
        if not stacks_.is_over_budget(idx, f, "standard", shards):
            raise AssertionError(f"{f.name} is not over the stack budget")
    # cold, promote, then resident; the streamed TopN and GroupBy have no
    # resident phase of their own, so they run three times
    for key, pql, want in queries:
        streamed = pql.startswith(("TopN", "GroupBy"))
        lat = []
        for _ in range(3 if streamed else 7):
            t1 = time.perf_counter()
            got = api.query("taxi", pql)["results"][0]
            lat.append(time.perf_counter() - t1)
            if got != want:
                raise AssertionError(f"{pql}: {json.dumps(got)[:300]} != numpy {json.dumps(want)[:300]}")
        times[f"{key}_cold_ms"] = lat[0] * 1e3
        times[f"{key}_promote_ms"] = lat[1] * 1e3
        times[f"{key}_resident_p50_ms"] = float(np.median(lat[2:])) * 1e3
        log(f"ok  {pql[:70]}  -> {json.dumps(got)[:80]}  (cold {lat[0] * 1e3:.3f} ms, promote "
            f"{lat[1] * 1e3:.3f} ms, resident p50 {float(np.median(lat[2:])) * 1e3:.3f} ms)")
    # resident now: the filtered queries once more, against the unfused
    # composition, and their launches (one fused launch each, no K1 words)
    times["fused_launches"] = fused_phase(
        torch, api, "taxi", [(pql, want) for _k, pql, want in queries[4:5] + fused_q], "residency",
        fused_modes(1, topn=1, ids=1, sums=1, mins=1, maxs=1))
    snap = stacks_.residency_snapshot()
    kinds = {k for t in snap["tiers"] for k, n in t["rows"].items() if n}
    log("residency after the queries:", json.dumps({k: snap[k] for k in ("rowsPromoted", "rowsDemoted", "coldUploads",
                                                                         "residentRows", "bytesByContainer", "tiers")}))
    if kinds != {"dense", "sparse", "run"} or snap["rowsPromoted"] <= 0 or snap["coldUploads"] <= 0:
        raise AssertionError(f"residency did not hold rows in all three stores: {snap}")
    # a write into the resident run row drops it; the next touches re-promote
    _key, count_q, count_want = queries[1]
    free_col = (day + 1) * rpd + 5
    # the Set marks its column's existence: that shard's existence
    # fragment first gets its rides as true bits and a matrix of its own
    # (its injected block is shared by the shards that cycle over it, and
    # a repack of a dirty row writes into the block in place)
    idx.existence_field().view("standard").fragment(free_col // SW).union_positions(np.arange(SW, dtype=np.uint64))
    api.query("taxi", f"Set({free_col}, pickup_day={day})")
    for _ in range(2):
        got = api.query("taxi", count_q)["results"][0]
        if got != count_want + 1:
            raise AssertionError(f"after Set: {count_q}: {got} != numpy {count_want + 1}")
    after = stacks_.residency_snapshot()
    log(f"ok  after Set({free_col}, pickup_day={day}): {count_q} -> {got}  (rowsDemoted {snap['rowsDemoted']} -> "
        f"{after['rowsDemoted']}, rowsPromoted {snap['rowsPromoted']} -> {after['rowsPromoted']})")
    if after["rowsDemoted"] <= snap["rowsDemoted"] or after["rowsPromoted"] <= snap["rowsPromoted"]:
        raise AssertionError(f"the write did not drop and re-promote the row: {after}")
    if on_card:
        # each promotion scattered into a new store: the generations it
        # replaced must be freed once no plan holds them
        sync()
        alloc, ledger = torch.cuda.memory_allocated(api.executor.device), stacks_.resident_bytes
        log(f"device memory after the promotions: {alloc / 2**30:.3f} GiB allocated, "
            f"{ledger / 2**30:.3f} GiB in the stack budget's ledger")
        if alloc > ledger + (1 << 30):  # the smallest store, the run store, is 2 GiB
            raise AssertionError(f"old store generations stayed live: {alloc} B allocated > {ledger} B + 1 GiB")
    # the kernels' inputs, taken before the executor lets go of them
    entry = stacks_._tiered[("tier", "taxi", "dropoff_cell", "standard", tuple(shards))]
    dense_store, sparse_store = entry.stores["dense"]["dev"], entry.stores["sparse"]["dev"]
    tail_slot = entry.stores["sparse"]["slots"][tail]
    run_entry = stacks_._tiered[("tier", "taxi", "pickup_day", "standard", tuple(shards))]
    run_store, day_slot = run_entry.stores["run"]["dev"], run_entry.stores["run"]["slots"][day]
    union_plan = api.executor.compiler._plan(idx, parse(queries[3][1])[0].children[0], shards)
    cab_m = stacks_.matrix(idx, idx.field("cab_type"), "standard", shards)[0]
    bsi_m = stacks_.dense(idx, idx.field("total_amount"), "bsi", shards)[0]
    depth = idx.field("total_amount").bit_depth
    router = api.executor.router
    log("router decisions on the residency path:", json.dumps(router.decisions))
    if router.decisions["host_unported"] != 0:
        raise AssertionError(f"a residency call ran host-side for want of a port: {router.decisions}")
    taxi.clear()
    del api, stacks_, entry, run_entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # the legacy slots mode: one Count through hot_batch (K3, hot mode)
    slots_q, slots_want = f"Count(Row(dropoff_cell={head}))", int(totals[head])
    StackCache.RESIDENCY_MODE = "slots"
    try:
        slots_api = API(h, device=device, route_mode="device")
        if budget is not None:
            slots_api.executor.compiler.stacks._budget = budget
        got = slots_api.query("taxi", slots_q)["results"][0]
        hot_uploads = slots_api.executor.compiler.stacks.stats_snapshot()["hotRowUploads"]
        del slots_api
    finally:
        StackCache.RESIDENCY_MODE = "tiered"
    if hot_uploads != 1:
        raise AssertionError(f"slots mode did not promote the row into the hot slot stack: {hot_uploads}")
    if got != slots_want:
        raise AssertionError(f"slots mode: {slots_q}: {got} != numpy {slots_want}")
    log(f"ok  slots mode: {slots_q}  -> {got}")
    gc.collect()
    sync()
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    modes = {n: k.modes for n, k in _cuda.KERNELS.items() if k.modes}
    log("launches on the residency path:", json.dumps(launches))
    log("launches on the residency path by mode:", json.dumps(modes))
    if on_card and (
        any(launches[n] <= 0 for n in ("tree_eval", "container_count", "stack_delta", "row_counts", "gb_counts", "bsi_sum"))
        or not any("containers" in m for m in modes["tree_eval"])
        or modes["stack_delta"].get("rows", 0) <= 0 or modes["stack_delta"].get("hot", 0) <= 0
        or modes["bsi_sum"].get("grouped", 0) <= 0
    ):
        raise AssertionError(f"a kernel of the residency path never launched: {modes}")
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------------------- kernels vs plain versions
    dev = dense_store.device
    total_bits = n_shards * W * 32
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    # edge payloads: ids at bit 0, bit 31, a shard's last bit and the
    # plane's last bit; runs across a shard boundary, inside one word,
    # over whole words, to the plane's end
    edge_sparse = torch.full((3, SPARSE_MAX_IDS), -1, dtype=torch.int32, device=dev)
    ids_edge = sorted({0, 31, 32, SW - 1, SW, 5 * SW + 77, total_bits - 1} | set(range(1000, 1000 + 64 * 31, 31)))
    edge_sparse[1, : len(ids_edge)] = i32(ids_edge)
    edge_sparse[2] = torch.arange(SPARSE_MAX_IDS, dtype=torch.int32, device=dev) * 3
    edge_run = torch.zeros((3, RUN_MAX_INTERVALS, 2), dtype=torch.int32, device=dev)
    runs_edge = [(3, 5), (40, 200), (SW - 100, SW + 100), (2 * SW, 2 * SW + 32 * 7), (3 * SW + 1, 3 * SW + 31),
                 (total_bits - 65, total_bits)]
    edge_run[1, : len(runs_edge)] = i32(runs_edge)
    starts = torch.arange(RUN_MAX_INTERVALS, dtype=torch.int32, device=dev) * 999
    edge_run[2] = torch.stack([starts, starts + 500], dim=1)
    L, LS, LR = bitwise.OP_LOAD, bitwise.OP_LOAD_SPARSE, bitwise.OP_LOAD_RUN
    A, O, X = bitwise.OP_AND, bitwise.OP_OR, bitwise.OP_XOR
    errs = {"tree_eval": 0, "container_count": 0, "stack_delta": 0,
            "row_counts_tree": 0, "bsi_sum_tree": 0, "bsi_minmax_tree": 0}
    tree_cases = [
        union_plan[:3],
        ([edge_sparse, edge_run], [(0, 1), (1, 1)], [(LS, 0), (LR, 1), (X, 0)]),
        ([edge_sparse, edge_run], [(0, 2), (1, 2), (0, -1), (1, 3)], [(LS, 0), (LR, 1), (A, 0), (LS, 2), (O, 0), (LR, 3), (O, 0)]),
        ([dense_store, sparse_store, run_store], [(0, 0), (1, tail_slot), (2, day_slot)], [(L, 0), (LS, 1), (O, 0), (LR, 2), (X, 0)]),
    ]
    for stacks_in, leaves, prog in tree_cases:
        for count in (True, False):
            got = ops.tree_eval(stacks_in, leaves, prog, n_shards, count=count, device=dev)
            want = bitwise.tree_eval_plain(stacks_in, leaves, prog, n_shards, count, dev)
            errs["tree_eval"] = max(errs["tree_eval"], max_abs_err(torch, got, want))
            del got, want
    for store, slot in ((sparse_store, tail_slot), (run_store, day_slot), (edge_sparse, 1), (edge_sparse, 2),
                        (edge_run, 1), (edge_run, 2), (edge_sparse, 0), (edge_run, -1)):
        got = ops.container_count(store, slot)
        payload = store[slot] if 0 <= slot < store.shape[0] else None
        want = (torch.zeros((), dtype=torch.int64, device=dev) if payload is None
                else containers.run_count(payload) if store.dim() == 3 else containers.sparse_count(payload))
        errs["container_count"] = max(errs["container_count"], max_abs_err(torch, got.reshape(1), want.reshape(1)))
    oob = stack.OOB
    for store in (edge_sparse, edge_run, dense_store[:8].contiguous(), sparse_store):
        h_ = store.shape[0]
        # the repeated slot: the later entry wins; one slot; K = 0
        for sl in ([1, oob, h_ - 1, -1, 1], [h_ - 1], []):
            sidx = i32(sl)
            rows = torch.randint(-(2**31), 2**31 - 1, (len(sl),) + tuple(store.shape[1:]), dtype=torch.int32, device=dev)
            got = ops.scatter_rows(store, sidx, rows)
            want = stack.scatter_rows_plain(store, sidx, rows)
            errs["stack_delta"] = max(errs["stack_delta"], max_abs_err(torch, got, want))
            del got, want, rows
    # the fused filters over container leaves: the day's run row, the
    # tail's sparse row, the edge payloads, and the Union of all three kinds
    PF = ops.PlannedFilter  # noqa: N806
    plane2 = (n_shards, W)
    pf_run = PF([run_store], [(0, day_slot)], [(LR, 0)], [], *plane2)
    pf_sparse = PF([sparse_store], [(0, tail_slot)], [(LS, 0)], [], *plane2)
    pf_edges = PF([edge_sparse, edge_run], [(0, 1), (1, 1)], [(LS, 0), (LR, 1), (X, 0)], [], *plane2)
    pf_union = PF(*union_plan[:3], [], *plane2)
    ids_r = i32([2, -1, 0, 9, 1])
    for pf in (pf_run, pf_sparse, pf_edges, pf_union):
        for ii in (None, ids_r):
            fused_check(torch, errs, "row_counts_tree", ops.row_counts(cab_m, pf, ii),
                        topn.row_counts_plain(cab_m, pf.plain(dev, plane2), ii))
        fused_check(torch, errs, "bsi_sum_tree", ops.bsi_sum(bsi_m, depth, pf),
                    bsi.bsi_sum_plain(bsi_m, depth, pf.plain(dev, plane2)[None]))
        for want_max in (False, True):
            fused_check(torch, errs, "bsi_minmax_tree", ops.bsi_min_max(bsi_m, depth, pf, want_max),
                        bsi.bsi_min_max_plain(bsi_m, depth, pf.plain(dev, plane2), want_max))
    log("max |kernel - plain| on the residency path's shapes:", json.dumps(errs))
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: {errs}")
    if on_card:
        torch.cuda.empty_cache()

    # --------------------------------------------------------- timings
    u_stacks, u_leaves, u_prog = union_plan[:3]
    k1 = dict(
        replaces="pilosa_tpu/ops/containers.py:35",  # sparse_plane and run_plane (:53) inside the program
        ms=cuda_ms(torch, lambda: ops.tree_eval(u_stacks, u_leaves, u_prog, n_shards, count=True, device=dev), 20),
        plain_ms=cuda_ms(torch, lambda: bitwise.tree_eval_plain(u_stacks, u_leaves, u_prog, n_shards, True, dev), 2),
        # the dense plane, the sparse and the run payload, each read once
        bound_ms=bound_ms(n_shards * W * 4 + SPARSE_MAX_IDS * 4 + RUN_MAX_INTERVALS * 8),
        library_ms=None,
    )
    tail_ids, day_runs = sparse_store[tail_slot], run_store[day_slot]
    k8 = dict(
        ms=cuda_ms(torch, lambda: ops.container_count(sparse_store, tail_slot), 50),
        plain_ms=cuda_ms(torch, lambda: containers.sparse_count(tail_ids), 50),
        bound_ms=bound_ms(SPARSE_MAX_IDS * 4 + 8),
        library_ms=cuda_ms(torch, lambda: (tail_ids >= 0).sum(), 50),
    )
    times["container_count_run_ms"] = cuda_ms(torch, lambda: ops.container_count(run_store, day_slot), 50)
    times["container_count_run_plain_ms"] = cuda_ms(torch, lambda: containers.run_count(day_runs), 50)
    times["container_count_run_library_ms"] = cuda_ms(torch, lambda: (day_runs[:, 1] - day_runs[:, 0]).sum(), 50)
    # a promotion into the sparse store: one row scattered into a copy
    one = i32([tail_slot])
    row = sparse_store[tail_slot : tail_slot + 1].clone()
    k3 = dict(
        replaces="pilosa_tpu/executor/compile.py:185",  # _scatter_rows
        ms=cuda_ms(torch, lambda: ops.scatter_rows(sparse_store, one, row), 5),
        plain_ms=cuda_ms(torch, lambda: stack.scatter_rows_plain(sparse_store, one, row), 2),
        # the store read once and written once, the row and its index read
        bound_ms=bound_ms(2 * sparse_store.numel() * 4 + row.numel() * 4 + 4),
        library_ms=cuda_ms(torch, lambda: torch.index_copy(sparse_store, 0, one.long(), row), 5),
    )
    # the same promotion into the dense and run stores
    for name, store, slot in (("dense", dense_store, 0), ("run", run_store, day_slot)):
        row = store[slot : slot + 1].clone()
        sl = i32([slot])
        times[f"scatter_rows_{name}_store_ms"] = cuda_ms(torch, lambda: ops.scatter_rows(store, sl, row), 3)
        times[f"scatter_rows_{name}_store_plain_ms"] = cuda_ms(
            torch, lambda: stack.scatter_rows_plain(store, sl, row), 2)
        times[f"scatter_rows_{name}_store_bound_ms"] = bound_ms(2 * store.numel() * 4 + row.numel() * 4)
        times[f"scatter_rows_{name}_store_library_ms"] = cuda_ms(
            torch, lambda: torch.index_copy(store, 0, sl.long(), row), 3)
        times[f"{name}_store_gib"] = store.numel() * 4 / 2**30
        del row
    times["sparse_store_gib"] = sparse_store.numel() * 4 / 2**30
    # the fused filters under one container leaf: K2 and K4 under the day's
    # run row, K5 under the tail's sparse row; the bound counts the rows or
    # planes and the leaf's payload, each read once
    plane = n_shards * W * 4
    run_bytes, sparse_bytes = RUN_MAX_INTERVALS * 8, SPARSE_MAX_IDS * 4
    fused = {
        "row_counts_tree": dict(
            ms=cuda_ms(torch, lambda: ops.row_counts(cab_m, pf_run), 20),
            plain_ms=cuda_ms(torch, lambda: topn.row_counts_plain(cab_m, pf_run.plain(dev, plane2)), 2),
            bound_ms=bound_ms(cab_m.shape[0] * plane + run_bytes),
            shape=f"rows+tree, [{cab_m.shape[0]}, {n_shards}, {W}] under a run row"),
        "bsi_sum_tree": dict(
            ms=cuda_ms(torch, lambda: ops.bsi_sum(bsi_m, depth, pf_run), 20),
            plain_ms=cuda_ms(torch, lambda: bsi.bsi_sum_plain(bsi_m, depth, pf_run.plain(dev, plane2)[None]), 2),
            bound_ms=bound_ms(min(bsi_m.shape[0], 2 + depth) * plane + run_bytes),
            shape=f"one+tree, [{2 + depth}, {n_shards}, {W}] under a run row"),
        "bsi_minmax_tree": dict(
            ms=cuda_ms(torch, lambda: ops.bsi_min_max(bsi_m, depth, pf_sparse, False), 20),
            plain_ms=cuda_ms(torch, lambda: bsi.bsi_min_max_plain(bsi_m, depth, pf_sparse.plain(dev, plane2), False), 2),
            bound_ms=bound_ms(min(bsi_m.shape[0], 2 + depth) * plane + sparse_bytes),
            shape=f"min+tree, [{2 + depth}, {n_shards}, {W}] under a sparse row"),
    }
    for t in fused.values():
        t.update(replaces="pilosa_tpu/executor/executor.py:1019", library_ms=None)
    log("residency times:", json.dumps(times))
    results = {"tree_eval": k1, "container_count": k8, "stack_delta": k3, **fused}
    return {name: (errs[name], t) for name, t in results.items()}, launches


def np_search(inter: np.ndarray, row_pop: np.ndarray, q_pop: int, k: int, threshold: float) -> tuple:
    """The reference's tanimoto_search by numpy: f32 scores with the
    threshold compared in f32, then the k largest by (score, -row), so
    ties go to the lower row."""
    fi = inter.astype(np.float32)
    union = (row_pop.astype(np.float32) + np.float32(q_pop)) - fi
    scores = np.zeros_like(fi)
    np.divide(fi, union, out=scores, where=union > 0)
    scores = np.where(scores >= np.float32(threshold), scores, np.float32(0))
    keys = (scores.view(np.uint32).astype(np.int64) << 32) | (0xFFFFFFFF - np.arange(fi.size, dtype=np.int64))
    k = min(k, fi.size)
    top = np.argpartition(keys, fi.size - k)[fi.size - k :]
    top = top[np.argsort(keys[top])[::-1]]
    return scores[top], top.astype(np.int32)


def np_pairwise(a: np.ndarray, b: np.ndarray, mode: str) -> np.ndarray:
    """f32[N, M] intersection counts, Tanimoto or cosine by numpy, each
    step rounded in f32 as the reference's program."""
    inter = np.bitwise_count(a[:, None, :] & b[None, :, :]).sum(axis=-1, dtype=np.int64).astype(np.float32)
    if mode == "inter":
        return inter
    pa = np.bitwise_count(a).sum(axis=1, dtype=np.int64).astype(np.float32)[:, None]
    pb = np.bitwise_count(b).sum(axis=1, dtype=np.int64).astype(np.float32)[None, :]
    den = (pa + pb) - inter if mode == "tanimoto" else np.sqrt(pa * pb)
    out = np.zeros_like(inter)
    np.divide(inter, den, out=out, where=den > 0)
    return out


def sim_edge_words(rng, n: int, w: int) -> np.ndarray:
    """uint32[n, w] random words with edge rows: all ones, bit 31 only,
    zero, and duplicates of rows 0 and 1."""
    m = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    m &= rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    m[2] = 0xFFFFFFFF
    m[3] = 0x80000000
    m[4] = 0
    m[5], m[6] = m[0], m[1]
    m[7] = m[0]
    return m


def similarity_path(torch, device: str, n_rows: int = SIM_ROWS, big: int = SIM_BLOCK) -> tuple:
    """BASELINE config 5 on one card: ``n_rows`` 2048-bit fingerprints
    made by the chemical-similarity demo's recipe (10.0 Gbit at the
    default), searched through ``ops.similarity.tanimoto_search`` (k = 10
    at threshold 0, k = 1,000 at threshold 0.3, every row of a 1,000-row
    slice at threshold 0.3) against numpy; the demo's 2048 x 2048 all-pairs block in the
    three modes and a ``big`` x ``big`` Tanimoto block against the plain
    version and a numpy sample. Then K9, K10 and K11 against their plain
    versions at those shapes and at the edges. Returns the kernel entries
    and the path's launch counts."""
    from pilosa_tpu_torch.examples.chemical_similarity import FP_WORDS, make_fingerprints
    from pilosa_tpu_torch.ops import _cuda
    from pilosa_tpu_torch.ops import similarity as sim
    from pilosa_tpu_torch.ops.bitwise import matrix_filter_counts_plain, popcount_rows_plain

    on_card = device == "cuda"
    dev = torch.device(device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ------------------------------------------------------------ data
    t0 = time.perf_counter()
    fps, family = make_fingerprints(n_rows)
    times = {"similarity_data_s": time.perf_counter() - t0, "similarity_gbit": n_rows * FP_WORDS * 32 / 1e9}
    t0 = time.perf_counter()
    q_np = fps[17]
    row_pop = np.empty(n_rows, dtype=np.int64)
    inter = np.empty(n_rows, dtype=np.int64)
    for lo in range(0, n_rows, 1 << 20):
        part = fps[lo : lo + (1 << 20)]
        row_pop[lo : lo + part.shape[0]] = np.bitwise_count(part).sum(axis=1, dtype=np.int64)
        inter[lo : lo + part.shape[0]] = np.bitwise_count(part & q_np).sum(axis=1, dtype=np.int64)
    q_pop = int(np.bitwise_count(q_np).sum())
    slice_rows = min(1000, n_rows)
    searches = [  # (what, rows, k, threshold)
        ("k10", n_rows, 10, 0.0),
        ("k1000_t0.3", n_rows, 1000, 0.3),
        ("slice_kR_t0.3", slice_rows, slice_rows + 30, 0.3),  # a zero-score tail in row order
    ]
    want = {name: np_search(inter[:rows], row_pop[:rows], q_pop, k, thr) for name, rows, k, thr in searches}
    times["similarity_expect_s"] = time.perf_counter() - t0

    # ------------------------------------------------- similarity path
    for k in _cuda.KERNELS.values():
        k.reset()
    t0 = time.perf_counter()
    matrix = sim.as_words(fps, dev)
    sync()
    times["similarity_upload_s"] = time.perf_counter() - t0
    query = matrix[17]
    for name, rows, k, thr in searches:
        scores, ids = sim.tanimoto_search(matrix[:rows], query, k=k, threshold=thr, device=dev)
        got_s, got_i = scores.cpu().numpy(), ids.cpu().numpy()
        want_s, want_i = want[name]
        if not (np.array_equal(got_i, want_i) and np.array_equal(got_s.view(np.uint32), want_s.view(np.uint32))):
            bad = int(np.flatnonzero((got_i != want_i) | (got_s != want_s))[0]) if got_i.shape == want_i.shape else -1
            raise AssertionError(f"search {name}: first difference at {bad}: ids {got_i[:12]} != numpy {want_i[:12]}")
        log(f"ok  tanimoto_search {name} over {rows:,} rows -> ids {got_i[:5].tolist()} "
            f"scores {[round(float(s), 4) for s in got_s[:3]]}, {int((got_s == 0).sum())} of {got_s.size} zero")
    if int(family[want["k10"][1][1]]) != int(family[17]):
        raise AssertionError("molecule 17's nearest other neighbour is not of its family")
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        scores, ids = sim.tanimoto_search(matrix, query, k=10, device=dev)
        scores.cpu(), ids.cpu()
        lat.append(time.perf_counter() - t0)
    times["search_sync_p50_ms"] = float(np.median(lat)) * 1e3
    times["search_gbit_per_s"] = times["similarity_gbit"] / (times["search_sync_p50_ms"] / 1e3)
    # all pairs: the demo's block in the three modes, then the big block
    rng = np.random.default_rng(31)
    blocks = [(min(2048, n_rows), "inter"), (min(2048, n_rows), "tanimoto"), (min(2048, n_rows), "cosine"),
              (min(big, n_rows), "tanimoto")]
    entry = {"inter": sim.pairwise_intersections, "tanimoto": sim.tanimoto_matrix, "cosine": sim.cosine_matrix}
    pair_errs = {}
    for n_blk, mode in blocks:
        blk = matrix[:n_blk]
        sync()
        t0 = time.perf_counter()
        got = entry[mode](blk, blk, device=dev)
        sync()
        wall = time.perf_counter() - t0
        rows = np.sort(rng.choice(n_blk, min(64, n_blk), replace=False))
        sample = np_pairwise(fps[rows], fps[:n_blk], mode)
        if not np.array_equal(got[torch.from_numpy(rows).to(dev)].cpu().numpy().view(np.uint32), sample.view(np.uint32)):
            raise AssertionError(f"all-pairs {mode} {n_blk}²: a sampled row differs from numpy")
        plain = sim.pairwise_plain(blk, blk, mode)
        pair_errs[f"{mode}_{n_blk}"] = int((got.view(torch.int32).long() - plain.view(torch.int32).long()).abs().max())
        del got, plain
        times[f"pairwise_{mode}_{n_blk}_wall_ms"] = wall * 1e3
        log(f"ok  {mode} all-pairs {n_blk:,} x {n_blk:,} in {wall * 1e3:.2f} ms wall, 64 rows equal numpy")
    if any(pair_errs.values()):
        raise AssertionError(f"all-pairs blocks disagree with the plain version: {pair_errs}")
    times[f"pairwise_tanimoto_{min(big, n_rows)}_pairs_per_s"] = min(big, n_rows) ** 2 / (
        times[f"pairwise_tanimoto_{min(big, n_rows)}_wall_ms"] / 1e3)
    sync()
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    log("launches on the similarity path:", json.dumps(launches))
    log("launches on the similarity path by mode:",
        json.dumps({n: k.modes for n, k in _cuda.KERNELS.items() if k.modes}))
    if on_card and any(launches[n] <= 0 for n in ("sim_scan", "sim_select", "pairwise")):
        raise AssertionError(f"a kernel of the similarity path never launched: {launches}")
    del fps

    # ------------------------------------------- kernels vs plain versions
    errs = {"sim_scan": 0, "sim_select": 0, "pairwise": 0}

    def scan_err(m, q, thr) -> int:
        keys, hist = sim.search_keys(m, q, thr)
        pk, ph = sim.search_keys_plain(m, q, float(np.float32(thr)))
        return max(max_abs_err(torch, keys, pk), max_abs_err(torch, hist, ph))

    def select_err(keys, hist, k) -> int:
        got = sim.select_top(keys, hist, k)
        want_ = sim.select_top_plain(keys, k)
        return max(max_abs_err(torch, got[0].view(torch.int32), want_[0].view(torch.int32)),
                   max_abs_err(torch, got[1], want_[1]))

    full_keys = {}
    for thr in (0.0, 0.3):
        errs["sim_scan"] = max(errs["sim_scan"], scan_err(matrix, query, thr))
        full_keys[thr] = sim.search_keys(matrix, query, thr)
    # the tile route (k <= 4,096) and the radix sort past it
    for thr, ks in ((0.0, (1, 10, 1000, 4096, 4097, 50_000, 65_536, n_rows)), (0.3, (1, 1000, 65_536, n_rows - 1))):
        keys, hist = full_keys[thr]
        for k in sorted({min(k, n_rows) for k in ks}):
            errs["sim_select"] = max(errs["sim_select"], select_err(keys, hist, k))
    # the small route: one block over n <= 4,096 keys (duplicate and edge
    # rows give equal scores, the threshold a zero-score tail)
    for n_s in (1, 8, 4096):
        for thr in (0.0, 0.3):
            keys, hist = sim.search_keys(matrix[:n_s], query, thr)
            for k in sorted({1, n_s}):
                errs["sim_select"] = max(errs["sim_select"], select_err(keys, hist, k))
    # edges: all-ones, bit-31 and zero rows, duplicates, a zero query, a
    # query equal to a row, W not a multiple of 4, rows that are not 16 B
    # aligned, a threshold of 1.0
    for n_e, w in ((300, 64), (300, 512), (77, 3), (50, 1)):
        m_np = sim_edge_words(rng, n_e, w)
        m = sim.as_words(m_np, dev)
        for q_t, thr in ((m[0], 0.0), (m[4], 0.0), (m[2], 0.3), (m[0], 1.0), (m[9], 0.9)):
            errs["sim_scan"] = max(errs["sim_scan"], scan_err(m, q_t, thr))
            keys, hist = sim.search_keys(m, q_t, thr)
            for k in (1, 10, n_e):
                errs["sim_select"] = max(errs["sim_select"], select_err(keys, hist, k))
        for mode in sim.PAIRWISE_MODES:
            a, b = m, sim.as_words(sim_edge_words(rng, 131, w), dev)
            errs["pairwise"] = max(errs["pairwise"], max_abs_err(
                torch, sim.pairwise(a, b, mode).view(torch.int32), sim.pairwise_plain(a, b, mode).view(torch.int32)))
    flat = torch.empty(300 * 64 + 1, dtype=torch.int32, device=dev)
    flat[1:] = sim.as_words(sim_edge_words(rng, 300, 64), dev).reshape(-1)
    shifted = flat[1:].view(300, 64)  # 4 B past a 16 B boundary: the word loop
    errs["sim_scan"] = max(errs["sim_scan"], scan_err(shifted, shifted[0].clone(), 0.0))

    def pair_err(a, b, mode) -> int:
        return max_abs_err(torch, sim.pairwise(a, b, mode).view(torch.int32), sim.pairwise_plain(a, b, mode).view(torch.int32))

    # K11 at the edges of its 128-row tiles and 8-word k-steps, on rows that
    # are not 16 B aligned (its 4 B copies), and past the old grid's
    # 4,194,240 rows (C3; a 134 MB output)
    for w in (1, 7, 8, 9, 33, 64):
        for n_e, m_e in ((1, 1), (63, 65), (129, 63), (65, 129)):
            a, b = (sim.as_words(sim_edge_words(rng, max(r, 8), w)[:r], dev) for r in (n_e, m_e))
            for mode in sim.PAIRWISE_MODES:
                errs["pairwise"] = max(errs["pairwise"], pair_err(a, b, mode))
    big_w = (sim.as_words(sim_edge_words(rng, 8, 1 << 18)[:r], dev) for r in (3, 2))  # counts past 2^23
    for a, b in ((shifted, shifted[:129]), tuple(big_w)):
        for mode in sim.PAIRWISE_MODES:
            errs["pairwise"] = max(errs["pairwise"], pair_err(a, b, mode))
    n_c3 = min(4_194_304 + 64, n_rows)
    errs["pairwise"] = max(errs["pairwise"], pair_err(matrix[:n_c3], matrix[:8], "tanimoto"))
    times["pairwise_c3_rows"] = n_c3
    log("max |kernel - plain| on the similarity path's shapes:", json.dumps(errs))
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: {errs}")

    # --------------------------------------------------------- timings
    keys, hist = full_keys[0.0]
    scores_plain = sim._scores_plain(matrix_filter_counts_plain(matrix, query), popcount_rows_plain(matrix), popcount_rows_plain(query), 0.0)
    w_bytes = matrix.numel() * 4
    k9 = dict(
        ms=cuda_ms(torch, lambda: sim.search_keys(matrix, query, 0.0), 20),
        plain_ms=cuda_ms(torch, lambda: sim.search_keys_plain(matrix, query, 0.0), 2),
        # the matrix and the query read once, a key per row and the
        # histogram written once
        bound_ms=bound_ms(w_bytes + query.numel() * 4 + n_rows * 8 + sim.SELECT_BINS * 4),
        library_ms=None,  # no PyTorch call computes a masked popcount
    )
    k10 = dict(
        ms=cuda_ms(torch, lambda: sim.select_top(keys, hist, 10), 20),
        plain_ms=cuda_ms(torch, lambda: sim.select_top_plain(keys, 10), 20),
        # the keys read once, k scores and ids written once
        bound_ms=bound_ms(n_rows * 8 + 10 * 8),
        # torch.topk of the scores: the same k, not the reference's order of ties
        library_ms=cuda_ms(torch, lambda: torch.topk(scores_plain, 10), 20),
        graph_ms=graph_ms(torch, lambda: sim.select_top(keys, hist, 10), 20),
        library_graph_ms=graph_ms(torch, lambda: torch.topk(scores_plain, 10), 20),
    )
    keys3, hist3 = full_keys[0.3]
    scores3 = sim._scores_plain(matrix_filter_counts_plain(matrix, query), popcount_rows_plain(matrix), popcount_rows_plain(query), 0.3)
    times["select_k1000_t0.3_ms"] = cuda_ms(torch, lambda: sim.select_top(keys3, hist3, 1000), 10)
    times["select_k1000_t0.3_plain_ms"] = cuda_ms(torch, lambda: sim.select_top_plain(keys3, 1000), 10)
    times["select_k1000_t0.3_library_ms"] = cuda_ms(torch, lambda: torch.topk(scores3, 1000), 10)
    times["select_kR_ms"] = cuda_ms(torch, lambda: sim.select_top(keys, hist, n_rows), 2)
    times["select_kR_plain_ms"] = cuda_ms(torch, lambda: sim.select_top_plain(keys, n_rows), 2)
    times["select_kR_library_ms"] = cuda_ms(torch, lambda: torch.topk(scores_plain, n_rows), 2)
    del scores_plain, scores3, full_keys, keys3, hist3
    # the library: the unpacked product as one int8 matrix product, exact
    # in int32 (the unpack timed apart); bf16 where torch lacks _int_mm
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    int_mm = on_card and hasattr(torch, "_int_mm")
    times["pairwise_library"] = "torch._int_mm int8" if int_mm else "torch.matmul bf16"

    def unpack8(t):
        bits = ((t[:, :, None] >> shifts) & 1).reshape(t.shape[0], -1)
        return bits.to(torch.int8) if int_mm else bits.to(torch.bfloat16)

    def library_ms(blk, reps: int) -> float:
        bits = unpack8(blk)
        if int_mm:
            if not torch.equal(torch._int_mm(bits, bits.t()).to(torch.float32), sim.pairwise(blk, blk, "inter")):
                raise AssertionError("torch._int_mm of the unpacked bits disagrees with K11's counts")
            return cuda_ms(torch, lambda: torch._int_mm(bits, bits.t()), reps)
        return cuda_ms(torch, lambda: torch.matmul(bits, bits.t()), reps)

    # K11's bound is its bytes: both operands read once, the f32 output
    # written once (its binary MMA has no published rate; the int8 figure
    # is kept beside it as a yardstick)
    for n_blk, mode in blocks[:3]:
        blk = matrix[:n_blk]
        times[f"pairwise_{mode}_{n_blk}_ms"] = cuda_ms(torch, lambda: sim.pairwise(blk, blk, mode), 10)
        times[f"pairwise_{mode}_{n_blk}_graph_ms"] = graph_ms(torch, lambda: sim.pairwise(blk, blk, mode), 20)
        times[f"pairwise_{mode}_{n_blk}_plain_ms"] = cuda_ms(torch, lambda: sim.pairwise_plain(blk, blk, mode), 2)
        times[f"pairwise_{mode}_{n_blk}_bound_ms"] = bound_ms(2 * n_blk * FP_WORDS * 4 + n_blk * n_blk * 4)
        times[f"pairwise_{n_blk}_int8_ops_ms"] = ops_ms(2 * n_blk * n_blk * FP_WORDS * 32)
    blk = matrix[: blocks[0][0]]
    times[f"pairwise_{blocks[0][0]}_library_ms"] = library_ms(blk, 10)
    bits = unpack8(blk)
    times[f"pairwise_{blocks[0][0]}_library_graph_ms"] = graph_ms(
        torch, (lambda: torch._int_mm(bits, bits.t())) if int_mm else (lambda: torch.matmul(bits, bits.t())), 20)
    del bits
    n_big = min(big, n_rows)
    blk = matrix[:n_big]
    times[f"pairwise_inter_{n_big}_ms"] = cuda_ms(torch, lambda: sim.pairwise(blk, blk, "inter"), 5)
    times[f"pairwise_{n_big}_int8_ops_ms"] = ops_ms(2 * n_big * n_big * FP_WORDS * 32)
    k11 = dict(
        ms=cuda_ms(torch, lambda: sim.pairwise(blk, blk, "tanimoto"), 5),
        plain_ms=cuda_ms(torch, lambda: sim.pairwise_plain(blk, blk, "tanimoto"), 2),
        bound_ms=bound_ms(2 * n_big * FP_WORDS * 4 + n_big * n_big * 4),
        bound_by="bytes",
        library_ms=library_ms(blk, 5),
    )
    times["pairwise_unpack_ms"] = cuda_ms(torch, lambda: unpack8(blk), 5)
    times["pairwise_tanimoto_big_pairs_per_s_kernel"] = n_big * n_big / (k11["ms"] / 1e3)
    del blk, matrix
    if on_card:
        torch.cuda.empty_cache()
    log("similarity times:", json.dumps(times))
    results = {"sim_scan": k9, "sim_select": k10, "pairwise": k11}
    return {name: (errs[name], t) for name, t in results.items()}, launches


MESH_POSITIONS = 8  # the mesh's positions: cuda:(i % cards), all on cuda:0 with one card
MESH_SEARCH_K = (5, R_PAD + 2)  # the mesh search's k: a shortlist, and k past R (clamped)
MESH_LAYOUTS = (("8x1", 1), ("4x2", 2))


def main_filters(one_device: bool = True) -> list:
    """The main holder's filter kinds: (PQL, numpy words of a block under
    it, ``fn(block, exists)``); the Shift only on one device (the mesh
    hands it to the device route)."""
    zeros = lambda b, e: np.zeros_like(e)  # noqa: E731
    out = [
        ("Row(f=1)", lambda b, e: b[1]),
        ("Intersect(Row(f=1), Row(f=2))", lambda b, e: b[1] & b[2]),
        ("Not(Row(f=3))", lambda b, e: e & ~b[3]),
        ("Union()", zeros),
        (f"Row(f={R_PAD + 1})", zeros),
    ]
    if one_device:
        out.append(("Shift(Row(f=1), n=1)", lambda b, e: np_shift(b[1], 1)))
    return out


def main_fused_queries(filt: str) -> list:
    """The main holder's filtered TopN: (PQL, n, ids), plain and ids=
    with an id past the rows."""
    return [(f"TopN(f, {filt}, n=5)", 5, None), (f"TopN(f, {filt}, ids=[7, 2, 0, 9])", None, [7, 2, 0, 9])]


def mesh_main_queries(n_shards: int) -> list:
    """The main holder's mesh queries: (PQL, numpy recipe) with the recipe
    (kind, argument) read by ``mesh_path``."""
    sub = [0, 5, min(9, n_shards - 1)]
    sub_s = ", ".join(map(str, sub))
    return [
        ("Count(Intersect(Row(f=1), Row(f=2)))", ("count", lambda b, e: b[1] & b[2])),
        ("Count(Union(Row(f=1), Row(f=2)))", ("count", lambda b, e: b[1] | b[2])),
        ("Count(Difference(Row(f=3), Row(f=4)))", ("count", lambda b, e: b[3] & ~b[4])),
        ("Count(Xor(Row(f=5), Row(f=6)))", ("count", lambda b, e: b[5] ^ b[6])),
        ("Count(Not(Row(f=1)))", ("count", lambda b, e: e & ~b[1])),
        ("TopN(f, n=5)", ("topn", (None, 5, None))),
        ("TopN(f, Row(f=1), n=5)", ("topn", (1, 5, None))),
        ("TopN(f, ids=[7, 2, 0, 9])", ("topn", (None, None, [7, 2, 0, 9]))),
        # three shards do not divide the shards axis: words mode
        (f"Options(Count(Intersect(Row(f=1), Row(f=7))), shards=[{sub_s}])", ("count_sub", (lambda b, e: b[1] & b[7], sub))),
        (f"Options(Row(f=2), shards=[{sub_s}])", ("columns", (2, sub))),
    ]


def mesh_path(torch, device: str, main: dict, taxi: dict, sim_block: int) -> tuple:
    """The device-mesh engine (B16) on the main and taxi holders, as
    ``API(holder, mesh_ctx=MeshContext(make_mesh(devices, words_axis)),
    route_mode="mesh")`` over MESH_POSITIONS positions, in the 8x1 and
    4x2 layouts: the main holder's Counts, a blocked bitmap readback,
    TopN plain, filtered and ids=, an Options subset in words mode, Shift
    (one counted fallback to the device route) and a Set then Count (K3
    per block, no restack); the taxi holder's BSI condition Count, Sum,
    Min, Max and GroupBy (fused, level-synchronous, aggregate=Sum); the
    mesh Tanimoto and cosine search of row 1 of ``f`` against the main
    holder's rows; the 2048² all-pairs block in both modes and a
    ``sim_block``² Tanimoto block. Every answer against numpy and the
    one-device route's; the sync p50 of Count, TopN, Sum and GroupBy
    beside the one-device p50. Then each kernel the path launches
    against its plain version at the 4x2 layout's block shapes. Returns
    the kernel entries and the path's launch counts."""
    from pilosa_tpu_torch import ops
    from pilosa_tpu_torch.core import VIEW_BSI
    from pilosa_tpu_torch.examples.chemical_similarity import make_fingerprints
    from pilosa_tpu_torch.ops import _cuda, bitwise, bsi, groupby, stack, topn
    from pilosa_tpu_torch.ops import similarity as sim
    from pilosa_tpu_torch.parallel import MeshContext, make_mesh
    from pilosa_tpu_torch.server import API
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

    on_card = device == "cuda"
    W = WORDS_PER_SHARD
    n_cards = torch.cuda.device_count() if on_card else 1
    devices = [torch.device("cuda", i % n_cards) if on_card else "cpu" for i in range(MESH_POSITIONS)]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    h, idx, shards = main["holder"], main["index"], main["shards"]
    n_shards = len(shards)
    th, tidx = taxi["holder"], taxi["index"]
    t_shards = sorted(tidx.available_shards())
    times = {}

    # ------------------------------------------------- numpy over the blocks
    # per-shard block ids: shard s holds main["blocks"][s % G] unless a
    # write gave it a copy of its own
    blk_list, ex_list = list(main["blocks"]), [e[0] for e in main["exists"]]
    block_of = {s: s % G for s in shards}

    def write(shard: int, col_in_shard: int, row: int) -> None:
        if block_of[shard] < G:
            blk_list.append(blk_list[block_of[shard]].copy())
            ex_list.append(ex_list[block_of[shard]].copy())
            block_of[shard] = len(blk_list) - 1
        g = block_of[shard]
        blk_list[g][row, col_in_shard // 32] |= np.uint32(1) << np.uint32(col_in_shard % 32)
        ex_list[g][col_in_shard // 32] |= np.uint32(1) << np.uint32(col_in_shard % 32)

    for shard, col in main["writes"]:
        write(shard, col % SHARD_WIDTH, 1)

    def expect_count(fn, shard_list=shards) -> int:
        mult = np.bincount([block_of[s] for s in shard_list], minlength=len(blk_list))
        return sum(int(mult[g]) * int(np.bitwise_count(fn(blk_list[g], ex_list[g])).sum())
                   for g in range(len(blk_list)) if mult[g])

    def expect(kind, arg):
        if kind == "count":
            return expect_count(arg)
        if kind == "count_sub":
            return expect_count(arg[0], arg[1])
        if kind == "columns":
            row, sub = arg
            cols = []
            for s in sub:
                bits = np.unpackbits(blk_list[block_of[s]][row].view(np.uint8), bitorder="little")
                cols.append(np.flatnonzero(bits) + s * SHARD_WIDTH)
            return {"columns": np.concatenate(cols).tolist()}
        filt_row, n, ids = arg
        rows = ids if ids is not None else range(R_PAD)
        pairs = []
        for r in rows:
            c = 0 if r >= R_PAD else expect_count(lambda b, e, r=r: b[r] if filt_row is None else b[r] & b[filt_row])
            if c:
                pairs.append((r, c))
        pairs.sort(key=lambda rc: (-rc[1], rc[0]))
        return [{"id": r, "count": c} for r, c in (pairs[:n] if n else pairs)]

    def np_scores(metric: str, k: int):
        inter = np.array([expect_count(lambda b, e, r=r: b[r] & b[1]) for r in range(R_PAD)], dtype=np.int64)
        pop = np.array([expect_count(lambda b, e, r=r: b[r]) for r in range(R_PAD)], dtype=np.int64)
        fi, fr, fq = inter.astype(np.float32), pop.astype(np.float32), np.float32(pop[1])
        den = (fr + fq) - fi if metric == "tanimoto" else np.sqrt(fr * fq)
        scores = np.zeros_like(fi)
        np.divide(fi, den, out=scores, where=den > 0)
        order = sorted(range(R_PAD), key=lambda r: (-scores[r], r))[: min(k, R_PAD)]
        return scores[order], np.array(order, dtype=np.int32)

    # the fingerprints of the all-pairs blocks: the demo's recipe; a
    # block's rows must divide the shards axis of both layouts
    n_big = sim_block - sim_block % MESH_POSITIONS
    n_demo = min(2048, n_big)
    fps, _family = make_fingerprints(max(n_demo, n_big))
    fps_dev = sim.as_words(fps, devices[0])
    one_device = {}
    for n_blk, mode in ((n_demo, "tanimoto"), (n_demo, "cosine"), (n_big, "tanimoto")):
        blk = fps_dev[:n_blk]
        one_device[(n_blk, mode)] = sim.pairwise(blk, blk, mode)
        sync()
        t0 = time.perf_counter()
        sim.pairwise(blk, blk, mode)
        sync()
        times[f"pairwise_{mode}_{n_blk}_one_device_wall_ms"] = (time.perf_counter() - t0) * 1e3
    sample = np.arange(0, n_demo, max(1, n_demo // 16))
    np_demo = {m: np_pairwise(fps[sample], fps[:n_demo], m) for m in ("tanimoto", "cosine")}

    main_q = mesh_main_queries(n_shards)

    def expect_topn_words(filt_fn, n, ids=None) -> list:
        pairs = []
        for r in ids if ids is not None else range(R_PAD):
            c = 0 if r >= R_PAD else expect_count(lambda b, e, r=r: b[r] & filt_fn(b, e))
            if c:
                pairs.append((r, c))
        pairs.sort(key=lambda rc: (-rc[1], rc[0]))
        return [{"id": r, "count": c} for r, c in (pairs[:n] if n else pairs)]

    main_fused = [(pql, expect_topn_words(fn, n, ids))
                  for filt, fn in main_filters(False) for pql, n, ids in main_fused_queries(filt)]
    taxi_q = taxi["checks"]
    gb_q = "GroupBy(Rows(cab_type), Rows(passenger_count))"
    sum_q = "Sum(field=total_amount)"

    # ---------------------------------------------------------- mesh path
    for k in _cuda.KERNELS.values():
        k.reset()
    pairwise_out = {}
    block_inputs = {}
    for name, words_axis in MESH_LAYOUTS:
        ctx = MeshContext(make_mesh(devices, words_axis=words_axis))
        api = API(h, mesh_ctx=ctx, route_mode="mesh")
        tapi = API(th, mesh_ctx=ctx, route_mode="mesh")
        ex, eng = api.executor, api.executor.compiler.mesh_engine
        t0 = time.perf_counter()
        fm = ex.compiler.stacks.matrix(idx, idx.field("f"), "standard", shards)[0]
        ex.compiler.stacks.matrix(idx, idx.existence_field(), "standard", shards)
        for fname in ("cab_type", "passenger_count"):
            tapi.executor.compiler.stacks.matrix(tidx, tidx.field(fname), "standard", t_shards)
        tapi.executor.compiler.stacks.matrix(tidx, tidx.field("total_amount"), VIEW_BSI, t_shards)
        tapi.executor.compiler.stacks.matrix(tidx, tidx.existence_field(), "standard", t_shards)
        sync()
        times[f"{name}_stack_upload_s"] = time.perf_counter() - t0
        if fm.mode != "grid" or len(fm.blocks) != MESH_POSITIONS // words_axis:
            raise AssertionError(f"{name}: the main stack placed as {fm.mode} over {len(fm.blocks)} rows")

        def run(a, iname, pql, want, one, fallback=False):
            e = a.executor
            en = e.compiler.mesh_engine
            before = (e.router.decisions["mesh"], sum(en.calls.values()), en.fallbacks, e.router.decisions["device"])
            got = a.query(iname, pql)["results"][0]
            if got != want:
                raise AssertionError(f"{name}: {pql}: {json.dumps(got)[:300]} != numpy {json.dumps(want)[:300]}")
            if got != one:
                raise AssertionError(f"{name}: {pql}: {json.dumps(got)[:300]} != one-device {json.dumps(one)[:300]}")
            after = (e.router.decisions["mesh"], sum(en.calls.values()), en.fallbacks, e.router.decisions["device"])
            if fallback:
                if after[2] != before[2] + 1 or after[3] != before[3] + 1 or after[0] != before[0]:
                    raise AssertionError(f"{name}: {pql} did not fall back once to the device route: {before} -> {after}")
            elif after[0] <= before[0] or after[1] <= before[1] or after[2] != before[2]:
                raise AssertionError(f"{name}: {pql} did not run on the mesh: {before} -> {after}")
            log(f"ok  mesh {name}: {pql[:60]}  -> {json.dumps(got)[:70]}")

        for pql, (kind, arg) in main_q:
            run(api, "bench", pql, expect(kind, arg), main["answers"][pql])
        # the fused filters per block: each block's plan inside K2, K4, K5
        blocks_n = MESH_POSITIONS
        n_main, n_taxi = len(main_filters(False)), len(taxi_filters(False))
        times[f"{name}_fused_launches_main"] = fused_phase(
            torch, api, "bench", main_fused, f"mesh {name} main", fused_modes(blocks_n, topn=n_main, ids=n_main))
        times[f"{name}_fused_launches_taxi"] = fused_phase(
            torch, tapi, "taxi", taxi["fused"], f"mesh {name} taxi",
            fused_modes(blocks_n, topn=n_taxi, ids=n_taxi, sums=n_taxi, mins=n_taxi, maxs=n_taxi))
        # the blocked readback of one whole row, in the placement's order
        mesh_before = ex.router.decisions["mesh"]
        segments = ex.execute("bench", "Row(f=1)")[0].segments
        for s in shards:
            if not np.array_equal(segments[s], blk_list[block_of[s]][1]):
                raise AssertionError(f"{name}: Row(f=1) differs from numpy in shard {s}")
        if digest(segments, shards) != main["row1_digest"] or ex.router.decisions["mesh"] != mesh_before + 1:
            raise AssertionError(f"{name}: Row(f=1) differs from the one-device route's, or did not run on the mesh")
        log(f"ok  mesh {name}: Row(f=1) read back blocked, equal to numpy and the device route in every shard")
        del segments
        shift_q = "Count(Shift(Row(f=1), n=1))"
        run(api, "bench", shift_q, expect_count(lambda b, e: np_shift(b[1], 1)), main["answers"][shift_q], fallback=True)
        # a Set into the last shard (its fragments hold their bits in roaring
        # storage, as the main path's write) at a column that exists and
        # is not in row 1, then a Clear of it: K3 on the blocks that hold
        # the shard, no restack, and the holder as it was for the next layout
        stacks_ = ex.compiler.stacks
        w_shard = shards[-1]
        g_w = block_of[w_shard]
        cand = np.flatnonzero(np.unpackbits((ex_list[g_w] & ~blk_list[g_w][1]).view(np.uint8), bitorder="little"))
        col = w_shard * SHARD_WIDTH + int(cand[words_axis])
        restacks, deltas, k3 = stacks_.full_restacks, stacks_.delta_updates, _cuda.STACK_DELTA.launches
        row1_want, not_want = expect_count(lambda b, e: b[1]), expect_count(lambda b, e: e & ~b[1])
        for write_q, step in ((f"Set({col}, f=1)", 1), (f"Clear({col}, f=1)", 0)):
            api.query("bench", write_q)
            run(api, "bench", "Count(Row(f=1))", row1_want + step, row1_want + step)
            run(api, "bench", "Count(Not(Row(f=1)))", not_want - step, not_want - step)
        sync()
        k3_launches, n_deltas = _cuda.STACK_DELTA.launches - k3, stacks_.delta_updates - deltas
        if stacks_.full_restacks != restacks or n_deltas < 2 or (on_card and k3_launches != n_deltas * words_axis):
            raise AssertionError(f"{name}: the writes did not ride K3 per block: {stacks_.stats_snapshot()}, K3 {k3_launches}")
        log(f"ok  mesh {name}: Set and Clear({col}, f=1) rode {n_deltas} deltas, K3 on {k3_launches} blocks, no restack")
        # the taxi holder
        for pql, want in taxi_q:
            run(tapi, "taxi", pql, want, taxi["answers"][pql])
        tapi.executor.GROUPBY_MASK_BUDGET = 2 * len(t_shards) * W * 4  # the fused path's 4 masks do not fit
        gb_want = next(w for q, w in taxi_q if q == gb_q)
        run(tapi, "taxi", gb_q, gb_want, taxi["answers"][gb_q])
        tapi.executor.GROUPBY_MASK_BUDGET = None
        log(f"ok  mesh {name}: {gb_q} level-synchronous")
        # sync p50s on the mesh route, beside the one-device route's
        for key, a, iname, pql in (("count", api, "bench", main_q[0][0]), ("topn", api, "bench", "TopN(f, n=5)"),
                                   ("sum", tapi, "taxi", sum_q), ("groupby", tapi, "taxi", gb_q)):
            lat = []
            for _ in range(10):
                t0 = time.perf_counter()
                a.query(iname, pql)
                lat.append(time.perf_counter() - t0)
            times[f"{name}_{key}_p50_ms"] = float(np.median(lat)) * 1e3
        times[f"{name}_count_split"] = split_ms(ex, "bench", main_q[0][0])
        times[f"{name}_count_profiled"] = device_busy(
            torch, lambda: api.query("bench", main_q[0][0]), "tree_eval", "tree_ring_kernel"
        )
        # the mesh search of row 1 against the main holder's rows (the
        # stack as the Set left it)
        fm = stacks_.matrix(idx, idx.field("f"), "standard", shards)[0]
        query = fm.row(1)
        for metric in ("tanimoto", "cosine"):
            for k in MESH_SEARCH_K:
                got_s, got_i = getattr(eng, metric)(fm, query, k)
                want_s, want_i = np_scores(metric, k)
                if not (np.array_equal(got_s.cpu().numpy().view(np.uint32), want_s.view(np.uint32))
                        and np.array_equal(got_i.cpu().numpy(), want_i)):
                    raise AssertionError(f"{name}: mesh {metric} k={k}: {got_s.tolist()} {got_i.tolist()} != numpy "
                                         f"{want_s.tolist()} {want_i.tolist()}")
                one = main["search"][(metric, k)]
                if not (torch.equal(one[0].view(torch.int32), got_s.cpu().view(torch.int32)) and torch.equal(one[1], got_i.cpu())):
                    raise AssertionError(f"{name}: mesh {metric} k={k} differs from the one-device route's")
                log(f"ok  mesh {name}: {metric} search k={k}  -> ids {got_i.tolist()}")
        sync()
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.tanimoto(fm, query, 5)[0].cpu()
            lat.append(time.perf_counter() - t0)
        times[f"{name}_search_p50_ms"] = float(np.median(lat)) * 1e3
        # all pairs: the demo block in both modes, the big Tanimoto block
        for n_blk, mode in ((n_demo, "tanimoto"), (n_demo, "cosine"), (n_big, "tanimoto")):
            pa, pb = eng.place_allpairs(fps[:n_blk], fps[:n_blk])
            sync()
            t0 = time.perf_counter()
            out = getattr(eng, "pairwise_" + mode)(pa, pb)
            sync()
            times[f"pairwise_{mode}_{n_blk}_{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3
            got = out.gather()
            if not torch.equal(got.view(torch.int32), one_device[(n_blk, mode)].view(torch.int32)):
                raise AssertionError(f"{name}: mesh {mode} {n_blk}² differs from the one-device K11")
            if n_blk == n_demo and not np.array_equal(got[sample].cpu().numpy().view(np.uint32), np_demo[mode].view(np.uint32)):
                raise AssertionError(f"{name}: mesh {mode} {n_blk}² differs from numpy")
            log(f"ok  mesh {name}: pairwise {mode} {n_blk}² equal to the one-device K11 and numpy")
            if words_axis > 1 and n_blk == n_big:
                pairwise_out = {"a": pa.blocks[0][0], "b": pb.blocks[0][0]}
            del got, out, pa, pb
        snap = ex.compiler.mesh_snapshot()
        log(f"mesh {name} engine:", json.dumps(snap), "taxi:", json.dumps(tapi.executor.compiler.mesh_snapshot()["calls"]))
        log(f"router decisions on the mesh {name}:", json.dumps(ex.router.decisions), json.dumps(tapi.executor.router.decisions))
        if words_axis > 1:
            # the 4x2 blocks the kernels are held to below
            tb = tapi.executor.compiler.stacks
            block_inputs = {
                "f": fm.blocks[0][1], "ex": stacks_.matrix(idx, idx.existence_field(), "standard", shards)[0].blocks[0][1],
                "bsi": tb.matrix(tidx, tidx.field("total_amount"), VIEW_BSI, t_shards)[0].blocks[0][1],
                "cab": tb.matrix(tidx, tidx.field("cab_type"), "standard", t_shards)[0].blocks[0][1],
                "pc": tb.matrix(tidx, tidx.field("passenger_count"), "standard", t_shards)[0].blocks[0][1],
            }
        del api, tapi, ex, eng, fm, query, stacks_, ctx
        free()
    sync()
    launches = {n: k.launches for n, k in _cuda.KERNELS.items()}
    log("launches on the mesh path:", json.dumps(launches))
    log("launches on the mesh path by mode:", json.dumps({n: k.modes for n, k in _cuda.KERNELS.items() if k.modes}))
    path_kernels = ("tree_eval", "row_counts", "stack_delta", "bsi_sum", "bsi_minmax", "gb_counts", "gb_masks",
                    "sim_select", "pairwise", "mesh_sim_keys", "mesh_pairwise_finish")
    if on_card and (any(launches[n] <= 0 for n in path_kernels) or _cuda.BSI_SUM.modes.get("grouped", 0) <= 0):
        raise AssertionError(f"a kernel of the mesh path never launched: {launches}")
    if launches["shift_words"] != 2 * on_card:
        raise AssertionError(f"Shift ran {launches['shift_words']} K7 launches, not one a layout")

    # ----------------------------------- kernels vs plain versions, 4x2 blocks
    fb, eb, tbm, cab, pc = (block_inputs[k] for k in ("f", "ex", "bsi", "cab", "pc"))
    dev = fb.device
    s_l, w_l = fb.shape[1], fb.shape[2]
    ts_l = tbm.shape[1]
    D = taxi["depth"]  # noqa: N806
    L, Z, C = bitwise.OP_LOAD, bitwise.OP_ZERO, bitwise.OP_CMP
    A, O, X, N = bitwise.OP_AND, bitwise.OP_OR, bitwise.OP_XOR, bitwise.OP_ANDNOT
    errs = {n: 0 for n in path_kernels + ("row_counts_tree", "bsi_sum_tree", "bsi_minmax_tree")}
    tree_cases = [
        ([fb], [(0, 1), (0, 2)], [(L, 0), (L, 1), (A, 0)], [], s_l),
        ([fb, eb], [(1, 0), (0, 1)], [(L, 0), (L, 1), (N, 0)], [], s_l),
        ([fb], [(0, -1), (0, R_PAD), (0, 3)], [(L, 0), (L, 1), (O, 0), (L, 2), (X, 0)], [], s_l),
        ([fb], [], [(Z, 0)], [], s_l),
        ([cab, tbm], [(0, 0)], [(L, 0), (C, 0), (A, 0)], [(1, D, ">=", -500)], ts_l),
        ([tbm], [], [(C, 0), (C, 1), (A, 0)], [(0, D, ">=", 2000), (0, D, "<=", -500)], ts_l),
    ]
    for stacks_in, leaves, prog, conds, sl in tree_cases:
        for count in (True, False):
            got = ops.tree_eval(stacks_in, leaves, prog, sl, count=count, device=dev, conds=conds, n_words=w_l)
            want = bitwise.tree_eval_plain(stacks_in, leaves, prog, sl, count, dev, conds, w_l)
            errs["tree_eval"] = max(errs["tree_eval"], max_abs_err(torch, got, want))
            del got, want
    filt = ops.tree_eval([fb], [(0, 1)], [(L, 0)], s_l, count=False, device=dev, n_words=w_l)
    ids = torch.tensor([-1, 0, 3, 7, R_PAD, 2**30], dtype=torch.int32, device=dev)
    for m, fl, ii in ((fb, None, None), (fb, filt, None), (fb, filt, ids)):
        errs["row_counts"] = max(errs["row_counts"], max_abs_err(torch, ops.row_counts(m, fl, ii), topn.row_counts_plain(m, fl, ii)))
    didx = torch.tensor([[1, 0], [stack.OOB, stack.OOB], [R_PAD - 1, s_l - 1], [2, stack.OOB], [-1, 1], [1, 0]],
                        dtype=torch.int32, device=dev)
    drows = torch.randint(-(2**31), 2**31 - 1, (didx.shape[0], w_l), dtype=torch.int32, device=dev)
    for di, dr in ((didx, drows), (didx[:0], drows[:0])):  # and K = 0
        got = ops.apply_stack_delta(fb, di, dr)
        errs["stack_delta"] = max(errs["stack_delta"], max_abs_err(torch, got, stack.apply_stack_delta_plain(fb, di, dr)))
        del got
    free()
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    rows16 = i32(list(range(10)) + [-1] * 6)
    ones = torch.full((1, ts_l, w_l), -1, dtype=torch.int32, device=dev)
    masks4 = ops.gb_masks(ones, cab, i32([0] * 4), i32([0, 1, 2, -1]))
    masks16 = ops.gb_masks(ones, pc, i32([0] * 16), rows16)
    for st, m in ((tbm, None), (tbm, masks16), (tbm, masks4)):
        errs["bsi_sum"] = max([errs["bsi_sum"]] + [max_abs_err(torch, a, b) for a, b in zip(ops.bsi_sum(st, D, m), bsi.bsi_sum_plain(st, D, m))])
    cab1 = cab[1].contiguous()
    for f_, want_max in ((None, False), (None, True), (cab1, True)):
        errs["bsi_minmax"] = max([errs["bsi_minmax"]] + [max_abs_err(torch, a, b) for a, b in zip(
            ops.bsi_min_max(tbm, D, f_, want_max), bsi.bsi_min_max_plain(tbm, D, f_, want_max))])
    for m, mat, rows in ((masks4, pc, rows16), (masks16, cab, i32([0, 1, 2, -1, 9, 2**30]))):
        errs["gb_counts"] = max(errs["gb_counts"], max_abs_err(torch, ops.gb_counts(m, mat, rows), groupby.gb_counts_plain(m, mat, rows)))
    for m, mat, g_idx, row_sel in ((ones, cab, i32([0] * 4), i32([0, 1, 2, -1])), (masks4, pc, i32([0, 1, 3, 2, 9]), i32([1, -1, 9, 2, 0]))):
        errs["gb_masks"] = max(errs["gb_masks"], max_abs_err(torch, ops.gb_masks(m, mat, g_idx, row_sel), groupby.gb_masks_plain(m, mat, g_idx, row_sel)))
    # the search's reduced counts (row 1 against every row), past 2^24
    inter = ops.row_counts(fb, fb[1].contiguous())
    row_pop = ops.row_counts(fb)
    q_pop = row_pop[1:2].contiguous()
    key_cases = [(inter, row_pop, q_pop), (inter * 2**11 + 3, row_pop * 2**11 + 5, q_pop * 2**11 + 5),
                 (torch.zeros_like(inter), torch.zeros_like(inter), torch.zeros_like(q_pop))]
    for metric in ("tanimoto", "cosine"):
        for c in key_cases:
            got, want = sim.mesh_sim_keys(*c, metric), sim.mesh_sim_keys_plain(*c, metric)
            errs["mesh_sim_keys"] = max([errs["mesh_sim_keys"]] + [max_abs_err(torch, a, b) for a, b in zip(got, want)])
            for k in (1, 5, R_PAD):
                a_, b_ = sim.select_top(got[0], got[1], k), sim.select_top_plain(want[0], k)
                errs["sim_select"] = max(errs["sim_select"], max_abs_err(torch, a_[0].view(torch.int32), b_[0].view(torch.int32)),
                                         max_abs_err(torch, a_[1], b_[1]))
    # the big block's 4x2 all-pairs block: K11 inter, and K12's finish
    pa_b, pb_b = pairwise_out["a"], pairwise_out["b"]
    inter_p = sim.pairwise(pa_b, pb_b, "inter")
    errs["pairwise"] = max_abs_err(torch, inter_p.view(torch.int32), sim.pairwise_plain(pa_b, pb_b, "inter").view(torch.int32))
    a_pop = ops.row_counts(pa_b[:, None]).to(torch.float32)
    b_pop = ops.row_counts(pb_b[:, None]).to(torch.float32)
    inter2 = inter_p * 2  # a two-block sum's range
    for metric in ("tanimoto", "cosine"):
        for c in ((inter_p, a_pop, b_pop), (inter2, a_pop * 2, b_pop * 2)):
            errs["mesh_pairwise_finish"] = max(errs["mesh_pairwise_finish"], max_abs_err(
                torch, sim.mesh_pairwise_finish(*c, metric).view(torch.int32), sim.mesh_pairwise_finish_plain(*c, metric).view(torch.int32)))
    # the fused filters at the 4x2 blocks: the block's plan, as _filter
    # hands it to the aggregate, with ids -1 and >= R
    PF = ops.PlannedFilter  # noqa: N806
    mplane, tplane2 = (s_l, w_l), (ts_l, w_l)
    pf_head = PF([fb], [(0, 1), (0, 2)], [(L, 0), (L, 1), (A, 0)], [], *mplane)
    pf_not = PF([fb, eb], [(1, 0), (0, 3)], [(L, 0), (L, 1), (N, 0)], [], *mplane)
    pf_cab = PF([cab], [(0, 1)], [(L, 0)], [], *tplane2)
    pf_cond = PF([cab, tbm], [(0, 0)], [(L, 0), (C, 0), (A, 0)], [(1, D, ">=", -500)], *tplane2)
    pf_between = PF([tbm], [], [(C, 0), (C, 1), (A, 0)], [(0, D, ">=", 2000), (0, D, "<=", -500)], *tplane2)
    # all-ones and bit-31 words at the block shapes: rows and filters of
    # them, and a 12-plane BSI block (the rest of 2 + D read zero)
    edge_b = torch.full((2, s_l, w_l), -1, dtype=torch.int32, device=dev)
    edge_b[1].fill_(-(2**31))
    edge_t = torch.full((12, ts_l, w_l), -1, dtype=torch.int32, device=dev)
    for p in (1, 3, 6):
        edge_t[p].fill_(-(2**31))
    pf_edge = PF([edge_b, fb], [(0, 0), (0, 1), (1, 5)], [(L, 0), (L, 1), (X, 0), (L, 2), (O, 0)], [], *mplane)
    pf_ones, pf_high = (PF([edge_t], [(0, r)], [(L, 0)], [], *tplane2) for r in (2, 3))
    for m, pf, ii in ((fb, pf_head, None), (fb, pf_not, ids), (pc, pf_cond, None), (pc, pf_between, i32([1, -1, 16, 0])),
                      (edge_b, pf_edge, None), (pc, pf_high, None)):
        fused_check(torch, errs, "row_counts_tree", ops.row_counts(m, pf, ii),
                    topn.row_counts_plain(m, pf.plain(dev, tuple(m.shape[1:])), ii))
    for st, pf in ((tbm, pf_cab), (tbm, pf_cond), (tbm, pf_between), (tbm, pf_high), (edge_t, pf_ones), (edge_t, pf_high)):
        fused_check(torch, errs, "bsi_sum_tree", ops.bsi_sum(st, D, pf), bsi.bsi_sum_plain(st, D, pf.plain(dev, tplane2)[None]))
        for want_max in (False, True):
            fused_check(torch, errs, "bsi_minmax_tree", ops.bsi_min_max(st, D, pf, want_max),
                        bsi.bsi_min_max_plain(st, D, pf.plain(dev, tplane2), want_max))
    del edge_b, edge_t, pf_edge, pf_ones, pf_high
    log("max |kernel - plain| on the mesh path's 4x2 blocks:", json.dumps(errs))
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: {errs}")

    # --------------------------------------------------------- timings
    plane = s_l * w_l * 4
    tplane = ts_l * w_l * 4
    keys, hist = sim.mesh_sim_keys(inter, row_pop, q_pop, "tanimoto")
    scores = sim.mesh_pairwise_finish_plain(inter.to(torch.float32)[None], row_pop.to(torch.float32), q_pop.to(torch.float32), "tanimoto")[0]
    n_p, m_p, w_p = pa_b.shape[0], pb_b.shape[0], pa_b.shape[1]
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    int_mm = on_card and hasattr(torch, "_int_mm")

    def unpack8(t):
        bits = ((t[:, :, None] >> shifts) & 1).reshape(t.shape[0], -1)
        return bits.to(torch.int8) if int_mm else bits.to(torch.bfloat16)

    a8, b8 = unpack8(pa_b), unpack8(pb_b)
    mm = (lambda: torch._int_mm(a8, b8.t())) if int_mm else (lambda: torch.matmul(a8, b8.t()))
    keep = (didx[:, 0] >= 0) & (didx[:, 0] < R_PAD) & (didx[:, 1] >= 0) & (didx[:, 1] < s_l)
    r_ok, s_ok, rows_ok = didx[keep, 0].long(), didx[keep, 1].long(), drows[keep]
    times["pairwise_block_int8_ops_ms"] = ops_ms(2 * n_p * m_p * w_p * 32)
    block = f"4x2 block [{R_PAD}, {s_l}, {w_l}]"
    results = {
        "tree_eval": dict(
            ms=cuda_ms(torch, lambda: ops.tree_eval([fb], [(0, 1), (0, 2)], [(L, 0), (L, 1), (A, 0)], s_l, True, device=dev, n_words=w_l), 20),
            plain_ms=cuda_ms(torch, lambda: bitwise.tree_eval_plain([fb], [(0, 1), (0, 2)], [(L, 0), (L, 1), (A, 0)], s_l, True, dev, (), w_l), 2),
            bound_ms=bound_ms(2 * plane), library_ms=None, shape=f"count, Intersect, {block}",
            graph_ms=graph_ms(torch, lambda: ops.tree_eval([fb], [(0, 1), (0, 2)], [(L, 0), (L, 1), (A, 0)], s_l, True,
                                                           device=dev, n_words=w_l), 20),
            replaces="pilosa_tpu/parallel/mesh.py:388"),
        "row_counts": dict(
            ms=cuda_ms(torch, lambda: ops.row_counts(fb), 10), plain_ms=cuda_ms(torch, lambda: topn.row_counts_plain(fb), 1),
            bound_ms=bound_ms(R_PAD * plane), library_ms=None, shape=f"TopN, {block}",
            replaces="pilosa_tpu/parallel/mesh.py:399"),
        "stack_delta": dict(
            ms=cuda_ms(torch, lambda: ops.apply_stack_delta(fb, didx, drows), 5),
            plain_ms=cuda_ms(torch, lambda: stack.apply_stack_delta_plain(fb, didx, drows), 2),
            bound_ms=bound_ms(2 * fb.numel() * 4 + int(keep.sum()) * w_l * 4 + didx.numel() * 4),
            library_ms=cuda_ms(torch, lambda: torch.index_put(fb, (r_ok, s_ok), rows_ok), 5), shape=f"delta, {block}",
            graph_ms=graph_ms(torch, lambda: ops.apply_stack_delta(fb, didx, drows), 5),
            library_graph_ms=graph_ms(torch, lambda: torch.index_put(fb, (r_ok, s_ok), rows_ok), 5),
            replaces="pilosa_tpu/executor/compile.py:194"),
        "bsi_sum": dict(
            ms=cuda_ms(torch, lambda: ops.bsi_sum(tbm, D), 20), plain_ms=cuda_ms(torch, lambda: bsi.bsi_sum_plain(tbm, D), 2),
            bound_ms=bound_ms((2 + D) * tplane), library_ms=None, shape=f"Sum, 4x2 block [32, {ts_l}, {w_l}]",
            replaces="pilosa_tpu/parallel/mesh.py:440"),
        "bsi_sum grouped": dict(
            ms=cuda_ms(torch, lambda: ops.bsi_sum(tbm, D, masks16), 20),
            plain_ms=cuda_ms(torch, lambda: bsi.bsi_sum_plain(tbm, D, masks16), 1),
            bound_ms=bound_ms((2 + D + 16) * tplane), library_ms=None,
            shape=f"grouped, 16 masks x 4x2 block [{2 + D}, {ts_l}, {w_l}]", replaces="pilosa_tpu/parallel/mesh.py:471"),
        "bsi_minmax": dict(
            ms=cuda_ms(torch, lambda: ops.bsi_min_max(tbm, D, None, False), 20),
            plain_ms=cuda_ms(torch, lambda: bsi.bsi_min_max_plain(tbm, D, None, False), 2),
            bound_ms=bound_ms((2 + D) * tplane), library_ms=None, shape=f"Min, 4x2 block [32, {ts_l}, {w_l}]",
            replaces="pilosa_tpu/parallel/mesh.py:486"),
        "gb_counts": dict(
            ms=cuda_ms(torch, lambda: ops.gb_counts(masks4, pc, rows16), 20),
            plain_ms=cuda_ms(torch, lambda: groupby.gb_counts_plain(masks4, pc, rows16), 2),
            bound_ms=bound_ms((4 + 10) * tplane), library_ms=None, shape="4 masks x 10 rows, 4x2 block",
            replaces="pilosa_tpu/parallel/mesh.py:527"),
        "gb_masks": dict(
            ms=cuda_ms(torch, lambda: ops.gb_masks(ones, pc, i32([0] * 16), rows16), 10),
            plain_ms=cuda_ms(torch, lambda: groupby.gb_masks_plain(ones, pc, i32([0] * 16), rows16), 2),
            bound_ms=bound_ms((1 + 10 + 16) * tplane), library_ms=None, shape="1 + 10 -> 16 masks, 4x2 block",
            replaces="pilosa_tpu/parallel/mesh.py:542"),
        "sim_select": dict(
            ms=cuda_ms(torch, lambda: sim.select_top(keys, hist, 5), 20), plain_ms=cuda_ms(torch, lambda: sim.select_top_plain(keys, 5), 20),
            bound_ms=bound_ms(R_PAD * 8 + 5 * 8), library_ms=cuda_ms(torch, lambda: torch.topk(scores, 5), 20),
            graph_ms=graph_ms(torch, lambda: sim.select_top(keys, hist, 5), 20),
            library_graph_ms=graph_ms(torch, lambda: torch.topk(scores, 5), 20),
            shape=f"k = 5 of the search's {R_PAD} keys", replaces="pilosa_tpu/parallel/mesh.py:690"),
        "pairwise": dict(
            ms=cuda_ms(torch, lambda: sim.pairwise(pa_b, pb_b, "inter"), 10),
            plain_ms=cuda_ms(torch, lambda: sim.pairwise_plain(pa_b, pb_b, "inter"), 2),
            bound_ms=bound_ms((n_p + m_p) * w_p * 4 + n_p * m_p * 4), bound_by="bytes",
            library_ms=cuda_ms(torch, mm, 10), shape=f"inter, [{n_p}, {w_p}] x [{m_p}, {w_p}]",
            graph_ms=graph_ms(torch, lambda: sim.pairwise(pa_b, pb_b, "inter"), 10),
            library_graph_ms=graph_ms(torch, mm, 10),
            replaces="pilosa_tpu/parallel/mesh.py:786"),
        "mesh_sim_keys": dict(
            ms=cuda_ms(torch, lambda: sim.mesh_sim_keys(inter, row_pop, q_pop, "tanimoto"), 20),
            plain_ms=cuda_ms(torch, lambda: sim.mesh_sim_keys_plain(inter, row_pop, q_pop, "tanimoto"), 20),
            bound_ms=bound_ms(3 * R_PAD * 8 + 8 + sim.SELECT_BINS * 4), library_ms=None,
            shape=f"{R_PAD} rows"),
        "mesh_pairwise_finish": dict(
            ms=cuda_ms(torch, lambda: sim.mesh_pairwise_finish(inter_p, a_pop, b_pop, "tanimoto"), 10),
            plain_ms=cuda_ms(torch, lambda: sim.mesh_pairwise_finish_plain(inter_p, a_pop, b_pop, "tanimoto"), 2),
            bound_ms=bound_ms(2 * n_p * m_p * 4 + (n_p + m_p) * 4), library_ms=None, shape=f"Tanimoto, [{n_p}, {m_p}]"),
        # the fused filters per block: the rows or planes and the filter's
        # leaf planes, each read once
        "row_counts_tree": dict(
            ms=cuda_ms(torch, lambda: ops.row_counts(fb, pf_head), 10),
            plain_ms=cuda_ms(torch, lambda: topn.row_counts_plain(fb, pf_head.plain(dev, mplane)), 1),
            bound_ms=bound_ms(R_PAD * plane + fused_plan_bytes(pf_head, plane, (fb,))), library_ms=None,
            shape=f"rows+tree under Intersect, {block}", replaces="pilosa_tpu/parallel/mesh.py:399"),
        "bsi_sum_tree": dict(
            ms=cuda_ms(torch, lambda: ops.bsi_sum(tbm, D, pf_cab), 20),
            plain_ms=cuda_ms(torch, lambda: bsi.bsi_sum_plain(tbm, D, pf_cab.plain(dev, tplane2)[None]), 2),
            bound_ms=bound_ms((2 + D) * tplane + fused_plan_bytes(pf_cab, tplane)), library_ms=None,
            shape=f"one+tree under Row(cab_type=1), 4x2 block [32, {ts_l}, {w_l}]", replaces="pilosa_tpu/parallel/mesh.py:440"),
        "bsi_minmax_tree": dict(
            ms=cuda_ms(torch, lambda: ops.bsi_min_max(tbm, D, pf_cab, True), 20),
            plain_ms=cuda_ms(torch, lambda: bsi.bsi_min_max_plain(tbm, D, pf_cab.plain(dev, tplane2), True), 2),
            bound_ms=bound_ms((2 + D) * tplane + fused_plan_bytes(pf_cab, tplane)), library_ms=None,
            shape=f"max+tree under Row(cab_type=1), 4x2 block [32, {ts_l}, {w_l}]", replaces="pilosa_tpu/parallel/mesh.py:486"),
    }
    times["sim_select_k5_library"] = "torch.topk of the f32 scores"
    times["pairwise_library"] = "torch._int_mm int8" if int_mm else "torch.matmul bf16"
    one = {"count": main["p50"]["count"], "topn": main["p50"]["topn"], "sum": taxi["p50"]["sum"], "groupby": taxi["p50"]["groupby"]}
    times["one_device_p50_ms"] = one
    times["one_device_count_split"], times["one_device_count_profiled"] = main["count_split"], main["count_profiled"]
    log("mesh times:", json.dumps(times))
    for key, ms in one.items():
        log(f"sync p50 {key}: one device {ms:.3f} ms, mesh 8x1 {times['8x1_' + key + '_p50_ms']:.3f} ms, "
            f"mesh 4x2 {times['4x2_' + key + '_p50_ms']:.3f} ms")
    del block_inputs, pairwise_out
    free()
    return {n: (errs[n.split()[0]], t) for n, t in results.items()}, launches


GRAFT_SEED = 6  # the graft step's delta and filter
GRAFT_K = 4  # entry()'s top_k
DELTA_SHARE = 100  # one word in DELTA_SHARE of the delta is non-zero


def graft_matrix(torch, blocks: list, n_shards: int, device: str):
    """int32[R_PAD, S, W] on ``device``: the main recipe's blocks, block
    s % G at shard s (bench.py:118-137, as the main path's stack)."""
    blk = torch.from_numpy(np.stack(blocks).view(np.int32)).to(device)
    sel = torch.arange(n_shards, device=device) % len(blocks)
    return blk.permute(1, 0, 2)[:, sel].contiguous()


def graft_delta(torch, shape: tuple, device: str):
    """(delta int32[R, S, W], filter int32[S, W]) from GRAFT_SEED: one
    word in DELTA_SHARE set to random bits, all-ones words in row 2 and
    high-bit (0x80000000) words in row 5; a random filter."""
    gen = torch.Generator(device=device)
    gen.manual_seed(GRAFT_SEED)
    delta = torch.zeros(shape, dtype=torch.int32, device=device)
    pos = torch.randint(0, delta.numel(), (delta.numel() // DELTA_SHARE,), generator=gen, device=device)
    delta.view(-1)[pos] = torch.randint(-(2**31), 2**31 - 1, (pos.numel(),), dtype=torch.int32, generator=gen, device=device)
    del pos
    delta[2, :, ::5] = -1
    delta[5, :, 3::7] = -(2**31)
    filt = torch.randint(-(2**31), 2**31 - 1, shape[1:], dtype=torch.int32, generator=gen, device=device)
    return delta, filt


def delta_vectors(torch, delta) -> int:
    """The 16 B vectors of ``delta`` with a bit set: the vectors K13
    writes back."""
    return sum(int((delta[r].view(-1, 4) != 0).any(dim=1).sum()) for r in range(delta.shape[0]))


def sync_p50_ms(torch, fn, reps: int = 10) -> float:
    """p50 host ms of ``fn`` with its readback (``fn`` ends in ``.cpu()``)."""
    fn()
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        lat.append(time.perf_counter() - t0)
    return float(np.median(lat)) * 1e3


def graft_path(torch, device: str, main: dict) -> tuple:
    """The graft step, __graft_entry__.py's ``entry()`` ``query_step``, on
    one device at the main cell's size: the main recipe's matrix
    int32[8, S, W] (10.7 GB at 10,240 shards), a write delta of the same
    shape and a filter (GRAFT_SEED). K13 ORs the delta in place and counts
    every row under the filter, with the total; K10's one-launch ``small
    int`` route takes the top 4 of the 8 counts. The counts, the total,
    the new matrix and the top 4 against the plain version on a copy made
    before the in-place call, and the top 4 against numpy's stable
    argsort; then ``select_top_counts`` (K10 small int, or K12's count keys
    and K10's tile and radix int routes) and K10 on count keys at 1, 8,
    4,096, 4,097 and 8,192 counts, with ties, -2^63 and 2^63 - 1. Returns
    the kernel entries, the launch counts and the arrays (the new matrix,
    the delta, the filter, the answers) for ``mesh_programs_path``."""
    from pilosa_tpu_torch import ops
    from pilosa_tpu_torch.ops import _cuda, topn
    from pilosa_tpu_torch.ops import similarity as sim

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    matrix = graft_matrix(torch, main["blocks"], len(main["shards"]), device)
    delta, filt = graft_delta(torch, tuple(matrix.shape), device)
    copy = matrix.clone()
    sync()
    times = {}
    # ------------------------------------------------------------ the step
    for k in _cuda.KERNELS.values():
        k.reset()
    t0 = time.perf_counter()
    new_m, counts, total = ops.ingest_counts(matrix, delta, filt)
    vals, ids = ops.select_top_counts(counts, GRAFT_K)
    vals, ids = vals.cpu(), ids.cpu()
    times["first_step_s"] = time.perf_counter() - t0
    sync()
    launches = {n: k.launches for n, k in _cuda.KERNELS.items()}
    log("launches on the graft step:", json.dumps(launches))
    log("launches on the graft step by mode:", json.dumps({n: k.modes for n, k in _cuda.KERNELS.items() if k.modes}))
    path_kernels = ("ingest_counts", "count_keys", "sim_select")
    want_launches = {"ingest_counts": 1, "count_keys": 0, "sim_select": 1}
    if on_card and ({n: launches[n] for n in path_kernels} != want_launches
                    or _cuda.SIM_SELECT.modes != {"small int": 1}):
        raise AssertionError(f"the graft step did not run K13 once and K10 small int once, no K12: {launches}")
    if new_m is not matrix:
        raise AssertionError("ingest_counts did not return the matrix it updated in place")
    # ---------------------------------------------- against the plain version
    errs = {n: 0 for n in path_kernels}
    _m, p_counts, p_total = topn.ingest_counts_plain(copy, delta, filt)
    errs["ingest_counts"] = max(max_abs_err(torch, matrix, copy), max_abs_err(torch, counts, p_counts),
                                abs(int(total) - int(p_total)))
    del copy, _m
    free()
    host = counts.cpu().numpy()
    order = np.argsort(-host, kind="stable")[:GRAFT_K]
    if ids.tolist() != order.tolist() or vals.tolist() != host[order].tolist() or int(total) != int(host.sum()):
        raise AssertionError(f"graft step top {GRAFT_K} {vals.tolist()} {ids.tolist()} != numpy {host[order].tolist()} {order.tolist()}")
    p_vals, p_ids = topn.select_top_counts_plain(p_counts, GRAFT_K)
    errs["sim_select"] = max(max_abs_err(torch, vals, p_vals.cpu()), max_abs_err(torch, ids, p_ids.cpu()))
    keys, hist = sim.count_keys(counts)
    p_keys, p_hist = sim.count_keys_plain(counts)
    errs["count_keys"] = max(max_abs_err(torch, keys, p_keys), max_abs_err(torch, hist, p_hist))
    # K12 and K10's int modes: ties at R = 8; 4,097 keys with ties, k up to
    # K10's shared-memory tile (4,096) and past it (its radix sort)
    gen = torch.Generator(device=device)
    gen.manual_seed(GRAFT_SEED + 1)
    ties = torch.tensor([5, 9, 9, 0, 3, 9, 1 << 40, 0], dtype=torch.int64, device=device)
    many = torch.randint(0, 64, (4097,), generator=gen, device=device) << 30
    # counts where a key of count << b | row would pass 62 bits: 2^(62 - b)
    # and 2^62 - 1 with ties at the k-th value, up to 2^63 - 1, and
    # negative counts, all to the plain version (lax.top_k's order)
    b8, b4097 = sim.count_key_bits(8), sim.count_key_bits(4097)
    big = torch.tensor([1 << (62 - b8), (1 << 62) - 1, 1 << (62 - b8), 7, (1 << 62) - 1, 1 << (62 - b8), -1, 2**63 - 1],
                       dtype=torch.int64, device=device)
    wide = torch.randint(0, 4, (4097,), generator=gen, device=device) * (1 << (62 - b4097))
    wide[torch.randint(0, 4097, (64,), generator=gen, device=device)] = (1 << 62) - 1
    wide[:8] = -(2**63)
    # K10's small route at 1 and 4,096 counts (ties, -2^63, 2^63 - 1), and
    # select_top_counts past it: 8,192 counts, K12 then K10's tile and
    # radix int routes
    one = torch.tensor([-(2**63)], dtype=torch.int64, device=device)
    full = torch.randint(-3, 4, (4096,), generator=gen, device=device) << 40
    full[torch.randint(0, 4096, (64,), generator=gen, device=device)] = 2**63 - 1
    full[:8] = -(2**63)
    past = torch.randint(0, 64, (8192,), generator=gen, device=device) << 50
    past[torch.randint(0, 8192, (16,), generator=gen, device=device)] = -(2**63)
    past[-5:] = 2**63 - 1
    cases = ((ties, (1, 4, 8)), (many, (5, 4096, 4097)), (big, (1, 2, 3, 4, 5, 8)), (wide, (1, 63, 64, 65, 4097)),
             (one, (1,)), (full, (1, 64, 65, 4096)), (past, (1, 4, 4096, 4097, 8192)))
    for c, ks in cases:
        kk, hh = sim.count_keys(c)
        pk, ph = sim.count_keys_plain(c)
        errs["count_keys"] = max(errs["count_keys"], max_abs_err(torch, kk, pk), max_abs_err(torch, hh, ph))
        b = sim.count_key_bits(c.shape[0])
        for k in ks:
            for got, want in ((sim.select_top(kk, hh, k, b), sim.select_top_plain(pk, k, b)),
                              (topn.select_top_counts(c, k), topn.select_top_counts_plain(c, k))):
                errs["sim_select"] = max(errs["sim_select"], max_abs_err(torch, got[0], want[0]),
                                         max_abs_err(torch, got[1], want[1]))
    log("max |kernel - plain| on the graft step:", json.dumps(errs))
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: {errs}")
    log(f"ok  graft step: K13 in place, total {int(total)}, top {GRAFT_K} {vals.tolist()} at rows {ids.tolist()}")

    # --------------------------------------------------------- timings
    mbytes, fbytes = matrix.numel() * 4, filt.numel() * 4
    written = delta_vectors(torch, delta) * 16
    # the matrix and the delta read once, the filter once, the vectors with a
    # delta bit written; the whole matrix written is the data-blind bound
    k13_bound, k13_bound_all = bound_ms(2 * mbytes + fbytes + written), bound_ms(3 * mbytes + fbytes)
    n = counts.shape[0]
    results = {
        "ingest_counts": dict(
            ms=cuda_ms(torch, lambda: ops.ingest_counts(matrix, delta, filt), 5),
            plain_ms=cuda_ms(torch, lambda: topn.ingest_counts_plain(matrix, delta, filt), 1),
            bound_ms=k13_bound, library_ms=None, shape=f"[{n}, {matrix.shape[1]}, {matrix.shape[2]}]",
            replaces="__graft_entry__.py:65"),
        # K12's keys now serve only a top-k past 4,096 counts
        "count_keys": dict(
            ms=cuda_ms(torch, lambda: sim.count_keys(past), 20), plain_ms=cuda_ms(torch, lambda: sim.count_keys_plain(past), 20),
            bound_ms=bound_ms(2 * past.numel() * 8 + sim.SELECT_BINS * 4), library_ms=None,
            shape=f"{past.numel()} counts (a top-k past 4,096 counts)", replaces="__graft_entry__.py:71"),
        "sim_select": dict(
            ms=cuda_ms(torch, lambda: ops.select_top_counts(counts, GRAFT_K), 20),
            plain_ms=cuda_ms(torch, lambda: topn.select_top_counts_plain(counts, GRAFT_K), 20),
            bound_ms=bound_ms(n * 8 + GRAFT_K * 12), library_ms=cuda_ms(torch, lambda: torch.topk(counts, GRAFT_K), 20),
            graph_ms=graph_ms(torch, lambda: ops.select_top_counts(counts, GRAFT_K), 20),
            library_graph_ms=graph_ms(torch, lambda: torch.topk(counts, GRAFT_K), 20),
            shape=f"small int, k = {GRAFT_K} of {n} counts, one launch", replaces="__graft_entry__.py:71"),
    }
    or_ms = cuda_ms(torch, lambda: matrix.bitwise_or_(delta), 5)
    times.update({
        "ingest_counts_bound_all_written_ms": k13_bound_all,
        "delta_bytes_written": written,
        "bitwise_or_ms (Tensor.bitwise_or_ of the same pair: not the same function)": or_ms,
        "step_sync_p50_ms": sync_p50_ms(torch, lambda: ops.select_top_counts(ops.ingest_counts(matrix, delta, filt)[1], GRAFT_K)[1].cpu()),
        "ingest_sync_p50_ms": sync_p50_ms(torch, lambda: ops.ingest_counts(matrix, delta, filt)[2].cpu()),
    })
    t = results["ingest_counts"]
    log(f"K13 ingest_counts {t['shape']}: {t['ms']:.4f} ms, bound {k13_bound:.4f} ms with this delta's writes "
        f"({100 * k13_bound / t['ms']:.1f} %), {k13_bound_all:.4f} ms with the whole matrix written "
        f"({100 * k13_bound_all / t['ms']:.1f} %); plain {t['plain_ms']:.4f} ms; "
        f"Tensor.bitwise_or_ alone (not the same function) {or_ms:.4f} ms")
    log("graft times:", json.dumps(times))
    answers = {"counts": counts, "total": int(total), "vals": vals.tolist(), "ids": ids.tolist(), "ingest_p50_ms": times["ingest_sync_p50_ms"]}
    return {n: (errs[n], t) for n, t in results.items()}, launches, {
        "matrix": matrix, "delta": delta, "filt": filt, "answers": answers}


def mesh_programs_path(torch, device: str, graft: dict, main: dict, taxi: dict) -> tuple:
    """__graft_entry__.py's ``dryrun_multichip`` sequence (:147-162) over
    MESH_POSITIONS positions in the 8x1 and 4x2 layouts, at full size, on
    fresh placed copies: ``ingest_and_aggregate`` of the graft step's
    arrays (the main recipe's matrix as it was, the delta, the filter),
    ``topn(new_m, filt, 4)``, ``bsi_sum`` of the taxi holder's
    total_amount slices under ``cab_type=1``, ``count_and`` of rows 0 and
    1, ``tanimoto(new_m, filt, 4)``. Every answer equal to the one-device
    answer (the graft step's, or K2's, K4's and the one-device search's),
    the Tanimoto scores bit for bit; each program's sync p50 beside the
    one-device p50 of the same work; ``top_rows`` of one fragment against
    numpy. The launch counts start after the one-device work and must be
    the programs' exact counts. Then K13 (on block (0, 0) as it was before
    the ingest), K2, K4, K1, K12's mesh_sim_keys and K10's small int
    route at the 4x2 blocks against their plain versions. Returns the
    kernel entries and the path's launch counts."""
    from pilosa_tpu_torch import ops
    from pilosa_tpu_torch.core import VIEW_BSI
    from pilosa_tpu_torch.ops import _cuda, bitwise, bsi, topn
    from pilosa_tpu_torch.ops import similarity as sim
    from pilosa_tpu_torch.parallel import MeshQueryEngine, make_mesh
    from pilosa_tpu_torch.server import API

    on_card = device == "cuda"
    n_cards = torch.cuda.device_count() if on_card else 1
    devices = [torch.device("cuda", i % n_cards) if on_card else "cpu" for i in range(MESH_POSITIONS)]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    matrix, delta, filt, ans = graft.pop("matrix"), graft["delta"], graft["filt"], graft["answers"]
    th, tidx = taxi["holder"], taxi["index"]
    t_shards = sorted(tidx.available_shards())
    times = {}
    # ------------------------------------------------ the one-device work
    # the taxi holder's total_amount slices and its cab_type=1 row, copied
    # out of a one-device stack cache
    tstacks = API(th, device=device, route_mode="device").executor.compiler.stacks
    slices = tstacks.matrix(tidx, tidx.field("total_amount"), VIEW_BSI, t_shards)[0].clone()
    cab1 = tstacks.matrix(tidx, tidx.field("cab_type"), "standard", t_shards)[0][1].clone()
    del tstacks
    free()
    load = [(bitwise.OP_LOAD, 0)]
    n_s, n_w = filt.shape

    def one_search():
        inter, pop = ops.row_counts(matrix, filt), ops.row_counts(matrix)
        q_pop = ops.tree_eval([filt[None]], [(0, 0)], load, n_s, count=True, n_words=n_w).reshape(1)
        return sim.select_top(*sim.mesh_sim_keys(inter, pop, q_pop, "tanimoto"), GRAFT_K)

    one = {
        "sum": tuple(int(x) for x in ops.sum_device(slices, cab1)),
        "count_and": int(ops.count_and(matrix[0], matrix[1])),
        "tanimoto": tuple(x.cpu() for x in one_search()),
    }
    sum_want = next(w for q, w in taxi["checks"] if q == "Sum(Row(cab_type=1), field=total_amount)")
    if one["sum"] != (sum_want["value"], sum_want["count"]):
        raise AssertionError(f"one-device sum_device {one['sum']} != numpy {sum_want}")
    # top_rows, the one-fragment twin of topn, on shard 0 against numpy
    frag, frag_f = matrix[:, 0].cpu().numpy().view(np.uint32), filt[0].cpu().numpy().view(np.uint32)
    frag_counts = np.bitwise_count(frag & frag_f[None]).sum(axis=1)
    order = np.argsort(-frag_counts, kind="stable")[:GRAFT_K]
    f_vals, f_ids = ops.top_rows(matrix[:, 0], filt[0], GRAFT_K)
    if f_ids.tolist() != order.tolist() or f_vals.tolist() != frag_counts[order].tolist():
        raise AssertionError(f"top_rows {f_vals.tolist()} {f_ids.tolist()} != numpy {frag_counts[order].tolist()} {order.tolist()}")
    log(f"ok  top_rows of shard 0 under the filter  -> {f_vals.tolist()} at rows {f_ids.tolist()}, as numpy's")
    one_p50 = {
        "ingest_and_aggregate": ans["ingest_p50_ms"],
        "topn": sync_p50_ms(torch, lambda: ops.select_top_counts(ops.row_counts(matrix, filt), GRAFT_K)[1].cpu()),
        "bsi_sum": sync_p50_ms(torch, lambda: ops.sum_device(slices, cab1)[0].cpu()),
        "count_and": sync_p50_ms(torch, lambda: ops.count_and(matrix[0], matrix[1]).cpu()),
        "tanimoto": sync_p50_ms(torch, lambda: one_search()[1].cpu()),
    }
    n_rows, blocks4 = matrix.shape[0], {}
    del matrix
    free()
    # ------------------------------------------------------ the mesh programs
    # the counts start here: the one-device work above launched K1, K2, K4,
    # K10 and K12 too
    sync()
    for k in _cuda.KERNELS.values():
        k.reset()
    for name, words_axis in MESH_LAYOUTS:
        eng = MeshQueryEngine(make_mesh(devices, words_axis=words_axis))
        t0 = time.perf_counter()
        orig = graft_matrix(torch, main["blocks"], len(main["shards"]), devices[0])
        m_dev = eng.place_matrix(orig)
        if words_axis > 1:
            # block (0, 0) as it was before the ingest, for K13's check
            s_lo, s_hi, w_lo, w_hi = m_dev.cover(0, 0)
            blocks4["m"] = orig[:, s_lo:s_hi, w_lo:w_hi].contiguous()
        del orig
        d_dev, f_dev = eng.place_matrix(delta), eng.place_row(filt)
        s_dev, c_dev = eng.place_matrix(slices), eng.place_row(cab1)
        sync()
        times[f"{name}_place_s"] = time.perf_counter() - t0
        new_m, counts, total = eng.ingest_and_aggregate(m_dev, d_dev, f_dev)
        if new_m is not m_dev or not torch.equal(counts.cpu(), ans["counts"].cpu()) or int(total) != ans["total"]:
            raise AssertionError(f"{name}: ingest_and_aggregate differs from the graft step's: total {int(total)} != {ans['total']}")
        log(f"ok  mesh programs {name}: ingest_and_aggregate in place, total {int(total)}, counts equal to the one-device K13's")
        vals, ids = eng.topn(new_m, f_dev, GRAFT_K)
        if vals.tolist() != ans["vals"] or ids.tolist() != ans["ids"]:
            raise AssertionError(f"{name}: topn {vals.tolist()} {ids.tolist()} != one device {ans['vals']} {ans['ids']}")
        log(f"ok  mesh programs {name}: topn  -> {vals.tolist()} at rows {ids.tolist()}")
        got_sum = tuple(int(x) for x in eng.bsi_sum(s_dev, c_dev))
        if got_sum != one["sum"]:
            raise AssertionError(f"{name}: bsi_sum {got_sum} != one-device K4 {one['sum']}")
        log(f"ok  mesh programs {name}: bsi_sum of total_amount under cab_type=1  -> {got_sum}")
        pair = int(eng.count_and(new_m.row(0), new_m.row(1)))
        if pair != one["count_and"]:
            raise AssertionError(f"{name}: count_and {pair} != one-device K2 {one['count_and']}")
        log(f"ok  mesh programs {name}: count_and of rows 0 and 1  -> {pair}")
        ts, ti = eng.tanimoto(new_m, f_dev, GRAFT_K)
        if not (torch.equal(ts.cpu().view(torch.int32), one["tanimoto"][0].view(torch.int32)) and torch.equal(ti.cpu(), one["tanimoto"][1])):
            raise AssertionError(f"{name}: tanimoto {ts.tolist()} {ti.tolist()} != one device {one['tanimoto']}")
        log(f"ok  mesh programs {name}: tanimoto  -> ids {ti.tolist()}, bit for bit with the one-device search")
        for prog, fn in (
            ("ingest_and_aggregate", lambda: eng.ingest_and_aggregate(m_dev, d_dev, f_dev)[2].cpu()),
            ("topn", lambda: eng.topn(new_m, f_dev, GRAFT_K)[1].cpu()),
            ("bsi_sum", lambda: eng.bsi_sum(s_dev, c_dev)[0].cpu()),
            ("count_and", lambda: eng.count_and(new_m.row(0), new_m.row(1)).cpu()),
            ("tanimoto", lambda: eng.tanimoto(new_m, f_dev, GRAFT_K)[1].cpu()),
        ):
            times[f"{name}_{prog}_p50_ms"] = sync_p50_ms(torch, fn)
        log(f"mesh programs {name} engine:", json.dumps(eng.snapshot()))
        if words_axis > 1:
            blocks4.update(d=d_dev.blocks[0][0], f=f_dev.blocks[0][0], s=s_dev.blocks[0][0], c=c_dev.blocks[0][0])
        del eng, new_m, m_dev, d_dev, f_dev, s_dev, c_dev, counts, total
        free()
    sync()
    launches = {n: k.launches for n, k in _cuda.KERNELS.items()}
    log("launches on the mesh programs path:", json.dumps(launches))
    log("launches on the mesh programs path by mode:", json.dumps({n: k.modes for n, k in _cuda.KERNELS.items() if k.modes}))
    path_kernels = ("ingest_counts", "row_counts", "bsi_sum", "tree_eval", "sim_select", "mesh_sim_keys")
    # each program runs 12 times a layout (the checked call, the p50's
    # warm-up and ten): K13, K4 and K1 once a block, K2 four times a block
    # (topn, count_and, and the search's |a ∩ q| and |a|), K12 and K10 on
    # the lead device: one K10 small int launch a topn (no count_keys), and
    # mesh_sim_keys and one K10 small launch a search
    calls = len(MESH_LAYOUTS) * (1 + 1 + 10)
    per_block = calls * MESH_POSITIONS
    want_launches = {n: 0 for n in launches}
    want_launches.update(ingest_counts=per_block, row_counts=4 * per_block, bsi_sum=per_block, tree_eval=per_block,
                mesh_sim_keys=calls, sim_select=2 * calls)
    want_modes = {"row_counts": {"filtered": 3 * per_block, "rows": per_block},
                  "sim_select": {"small int": calls, "small": calls}}
    if on_card and (launches != want_launches or any(_cuda.KERNELS[n].modes != m for n, m in want_modes.items())):
        raise AssertionError(f"the mesh programs did not launch their kernels once a block: {launches} != {want_launches}")
    for prog, ms in one_p50.items():
        log(f"sync p50 {prog}: one device {ms:.3f} ms, mesh 8x1 {times['8x1_' + prog + '_p50_ms']:.3f} ms, "
            f"mesh 4x2 {times['4x2_' + prog + '_p50_ms']:.3f} ms")

    # ----------------------------------- kernels vs plain versions, 4x2 blocks
    mb, db, fb, sb, cb = (blocks4[k] for k in ("m", "d", "f", "s", "c"))
    s_l, w_l = fb.shape
    depth = sb.shape[0] - bsi.OFFSET_ROW
    if not bool((db & ~mb).any()):
        raise AssertionError("the 4x2 block's delta adds no bit to it: K13's check would test nothing")
    m1, m2 = mb, mb.clone()
    got, want = ops.ingest_counts(m1, db, fb), topn.ingest_counts_plain(m2, db, fb)
    errs = {n: 0 for n in path_kernels}
    errs["ingest_counts"] = max(max_abs_err(torch, m1, m2), max_abs_err(torch, got[1], want[1]), abs(int(got[2]) - int(want[2])))
    errs["row_counts"] = max_abs_err(torch, ops.row_counts(m1, fb), topn.row_counts_plain(m1, fb))
    errs["bsi_sum"] = max(max_abs_err(torch, a, b) for a, b in zip(ops.bsi_sum(sb, depth, cb[None]), bsi.bsi_sum_plain(sb, depth, cb[None])))
    q_block = fb[None]
    errs["tree_eval"] = max_abs_err(torch, ops.tree_eval([q_block], [(0, 0)], load, s_l, count=True, n_words=w_l),
                                    bitwise.tree_eval_plain([q_block], [(0, 0)], load, s_l, True, fb.device, (), w_l))
    counts4 = ops.row_counts(m1, fb)
    pop4 = ops.row_counts(m1)
    q4 = pop4[1:2].contiguous()
    errs["sim_select"] = max(max_abs_err(torch, a, b) for a, b in zip(
        ops.select_top_counts(counts4, GRAFT_K), topn.select_top_counts_plain(counts4, GRAFT_K)))
    errs["mesh_sim_keys"] = max(max_abs_err(torch, a, b) for a, b in zip(
        sim.mesh_sim_keys(counts4, pop4, q4, "tanimoto"), sim.mesh_sim_keys_plain(counts4, pop4, q4, "tanimoto")))
    log("max |kernel - plain| on the mesh programs' 4x2 blocks:", json.dumps(errs))
    if any(errs.values()):
        raise AssertionError(f"a kernel disagrees with its plain version: {errs}")

    # --------------------------------------------------------- timings
    plane, splane = s_l * w_l * 4, sb.shape[1] * w_l * 4
    block = f"4x2 block [{n_rows}, {s_l}, {w_l}]"
    # K13 writes every vector with a delta bit, whether or not the block
    # holds it already: a repeat on the ingested block moves the first
    # call's bytes
    results = {
        "ingest_counts": dict(
            ms=cuda_ms(torch, lambda: ops.ingest_counts(m1, db, fb), 10),
            plain_ms=cuda_ms(torch, lambda: topn.ingest_counts_plain(m2, db, fb), 1),
            bound_ms=bound_ms(2 * mb.numel() * 4 + plane + delta_vectors(torch, db) * 16), library_ms=None,
            shape=block, replaces="pilosa_tpu/parallel/mesh.py:873"),
        "row_counts": dict(
            ms=cuda_ms(torch, lambda: ops.row_counts(m1, fb), 10), plain_ms=cuda_ms(torch, lambda: topn.row_counts_plain(m1, fb), 1),
            bound_ms=bound_ms((n_rows + 1) * plane), library_ms=None, shape=f"topn, filtered, {block}",
            replaces="pilosa_tpu/parallel/mesh.py:642"),
        "bsi_sum": dict(
            ms=cuda_ms(torch, lambda: ops.bsi_sum(sb, depth, cb[None]), 10),
            plain_ms=cuda_ms(torch, lambda: bsi.bsi_sum_plain(sb, depth, cb[None]), 1),
            bound_ms=bound_ms((sb.shape[0] + 1) * splane), library_ms=None,
            shape=f"bsi_sum, filtered, 4x2 block [{sb.shape[0]}, {sb.shape[1]}, {w_l}]", replaces="pilosa_tpu/parallel/mesh.py:841"),
        "tree_eval": dict(
            ms=cuda_ms(torch, lambda: ops.tree_eval([q_block], [(0, 0)], load, s_l, count=True, n_words=w_l), 20),
            plain_ms=cuda_ms(torch, lambda: bitwise.tree_eval_plain([q_block], [(0, 0)], load, s_l, True, fb.device, (), w_l), 2),
            bound_ms=bound_ms(plane), library_ms=None, shape=f"count of the query, 4x2 block [{s_l}, {w_l}]",
            graph_ms=graph_ms(torch, lambda: ops.tree_eval([q_block], [(0, 0)], load, s_l, count=True, n_words=w_l), 20),
            replaces="pilosa_tpu/parallel/mesh.py:677"),
        "sim_select": dict(
            ms=cuda_ms(torch, lambda: ops.select_top_counts(counts4, GRAFT_K), 20),
            plain_ms=cuda_ms(torch, lambda: topn.select_top_counts_plain(counts4, GRAFT_K), 20),
            bound_ms=bound_ms(n_rows * 8 + GRAFT_K * 12), library_ms=cuda_ms(torch, lambda: torch.topk(counts4, GRAFT_K), 20),
            graph_ms=graph_ms(torch, lambda: ops.select_top_counts(counts4, GRAFT_K), 20),
            library_graph_ms=graph_ms(torch, lambda: torch.topk(counts4, GRAFT_K), 20),
            shape=f"small int, k = {GRAFT_K} of {n_rows} counts, one launch", replaces="pilosa_tpu/parallel/mesh.py:650"),
        "mesh_sim_keys": dict(
            ms=cuda_ms(torch, lambda: sim.mesh_sim_keys(counts4, pop4, q4, "tanimoto"), 20),
            plain_ms=cuda_ms(torch, lambda: sim.mesh_sim_keys_plain(counts4, pop4, q4, "tanimoto"), 20),
            bound_ms=bound_ms(3 * n_rows * 8 + 8 + sim.SELECT_BINS * 4), library_ms=None, shape=f"{n_rows} rows"),
    }
    times["one_device_p50_ms"] = one_p50
    log("mesh programs times:", json.dumps(times))
    del blocks4, mb, db, fb, sb, cb, m1, m2, slices, cab1
    free()
    return {n: (errs[n], t) for n, t in results.items()}, launches


S_VMAX = 63  # the serving holder's int field v: values 0-63, depth 6
S_CONDS = 17  # one past K1's condition table


def serving_path(torch, device: str, main: dict) -> tuple:
    """The HTTP server on the card: ``Server(config, device)`` on a temp
    data dir and 127.0.0.1:0, the main path's 64 blocks injected into
    its holder over the same shards with an int field v, and PQL sent
    over HTTP/JSON: the headline Count, TopN plain and filtered, one
    tree past each of K1's fixed limits (C4: 17 BSI conditions, a stack
    33 deep, 300 leaves), a Set then the Count (K3's delta), and the
    /import-roaring and /import-value routes each followed by a Count or
    Sum, every answer against numpy with the kernels each query must
    launch (result cache off); the C4 trees again in K1's words and
    count modes and under a fused-filter TopN, through the server's
    compiler; then the latencies: HTTP sync p50 beside ``API.query``'s,
    64 Counts from 8 keep-alive clients, the device busy share of an
    HTTP Count, cache hits, and the probe's wall time. → ({}, the path's
    launches)."""
    import http.client
    import tempfile
    import threading

    from pilosa_tpu_torch.core import VIEW_BSI
    from pilosa_tpu_torch.ops import _cuda
    from pilosa_tpu_torch.pql import parse
    from pilosa_tpu_torch.roaring import Bitmap, serialize
    from pilosa_tpu_torch.server import Server
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD
    from pilosa_tpu_torch.utils.config import Config

    on_card = device == "cuda"
    W = WORDS_PER_SHARD
    blocks, shards = main["blocks"], main["shards"]
    n_shards = len(shards)
    write_shard = n_shards - 1
    mult = np.bincount(np.arange(n_shards) % G, minlength=G)
    rng = np.random.default_rng(23)
    vals = [rng.integers(0, S_VMAX + 1, SHARD_WIDTH) for _ in range(G)]
    has = [rng.random(SHARD_WIDTH) < 0.5 for _ in range(G)]
    depth = S_VMAX.bit_length()
    bsi = []
    for g in range(G):
        bits = np.zeros((8, SHARD_WIDTH), dtype=bool)
        bits[0] = has[g]
        for k in range(depth):
            bits[2 + k] = has[g] & (((vals[g] >> k) & 1) == 1)
        bsi.append(pack(bits))
    exists = []
    for g in range(G):
        ex = np.zeros((R_PAD, W), np.uint32)
        ex[0] = np.bitwise_or.reduce(blocks[g], axis=0) | bsi[g][0]
        exists.append(ex)

    def vmask(g: int, pred) -> np.ndarray:
        return pack(has[g] & pred(vals[g]))

    def expect(fn) -> int:
        return sum(int(mult[g]) * int(np.bitwise_count(fn(g)).sum()) for g in range(G) if mult[g])

    def expect_topn(fn, n: int) -> list:
        pairs = [(r, expect(lambda g, r=r: blocks[g][r] & fn(g))) for r in range(R_PAD)]
        pairs = sorted((rc for rc in pairs if rc[1]), key=lambda rc: (-rc[1], rc[0]))
        return [{"id": r, "count": c} for r, c in pairs[:n]]

    def expect_sum() -> dict:
        return {"value": sum(int(mult[g]) * int(vals[g][has[g]].sum()) for g in range(G)),
                "count": sum(int(mult[g]) * int(has[g].sum()) for g in range(G))}

    deep = "Row(f=1)"
    for _ in range(33):
        deep = f"Intersect(Row(f=2), {deep})"
    c4 = {
        "conds17": ("Union(" + ", ".join(f"Row(v > {i})" for i in range(S_CONDS)) + ")",
                    lambda g: vmask(g, lambda v: v > 0)),
        "depth33": (deep, lambda g: blocks[g][1] & blocks[g][2]),
        "leaves300": ("Union(" + ", ".join(f"Row(f={i % R_PAD})" for i in range(300)) + ")",
                      lambda g: np.bitwise_or.reduce(blocks[g], axis=0)),
    }

    # the probe's verdict file, in a temp dir of this run
    probe_cache = tempfile.TemporaryDirectory()
    cache_env = os.environ.get("PILOSA_TPU_TORCH_PROBE_CACHE")
    os.environ["PILOSA_TPU_TORCH_PROBE_CACHE"] = os.path.join(probe_cache.name, "device_probe.json")
    data_dir = tempfile.TemporaryDirectory()
    times = {}
    t0 = time.perf_counter()
    srv = Server(Config(bind="127.0.0.1:0", data_dir=data_dir.name, route_mode="device",
                        result_cache_mode="off"), device=device)
    srv.open()
    if not srv.wait_mesh(600) or not srv.device_verdict[0]:
        raise AssertionError(f"the server's device probe failed: {srv.device_verdict}")
    times["open_and_probe_s"] = time.perf_counter() - t0
    times["probe_s"] = srv.probe_seconds
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)

    def post(path: str, body, want_status: int = 200):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        conn.request("POST", path, body=data)
        resp = conn.getresponse()
        out = json.loads(resp.read() or b"{}")
        if resp.status != want_status:
            raise AssertionError(f"POST {path}: {resp.status} {json.dumps(out)[:300]}")
        return out

    def query(pql: str):
        return post("/index/bench/query", pql.encode())["results"]

    launches = {n: 0 for n in _cuda.KERNELS}

    def served(pql: str, want, must: dict):
        """One query over HTTP, its answer against numpy, and the kernel
        launches it made (counts zeroed just before) against ``must``:
        {kernel: {mode (None: any mode): at least}}, on the card."""
        for k in _cuda.KERNELS.values():
            k.reset()
        t0 = time.perf_counter()
        got = query(pql)
        wall_ms = (time.perf_counter() - t0) * 1e3
        made = kernel_modes(torch)
        for n, k in _cuda.KERNELS.items():
            launches[n] += k.launches
        if got[-1] != want:
            raise AssertionError(f"serving: {pql[:80]}: {json.dumps(got)[:300]} != numpy {json.dumps(want)[:300]}")
        short = {n: m for n, m in made.items() if m}
        log(f"ok  HTTP {pql[:60]}  -> {json.dumps(got[-1])[:60]}  {wall_ms:.3f} ms  launches {json.dumps(short)}")
        if on_card:
            for n, modes in must.items():
                for m, least in modes.items():
                    if (sum(made[n].values()) if m is None else made[n].get(m, 0)) < least:
                        raise AssertionError(f"serving: {pql[:80]} launched {short}, not {n} {m} x{least}")
        return got

    # ------------------------------------------------------------ data
    t0 = time.perf_counter()
    post("/index/bench", {"options": {"trackExistence": True}})
    post("/index/bench/field/f", {"options": {}})
    post("/index/bench/field/v", {"options": {"type": "int", "min": 0, "max": S_VMAX}})
    idx = srv.holder.index("bench")
    v_f = idx.field("v")
    if v_f.bit_depth != depth:
        raise AssertionError(f"v's depth {v_f.bit_depth} != {depth}")
    views = [(idx.field("f").create_view_if_not_exists("standard"), blocks),
             (v_f.create_view_if_not_exists(VIEW_BSI), bsi),
             (idx.existence_field().create_view_if_not_exists("standard"), exists)]
    for s in shards:
        for view, src in views:
            frag = view.create_fragment_if_not_exists(s)
            if s == write_shard:
                # the writes land here: true roaring storage
                r, c = np.nonzero(np.unpackbits(src[s % G].view(np.uint8), axis=1, bitorder="little"))
                frag.union_positions(r.astype(np.uint64) * SHARD_WIDTH + c.astype(np.uint64))
                continue
            # packed-matrix injection, as the main path does it
            frag._np_matrix = src[s % G]
            frag._all_dirty = False
    times["serving_data_s"] = time.perf_counter() - t0
    # the front end closes a keep-alive connection idle past
    # keepalive-idle-s (75 s), which the data phase may outlast
    conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
    # the router's choice under auto, before the pinned device route serves
    router = srv.api.executor.router
    router.mode = "auto"
    auto_routes = {pql: srv.api.executor.route_for("bench", pql)
                   for pql in ("Count(Intersect(Row(f=1), Row(f=2)))", "TopN(f, n=5)", "Sum(field=v)")}
    router.mode = "device"
    log(f"router under auto at {n_shards} shards:", json.dumps(auto_routes))

    # ------------------------------------------------- queries over HTTP
    head = "Count(Intersect(Row(f=1), Row(f=2)))"
    t0 = time.perf_counter()
    served(head, expect(lambda g: blocks[g][1] & blocks[g][2]), {"tree_eval": {"count": 1}})
    times["first_http_count_s"] = time.perf_counter() - t0
    served("TopN(f, n=5)", expect_topn(lambda g: ~np.uint32(0), 5), {"row_counts": {None: 1}})
    served("TopN(f, Row(f=1), n=5)", expect_topn(lambda g: blocks[g][1], 5), {"row_counts_tree": {"rows+tree": 1}})
    served("Sum(field=v)", expect_sum(), {"bsi_sum": {None: 1}})
    for name, (tree, fn) in c4.items():
        mode = "+cmp" if name == "conds17" else ""
        served(f"Count({tree})", expect(fn), {"tree_eval": {"words" + mode: 1, "count" + mode: 1}})
    served(f"TopN(f, {c4['leaves300'][0]}, n=5)", expect_topn(c4["leaves300"][1], 5),
           {"tree_eval": {"words": 1}, "row_counts_tree": {"rows+tree": 1}})
    # ------------------------------- C4 trees through the server's compiler
    comp = srv.api.executor.compiler
    for name, (tree, fn) in c4.items():
        for k in _cuda.KERNELS.values():
            k.reset()
        call = parse(tree)[0]
        n = int(comp.count_async(idx, call, shards))
        words = comp.bitmap_words(idx, call, shards)
        made = kernel_modes(torch)["tree_eval"]
        for kk in _cuda.KERNELS.values():
            launches[kk.name] += kk.launches
        want_n = expect(fn)
        if n != want_n or int(np.bitwise_count(words).sum()) != want_n:
            raise AssertionError(f"C4 {name}: count {n}, words {int(np.bitwise_count(words).sum())}, numpy {want_n}")
        g_words = words.reshape(n_shards, W)
        for s in (0, 1, n_shards // 2):
            if not np.array_equal(g_words[s], fn(s % G)):
                raise AssertionError(f"C4 {name}: shard {s}'s words differ from numpy")
        log(f"ok  C4 {name} on {device}: count and words equal to numpy, K1 launches {json.dumps(made)}")
        mode = "+cmp" if name == "conds17" else ""
        if on_card and (made.get("words" + mode, 0) < 2 or made.get("count" + mode, 0) < 1):
            raise AssertionError(f"C4 {name}: K1 ran no sub-program: {made}")
        del words, g_words

    # a Set in the last shard, at a column in no row of f: the Count takes K3's delta
    g_w = write_shard % G
    free = np.flatnonzero(np.unpackbits(exists[g_w][0].view(np.uint8), bitorder="little") == 0)
    col = write_shard * SHARD_WIDTH + int(free[0])
    stacks = srv.api.executor.compiler.stacks
    restacks, deltas = stacks.full_restacks, stacks.delta_updates
    served(f"Set({col}, f=1)", True, {})
    served("Count(Row(f=1))", expect(lambda g: blocks[g][1]) + 1, {"stack_delta": {None: 1}, "tree_eval": {"count": 1}})
    if stacks.full_restacks != restacks or stacks.delta_updates <= deltas:
        raise AssertionError(f"serving: the Set did not take the delta path: {stacks.stats_snapshot()}")
    # /import-roaring into the last shard: row 3 gains the free columns
    new = free[1:1001].astype(np.uint64)
    bm = Bitmap()
    bm.add_many(3 * SHARD_WIDTH + new)
    t0 = time.perf_counter()
    post(f"/index/bench/field/f/import-roaring/{write_shard}", serialize(bm))
    times["import_roaring_1000_bits_ms"] = (time.perf_counter() - t0) * 1e3
    served("Count(Row(f=3))", expect(lambda g: blocks[g][3]) + new.size, {"tree_eval": {"count": 1}})
    # /import-value into v in the last shard: 1,000 columns without a
    # value take 63, so the Sum moves by 63 per column
    no_v = np.flatnonzero(~has[g_w])[:1000]
    t0 = time.perf_counter()
    post("/index/bench/field/v/import-value", {
        "columnIDs": (write_shard * SHARD_WIDTH + no_v).tolist(), "values": [S_VMAX] * no_v.size})
    times["import_value_1000_ms"] = (time.perf_counter() - t0) * 1e3
    want = expect_sum()
    want = {"value": want["value"] + S_VMAX * no_v.size, "count": want["count"] + no_v.size}
    served("Sum(field=v)", want, {"bsi_sum": {None: 1}})

    # -------------------------------------------------------- latencies
    def p50_ms(fn, reps: int) -> float:
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            lat.append(time.perf_counter() - t0)
        return float(np.median(lat)) * 1e3

    for pql, key in ((head, "count"), ("TopN(f, n=5)", "topn")):
        times[f"http_{key}_p50_ms"] = p50_ms(lambda pql=pql: query(pql), 20)
        times[f"api_{key}_p50_ms"] = p50_ms(lambda pql=pql: srv.api.query("bench", pql), 20)
    want_head = expect(lambda g: blocks[g][1] & blocks[g][2])
    errors = []

    def client(n: int) -> None:
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
        try:
            for _ in range(n):
                c.request("POST", "/index/bench/query", body=head.encode())
                r = c.getresponse()
                got = json.loads(r.read())
                if r.status != 200 or got["results"] != [want_head]:
                    errors.append((r.status, got))
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(8,)) for _ in range(8)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    times["http_count_8_clients_qps"] = 64 / (time.perf_counter() - t0)
    if errors:
        raise AssertionError(f"concurrent Counts: {errors[:3]}")
    times["http_count_profiled"] = device_busy(torch, lambda: query(head), "tree_eval", "tree_ring_kernel")
    # cache hits, timed apart: the cache on (and admitting any cost: a
    # small rehearsal's Count takes under its 1 ms floor), one fill,
    # then 20 hits that launch nothing
    cache = srv.http.result_cache
    cache.mode, min_cost = "on", cache.min_cost_ms
    cache.min_cost_ms = 0.0
    query(head)
    hits = cache.hits
    for k in _cuda.KERNELS.values():
        k.reset()
    times["http_count_cache_hit_p50_ms"] = p50_ms(lambda: query(head), 20)
    hit_launches = sum(k.launches for k in _cuda.KERNELS.values())
    cache.mode, cache.min_cost_ms = "off", min_cost
    if cache.hits - hits != 20:
        raise AssertionError(f"{cache.hits - hits} of 20 repeats were cache hits: {cache.snapshot()}")
    if query(head) != [want_head]:
        raise AssertionError("the headline Count moved")
    if on_card and hit_launches:
        raise AssertionError(f"cache hits launched {hit_launches} kernels")
    times["cache"] = cache.snapshot()
    log("serving times:", json.dumps(times))
    log("serving launches:", json.dumps(launches))
    conn.close()
    srv.close()
    data_dir.cleanup()
    probe_cache.cleanup()
    if cache_env is None:
        os.environ.pop("PILOSA_TPU_TORCH_PROBE_CACHE")
    else:
        os.environ["PILOSA_TPU_TORCH_PROBE_CACHE"] = cache_env
    return {}, launches


def main(
    device: str = "cuda",
    n_shards: int = N_SHARDS,
    taxi_shards: int = T_SHARDS,
    budget: "int | None" = None,
    sim_rows: int = SIM_ROWS,
    sim_block: int = SIM_BLOCK,
) -> int:
    """``device="cpu"`` with small ``n_shards``, ``taxi_shards``,
    ``sim_rows`` and ``sim_block``, and a ``budget`` that puts the
    residency path's fields over it, rehearses the same steps on the
    plain versions, without the card lines or the ok line."""
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
        build_s = _cuda.build(_cuda.SOURCES, force=True)
        log(f"kernel build: {time.perf_counter() - t0:.3f} s wall, per source {json.dumps(build_s)}")
        for stem in TENSOR_CORE_SOURCES:
            found = tensor_ops(stem)
            log(f"{stem}.cu SASS tensor-core instructions:", json.dumps(found))
            if not any(op.startswith("BMMA") for op in found):
                raise AssertionError(f"{stem}.cu's SASS holds no binary MMA")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def main_path() -> list:
        """The 10,240-shard main path, the write phase, and K1-K3 against
        their plain versions; returns their kernel entries. Its tensors
        are freed on return, before the taxi path."""
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

        def expect_topn_words(filt_fn, n, ids=None) -> list:
            """TopN under the filter words ``filt_fn(block, exists)``."""
            pairs = []
            for r in ids if ids is not None else range(R_PAD):
                c = 0 if r >= R_PAD else expect_count(lambda b, e, r=r: b[r] & filt_fn(b, e))
                if c:
                    pairs.append((r, c))
            pairs.sort(key=lambda rc: (-rc[1], rc[0]))
            return [{"id": r, "count": c} for r, c in (pairs[:n] if n else pairs)]

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
            k.reset()
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
        # PQL Shift: K1 evaluates the shifted subtree into a plane (words),
        # K7 shifts it, and K1 counts the outer program
        shift_checks = [
            ("Count(Shift(Row(f=1), n=1))", expect_count(lambda b, e: np_shift(b[1], 1))),
            ("Count(Intersect(Shift(Row(f=1), n=33), Row(f=2)))",
             expect_count(lambda b, e: np_shift(b[1], 33) & b[2])),
        ]
        k1 = _cuda.TREE_EVAL
        before = (dict(k1.modes), _cuda.SHIFT_WORDS.launches)
        for pql, want in shift_checks:
            got = api.query("bench", pql)["results"][0]
            if got != want:
                raise AssertionError(f"{pql}: {got} != numpy {want}")
            log(f"ok  {pql[:60]}  -> {json.dumps(got)[:80]}")
        sync()
        shift_launches = {
            "tree_eval " + m: k1.modes.get(m, 0) - before[0].get(m, 0) for m in ("words", "count")
        }
        shift_launches["shift_words"] = _cuda.SHIFT_WORDS.launches - before[1]
        log("launches of the two Shift queries:", json.dumps(shift_launches))
        if on_card and shift_launches != {"tree_eval words": 2, "tree_eval count": 2, "shift_words": 2}:
            raise AssertionError(f"Shift did not run as K1 words, K7, K1 count: {shift_launches}")
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            api.query("bench", shift_checks[0][0])
            lat.append(time.perf_counter() - t0)
        times["sync_shift_count_p50_ms"] = float(np.median(lat)) * 1e3
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            api.query("bench", headline)
            lat.append(time.perf_counter() - t0)
        times["sync_count_p50_ms"] = float(np.median(lat)) * 1e3
        times["count_split"] = split_ms(api.executor, "bench", headline)
        times["count_profiled"] = device_busy(torch, lambda: api.query("bench", headline), "tree_eval", "tree_ring_kernel")
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
        # the fused filters: filtered TopN, plain and ids=, each filter
        # evaluated inside K2 (one launch), with the Shift's sub-program
        fused_cases = [(pql, expect_topn_words(fn, n, ids))
                       for filt, fn in main_filters() for pql, n, ids in main_fused_queries(filt)]
        n_filters = len(main_filters())
        times["fused_launches"] = fused_phase(
            torch, api, "bench", fused_cases, "main",
            fused_modes(1, topn=n_filters, ids=n_filters, shift=2))
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            api.query("bench", "TopN(f, Row(f=1), n=5)")
            lat.append(time.perf_counter() - t0)
        times["topn_filtered_p50_ms"] = float(np.median(lat)) * 1e3
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
        log("launches on the main path by mode:", json.dumps({n: k.modes for n, k in _cuda.KERNELS.items() if k.modes}))
        if on_card and any(launches[n] <= 0 for n in ("tree_eval", "row_counts", "stack_delta", "shift_words")):
            raise AssertionError(f"a kernel of the main path never launched: {launches}")
        router = api.executor.router
        log("router calibration after the main path:", json.dumps(
            {"dispatch_s": router.dispatch_s.value, "readback_s": router.readback_s.value}))
        log("router decisions on the main path:", json.dumps(router.decisions))
        if router.decisions["host_unported"] != 0:
            raise AssertionError(f"a main-path call ran host-side for want of a port: {router.decisions}")
        # the one-device route's answers to the mesh path's queries, after the write
        mesh_answers = {pql: api.query("bench", pql)["results"][0] for pql, _r in mesh_main_queries(N_SHARDS)}
        mesh_answers[shift_checks[0][0]] = api.query("bench", shift_checks[0][0])["results"][0]
        row1_digest = digest(api.executor.execute("bench", "Row(f=1)")[0].segments, shards)
        mesh_ctx = {
            "holder": h, "index": idx, "shards": shards, "blocks": blocks, "exists": exists,
            "writes": [(write_shard, col)], "answers": mesh_answers, "row1_digest": row1_digest,
            "p50": {"count": times["sync_count_p50_ms"], "topn": times["topn_p50_ms"]},
            "count_split": times["count_split"], "count_profiled": times["count_profiled"],
        }

        # write phase: a small holder loaded through the import entry points
        for k in _cuda.KERNELS.values():
            k.reset()
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
        errs = {"tree_eval": 0, "row_counts": 0, "stack_delta": 0, "shift_words": 0, "row_counts_tree": 0}
        for stacks_, leaves, prog in tree_cases:
            for count in (True, False):
                got = ops.tree_eval(stacks_, leaves, prog, N_SHARDS, count=count, device=dev)
                want = bitwise.tree_eval_plain(stacks_, leaves, prog, N_SHARDS, count, dev)
                errs["tree_eval"] = max(errs["tree_eval"], max_abs_err(torch, got, want))
                del got, want
        for stacks_, leaves, prog, conds, s_n, w_n in tree_limit_cases(torch, dev):
            for count in (True, False):
                got = ops.tree_eval(stacks_, leaves, prog, s_n, count=count, device=dev, conds=conds, n_words=w_n)
                want = bitwise.tree_eval_plain(stacks_, leaves, prog, s_n, count, dev, conds, w_n)
                errs["tree_eval"] = max(errs["tree_eval"], max_abs_err(torch, got, want))
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
            # and K = 0: the copy alone
            for di, dr in ((didx, drows), (didx[:0], drows[:0])):
                got = ops.apply_stack_delta(m, di, dr)
                want = stack.apply_stack_delta_plain(m, di, dr)
                errs["stack_delta"] = max(errs["stack_delta"], max_abs_err(torch, got, want))
                del got, want
                torch.cuda.empty_cache()
        # K7 on the main path's words: the carry at 31/33, whole-word
        # rolls, and a shift leaving one bit per shard
        for n in (1, 31, 32, 33, 32 * W - 1):
            got = ops.shift_words(filt, n)
            want = bitwise.shift_words_plain(filt, n)
            errs["shift_words"] = max(errs["shift_words"], max_abs_err(torch, got, want))
            del got, want
        got = ops.shift_words(edge[1].contiguous(), 1)  # every bit 31 carries
        errs["shift_words"] = max(errs["shift_words"], max_abs_err(
            torch, got, bitwise.shift_words_plain(edge[1].contiguous(), 1)))
        del got
        # K2's fused filter: the headline's Intersect, Not, an empty
        # Union(), a row >= R, ids with -1 and >= R, all-ones and bit-31
        # rows under an all-ones, bit-31 and random filter
        PF = ops.PlannedFilter  # noqa: N806
        plane2 = (N_SHARDS, W)
        pf_head = PF([fm], [(0, 1), (0, 2)], [(L, 0), (L, 1), (A, 0)], [], *plane2)
        fused_k2 = [
            (fm, pf_head, None), (fm, pf_head, ids),
            (fm, PF([fm, em], [(1, 0), (0, 3)], [(L, 0), (L, 1), (N, 0)], [], *plane2), ids),
            (fm, PF([], [], [(Z, 0)], [], *plane2), None),
            (fm, PF([fm], [(0, R_PAD)], [(L, 0)], [], *plane2), None),
            (edge, PF([edge, fm], [(0, 0), (0, 1), (1, 5)], [(L, 0), (L, 1), (X, 0), (L, 2), (O, 0)], [], *plane2), None),
        ]
        for m, pf, ii in fused_k2:
            fused_check(torch, errs, "row_counts_tree", ops.row_counts(m, pf, ii),
                        topn.row_counts_plain(m, pf.plain(dev, plane2), ii))
        log("max |kernel - plain|:", json.dumps(errs))
        if any(errs.values()):
            raise AssertionError(f"a kernel disagrees with its plain version: {errs}")
        del delta_cases[0]
        # the mesh path's search on one device: row 1 against every row of
        # the whole stack (K2 twice, K12, K10), for the mesh's answers
        inter1, pop1 = ops.row_counts(fm, fm[1].contiguous()), ops.row_counts(fm)
        mesh_ctx["search"] = {}
        for metric in ("tanimoto", "cosine"):
            keys1, hist1 = ops.similarity.mesh_sim_keys(inter1, pop1, pop1[1:2].contiguous(), metric)
            for k in MESH_SEARCH_K:
                top = ops.similarity.select_top(keys1, hist1, min(k, R_PAD))
                mesh_ctx["search"][(metric, k)] = tuple(t.cpu() for t in top)
        del inter1, pop1, keys1, hist1

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
        k7 = dict(
            ms=cuda_ms(torch, lambda: ops.shift_words(filt, 33), 20),
            plain_ms=cuda_ms(torch, lambda: bitwise.shift_words_plain(filt, 33), 2),
            # the plane read once and written once
            bound_ms=bound_ms(2 * plane),
            library_ms=None,  # no one PyTorch call shifts per shard with a carry
        )
        head_filter = lambda: ops.tree_eval([fm], [(0, 1), (0, 2)], [(L, 0), (L, 1), (A, 0)], N_SHARDS, count=False, device=dev)  # noqa: E731
        k2t = dict(
            replaces="pilosa_tpu/executor/executor.py:1019",  # _filter_plan in the TopN program (:1356-1383)
            ms=cuda_ms(torch, lambda: ops.row_counts(fm, pf_head), 10),
            plain_ms=cuda_ms(torch, lambda: topn.row_counts_plain(fm, pf_head.plain(dev, plane2)), 1),
            # the 8 rows, each read once: the filter's leaves are rows 1 and 2
            bound_ms=bound_ms(fm.shape[0] * plane + fused_plan_bytes(pf_head, plane, (fm,))),
            library_ms=None,
            shape=f"rows+tree, [{R_PAD}, {N_SHARDS}, {W}] under Intersect(Row(f=1), Row(f=2))",
        )
        times["row_counts_two_launches_ms (K1 words, then K2 filtered)"] = cuda_ms(
            torch, lambda: ops.row_counts(fm, head_filter()), 10)
        times.update({
            "tree_eval_words_ms": words_ms,
            "tree_eval_words_plain_ms": cuda_ms(
                torch, lambda: bitwise.tree_eval_plain([fm], [(0, 1)], [(L, 0)], N_SHARDS, False, dev), 2),
            "row_counts_filtered_ms": k2_filtered_ms,
            "row_counts_filtered_plain_ms": cuda_ms(torch, lambda: topn.row_counts_plain(fm, filt), 1),
            "row_counts_filtered_bound_ms": bound_ms((R_PAD + 1) * plane),
        })
        log("times:", json.dumps(times))
        results = {"tree_eval": k1, "row_counts": k2, "stack_delta": k3, "shift_words": k7, "row_counts_tree": k2t}
        return {name: (errs[name], t) for name, t in results.items()}, launches, mesh_ctx
    main_results, main_launches, main_ctx = main_path()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    serve_results, serve_launches = serving_path(torch, device, main_ctx)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    taxi_results, taxi_launches, taxi = taxi_path(torch, device, taxi_shards)
    # the mesh path's share of the taxi holder (the residency path drops its API)
    taxi_ctx = {k: taxi[k] for k in ("holder", "index", "checks", "answers", "depth", "p50", "fused")}
    res_results, res_launches = residency_path(torch, device, taxi, budget)
    del taxi
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    sim_results, sim_launches = similarity_path(torch, device, sim_rows, sim_block)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    mesh_results, mesh_launches = mesh_path(torch, device, main_ctx, taxi_ctx, sim_block)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # the graft step needs ~36 GB (the matrix, its delta, the filter and a
    # copy for the plain version) and its mesh programs ~23 GB of placement
    # a layout: both run after the mesh path has freed its stacks
    graft_results, graft_launches, graft = graft_path(torch, device, main_ctx)
    prog_results, prog_launches = mesh_programs_path(torch, device, graft, main_ctx, taxi_ctx)
    del main_ctx, taxi_ctx, graft
    paths = (("main", main_results, main_launches), ("serving", serve_results, serve_launches),
             ("taxi", taxi_results, taxi_launches),
             ("residency", res_results, res_launches), ("similarity", sim_results, sim_launches),
             ("mesh", mesh_results, mesh_launches), ("graft", graft_results, graft_launches),
             ("mesh_programs", prog_results, prog_launches))
    # a result's key is the kernel's name, then (for a second entry of
    # one kernel) what it times
    kernels = [
        kernel_entry(_cuda.KERNELS[key.split()[0]], {p: launches[key.split()[0]] for p, _r, launches in paths},
                     err, t, path)
        for path, results, _launches in paths
        for key, (err, t) in results.items()
    ]
    for t in kernels:
        log(f"{t['name']}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
            f"plain {t['plain_ms']:.4f} ms)")
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
