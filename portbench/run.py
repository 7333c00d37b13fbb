"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. It reads
``BENCHMARK.json``: the cell names a configuration (its file under
``configs/``) and a traffic mix (``traffic/<name>.json``); each metric
is read by ``metrics/<name>.py``.

Set-up: the data of the fields the mix reads, from the seed;
``pilosa_tpu_torch``'s HTTP ``Server`` on 127.0.0.1 with its data dir
in the temp dir, filled with the data and warmed on the cell's own
queries (one of each template in turn, then each client's warm-up).
``setup_s`` runs from the process's start to the window's, and holds
the kernels' build where a checkout's first run makes it. The window:
the mix's closed-loop clients, threads of one client process, send
their queries over keep-alive connections for ``--seconds``. Then the program's answers are held against the NumPy
reference, and the last line of standard output is the result:
``{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}``, with the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``: counters, a timer around
``API.query`` and a device trace over the window).

Without a CUDA card it exits 2 and prints no result. It exits 3, with
no result, where a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import judge, latency, roofline  # noqa: E402
from portbench.data import Dataset  # noqa: E402
from portbench.reference import Reference  # noqa: E402
from portbench.traffic import Mix, read_spec  # noqa: E402

HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "pilosa_tpu")
REQUEST_TIMEOUT_S = 120.0


def process_age() -> float:
    """Seconds since this process started (its start time from /proc)."""
    with open("/proc/self/stat", encoding="ascii") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: str = ROOT):
        with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as fh:
            self.spec = json.load(fh)
        self.root = root

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"]), encoding="utf-8") as fh:
                    return json.load(fh)
        raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")

    def traffic_path(self, name: str) -> str:
        return os.path.join(HERE, "traffic", f"{name}.json")

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's metric entries: end-to-end, or per-layer when traced."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run)``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(name)}_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What one run saw, for the metric readers."""

    def __init__(self):
        self.seconds = 0.0
        self.setup_s = 0.0
        self.t_go = self.t_end = self.t_done = 0.0
        self.records: list = []  # [client, position, t_sent, t_parsed, status]
        self.mem_peak_bytes = 0
        self.card = ""
        # traced runs only
        self.api_seconds: list = []
        self.before: dict = {}
        self.after: dict = {}
        self.events: list = []  # device operations [(start_us, end_us, name)]
        self.kernels: list = []
        self.query_bytes = 0

    def window(self) -> list:
        return [r for r in self.records if r[2] < self.t_end]

    def answered(self) -> list:
        return [r for r in self.records if r[4] == 200]

    def delta(self, group: str, key: str) -> float:
        """A counter's change over the traced window."""
        return self.after.get(group, {}).get(key, 0) - self.before.get(group, {}).get(key, 0)


def spawn_clients(mix, plan: dict, port: int, path: str) -> list:
    """The mix's clients: one process, isolated from site packages and
    Python's environment variables (``-I -S``), given their jobs."""
    p = subprocess.Popen([sys.executable, "-I", "-S", os.path.join(HERE, "loadgen.py")],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    clients = [{"warm": plan["warm"][c], "queries": plan["queries"][c], "keep": plan["keep"][c]}
               for c in range(mix.clients)]
    p.stdin.write(json.dumps({"port": port, "path": path, "timeout": REQUEST_TIMEOUT_S, "clients": clients}) + "\n")
    p.stdin.flush()
    return [p]


def stop(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)


def card_line() -> tuple:
    """(name, power limit) of card 0, by nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = [x.strip() for x in out.strip().splitlines()[0].split(",")]
    return name, limit


def main(argv=None, rehearsal: "dict | None" = None) -> int:
    """``rehearsal`` (tests only): run on the CPU's plain versions with
    ``{"shards", "width_exp"[, "fault"]}``, skipping the look for a card."""
    t_import = time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench()
    cell = bench.cell(args.workload)

    import torch

    if rehearsal is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = "cuda"
        card, power = card_line()
    else:
        device, card, power = "cpu", "cpu (rehearsal)", "n/a"

    config = bench.config(cell["config"])
    rh = rehearsal or {}

    from portbench import serve

    run = Run()
    system = serve.System(config["index"], device=device)
    procs: list = []
    results: list = []
    try:
        t0 = time.perf_counter()
        mix_spec = read_spec(bench.traffic_path(cell["traffic"]))
        data = Dataset(config, args.seed, shards=rh.get("shards"), width_exp=rh.get("width_exp"),
                       only=mix_spec["fields"])
        mix = Mix(mix_spec, data.fields)
        plan = mix.plan(args.seed, args.seconds)
        system.times["data_s"] = time.perf_counter() - t0
        run.seconds, run.card = args.seconds, card
        system.load(data)
        system.ready()
        system.stack()
        t0 = time.perf_counter()
        for pql in mix.first_of_each(args.seed):
            system.query(pql)
        system.times["warm_sequential_s"] = time.perf_counter() - t0
        system.times["after_sequential"] = system.counters()["decisions"]
        if rh.get("fault"):
            plant(system, rh["fault"])
        procs = spawn_clients(mix, plan, system.port, system.path)
        system.times["spawn_s"] = time.perf_counter() - t0 - system.times["warm_sequential_s"]
        (clients,) = procs
        line = clients.stdout.readline()
        if not line or not json.loads(line).get("ready"):
            raise RuntimeError("the clients failed before the window")
        system.times["warm_s"] = time.perf_counter() - t0
        system.times["after_warm"] = system.counters()
        traced = None
        if args.trace:
            from portbench.trace import DeviceTrace

            run.before = system.counters()
            undo = serve.query_timer(system.srv.api, run.api_seconds)
            if device == "cuda":
                traced = DeviceTrace().__enter__()
        run.t_go = time.monotonic()
        run.setup_s = process_age() if rehearsal is None else run.t_go - t_import
        run.t_end = run.t_go + args.seconds
        clients.stdin.write(json.dumps({"end": run.t_end}) + "\n")
        clients.stdin.flush()
        line = clients.stdout.readline()
        if not line:
            raise RuntimeError("the clients ended without their records")
        run.t_done = time.monotonic()
        results = json.loads(line)["clients"]
        for c, res in enumerate(results):
            run.records += [[c, *r] for r in res["records"]]
        if args.trace:
            if traced is not None:
                traced.__exit__(None, None, None)
                run.events, run.kernels = traced.events, traced.kernels
            run.after = system.counters()
            undo()
        clients.wait(timeout=60)
        if device == "cuda":
            run.mem_peak_bytes = int(torch.cuda.max_memory_allocated())
    finally:
        stop(procs)
        system.close()
    if device == "cuda":
        torch.cuda.empty_cache()

    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3

    # the reference, after the window and with the program's state freed
    t0 = time.perf_counter()
    ref = Reference(data)
    picks = judge.sample(results, mix.check_max, args.seed)
    wrong, examples = judge.compare(ref, plan, results, picks)
    errors = sum(1 for r in run.records if r[4] != 200) + sum(int(r["warm_failed"]) for r in results)
    numbers = {"wrong": wrong, "errors": errors, "checked": len(picks)}
    correct = judge.verdict(numbers)
    check_s = time.perf_counter() - t0

    if args.trace:
        run.query_bytes = sum(roofline.query_bytes(data, plan["queries"][c][pos % len(plan["queries"][c])])
                              for c, pos, _a, _b, status in run.records if status == 200)
    metrics = {}
    for m in bench.metrics(args.workload, bool(args.trace)):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device == "cuda" else "cpu", "kind": card, "count": int(cell["chips"]),
                   "memory_peak_bytes": run.mem_peak_bytes, "power_limit": power}
    out = {"correct": correct, "attempted": len(run.window()),
           "failed": sum(1 for r in run.window() if r[4] != 200), "metrics": metrics, "device": device_info}
    if args.trace and run.events:
        from portbench.trace import breakdown, union_length

        device_info["busy_s"] = union_length([(a, b) for a, b, _ in run.events]) / 1e6
        device_info["window_s"] = run.t_done - run.t_go
        out["breakdown"] = breakdown(run.events)
    checks = judge.lines(numbers)
    out["checks"] = checks

    diag = {"times": system.times, "check_s": check_s, "examples": examples, "setup_s": run.setup_s,
            "latency_ms": latency.summary(run)}
    if args.trace:
        diag["decisions"] = {k: run.delta("decisions", k) for k in run.after.get("decisions", {})}
        diag["scheduler"] = {k: run.delta("scheduler", k) for k in ("waves", "batchedQueries", "dedupedQueries",
                                                                  "directQueries")}
        diag["launches"] = {k: run.delta("launches", k) for k in run.after.get("launches", {})
                            if run.delta("launches", k)}
        diag["trace_kernels"] = len(run.kernels)
    print("portbench: " + json.dumps(diag, default=str), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


def plant(system, fault: str) -> None:
    """Break the timed path underneath the harness (tests only):
    ``answer`` alters every answer where the API produces it; ``half``
    leaves half of the shards out of every query."""
    api = system.srv.api
    inner = api.query
    shards = list(range(system.data.shards))

    def altered(index, pql, shard_list=None):
        resp = inner(index, pql, shard_list)
        res = resp["results"]
        if isinstance(res[-1], int):
            res[-1] += 1
        elif isinstance(res[-1], list) and res[-1]:
            res[-1][0]["count"] += 1
        return resp

    def half(index, pql, shard_list=None):
        return inner(index, pql, shards[: len(shards) // 2])

    api.query = {"answer": altered, "half": half}[fault]


if __name__ == "__main__":
    sys.exit(main())
