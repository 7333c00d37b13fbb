"""pilosa_tpu_torch stands alone: it imports neither JAX nor pilosa_tpu.

The runtime check runs in a subprocess, because this test process
already imported jax through conftest.
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SERVE_ONE = """
import sys
import numpy as np
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.server import API

api = API(Holder(None), device="cpu", route_mode="device")
api.create_index("i")
api.create_field("i", "f")
api.import_bits("i", "f", {"rowIDs": [1, 1, 2], "columnIDs": [3, 70000, 3]})
assert api.query("i", "Count(Intersect(Row(f=1), Row(f=2)))") == {"results": [1]}
from pilosa_tpu_torch.parallel import MeshContext, make_mesh

mesh_api = API(api.holder, mesh_ctx=MeshContext(make_mesh(["cpu"] * 4, words_axis=2)), route_mode="mesh")
assert mesh_api.query("i", "Count(Intersect(Row(f=1), Row(f=2)))") == {"results": [1]}
assert mesh_api.executor.router.decisions["mesh"] == 1
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib", "pilosa_tpu")
             or m.startswith(("jax.", "jaxlib.", "pilosa_tpu.")))
print("LOADED", bad)
"""


_SERVE_HTTP = """
import json, sys, tempfile, urllib.request
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.utils.config import Config

with tempfile.TemporaryDirectory() as d:
    srv = Server(Config(bind="127.0.0.1:0", data_dir=d, anti_entropy_interval=0, profiler_enabled=False,
                        diagnostics_interval=0), device="cpu")
    srv.open()
    try:
        def post(path, body):
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())
        post("/index/i", b"{}")
        post("/index/i/field/f", b"{}")
        post("/index/i/query", b"Set(3, f=1) Set(70000, f=1) Set(3, f=2)")
        assert post("/index/i/query", b"Count(Intersect(Row(f=1), Row(f=2)))") == {"results": [1]}
    finally:
        srv.close()
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib", "pilosa_tpu")
             or m.startswith(("jax.", "jaxlib.", "pilosa_tpu.")))
print("LOADED", bad)
"""


def test_http_server_loads_no_jax_and_no_pilosa_tpu():
    """The port's Server answers an HTTP query with neither jax nor
    pilosa_tpu loaded: its encoding (pilosa_pb2's descriptor names the
    wire package ``pilosa_tpu``, not a module), config, planes and
    front end are its own copies."""
    env = dict(os.environ, PILOSA_TPU_SHARD_WIDTH_EXP="16")
    out = subprocess.run(
        [sys.executable, "-c", _SERVE_HTTP], cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_serving_a_query_loads_no_jax_and_no_pilosa_tpu():
    env = dict(os.environ, PILOSA_TPU_SHARD_WIDTH_EXP="16")
    out = subprocess.run(
        [sys.executable, "-c", _SERVE_ONE],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_python_m_server_loads_no_jax_and_stops_on_sigterm(tmp_path):
    """``python -m pilosa_tpu_torch server --device cpu`` starts, says
    where it listens and where queries run, answers a Count over HTTP,
    and exits 0 on SIGTERM; ``-X importtime`` lists every module it
    imported, and none is jax or pilosa_tpu."""
    import json
    import signal
    import urllib.request

    env = dict(os.environ, PILOSA_TPU_SHARD_WIDTH_EXP="16")
    # the import-time log runs to hundreds of kB: a file, not a pipe
    log = open(tmp_path / "stderr.txt", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "pilosa_tpu_torch", "server", "--device", "cpu",
         "--bind", "127.0.0.1:0", "--data-dir", str(tmp_path / "d")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=log, text=True,
    )
    try:
        listening = proc.stdout.readline()
        m = re.match(r"pilosa-tpu server listening on (http://127\.0\.0\.1:\d+)$", listening.strip())
        assert m, listening
        assert proc.stdout.readline().strip() == "device cpu: ready (cpu: no probe)"

        def post(path, body):
            req = urllib.request.Request(m.group(1) + path, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())

        post("/index/i", b"{}")
        post("/index/i/field/f", b"{}")
        post("/index/i/query", b"Set(3, f=1) Set(70000, f=1) Set(3, f=2)")
        assert post("/index/i/query", b"Count(Intersect(Row(f=1), Row(f=2)))") == {"results": [1]}
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        log.seek(0)
        err = log.read()
        log.close()
    assert proc.returncode == 0, err[-3000:]
    imported = {ln.split("|")[-1].strip() for ln in err.splitlines() if ln.startswith("import time:")}
    assert {"torch", "pilosa_tpu_torch.cli", "pilosa_tpu_torch.server.server"} <= imported
    bad = sorted(n for n in imported if n in ("jax", "jaxlib", "pilosa_tpu") or n.startswith(("jax.", "jaxlib.", "pilosa_tpu.")))
    assert bad == []


def test_client_commands_load_no_torch():
    """The client side of the CLI (``doctor`` here, against nothing)
    imports neither torch nor the server runtime."""
    code = (
        "import sys\n"
        "from pilosa_tpu_torch import cli\n"
        "rc = cli.main(['doctor', '--host', '127.0.0.1:9', '--timeout', '0.5', '--compact'])\n"
        "print('RC', rc, sorted(m for m in sys.modules if m == 'torch' or m.startswith(('torch.', 'pilosa_tpu_torch.server', 'jax', 'pilosa_tpu.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RC 1 []" in out.stdout, out.stdout[-2000:]


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|pilosa_tpu)(\.|\s|$)")


def test_no_source_line_imports_jax_or_pilosa_tpu():
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "pilosa_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in sources:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                if _IMPORT.match(line):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{n}: {line.strip()}")
    assert len(sources) > 30
    scanned = {os.path.relpath(p, REPO) for p in sources}
    assert {
        "pilosa_tpu_torch/ops/similarity.py", "pilosa_tpu_torch/examples/chemical_similarity.py",
        "pilosa_tpu_torch/parallel/__init__.py", "pilosa_tpu_torch/parallel/mesh.py",
        "pilosa_tpu_torch/server/server.py", "pilosa_tpu_torch/server/http.py",
        "pilosa_tpu_torch/server/eventloop.py", "pilosa_tpu_torch/encoding/pilosa_pb2.py",
        "pilosa_tpu_torch/utils/config.py", "pilosa_tpu_torch/utils/probecache.py",
        "pilosa_tpu_torch/cli.py", "pilosa_tpu_torch/__main__.py", "pilosa_tpu_torch/loader.py",
        "pilosa_tpu_torch/parallel/multihost.py", "pilosa_tpu_torch/parallel/movement.py",
        "pilosa_tpu_torch/parallel/cluster.py", "pilosa_tpu_torch/parallel/client.py",
        "pilosa_tpu_torch/server/supervisor.py",
    } <= scanned
    assert offenders == []


def test_chip_smoke_rehearses_on_the_cpu(capsys):
    """chip_smoke.py's steps on the plain versions at a tiny size: the
    same data recipes, queries, numpy checks, write phase, taxi path,
    residency path (over a lowered budget), similarity path and kernel
    comparisons, the fused-filter phases, the mesh path on eight CPU
    positions in both layouts, the graft step and the mesh programs of
    dryrun_multichip, the CLI's server fed through ``import --roaring``
    and the loader, the two-rank gloo mesh, the three-node cluster and
    the supervised fleet of three, without the card lines or the final
    ok line."""
    import json

    sys.path.insert(0, REPO)
    import chip_smoke
    import torch

    # one intra-op thread: beside the other test workers, torch's thread
    # pool on every core slows this many-small-ops run tenfold
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert chip_smoke.main(
            device="cpu", n_shards=64, taxi_shards=16, budget=32 << 20, sim_rows=5000, sim_block=300,
            cli_records=20_000, cli_shards=8, cli_bulk_bits=200_000,
        ) == 0
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.strip().splitlines()
    kernels = json.loads(lines[-2])["kernels"]
    fused = ("row_counts_tree", "bsi_sum_tree", "bsi_minmax_tree")
    assert [(k["path"], k["name"]) for k in kernels] == [
        ("main", "tree_eval"), ("main", "row_counts"), ("main", "stack_delta"), ("main", "shift_words"),
        ("main", "row_counts_tree"),
        ("taxi", "bsi_sum"), ("taxi", "bsi_sum"), ("taxi", "bsi_sum"), ("taxi", "bsi_minmax"), ("taxi", "gb_counts"),
        ("taxi", "gb_masks"),
        *(("taxi", n) for n in fused),
        ("residency", "tree_eval"), ("residency", "container_count"), ("residency", "stack_delta"),
        *(("residency", n) for n in fused),
        ("similarity", "sim_scan"), ("similarity", "sim_select"), ("similarity", "pairwise"),
        ("mesh", "tree_eval"), ("mesh", "row_counts"), ("mesh", "stack_delta"), ("mesh", "bsi_sum"), ("mesh", "bsi_sum"),
        ("mesh", "bsi_minmax"), ("mesh", "gb_counts"), ("mesh", "gb_masks"), ("mesh", "sim_select"),
        ("mesh", "pairwise"), ("mesh", "sim_select"), ("mesh", "mesh_sim_keys"), ("mesh", "mesh_pairwise_finish"),
        *(("mesh", n) for n in fused),
        ("graft", "ingest_counts"), ("graft", "count_keys"), ("graft", "sim_select"),
        ("mesh_programs", "ingest_counts"), ("mesh_programs", "row_counts"), ("mesh_programs", "bsi_sum"),
        ("mesh_programs", "tree_eval"), ("mesh_programs", "sim_select"), ("mesh_programs", "sim_select"),
    ]
    # the mesh search's finish: K10's one-launch small sim route on both
    # mesh paths, and K12's keys timed past 4,096 rows, where they still run
    assert [k["path"] for k in kernels if (k["shape"] or "").startswith("small sim")] == ["mesh", "mesh_programs"]
    assert next(k for k in kernels if k["name"] == "mesh_sim_keys")["shape"].startswith("4097 rows")
    assert all(k["max_abs_err"] == 0 for k in kernels)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) for k in kernels)
    paths = {"main", "serving", "taxi", "residency", "similarity", "mesh", "graft", "mesh_programs", "cli", "multihost",
             "cluster", "fleet"}
    assert {k["launches_by_path"].keys() == paths for k in kernels} == {True}
    # K4's grouped mode has entries of its own: 16 and 32 masks, per block
    assert [k["path"] for k in kernels if k["name"] == "bsi_sum" and (k["shape"] or "").startswith("grouped")] == [
        "taxi", "taxi", "mesh"]
    pairwise = next(k for k in kernels if (k["path"], k["name"]) == ("similarity", "pairwise"))
    # K11's bound is its bytes: its binary MMA has no published rate
    assert pairwise["bound_by"] == "bytes" and pairwise["library_ms"] is not None
    # the CUDA-graph device times: on every entry, not measured without a card
    assert all(k["graph_ms"] is None and k["library_graph_ms"] is None for k in kernels)
    assert {k["replaces"].split(":")[0] for k in kernels if k["path"] == "mesh"} == {
        "pilosa_tpu/parallel/mesh.py", "pilosa_tpu/executor/compile.py"}
    # main 8 + Shift 2 + the fused phase, write 2, serving 12 queries over
    # HTTP + the 3 C4 trees through its compiler, taxi 13 + the fused
    # phase, residency 8 + 4 fused queries + the fused phase + the write +
    # slots, similarity 3 searches + 4 all-pairs blocks; per mesh layout:
    # the main holder's 10 queries, its fused phase, the Row readback,
    # Shift, 4 Counts around the Set and Clear and their line, the taxi's
    # 13, its fused phase and the level-synchronous GroupBy (2 lines), 4
    # searches, 3 all-pairs blocks; the graft step; top_rows of one
    # fragment; per layout, the five mesh programs of dryrun_multichip;
    # the CLI's server, its two loads, 4 queries, the Count after a Set
    # and SIGTERM; the six programs on two ranks; the cluster's nodes,
    # 6 queries through each of two coordinators, the Set, its read-back
    # from the replicas, 3 Counts, 9 queries after the failover, the Set
    # and the Clear while node 2 is closed, 3 queries then, the line of
    # their acknowledgements and the marks file, the restart of nodes 0
    # and 1, 3 queries through each of them, node 2's reopen, 3 queries
    # through each of node 2, node 0 and node 1, and the 8 clients; the
    # fleet's start, its import, the mix before and after child 1's
    # restart (3 each), the Set and Clear while it is down, the restart
    # and SIGTERM
    mesh_layout = 10 + 1 + 1 + 1 + 4 + 1 + 13 + 1 + 2 + 4 + 3
    cluster = 1 + 2 * 6 + 1 + 1 + 3 + 9 + 2 + 3 + 1 + 1 + 2 * 3 + 1 + 3 * 3 + 1
    fleet = 1 + 1 + 3 + 1 + 1 + 3 + 1
    assert sum(line.startswith("ok  ") for line in lines) == (
        8 + 2 + 1 + 2 + 12 + 3 + 13 + 1 + 8 + 4 + 1 + 2 + 3 + 4 + 2 * mesh_layout + 1 + 1 + 2 * 5 + 9 + 6
        + cluster + fleet)
    assert not any(line.startswith('{"ok"') for line in lines)
