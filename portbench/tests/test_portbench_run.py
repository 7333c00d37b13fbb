"""Whole runs of the harness on the CPU (``rehearse.py``: the program's
plain versions, 8 shards of 2^16 columns): the last line's shape, a
sound run judged correct, the timed path broken underneath judged not
correct, no module of JAX or the JAX package loaded, and the measured
path refusing to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from portbench.control import control
from portbench.run import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "pilosa_tpu"}


def rehearse(*args, timeout=300) -> tuple:
    """(the result line, the loaded modules' top-level names)."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "rehearse.py"), *args],
                         capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = [ln for ln in out.stderr.splitlines() if ln.startswith("modules ")]
    return json.loads(out.stdout.strip().splitlines()[-1]), set(json.loads(modules[-1][len("modules "):]))


@pytest.mark.parametrize("cell, trace", [("taxi-1b.rides-c1", "1"), ("taxi-1b.rides-c1", "0"),
                                         ("taxi-1b.topn-c16", "1"), ("taxi-1b.topn-c16", "0")])
def test_a_sound_run_is_correct_and_loads_no_jax(cell, trace):
    line, modules = rehearse(cell, "--trace", trace, "--seconds", "1.5")
    assert line["correct"] is True, line
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"]["wrong"] == {"value": 0, "limit": 0}
    assert line["checks"]["checked"]["value"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes", "power_limit"} <= set(line["device"])
    bench = Bench()
    names = {m["name"] for m in bench.metrics(cell, trace == "1")}
    # on the CPU no device metric is read, and where the router sent
    # the small rehearsal's queries to the host no wave is there to read
    device_only = {"device_mem_gib", "kernels_roofline", "device_idle_pct"}
    if line["metrics"].get("device_route_pct", {}).get("value", 100.0) < 100.0:
        device_only.add("queries_per_wave")
    assert names - device_only <= set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], (int, float))
    assert not modules & FORBIDDEN
    assert "pilosa_tpu_torch" in modules  # the program served it


@pytest.mark.parametrize("fault", ["answer", "half"])
@pytest.mark.parametrize("cell", ["taxi-1b.rides-c1", "taxi-1b.topn-c16"])
def test_the_timed_path_broken_underneath_is_not_correct(cell, fault):
    """An answer altered where the API produces it; half of the shards
    left out of every query."""
    line, _ = rehearse(cell, "--fault", fault, "--seconds", "2")
    assert line["correct"] is False
    assert line["checks"]["wrong"]["value"] > 0


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference, portbench.judge, portbench.control, portbench.roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.replace("'", '"')))
    assert not top & (FORBIDDEN | {"pilosa_tpu_torch", "torch"})


def test_the_clients_import_only_the_standard_library():
    import ast

    with open(os.path.join(ROOT, "portbench", "loadgen.py")) as fh:
        tree = ast.parse(fh.read())
    imports = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imports |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imports.add(node.module.split(".")[0])
    assert imports == {"http", "json", "sys", "threading", "time"}


def test_the_measured_path_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "taxi-1b.rides-c1", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.mark.parametrize("cell, check_max", [("taxi-1b.rides-c1", 4), ("taxi-1b.topn-c16", 70)])
def test_the_control_fails_at_the_cells_own_size(cell, check_max):
    got = control(cell, 3_000_000_031, 2.0, check_max=check_max)
    assert got["checked"] == check_max and got["wrong"] > 0


@pytest.mark.card
def test_a_cell_on_the_card_is_correct(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "taxi-1b.topn-c16",
                          "--seed", "3000000041", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["kind"] == card
    assert line["device"]["busy_s"] > 0
