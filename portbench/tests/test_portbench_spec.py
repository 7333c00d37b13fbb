"""BENCHMARK.json against the files it names, and its names, units and
bounds against their limits."""

import json
import os
import re

import pytest

from portbench.run import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return Bench().spec


def test_every_cell_names_a_config_and_a_mix_that_exist(spec):
    configs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]
        assert {w["config"] for w in spec["workloads"]} >= {c["name"]}


def test_every_metric_has_a_reader_and_a_valid_entry(spec):
    cells = {w["name"] for w in spec["workloads"]}
    ends = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in ends
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", [])) <= cells
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in ends and m["source"] in ("device_trace", "program_span", "program_counter",
                                                      "host_clock")
        assert m["layer"] and "\n" not in m["layer"]
        # each cell that reads the metric reports the end-to-end metric it moves
        moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in cells:
        ends_of = [m for m in spec["end_to_end"] if w in m.get("workloads", [w])]
        assert len(ends_of) >= 2 and any(w in m["workloads"] for m in spec["per_layer"])


def test_file_names_under_the_paths_are_names(spec):
    for p in spec["paths"]:
        for root, dirs, files in os.walk(os.path.join(ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(root, f), ROOT)
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
