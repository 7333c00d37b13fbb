"""The port's HTTP server against pilosa_tpu's, over real sockets.

One data dir is written through the reference Server's HTTP imports,
then copied: the reference serves the original, the port's
``Server(..., device="cpu")`` the copy, both with ``route-mode =
"device"`` and the result cache off, so every read runs the device
programs (the port's plain torch versions here). Each case sends the
same requests to both and compares the JSON, or the status codes.
The probe gate is driven with a CUDA probe that hangs or fails, with
``torch.cuda.is_available`` patched: nothing runs on the CPU.
"""

import json
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pilosa_tpu.core as ref_core
import pilosa_tpu_torch.core as pt_core
from pilosa_tpu import roaring as ref_roaring
from pilosa_tpu.executor import Executor as RefExecutor
from pilosa_tpu.server import Server as RefServer
from pilosa_tpu.utils.config import Config as RefConfig
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server import server as server_mod
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.config import Config

from _torch_parity import N_SHARDS, fill

MAX_WRITES = 2000


def _config(cls, data_dir, **kw):
    return cls(
        bind="127.0.0.1:0", data_dir=str(data_dir), anti_entropy_interval=0, route_mode="device",
        result_cache_mode="off", max_writes_per_request=MAX_WRITES, profiler_enabled=False,
        diagnostics_interval=0, **kw,
    )


def call(srv, method, path, body=None, headers=None):
    """→ (status, parsed JSON or raw bytes, headers)"""
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            status, raw, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), e.headers
    try:
        return status, json.loads(raw or b"{}"), hdrs
    except ValueError:
        return status, raw, hdrs


def _chunks(n):
    return [slice(i, i + MAX_WRITES) for i in range(0, n, MAX_WRITES)]


def _write_fixture(srv):
    """Index i over three shards: set fields f (rows 0-5) and g (rows
    0-2), int field v in [-1000, 1000], a time field t, and the keyed
    index k; all through the HTTP imports."""
    rng = np.random.default_rng(17)
    n_cols = N_SHARDS * SHARD_WIDTH
    assert call(srv, "POST", "/index/i", {"options": {"trackExistence": True}})[0] == 200
    for name, opts in (("f", {}), ("g", {}), ("v", {"type": "int", "min": -1000, "max": 1000}),
                       ("t", {"type": "time", "timeQuantum": "YMD"})):
        assert call(srv, "POST", f"/index/i/field/{name}", {"options": opts})[0] == 200
    for name, n_bits, n_rows in (("f", 5000, 6), ("g", 1500, 3)):
        cols = rng.integers(0, n_cols, n_bits).tolist()
        rows = rng.integers(0, n_rows, n_bits).tolist()
        for sl in _chunks(n_bits):
            got = call(srv, "POST", f"/index/i/field/{name}/import", {"rowIDs": rows[sl], "columnIDs": cols[sl]})
            assert got[0] == 200, got
    vcols = rng.choice(n_cols, 600, replace=False).tolist()
    vals = rng.integers(-1000, 1001, 600).tolist()
    assert call(srv, "POST", "/index/i/field/v/import-value", {"columnIDs": vcols, "values": vals})[0] == 200
    tcols = rng.integers(0, n_cols, 300).tolist()
    stamps = [f"2020-{1 + i % 12:02d}-{1 + i % 27:02d}T05:00" for i in range(300)]
    got = call(srv, "POST", "/index/i/field/t/import",
               {"rowIDs": [i % 3 for i in range(300)], "columnIDs": tcols, "timestamps": stamps})
    assert got[0] == 200, got
    assert call(srv, "POST", "/index/k", {"options": {"keys": True}})[0] == 200
    assert call(srv, "POST", "/index/k/field/c", {"options": {"keys": True}})[0] == 200
    got = call(srv, "POST", "/index/k/query", b'Set("alice", c="red") Set("bob", c="red") Set("bob", c="blue")')
    assert got[0] == 200, got


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_server")
    writer = RefServer(_config(RefConfig, base / "ref", device_init_timeout=0, mesh_enabled=False))
    writer.open()
    try:
        _write_fixture(writer)
    finally:
        writer.close()
    shutil.copytree(base / "ref", base / "port")
    ref = RefServer(_config(RefConfig, base / "ref", device_init_timeout=0, mesh_enabled=False))
    port = Server(_config(Config, base / "port"), device="cpu")
    ref.open()
    port.open()
    assert ref.wait_mesh(60) and port.wait_mesh(60)
    yield ref, port
    port.close()
    ref.close()


def both(servers, method, path, body=None, headers=None):
    ref, port = servers
    return call(ref, method, path, body, headers), call(port, method, path, body, headers)


READS = [
    "Row(f=1)",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Union(Row(f=0), Row(g=1)))",
    "Count(Not(Row(f=3)))",
    "TopN(f, n=5)",
    "TopN(f, Row(g=1), n=3)",
    "Count(Row(v > 10))",
    "Row(-100 < v < 300)",
    "Sum(field=v)",
    "Sum(Row(f=2), field=v)",
    "Min(field=v)",
    "Max(Row(g=0), field=v)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), filter=Row(v > 0), limit=4)",
    "Row(t=1, from='2020-03-01T00:00', to='2020-09-01T00:00')",
    "Count(Shift(Row(f=1), n=2))",
    # past K1's fixed limits (C4): sub-programs
    "Count(Union(" + ", ".join(f"Row(f={i % 6})" for i in range(300)) + "))",
    "TopN(f, Union(" + ", ".join(f"Row(v > {i * 40})" for i in range(17)) + "), n=3)",
]


@pytest.mark.parametrize("pql", READS)
def test_read_query_matches_reference(servers, pql):
    want, got = both(servers, "POST", "/index/i/query", pql.encode())
    assert want[0] == 200, want
    assert got[:2] == want[:2]


def test_keyed_index_matches_reference(servers):
    for pql in (b'Row(c="red")', b'TopN(c, n=2)', b'Count(Row(c="blue"))'):
        want, got = both(servers, "POST", "/index/k/query", pql)
        assert want[0] == 200 and got[:2] == want[:2]


def test_set_clear_and_count_match_reference(servers):
    """Schema create over HTTP, then Set, Clear and the reads after
    them: the port takes the delta path (K3's plain version)."""
    for s in servers:
        assert call(s, "POST", "/index/w", {"options": {}})[0] == 200
        assert call(s, "POST", "/index/w/field/f", {"options": {}})[0] == 200
    cols = [3, 70000, SHARD_WIDTH * 2 + 5, 9]
    sets = " ".join(f"Set({c}, f={i % 2})" for i, c in enumerate(cols)).encode()
    for pql in (sets, b"Count(Row(f=0))", b"Row(f=1)", b"Clear(70000, f=1) Clear(1, f=1)",
                b"Row(f=1)", b"Count(Intersect(Row(f=0), Row(f=1)))", b"Count(Union(Row(f=0), Row(f=1)))"):
        want, got = both(servers, "POST", "/index/w/query", pql)
        assert want[0] == 200 and got[:2] == want[:2], pql
    # a write to the big index: the next read re-reads its stack
    want, got = both(servers, "POST", "/index/i/query", f"Set({SHARD_WIDTH + 7}, f=4) Count(Row(f=4))".encode())
    assert want[0] == 200 and got[:2] == want[:2]


@pytest.mark.parametrize("route", ["import", "import-value", "import-roaring"])
def test_import_routes_match_reference(servers, route):
    field = "imp_" + route.replace("-", "_")
    opts = {"type": "int", "min": -50, "max": 5000} if route == "import-value" else {}
    for s in servers:
        assert call(s, "POST", f"/index/i/field/{field}", {"options": opts})[0] == 200
    rng = np.random.default_rng(3)
    cols = rng.choice(N_SHARDS * SHARD_WIDTH, 400, replace=False)
    if route == "import":
        body, path = {"rowIDs": (cols % 4).tolist(), "columnIDs": cols.tolist()}, f"/index/i/field/{field}/import"
        reads = [f"Count(Row({field}=1))", f"TopN({field}, Row(f=1), n=4)"]
    elif route == "import-value":
        body = {"columnIDs": cols.tolist(), "values": rng.integers(-50, 5000, 400).tolist()}
        path = f"/index/i/field/{field}/import-value"
        reads = [f"Sum(field={field})", f"Count(Row({field} >= 100))", f"Min(Row(f=2), field={field})"]
    else:
        shard_cols = cols[cols < SHARD_WIDTH]
        positions = (shard_cols % 3) * SHARD_WIDTH + shard_cols
        body = ref_roaring.serialize(ref_roaring.Bitmap.from_values(np.sort(positions).astype(np.uint64)))
        path = f"/index/i/field/{field}/import-roaring/0"
        reads = [f"Count(Row({field}=2))", f"Row({field}=1)"]
    want, got = both(servers, "POST", path, body)
    assert want[0] == 200 and got[:2] == want[:2]
    for pql in reads:
        want, got = both(servers, "POST", "/index/i/query", pql.encode())
        assert want[0] == 200 and got[:2] == want[:2], pql


def test_schema_get_and_post_match_reference(servers):
    schema = {"indexes": [{"name": "s", "options": {"keys": False, "trackExistence": True}, "fields": [
        {"name": "a", "options": {"type": "set"}},
        {"name": "n", "options": {"type": "int", "min": -5, "max": 99, "hasRange": True}},
    ]}]}
    want, got = both(servers, "POST", "/schema", schema)
    assert want[0] == 200 and got[:2] == want[:2]
    want, got = both(servers, "GET", "/schema")
    assert want[0] == 200 and got[:2] == want[:2]
    want, got = both(servers, "GET", "/index/s")
    assert want[0] == 200 and got[:2] == want[:2]


def test_export_matches_reference(servers):
    for path in ("/export?index=i&field=g", "/export?index=i&field=f&shard=1", "/export?index=k&field=c"):
        want, got = both(servers, "GET", path)
        assert want[0] == 200 and got[:2] == want[:2], path


def _shape(x):
    """Keys and types of a JSON value, numbers as one type."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x[:1]]
    return "number" if isinstance(x, (int, float)) and not isinstance(x, bool) else type(x).__name__


@pytest.mark.parametrize("mode", ["true", "analyze"])
def test_explain_matches_reference(servers, mode):
    """EXPLAIN's plan: the same route, residency and cache verdicts and
    the same shape; the cost figures are each router's own calibration."""
    pql = b"Count(Intersect(Row(f=1), Row(g=2)))"
    want, got = both(servers, "POST", f"/index/i/query?explain={mode}", pql)
    assert want[0] == got[0] == 200
    w, g = want[1]["explain"], got[1]["explain"]
    for key in ("index", "query", "routeMode", "waveScheduler", "resultCache"):
        assert (key, _shape(g[key])) == (key, _shape(w[key]))
    for key in ("index", "query", "routeMode"):
        assert g[key] == w[key]
    assert g["waveScheduler"]["batchable"] == w["waveScheduler"]["batchable"]
    assert [c["route"] for c in g["calls"]] == [c["route"] for c in w["calls"]]
    assert [c["call"] for c in g["calls"]] == [c["call"] for c in w["calls"]]
    if mode == "analyze":
        assert got[1]["results"] == want[1]["results"]


@pytest.mark.parametrize(
    "method,path,body",
    [
        ("POST", "/index/Bad_Name", {}),
        ("POST", "/index/i/field/UPPER", {}),
        ("POST", "/index/ghost/query", b"Count(Row(f=1))"),
        ("GET", "/index/ghost", None),
        ("POST", "/index/i/query", b"Count(Row(nofield=1))"),
        ("POST", "/index/i/query", b"Count(Rows(f"),
        ("POST", "/index/i/field/f/import",
         {"rowIDs": [1] * (MAX_WRITES + 1), "columnIDs": list(range(MAX_WRITES + 1))}),
        ("POST", "/index/i/query", " ".join(f"Set({c}, f=1)" for c in range(MAX_WRITES + 1)).encode()),
    ],
    ids=["bad-index-name", "bad-field-name", "query-missing-index", "get-missing-index", "missing-field",
         "parse-error", "import-over-max-writes", "query-over-max-writes"],
)
def test_error_status_matches_reference(servers, method, path, body):
    want, got = both(servers, method, path, body)
    assert want[0] >= 400
    assert got[0] == want[0]


def test_expired_query_timeout_matches_reference(servers):
    """query-timeout-ms spent before the query reaches the scheduler:
    the labeled 504 on both servers."""
    for s in servers:
        s.http.query_timeout_ms = 1e-6
    try:
        want, got = both(servers, "POST", "/index/i/query", b"Count(Intersect(Row(f=0), Row(g=0)))")
    finally:
        for s in servers:
            s.http.query_timeout_ms = 0.0
    assert want[0] == 504 and got[0] == 504
    assert "deadline exceeded" in got[1]["error"]


def test_route_for_matches_reference():
    """Executor.route_for names the route of a query's first call as the
    reference's does, for every call kind, under each pinned mode and
    under auto on a small holder (the host engine)."""
    ref_h, pt_h = ref_core.Holder(None), pt_core.Holder(None)
    fill(ref_core, ref_h)
    fill(pt_core, pt_h)
    queries = ["Count(Row(f=1))", "Row(f=1)", "TopN(f, n=2)", "Sum(field=v)", "Min(field=v)", "Max(field=v)",
               "GroupBy(Rows(f))", "Rows(f)", "Set(1, f=1)", "Count(Shift(Row(f=1)))", "Options(Row(f=1), shards=[0])",
               "Clear(1, f=1) Count(Row(f=1))"]
    for mode in ("auto", "host", "device"):
        ref = RefExecutor(ref_h, route_mode=mode)
        port = Executor(pt_h, device="cpu", route_mode=mode)
        for q in queries:
            assert port.route_for("i", q) == ref.route_for("i", q), (mode, q)
    with pytest.raises(Exception, match="not found"):
        port.route_for("ghost", "Count(Row(f=1))")


# ------------------------------------------------------------ probe gate
def _probe_server(tmp_path, monkeypatch, body: str, timeout_s: float):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(server_mod, "_PROBE_BODY", body)
    monkeypatch.setattr(server_mod, "_DEVICE_PROBE", None)
    monkeypatch.setenv("PILOSA_TPU_TORCH_PROBE_CACHE", str(tmp_path / "probe.json"))
    s = Server(_config(Config, tmp_path / "d", device_init_timeout=timeout_s, query_gate_wait=0))
    assert s.device == torch.device("cuda", 0)
    s.open()
    return s


def _assert_nothing_ran(s):
    assert s.api.executor.router.decisions == {"host": 0, "device": 0, "mesh": 0, "host_unported": 0}
    assert s.api.executor.compiler.stacks.resident_bytes == 0


def test_probe_pending_then_failed_serves_503(tmp_path, monkeypatch):
    """While the CUDA probe runs, queries and imports answer 503 with
    Retry-After; when it times out they keep answering 503, with the
    reason, and schema routes serve. Nothing runs on the CPU."""
    s = _probe_server(tmp_path, monkeypatch, "import time; time.sleep(30)", 1.5)
    try:
        assert call(s, "POST", "/index/x", {})[0] == 200
        assert call(s, "POST", "/index/x/field/f", {})[0] == 200
        status, body, hdrs = call(s, "POST", "/index/x/query", b"Count(Row(f=1))")
        assert (status, body) == (503, {"error": "device probe in progress; retry"})
        assert hdrs.get("Retry-After")
        assert s.wait_mesh(30)
        assert s.device_verdict[0] is False and s.probe_seconds >= 1.5
        for path, req in (("/index/x/query", b"Count(Row(f=1))"),
                          ("/index/x/field/f/import", {"rowIDs": [1], "columnIDs": [1]})):
            status, body, hdrs = call(s, "POST", path, req)
            assert status == 503 and hdrs.get("Retry-After")
            assert "did not initialize within 2s" in body["error"] and "restart" in body["error"]
        assert call(s, "GET", "/schema")[0] == 200
        assert call(s, "GET", "/status")[0] == 200
        assert s.stats.expvar()["counters"]["queries_gated"] == 3
        _assert_nothing_ran(s)
    finally:
        s.close()


def test_failed_probe_serves_503_with_its_reason(tmp_path, monkeypatch):
    s = _probe_server(tmp_path, monkeypatch, "raise SystemExit('no CUDA-capable device is detected')", 60)
    try:
        assert s.wait_mesh(60)
        status, body, hdrs = call(s, "POST", "/index/x/query", b"Count(Row(f=1))")
        assert status == 503 and hdrs.get("Retry-After")
        assert "exited 1: no CUDA-capable device is detected" in body["error"]
        _assert_nothing_ran(s)
        # the verdict persists in the port's own probe-cache file
        assert json.loads((tmp_path / "probe.json").read_text())["pin"] == "cuda"
    finally:
        s.close()


def test_server_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(_config(Config, tmp_path / "d"))


@pytest.mark.parametrize(
    "kw,roadmap",
    [({"seeds": ["http://127.0.0.1:1"]}, "A10"), ({"coordinator": True}, "A10"),
     ({"coordinator_address": "127.0.0.1:8476"}, "A13b-2"),
     ({"serving_processes": 2}, "serving-processes.*A10"),
     ({"shared_bind": "127.0.0.1:10101"}, "shared-bind.*A10"),
     ({"fd_pass_socket": "/tmp/pass.sock"}, "fd-pass-socket.*A10"),
     ({"supervisor_state": "/tmp/fleet.json"}, "supervisor-state.*A10"),
     ({"serving_mode": "threaded"}, "event-loop listener only")],
)
def test_cluster_and_multihost_configs_are_refused(tmp_path, kw, roadmap):
    with pytest.raises(ValueError, match=roadmap):
        Server(_config(Config, tmp_path / "d", **kw), device="cpu")


@pytest.mark.parametrize(
    "path",
    ["/", "/status", "/info", "/version", "/metrics", "/debug/", "/debug/vars", "/debug/resources",
     "/debug/flightrec", "/debug/workload", "/debug/slo", "/debug/saturation", "/debug/cluster", "/debug/traces",
     "/debug/faults", "/index/i/field/f/fragment/data?shard=0", "/internal/fragment/nodes?index=i&shard=0"],
)
def test_admin_route_status_matches_reference(servers, path):
    """The control-plane and debug routes serve on the port as on the
    reference; the console page is the port's own copy."""
    want, got = both(servers, "GET", path)
    assert want[0] == 200
    assert got[0] == want[0]
    if path == "/":
        assert got[1] == want[1] and got[1].startswith(b"<!DOCTYPE html>")
    if path.startswith(("/index/", "/internal/")):
        assert got[1] == want[1]
