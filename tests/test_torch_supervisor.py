"""The port's multi-process supervisor and listeners against pilosa_tpu's.

tests/test_multiproc.py's in-process cases, on ``Server(...,
device="cpu")``: the SO_REUSEPORT probe, the restart backoff, the plan
(reuseport and fd-pass), the fleet-state file, the shared and the
fd-passed listeners, the threaded listener's refusal of both, and the
``/debug/processes`` view with and without a supervisor. Then the port's
own: every child is ``python -m pilosa_tpu_torch server --device D``,
a child of N takes 1/N of the card's default stack budget, and a fleet
of two children on the CPU answers through one public port while its
parent never imports torch.
"""

import array
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from pilosa_tpu.server import supervisor as ref_supervisor
from pilosa_tpu.utils.config import Config as RefConfig
from pilosa_tpu_torch.executor import compile as query_compile
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.server.supervisor import Supervisor, probe_so_reuseport, restart_backoff
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def http(port, method, path, body=None, timeout=60):
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


# --------------------------------------------------------------- units


def test_probe_so_reuseport_here():
    assert probe_so_reuseport() is True
    assert ref_supervisor.probe_so_reuseport() is True


def test_probe_so_reuseport_missing(monkeypatch):
    monkeypatch.delattr(socket, "SO_REUSEPORT")
    assert probe_so_reuseport() is False


def test_restart_backoff_curve():
    for n in range(0, 8):
        assert restart_backoff(n, 0.5, 10.0) == ref_supervisor.restart_backoff(n, 0.5, 10.0)
    assert [restart_backoff(n, 0.5, 10.0) for n in (1, 2, 3, 4, 5)] == [0.5, 1.0, 2.0, 4.0, 8.0]
    assert restart_backoff(50, 0.5, 10.0) == 10.0


def test_supervisor_rejects_zero_processes(tmp_path):
    with pytest.raises(ValueError):
        Supervisor(Config(serving_processes=0, data_dir=str(tmp_path)))


def _plans(tmp_path, mode, **kw):
    """The port's plan beside the reference's for one config."""
    out = []
    for mod, cfg_cls, name in ((ref_supervisor, RefConfig, "ref"), (None, Config, "port")):
        cls = mod.Supervisor if mod is not None else Supervisor
        sup = cls(cfg_cls(data_dir=str(tmp_path / name), **kw), argv_overrides={"tls_skip_verify": "1"})
        sup.mode = mode
        out.append((sup, sup.plan()))
    return out


def test_supervisor_plan_reuseport(tmp_path):
    (ref_sup, ref_children), (sup, children) = _plans(
        tmp_path, "reuseport", serving_processes=3, bind="127.0.0.1:18300", replica_n=2)
    assert len(children) == 3
    binds = [c.bind for c in children]
    assert len(set(binds)) == 3 and "127.0.0.1:18300" not in binds
    assert len({c.data_dir for c in children}) == 3
    seeds = ",".join(f"http://{b}" for b in binds)
    keys = lambda env: sorted(k for k in env if k.startswith("PILOSA_TPU_"))  # noqa: E731
    for i, (c, r) in enumerate(zip(children, ref_children)):
        env = c.env
        assert keys(env) == keys(r.env)
        assert env["PILOSA_TPU_SERVING_PROCESSES"] == "1"
        assert "PILOSA_TPU_NAME" not in env
        assert env["PILOSA_TPU_COORDINATOR"] == ("1" if i == 0 else "0")
        assert env["PILOSA_TPU_SEEDS"] == seeds
        assert env["PILOSA_TPU_REPLICA_N"] == "2"
        assert env["PILOSA_TPU_SHARED_BIND"] == "127.0.0.1:18300"
        assert "PILOSA_TPU_FD_PASS_SOCKET" not in env
        assert env["PILOSA_TPU_TLS_SKIP_VERIFY"] == "1"
        assert env["PILOSA_TPU_SUPERVISOR_STATE"] == sup.state_path


def test_supervisor_plan_fd_pass(tmp_path):
    (_, ref_children), (_, children) = _plans(tmp_path, "fd-pass", serving_processes=2, bind="127.0.0.1:18301")
    for i, (c, r) in enumerate(zip(children, ref_children)):
        assert "PILOSA_TPU_SHARED_BIND" not in c.env
        assert c.env["PILOSA_TPU_FD_PASS_SOCKET"].endswith(f"proc{i}.sock")
        assert os.path.basename(c.env["PILOSA_TPU_FD_PASS_SOCKET"]) == os.path.basename(
            r.env["PILOSA_TPU_FD_PASS_SOCKET"])


def test_supervisor_state_file(tmp_path):
    (ref_sup, _), (sup, _) = _plans(tmp_path, "reuseport", serving_processes=2, bind="127.0.0.1:18302")
    for s in (ref_sup, sup):
        os.makedirs(s.root, exist_ok=True)
        s.children = s.plan()
        s._write_state()
    ref_state = json.loads(open(ref_sup.state_path).read())
    state = json.loads(open(sup.state_path).read())
    # the reference's keys, and the fleet's device
    assert sorted(state) == sorted(list(ref_state) + ["device"]) and state["device"] == "cuda"
    assert state["mode"] == "reuseport"
    assert state["publicBind"] == "127.0.0.1:18302"
    assert state["parentPid"] == os.getpid()
    rows = state["processes"]
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref_state["processes"]]
    assert [r["index"] for r in rows] == [0, 1]
    for r, c in zip(rows, sup.children):
        assert r["bind"] == c.bind and r["uri"] == f"http://{c.bind}"
        assert r["ready"] is False and r["restarts"] == 0


def test_plan_spawns_the_port_on_the_parents_device(tmp_path, monkeypatch):
    """Each child is ``python -m pilosa_tpu_torch server`` with its bind,
    data dir and the parent's ``--device``."""
    sup = Supervisor(Config(serving_processes=2, bind="127.0.0.1:18303", data_dir=str(tmp_path)),
                     config_path="/etc/p.toml", device="cpu")
    sup.mode = "reuseport"
    sup.children = sup.plan()
    argvs = []

    class FakePopen:
        def __init__(self, argv, env=None):
            argvs.append((argv, env))
            self.pid = 1

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    for c in sup.children:
        sup._spawn(c)
    for (argv, env), c in zip(argvs, sup.children):
        assert argv == [sys.executable, "-m", "pilosa_tpu_torch", "server", "--bind", c.bind,
                        "--data-dir", c.data_dir, "--device", "cpu", "--config", "/etc/p.toml"]
        assert env is c.env
    sup._write_state()
    assert json.loads(open(sup.state_path).read())["device"] == "cpu"


def test_a_childs_default_budget_is_its_share_of_the_card(tmp_path):
    """A child reads the fleet's size from the supervisor's state file:
    its default budget is 70% of the card over N. A budget in the config
    wins, and a server outside a fleet takes the whole 70%."""
    state = tmp_path / "supervisor.json"
    state.write_text(json.dumps({"processes": [{"index": i} for i in range(3)]}))
    total = 80 << 30
    kw = dict(bind="127.0.0.1:0", data_dir=str(tmp_path / "d"), anti_entropy_interval=0)
    try:
        Server(Config(supervisor_state=str(state), **kw), device="cpu")
        assert query_compile.card_budget(total) == int(total * 0.7) // 3
        assert query_compile.stack_budget_if_resolved() is None
        Server(Config(supervisor_state=str(state), device_stack_budget_bytes=5 << 30, **kw), device="cpu")
        assert query_compile.stack_budget_if_resolved() == 5 << 30
        Server(Config(supervisor_state=str(tmp_path / "missing.json"), **kw), device="cpu")
        assert query_compile.card_budget(total) == int(total * 0.7)
        Server(Config(supervisor_state=str(state), **kw), device="cpu")
        Server(Config(**kw), device="cpu")
        assert query_compile.card_budget(total) == int(total * 0.7)
    finally:
        query_compile.set_card_share(1)
        query_compile.set_stack_budget(None)


# ------------------------------------------------- in-process listeners


def _make_server(tmp_path, name, **kw):
    s = Server(Config(bind="127.0.0.1:0", data_dir=str(tmp_path / name), anti_entropy_interval=0, **kw),
               device="cpu")
    s.open()
    s.wait_mesh(60)
    return s


def test_shared_reuseport_listener_two_servers(tmp_path):
    if not probe_so_reuseport():
        pytest.skip("no SO_REUSEPORT on this host")
    (shared,) = free_ports(1)
    a = _make_server(tmp_path, "a", shared_bind=f"127.0.0.1:{shared}")
    b = _make_server(tmp_path, "b", shared_bind=f"127.0.0.1:{shared}")
    try:
        for _ in range(16):
            assert http(shared, "GET", "/status")["state"] == "NORMAL"
        for s in (a, b):
            snap = http(s.port, "GET", "/debug/vars")["serving"]
            assert snap["sharedListener"] == {"mode": "reuseport", "bind": f"127.0.0.1:{shared}"}
        assert http(a.port, "GET", "/status")["state"] == "NORMAL"
    finally:
        a.close()
        b.close()


def test_fd_pass_adoption(tmp_path):
    fd_sock = str(tmp_path / "proc0.sock")
    s = _make_server(tmp_path, "a", fd_pass_socket=fd_sock)
    try:
        assert http(s.port, "GET", "/debug/vars")["serving"]["sharedListener"] == {"mode": "fd-pass", "bind": fd_sock}
        ctrl = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        ctrl.connect(fd_sock)
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        client = socket.create_connection(lst.getsockname())
        served, _ = lst.accept()
        ctrl.sendmsg([b"c"], [(socket.SOL_SOCKET, socket.SCM_RIGHTS, array.array("i", [served.fileno()]).tobytes())])
        served.close()
        client.sendall(b"GET /status HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        client.settimeout(30)
        buf = b""
        while True:
            chunk = client.recv(65536)
            if not chunk:
                break
            buf += chunk
        assert buf.startswith(b"HTTP/1.1 200") and b"NORMAL" in buf
        client.close()
        ctrl.close()
        lst.close()
        assert http(s.port, "GET", "/debug/vars")["counters"]["connections_adopted"] == 1.0
    finally:
        s.close()


def test_threaded_mode_rejects_multiproc_listeners(tmp_path):
    for kw in ({"shared_bind": "127.0.0.1:1"}, {"fd_pass_socket": str(tmp_path / "x.sock")}):
        cfg = Config(bind="127.0.0.1:0", data_dir=str(tmp_path / "t"), serving_mode="threaded", **kw)
        with pytest.raises(ValueError, match="serving-mode"):
            Server(cfg, device="cpu").open()


def test_debug_processes_unsupervised(tmp_path):
    s = _make_server(tmp_path, "a")
    try:
        view = http(s.port, "GET", "/debug/processes")
        assert view["supervised"] is False
        (row,) = view["processes"]
        assert "binding" in row and "verdict" in row
        assert row["sharedListener"] == {"mode": "none"}
    finally:
        s.close()


def test_debug_processes_supervised(tmp_path):
    """The stitched fleet view: the state file's parent metadata and each
    live member's saturation digest; a dead member is an error row."""
    s = _make_server(tmp_path, "a")
    try:
        (dead_port,) = free_ports(1)
        row = lambda i, port, **kw: dict(  # noqa: E731
            index=i, bind=f"127.0.0.1:{port}", uri=f"http://127.0.0.1:{port}", dataDir=str(tmp_path), **kw)
        state = {"mode": "reuseport", "publicBind": "127.0.0.1:1", "publicUri": "http://127.0.0.1:1",
                 "parentPid": 4242, "device": "cpu",
                 "processes": [row(0, s.port, pid=1, ready=True, restarts=0, lastExitCode=None),
                               row(1, dead_port, pid=2, ready=False, restarts=3, lastExitCode=-9)]}
        sp = tmp_path / "supervisor.json"
        sp.write_text(json.dumps(state))
        s.http.supervisor_state_path = str(sp)
        view = http(s.port, "GET", "/debug/processes?window=60")
        assert view["supervised"] is True and view["mode"] == "reuseport" and view["parentPid"] == 4242
        live, dead = view["processes"]
        assert live["index"] == 0 and "binding" in live
        assert dead["index"] == 1 and "error" in dead
        assert dead["restarts"] == 3 and dead["lastExitCode"] == -9
        with pytest.raises(urllib.error.HTTPError) as e:
            http(s.port, "GET", "/debug/processes?window=nope")
        assert e.value.code == 400
    finally:
        s.close()


# ----------------------------------------------------- a real fleet

# the parent through the CLI, reporting at exit whether it loaded torch
PARENT = (
    "import atexit, sys\n"
    "from pilosa_tpu_torch import cli\n"
    "atexit.register(lambda: print('PARENT_TORCH', 'torch' in sys.modules, flush=True))\n"
    "sys.exit(cli.main(sys.argv[1:]))\n"
)


def test_a_fleet_of_two_answers_through_one_port(tmp_path):
    (public,) = free_ports(1)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # one thread per child: two CPU servers and their probes start together
    env["OMP_NUM_THREADS"] = "1"
    log = open(tmp_path / "fleet.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", PARENT, "server", "--processes", "2", "--replica-n", "1", "--device", "cpu",
         "--bind", f"127.0.0.1:{public}", "--data-dir", str(tmp_path / "fleet")],
        env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp_path),
    )
    try:
        deadline = time.monotonic() + 120
        while "processes serving" not in open(tmp_path / "fleet.log").read():
            assert proc.poll() is None and time.monotonic() < deadline, open(tmp_path / "fleet.log").read()
            time.sleep(0.2)
        http(public, "POST", "/index/i", {})
        http(public, "POST", "/index/i/field/f", {})
        cols = [s * SHARD_WIDTH + 3 for s in range(8)]
        http(public, "POST", "/index/i/field/f/import", {"rowIDs": [1] * 8, "columnIDs": cols})
        for _ in range(6):  # new connections: the kernel spreads them over both children
            assert http(public, "POST", "/index/i/query", b"Count(Row(f=1))")["results"] == [8]
        state = json.loads((tmp_path / "fleet" / "supervisor.json").read_text())
        assert state["device"] == "cpu" and [p["ready"] for p in state["processes"]] == [True, True]
        with open(f"/proc/{proc.pid}/maps") as f:
            assert "libtorch" not in f.read()
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
    out = open(tmp_path / "fleet.log").read()
    assert rc == 0, out
    assert "PARENT_TORCH False" in out
    # each child reports its kernels at exit: none on the CPU
    assert out.count("kernel launches {}") == 2
