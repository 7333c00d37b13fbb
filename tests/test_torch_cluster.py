"""The port's cluster layer against pilosa_tpu's, over real sockets.

``make_cluster`` is tests/test_cluster.py's, once for each package: the
reference's ``Server`` (no device probe, no mesh: its CPU backend) and
the port's ``Server(..., device="cpu")`` (the plain torch versions of the
kernels). Three nodes, ``replica_n = 2``, no anti-entropy loop, the
result cache off and ``route-mode = "device"``, so every leg runs the
device programs. ``_torch_parity.fill``'s data goes into each cluster
and into one port node alone through the same HTTP imports; every call
of the parity set, sent to one node, answers with the reference
cluster's JSON and the single node's. The other cases drive placement,
replication, two-phase TopN, GroupBy's global child limit, key
translation, a node down, a dead sole owner, a join, coalesced legs,
and a node whose card failed its probe. The last cases hold reads right
after an acknowledged write, while a node's probes of a peer fail or a
node is cut off from its peers, exact or an error.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import pilosa_tpu.parallel.topology as ref_topology
import pilosa_tpu_torch.parallel.topology as pt_topology
from pilosa_tpu import cli as ref_cli
from pilosa_tpu.server import Server as RefServer
from pilosa_tpu.utils.config import Config as RefConfig
from pilosa_tpu_torch import cli
from pilosa_tpu_torch.parallel.client import InternalClient, PeerError
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.config import Config

from _torch_parity import N_SHARDS, fill_data
from test_torch_slice import AGGREGATES, HOST_ONLY, READS

PKGS = ("ref", "port")
MAX_WRITES = 2000


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


def _server(pkg, port, data_dir, seeds=None, replica_n=2, coordinator=False, **extra):
    kw = dict(
        bind=f"127.0.0.1:{port}", data_dir=str(data_dir), seeds=seeds or [], replica_n=replica_n,
        coordinator=coordinator, anti_entropy_interval=0, result_cache_mode="off",
        route_mode="device", max_writes_per_request=MAX_WRITES, profiler_enabled=False,
        diagnostics_interval=0, **extra,
    )
    if pkg == "ref":
        return RefServer(RefConfig(device_init_timeout=0, mesh_enabled=False, **kw))
    return Server(Config(**kw), device="cpu")


def make_cluster(pkg, tmp_path, n=3, replica_n=2, start=None, **extra):
    """tests/test_cluster.py's harness: ``n`` nodes on free ports, node 0
    the coordinator; ``start`` limits which nodes open; ``extra`` config
    keys go to every node."""
    ports = free_ports(n)
    seeds = [f"http://127.0.0.1:{p}" for p in ports]
    servers = []
    for i in range(n):
        if start is not None and i not in start:
            servers.append(None)
            continue
        s = _server(pkg, ports[i], tmp_path / f"{pkg}{i}", seeds, replica_n, coordinator=(i == 0), **extra)
        s.open()
        servers.append(s)
    # startup heartbeats ran while later nodes were not listening yet
    for s in servers:
        if s is not None:
            s.cluster._heartbeat_once()
    return servers, ports, seeds


def shutdown(servers):
    live = [s for s in servers if s is not None]
    # stop the heartbeats and drop every pooled peer connection first,
    # so no listener waits on a peer's idle keep-alive socket
    for s in live:
        if s.cluster is not None:
            s.cluster.close()
            s.cluster.client.close()
    for s in live:
        s.close()


def call(port, method, path, body=None):
    """→ (status, parsed JSON)"""
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, json.loads(raw or b"{}")


def ok(port, method, path, body=None):
    status, out = call(port, method, path, body)
    assert status == 200, (path, status, out)
    return out


def query(port, index, pql):
    return ok(port, "POST", f"/index/{index}/query", pql.encode())["results"]


def _import(port, index, field, rows, cols, **extra):
    for lo in range(0, len(cols), MAX_WRITES):
        body = {"rowIDs": [int(r) for r in rows[lo:lo + MAX_WRITES]],
                "columnIDs": [int(c) for c in cols[lo:lo + MAX_WRITES]]}
        body.update({k: v[lo:lo + MAX_WRITES] for k, v in extra.items()})
        ok(port, "POST", f"/index/{index}/field/{field}/import", body)


def load_parity(port):
    """``_torch_parity.fill``'s index "i" through the HTTP imports."""
    d = fill_data()
    ok(port, "POST", "/index/i", {"options": {"trackExistence": True}})
    for name, opts in (("f", {}), ("g", {}), ("t", {"type": "time", "timeQuantum": "YMD"}),
                       ("v", {"type": "int", "min": -1000, "max": 1000})):
        ok(port, "POST", f"/index/i/field/{name}", {"options": opts})
    _import(port, "i", "f", *d["f"])
    _import(port, "i", "g", *d["g"])
    rows, cols, stamps = d["t"]
    _import(port, "i", "t", rows, cols, timestamps=[s.strftime("%Y-%m-%dT%H:%M") for s in stamps])
    vcols, vals = d["v"]
    for lo in range(0, len(vcols), MAX_WRITES):
        ok(port, "POST", "/index/i/field/v/import-value",
           {"columnIDs": [int(c) for c in vcols[lo:lo + MAX_WRITES]],
            "values": [int(v) for v in vals[lo:lo + MAX_WRITES]]})


@pytest.fixture(scope="module")
def deployments(tmp_path_factory):
    """{"ref": ports, "port": ports, "single": [port], "servers": ...}:
    both clusters and one port node alone, each loaded with the parity
    data."""
    base = tmp_path_factory.mktemp("torch_cluster")
    out, servers = {}, []
    try:
        for pkg in PKGS:
            srvs, ports, _ = make_cluster(pkg, base)
            servers += srvs
            load_parity(ports[1])
            out[pkg] = ports
            out.setdefault("servers", {})[pkg] = srvs
        (p,) = free_ports(1)
        single = _server("port", p, base / "single")
        single.open()
        servers.append(single)
        load_parity(p)
        out["single"] = [p]
        yield out
    finally:
        shutdown(servers)


PARITY = READS + AGGREGATES + HOST_ONLY


@pytest.mark.parametrize("pql", PARITY)
def test_parity_set_matches_the_reference_cluster(deployments, pql):
    node = PARITY.index(pql) % 3
    want = call(deployments["ref"][node], "POST", "/index/i/query", pql.encode())
    got = call(deployments["port"][node], "POST", "/index/i/query", pql.encode())
    alone = call(deployments["single"][0], "POST", "/index/i/query", pql.encode())
    assert want[0] == 200, want
    assert got == want
    assert alone == want


def test_partition_placement_matches_the_reference(deployments):
    """Topology places every shard on the reference's owners, and each
    port node holds only shards it owns, with every shard held twice."""
    nodes = [f"http://127.0.0.1:{p}" for p in (11, 22, 33, 44)]
    for replica_n in (1, 2, 3):
        ref = ref_topology.Topology([ref_topology.Node(id=u, uri=u) for u in nodes], replica_n=replica_n)
        pt = pt_topology.Topology([pt_topology.Node(id=u, uri=u) for u in nodes], replica_n=replica_n)
        for shard in range(64):
            assert [n.id for n in pt.shard_nodes("i", shard)] == [n.id for n in ref.shard_nodes("i", shard)]
    assert pt_topology.partition("i", 5) == ref_topology.partition("i", 5)
    servers = deployments["servers"]["port"]
    held = {}
    for srv in servers:
        me = srv.cluster.me.id
        for shard in srv.holder.index("i").available_shards():
            assert srv.cluster.topology.owns(me, "i", shard)
            held.setdefault(shard, set()).add(me)
    assert sorted(held) == list(range(N_SHARDS))
    for shard, ids in held.items():
        assert ids == {n.id for n in servers[0].cluster.shard_nodes("i", shard)} and len(ids) == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_replicated_set_is_read_from_each_replica(tmp_path, pkg):
    """A Set through one node lands on both owners of its shard: each
    owner's own /internal/query over that shard counts it."""
    servers, ports, _ = make_cluster(pkg, tmp_path)
    try:
        ok(ports[0], "POST", "/index/i", {})
        ok(ports[0], "POST", "/index/i/field/f", {})
        cols = [s * SHARD_WIDTH + 3 for s in range(6)]
        _import(ports[0], "i", "f", [1] * 6, cols)
        col = 4 * SHARD_WIDTH + 9
        assert query(ports[2], "i", f"Set({col}, f=1)") == [True]
        owners = servers[0].cluster.shard_nodes("i", 4)
        assert len(owners) == 2
        client = InternalClient()
        for o in owners:
            got = client.query_node(o.uri, "i", "Count(Row(f=1))", [4])
            assert got == [2]
        client.close()
        for p in ports:
            assert query(p, "i", "Count(Row(f=1))") == [7]
    finally:
        shutdown(servers)


def _owner_shards(servers, index, n_shards=12):
    """Each node's shards as replica 0, over the first ``n_shards``."""
    by_node = {}
    for s in range(n_shards):
        by_node.setdefault(servers[0].cluster.shard_nodes(index, s)[0].id, []).append(s)
    return [by_node.get(srv.cluster.me.id, []) for srv in servers]


@pytest.mark.parametrize("pkg", PKGS)
def test_topn_two_phase_is_exact(tmp_path, pkg):
    """tests/test_cluster.py's case: row 100 is top-heavy on node A and
    under node B's local cut; the coordinator's recount (TopN's ids
    mode on each node) gives its exact global count."""
    servers, ports, _ = make_cluster(pkg, tmp_path, n=2, replica_n=1)
    try:
        ok(ports[0], "POST", "/index/i", {})
        ok(ports[0], "POST", "/index/i/field/f", {})
        sh_a, sh_b = (_owner_shards(servers, "i")[i][0] for i in (0, 1))
        rows, cols = [], []
        for off in range(30):
            rows.append(100), cols.append(sh_a * SHARD_WIDTH + off)
        for r in range(1, 21):
            for off in range(10):
                rows.append(r), cols.append(sh_a * SHARD_WIDTH + 100 + r * 10 + off)
        for off in range(5):
            rows.append(100), cols.append(sh_b * SHARD_WIDTH + off)
        for r in range(21, 41):
            for off in range(10):
                rows.append(r), cols.append(sh_b * SHARD_WIDTH + 100 + (r - 20) * 10 + off)
        _import(ports[0], "i", "f", rows, cols)
        assert query(ports[0], "i", "Count(Row(f=100))") == [35]
        for p in ports:
            assert query(p, "i", "TopN(f, n=1)") == [[{"id": 100, "count": 35}]]
            assert query(p, "i", "TopN(f, ids=[100, 1], n=1)") == [[{"id": 100, "count": 35}]]
    finally:
        shutdown(servers)


@pytest.mark.parametrize("pkg", PKGS)
def test_groupby_child_limit_is_global(tmp_path, pkg):
    """Rows(f, limit=L) in a cluster GroupBy keeps the GLOBAL first L rows
    of f (tests/test_cluster.py's case)."""
    servers, ports, _ = make_cluster(pkg, tmp_path, n=2, replica_n=1)
    try:
        ok(ports[0], "POST", "/index/i", {})
        ok(ports[0], "POST", "/index/i/field/f", {})
        ok(ports[0], "POST", "/index/i/field/g", {})
        sh_a, sh_b = (_owner_shards(servers, "i")[i][0] for i in (0, 1))
        rows = [2] * 3 + [1] * 4 + [2] * 2
        cols = [sh_a * SHARD_WIDTH + o for o in range(3)] + [sh_b * SHARD_WIDTH + o for o in range(4)] + \
               [sh_b * SHARD_WIDTH + 10 + o for o in range(2)]
        _import(ports[0], "i", "f", rows, cols)
        gcols = sorted(set(cols))
        _import(ports[0], "i", "g", [5] * len(gcols), gcols)
        _import(ports[0], "i", "f", [0] * 3, [sh_a * SHARD_WIDTH + 100 + k for k in range(3)])
        assert query(ports[0], "i", "GroupBy(Rows(f, limit=1), Rows(g))") == [[]]
        g = lambda r: [{"field": "f", "rowID": r}, {"field": "g", "rowID": 5}]  # noqa: E731
        assert query(ports[0], "i", "GroupBy(Rows(f, limit=2), Rows(g))") == [[{"group": g(1), "count": 4}]]
        assert query(ports[1], "i", "GroupBy(Rows(f), Rows(g), limit=2)") == [
            [{"group": g(1), "count": 4}, {"group": g(2), "count": 5}]]
    finally:
        shutdown(servers)


@pytest.mark.parametrize("pkg", PKGS)
def test_translate_keys_are_allocated_on_the_primary_only(tmp_path, pkg):
    servers, ports, _ = make_cluster(pkg, tmp_path)
    try:
        ok(ports[0], "POST", "/index/ki", {"options": {"keys": True}})
        a = ok(ports[1], "POST", "/internal/translate/keys", {"index": "ki", "keys": ["k1", "k2"]})["ids"]
        b = ok(ports[2], "POST", "/internal/translate/keys", {"index": "ki", "keys": ["k3", "k1"]})["ids"]
        assert len(set(a + b[:1])) == 3 and b[1] == a[0]
        c = ok(ports[0], "POST", "/internal/translate/keys", {"index": "ki", "keys": ["k3"], "lookupOnly": True})["ids"]
        assert c == [b[0]]
        ok(ports[0], "POST", "/index/ki/field/c", {"options": {"keys": True}})
        assert query(ports[2], "ki", 'Set("alice", c="red") Set("bob", c="red")') == [True, True]
        for p in ports:
            assert query(p, "ki", 'Count(Row(c="red"))') == [2]
    finally:
        shutdown(servers)


@pytest.mark.parametrize("pkg", PKGS)
def test_node_down_answers_degraded_and_catches_up(tmp_path, pkg):
    servers, ports, seeds = make_cluster(pkg, tmp_path, start={0, 1})
    try:
        ok(ports[0], "POST", "/index/i", {})
        ok(ports[0], "POST", "/index/i/field/f", {})
        assert ok(ports[0], "GET", "/status")["state"] == "DEGRADED"
        cols = [s * SHARD_WIDTH + 1 for s in range(6)]
        _import(ports[0], "i", "f", [1] * 6, cols)
        assert query(ports[1], "i", "Count(Row(f=1))") == [6]
        s2 = _server(pkg, ports[2], tmp_path / f"{pkg}2", seeds)
        s2.open()
        servers[2] = s2
        owned = {sh for sh in range(6) if s2.cluster.topology.owns(s2.cluster.me.id, "i", sh)}
        assert owned and owned <= s2.holder.index("i").available_shards()
        assert query(ports[2], "i", "Count(Row(f=1))") == [6]
        assert query(ports[2], "i", "TopN(f, n=1)") == [[{"id": 1, "count": 6}]]
    finally:
        shutdown(servers)


@pytest.mark.parametrize("pkg", PKGS)
def test_dead_sole_owner_is_an_error_not_a_partial_answer(tmp_path, pkg):
    servers, ports, _ = make_cluster(pkg, tmp_path, n=2, replica_n=1)
    try:
        ok(ports[0], "POST", "/index/i", {})
        ok(ports[0], "POST", "/index/i/field/f", {})
        _import(ports[0], "i", "f", [1] * 4, [s * SHARD_WIDTH + 1 for s in range(4)])
        assert query(ports[0], "i", "Count(Row(f=1))") == [4]
        c0 = servers[0].cluster
        assert any(not c0.topology.owns(c0.me.id, "i", s) for s in range(4))
        c0.client.close()  # no idle connection holds node 1's listener
        servers[1].close()
        servers[1] = None
        c0._heartbeat_once()
        c0._known_shards.clear()
        status, body = call(ports[0], "POST", "/index/i/query", b"Count(Row(f=1))")
        assert status == 503 and "results" not in body
    finally:
        shutdown(servers)


@pytest.mark.parametrize("pkg", PKGS)
def test_a_joining_node_rebalances(tmp_path, pkg):
    """A fourth node joins: every member lists it, it pulls the shards it
    now owns through the movement lane (``GET /debug/cluster``), and the
    answers stay exact from every member."""
    servers, ports, seeds = make_cluster(pkg, tmp_path, n=2, replica_n=1)
    try:
        ok(ports[0], "POST", "/index/i", {})
        ok(ports[0], "POST", "/index/i/field/f", {})
        n_shards = 16
        _import(ports[0], "i", "f", [1] * n_shards, [s * SHARD_WIDTH + 7 for s in range(n_shards)])
        (new_port,) = free_ports(1)
        joiner = _server(pkg, new_port, tmp_path / f"{pkg}-join", seeds + [f"http://127.0.0.1:{new_port}"], 1)
        joiner.open()
        servers.append(joiner)
        ports.append(new_port)
        for s in servers:
            s.cluster.wait_rebalanced(30)
        assert {len(s.cluster.topology.nodes) for s in servers} == {3}
        own = [sh for sh in range(n_shards) if joiner.cluster.topology.owns(joiner.cluster.me.id, "i", sh)]
        assert own and set(own) <= joiner.holder.index("i").available_shards()
        dbg = ok(new_port, "GET", "/debug/cluster")
        assert dbg["movement"]["meter"]["bytesByDirection"].get("pull", 0) > 0
        assert dbg["rebalance"]["inFlight"] is False
        for p in ports:
            assert query(p, "i", "Count(Row(f=1))") == [n_shards]
    finally:
        shutdown(servers)


def test_coalesced_legs_share_one_wave_and_isolate_errors(tmp_path):
    """k legs in one ``/internal/query/batch`` RPC go to the node's wave
    scheduler as one enqueue (``execute_many``): fewer waves than legs,
    each leg its own answer, and a bad leg an error of its own."""
    servers, ports, _ = make_cluster("port", tmp_path, n=2, replica_n=1)
    try:
        ok(ports[0], "POST", "/index/qb", {})
        ok(ports[0], "POST", "/index/qb/field/f", {})
        cols = list(range(0, 3 * SHARD_WIDTH, 97))
        _import(ports[0], "qb", "f", [c % 5 for c in cols], cols)
        uri = f"http://127.0.0.1:{ports[1]}"
        client = InternalClient()
        want = [client.query_node(uri, "qb", f"Count(Row(f={r}))", None)[0] for r in range(5)]
        sched = servers[1].api.scheduler
        waves, legs = sched.waves, 5
        entries = [{"index": "qb", "query": f"Count(Row(f={r}))", "shards": None, "traceId": None,
                    "parentSpanId": None} for r in range(legs)]
        entries.insert(2, {"index": "qb", "query": "Count(Row(ghost=1))", "shards": None,
                           "traceId": None, "parentSpanId": None})
        outs = client.query_batch_node(uri, entries)
        assert [o[0] for i, o in enumerate(outs) if i != 2] == want
        assert isinstance(outs[2], PeerError) and "ghost" in str(outs[2])
        assert 1 <= sched.waves - waves < legs
        client.close()
        # concurrent client queries through both coordinators stay exact
        expect = query(ports[0], "qb", "Count(Row(f=1))")
        got, errors = [None] * 8, []
        barrier = threading.Barrier(8)

        def run(i):
            barrier.wait()
            try:
                got[i] = query(ports[i % 2], "qb", "Count(Row(f=1))")
            except Exception as exc:  # noqa: BLE001 — surfaced below
                errors.append(exc)

        ts = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errors and got == [expect] * 8
    finally:
        shutdown(servers)


def test_a_failed_card_fails_its_legs_over_and_is_named_when_alone(tmp_path):
    """A node whose card failed its probe answers its legs 503 with the
    reason. It stays alive for heartbeats; its legs fail over to a
    replica, and where it alone holds a shard the query fails naming the
    node and its card: never a partial answer, never the CPU."""
    servers, ports, _ = make_cluster("port", tmp_path)
    try:
        ok(ports[0], "POST", "/index/i", {})
        ok(ports[0], "POST", "/index/i/field/f", {})
        n_shards = 12
        _import(ports[0], "i", "f", [1] * n_shards, [s * SHARD_WIDTH + 5 for s in range(n_shards)])
        bad = servers[1]
        bad.device_verdict = (False, "CUDA probe exited 1: no CUDA-capable device is detected")
        status, body = call(ports[1], "POST", "/index/i/query", b"Count(Row(f=1))")
        assert status == 503 and "failed its probe" in body["error"]
        bad_id = bad.cluster.me.id
        c0 = servers[0].cluster
        for _ in range(3):
            assert query(ports[0], "i", "Count(Row(f=1))") == [n_shards]
            assert query(ports[2], "i", "TopN(f, n=1)") == [[{"id": 1, "count": n_shards}]]
        c0._heartbeat_once()
        assert next(n for n in c0.nodes if n.id == bad_id).alive
        # the third node goes: shards held by {bad, third} have no card left
        third = servers[2]
        alone = [s for s in range(n_shards)
                 if {n.id for n in c0.shard_nodes("i", s)} == {bad_id, third.cluster.me.id}]
        assert alone
        third.close()
        servers[2] = None
        c0._heartbeat_once()
        status, body = call(ports[0], "POST", "/index/i/query", b"Count(Row(f=1))")
        assert status == 503 and "results" not in body
        assert bad_id in body["error"] and "failed its probe" in body["error"]
        assert "no CUDA-capable device" in body["error"]
    finally:
        shutdown(servers)


# ------------------------------------- C5: reads right after an acknowledged import
C5_SHARDS = 8
C5_RECORDS = 4000
C5_READS = ("TopN(f, n=10)", "Count(Union(Row(f=1), Row(f=2)))", "GroupBy(Rows(f))", "Sum(field=v)")
# node 0's client cannot reach node 2's /status: the heartbeat probe that
# timed out under load while node 2 serves. The reference's node 0 then
# holds node 2 for dead and leaves it out of the import's writes and
# shard announce.
PROBE_LOST = {"path": "/status", "action": "blackhole"}
# node 0's shard announce cannot reach node 2, which serves
ANNOUNCE_LOST = {"path": "/internal/shards/announce", "action": "blackhole"}


def c5_data():
    """rows 1-2 over ``C5_SHARDS`` shards, and values of the int field v
    on a third of their columns; with numpy's answer to each read."""
    rng = np.random.default_rng(5)
    rows = rng.integers(1, 3, C5_RECORDS)
    cols = rng.integers(0, C5_SHARDS * SHARD_WIDTH, C5_RECORDS)
    vcols = np.unique(cols)[::3]
    vals = rng.integers(-100, 1000, vcols.size)
    u = {r: np.unique(cols[rows == r]) for r in (1, 2)}
    top = sorted(((r, int(u[r].size)) for r in (1, 2)), key=lambda rc: (-rc[1], rc[0]))
    want = dict(zip(C5_READS, (
        [{"id": r, "count": c} for r, c in top],
        int(np.union1d(u[1], u[2]).size),
        [{"group": [{"field": "f", "rowID": r}], "count": int(u[r].size)} for r in (1, 2)],
        {"value": int(vals.sum()), "count": int(vals.size)},
    )))
    return (rows, cols, vcols, vals), want


def c5_arm(servers, ports, rule):
    """Node 0 arms ``rule`` against node 2 on its peer client and runs
    one heartbeat."""
    servers[0].fault_injector.set_rules([{**rule, "peer": f"127.0.0.1:{ports[2]}"}], seed=5)
    servers[0].cluster._heartbeat_once()


def c5_cluster(pkg, tmp_path, rule):
    """Three nodes, ``replica_n = 2``, whose heartbeats run only when the
    test runs them (so a stale view stays as the fault left it). Node 0
    arms ``rule`` against node 2, and its heartbeat ticks once now and
    once after each schema broadcast: the tick that, under load, falls
    between the CLI's ``--create`` (whose broadcast reaches node 2 and
    marks it alive in the reference) and its first frame."""
    servers, ports, _ = make_cluster(pkg, tmp_path, heartbeat_interval=3600)
    c5_arm(servers, ports, rule)
    s0 = servers[0]
    broadcast = s0.http.broadcast_schema

    def broadcast_then_tick():
        broadcast()
        s0.cluster._heartbeat_once()

    s0.http.broadcast_schema = broadcast_then_tick
    return servers, ports


def c5_import(pkg, port, tmp_path, data, create=True, create_v=True):
    """``import --roaring --create`` of the records through one node, as
    chip_smoke.py's fleet phase sends it (``create``: with ``--create``),
    then v's values (``create_v``: into a new field v)."""
    rows, cols, vcols, vals = data
    csv = tmp_path / "c5.csv"
    csv.write_text("".join(f"{r},{c}\n" for r, c in zip(rows.tolist(), cols.tolist())))
    argv = ["import", str(csv), "--roaring", "--host", f"127.0.0.1:{port}", "-i", "c5", "-f", "f"]
    assert (cli if pkg == "port" else ref_cli).main(argv + ["--create"] * create) == 0
    if create_v:
        ok(port, "POST", "/index/c5/field/v", {"options": {"type": "int", "min": -1000, "max": 1000}})
    ok(port, "POST", "/index/c5/field/v/import-value", {"columnIDs": vcols.tolist(), "values": vals.tolist()})


@pytest.fixture(scope="module")
def probe_lost(tmp_path_factory):
    """{pkg: ports} of a cluster of each package after the import through
    node 0 under ``PROBE_LOST``, with numpy's answers under "want" and
    whether node 0 held node 2 alive before the import under
    "{pkg}_node2_alive"."""
    data, want = c5_data()
    out, servers = {"want": want}, []
    try:
        for pkg in PKGS:
            tmp = tmp_path_factory.mktemp(f"c5_{pkg}")
            srvs, ports = c5_cluster(pkg, tmp, PROBE_LOST)
            servers += srvs
            out[f"{pkg}_node2_alive"] = next(n for n in srvs[0].cluster.nodes if n.uri.endswith(f":{ports[2]}")).alive
            c5_import(pkg, ports[0], tmp, data)
            out[pkg] = ports
        yield out
    finally:
        shutdown(servers)


@pytest.mark.parametrize("pql", C5_READS)
def test_reads_right_after_an_acknowledged_import_are_exact(probe_lost, pql):
    """C5: the import through node 0 was acknowledged while node 0's probe
    of node 2 was lost. Each read through each node, right away, equals
    numpy: node 2 took its replicas and was told where the new shards
    are, although its own heartbeat has not run since."""
    for port in probe_lost["port"]:
        assert query(port, "c5", pql) == [probe_lost["want"][pql]], port


def test_reference_reads_partially_after_a_missed_announce(probe_lost):
    """The reference's C5, pinned: its node 0 announces the new shards only
    to the peers its heartbeat holds alive, so node 2, which serves,
    knows none of them and counts short of numpy, with no error, until
    its next heartbeat. Nodes 0 and 1 answer exactly."""
    pql = C5_READS[1]
    want = probe_lost["want"][pql]
    ports = probe_lost["ref"]
    assert not probe_lost["ref_node2_alive"]  # one lost probe dead-marked it
    assert [query(p, "c5", pql) for p in ports[:2]] == [[want]] * 2
    (got,) = query(ports[2], "c5", pql)
    assert 0 <= got < want


def test_an_import_that_cannot_tell_a_serving_peer_is_not_acknowledged(tmp_path):
    """Node 0's shard announce cannot reach node 2, which serves: the
    import fails with a 503 naming node 2 where the reference would
    acknowledge it and node 2 would count short. Once the announce gets
    through, the client's retry tells node 2, and every read through
    every node equals numpy."""
    data, want = c5_data()
    servers, ports = c5_cluster("port", tmp_path, ANNOUNCE_LOST)
    try:
        with pytest.raises(Exception, match=r"HTTP 503.*were not told"):
            c5_import("port", ports[0], tmp_path, data)
        servers[0].fault_injector.clear()
        c5_import("port", ports[0], tmp_path, data, create=False, create_v=True)
        for port in ports:
            for pql in C5_READS:
                assert query(port, "c5", pql) == [want[pql]], (port, pql)
    finally:
        shutdown(servers)


def test_a_peer_that_refused_while_it_restarted_is_told_of_new_shards(tmp_path):
    """C5's other source: node 0's heartbeat found node 2 refusing while it
    restarted, and node 0's next tick has not come. A Set through node 0
    into a new shard that node 2 does not own is acknowledged only once
    node 2, listening again, was told where it lives: the Count through
    every node, right away, equals numpy."""
    servers, ports, seeds = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        ok(ports[0], "POST", "/index/c5", {})
        ok(ports[0], "POST", "/index/c5/field/f", {})
        _import(ports[0], "c5", "f", [1] * C5_SHARDS, [s * SHARD_WIDTH for s in range(C5_SHARDS)])
        c0, node2 = servers[0].cluster, servers[2].cluster.me.id
        c0.client.close()  # no idle connection holds node 2's listener
        servers[2].close()
        c0._heartbeat_once()
        assert not next(n for n in c0.nodes if n.id == node2).alive
        servers[2] = _server("port", ports[2], tmp_path / "port2", seeds, 2, heartbeat_interval=3600)
        servers[2].open()
        new = next(s for s in range(C5_SHARDS, 64) if not c0.topology.owns(node2, "c5", s))
        assert query(ports[0], "c5", f"Set({new * SHARD_WIDTH}, f=1)") == [True]
        assert [query(p, "c5", "Count(Row(f=1))") for p in ports] == [[C5_SHARDS + 1]] * 3
    finally:
        shutdown(servers)


def c6_second_write(pkg, servers, ports, tmp_path, write):
    """After a first import with every node healthy, node 0 holds node 2
    for dead (``PROBE_LOST``) while node 2 serves the replicas it holds;
    then one more write through node 0 into shards node 2 owns: an
    ``import --roaring`` of new records, or a Set. → numpy's Count of
    Union(Row(f=1), Row(f=2)) after it."""
    data, _ = c5_data()
    rows, cols = data[0], data[1]
    c5_import(pkg, ports[0], tmp_path, data)
    c5_arm(servers, ports, PROBE_LOST)
    node2 = servers[2].cluster.me.id
    mine = [s for s in range(C5_SHARDS) if servers[0].cluster.topology.owns(node2, "c5", s)]
    assert mine
    new = np.array([s * SHARD_WIDTH + SHARD_WIDTH - 1 - k for s in mine for k in range(3)])
    if write == "set":
        assert query(ports[0], "c5", f"Set({int(new[0])}, f=1)") == [True]
        new = new[:1]
    else:
        csv = tmp_path / "c6.csv"
        csv.write_text("".join(f"1,{c}\n" for c in new.tolist()))
        argv = ["import", str(csv), "--roaring", "--host", f"127.0.0.1:{ports[0]}", "-i", "c5", "-f", "f"]
        assert (cli if pkg == "port" else ref_cli).main(argv) == 0
    return int(np.union1d(cols, new).size)


@pytest.mark.parametrize("write", ["import", "set"])
def test_a_write_reaches_a_serving_owner_whose_probe_failed(tmp_path, write):
    """C6: node 0's probe of node 2 failed without a refusal, so node 2 may
    be serving (it is), and one lost probe does not make it down. The
    write through node 0 lands on node 2's replica too, and the Count
    through every node, right away, equals numpy: node 2 serves the
    shards it holds itself."""
    servers, ports, _ = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        want = c6_second_write("port", servers, ports, tmp_path, write)
        for port in ports:
            assert query(port, "c5", C5_READS[1]) == [want], port
    finally:
        shutdown(servers)


def test_reference_skips_a_serving_owner_whose_probe_failed(tmp_path):
    """The reference's C6, pinned: it acknowledges the import without node
    2's replica, so node 2, which serves its own shards locally, counts
    short of numpy, with no error."""
    servers, ports, _ = make_cluster("ref", tmp_path, heartbeat_interval=3600)
    try:
        want = c6_second_write("ref", servers, ports, tmp_path, "import")
        assert query(ports[0], "c5", C5_READS[1]) == [want]
        (got,) = query(ports[2], "c5", C5_READS[1])
        assert 0 <= got < want
    finally:
        shutdown(servers)


# ------------------------------- C7: a stale dead mark at the coordinator
# node 0's heartbeat loses its probes of both peers once: the ticks that
# time out under load while the peers serve
PROBES_LOST_ONCE = {"path": "/status", "action": "drop", "times": 2}
C7_SHARDS = 64


def c7_cluster(pkg, tmp_path):
    """One bit of row 1 in each of ``C7_SHARDS`` shards, imported with
    every node healthy; then node 0's heartbeat loses its probes of both
    peers, which serve. → (servers, ports, whether node 0 still holds
    each peer alive)"""
    servers, ports, _ = make_cluster(pkg, tmp_path, heartbeat_interval=3600)
    ok(ports[0], "POST", "/index/c7", {})
    ok(ports[0], "POST", "/index/c7/field/f", {})
    _import(ports[0], "c7", "f", [1] * C7_SHARDS, [s * SHARD_WIDTH + 3 for s in range(C7_SHARDS)])
    c0 = servers[0].cluster
    peers = {srv.cluster.me.id for srv in servers[1:]}
    # shards that only the two peers hold: node 0 cannot serve them itself
    assert any({o.id for o in c0.shard_nodes("c7", s)} == peers for s in range(C7_SHARDS))
    servers[0].fault_injector.set_rules([PROBES_LOST_ONCE], seed=5)
    c0._heartbeat_once()
    return servers, ports, [n.alive for n in c0.nodes if n.id in peers]


def test_a_lost_probe_leaves_serving_owners_to_reads(tmp_path):
    """C7: node 0's probes of both peers were lost once while they serve.
    The port does not dead-mark them for that, so a read of shards only
    they hold answers exactly, where the reference fails it with a 503
    ("no alive owner")."""
    servers, ports, alive = c7_cluster("port", tmp_path)
    try:
        assert alive == [True, True]
        assert query(ports[0], "c7", "Count(Row(f=1))") == [C7_SHARDS]
        assert query(ports[0], "c7", "TopN(f, n=1)") == [[{"id": 1, "count": C7_SHARDS}]]
    finally:
        shutdown(servers)


def test_a_read_reprobes_an_owner_that_refused_while_it_restarted(tmp_path):
    """C7's other source: node 0's heartbeat found node 1 refusing while it
    restarted, and node 0's next tick has not come. A read of the shards
    only node 1 holds (``replica_n = 1``) re-probes it and answers
    exactly, where the reference fails it with a 503 until the tick."""
    servers, ports, seeds = make_cluster("port", tmp_path, n=2, replica_n=1, heartbeat_interval=3600)
    try:
        ok(ports[0], "POST", "/index/c7", {})
        ok(ports[0], "POST", "/index/c7/field/f", {})
        _import(ports[0], "c7", "f", [1] * C7_SHARDS, [s * SHARD_WIDTH + 3 for s in range(C7_SHARDS)])
        c0, node1 = servers[0].cluster, servers[1].cluster.me.id
        assert any(not c0.topology.owns(c0.me.id, "c7", s) for s in range(C7_SHARDS))
        c0.client.close()  # no idle connection holds node 1's listener
        servers[1].close()
        c0._heartbeat_once()
        assert not next(n for n in c0.nodes if n.id == node1).alive
        servers[1] = _server("port", ports[1], tmp_path / "port1", seeds, 1, heartbeat_interval=3600)
        servers[1].open()
        assert query(ports[0], "c7", "Count(Row(f=1))") == [C7_SHARDS]
    finally:
        shutdown(servers)


def test_reference_fails_a_read_on_a_stale_dead_mark(tmp_path):
    """The reference's C7, pinned: an error, never a partial count."""
    servers, ports, alive = c7_cluster("ref", tmp_path)
    try:
        assert alive == [False, False]
        status, body = call(ports[0], "POST", "/index/c7/query", b"Count(Row(f=1))")
        assert status == 503 and "no alive owner" in body["error"], (status, body)
    finally:
        shutdown(servers)


# ---------------------------------- a node cut off from every peer
# each blackholed request fails after this: a timeout's shape, never a
# refusal (a host that is down, or a partition)
CUT_DELAY_MS = 50
CUT_LEASE_S = 1.0  # the nodes' lease, and twice it the time to count a peer down


def test_a_cut_off_node_errors_while_the_others_write_without_it(tmp_path):
    """Every path between node 2 and its peers is blackholed after a
    delay. Node 2 stops coordinating queries once its lease lapses;
    nodes 0 and 1 count it down after twice the lease and acknowledge
    writes without it, within a bounded time. Then a Count through nodes
    0 and 1 equals numpy, and through node 2 it is an error: node 2
    holds every shard of the index but the newest, and never learns of
    that one."""
    servers, ports, _ = make_cluster("port", tmp_path, heartbeat_interval=0.1)
    try:
        c0, node2 = servers[0].cluster, servers[2].cluster.me.id
        ok(ports[0], "POST", "/index/cut", {})
        ok(ports[0], "POST", "/index/cut/field/f", {})
        mine = [s for s in range(64) if c0.topology.owns(node2, "cut", s)][:5]
        old, new = mine[:4], mine[4]
        _import(ports[0], "cut", "f", [1] * len(old), [s * SHARD_WIDTH for s in old])
        assert [query(p, "cut", "Count(Row(f=1))") for p in ports] == [[len(old)]] * 3
        # the short lease from here on: set up under the default one, as a
        # stall of the whole process under load (every node of the test is
        # one process) may outlast a 1 s lease and fence a healthy node
        for srv in servers:
            srv.cluster.lease_s, srv.cluster.down_after_s = CUT_LEASE_S, 2 * CUT_LEASE_S
        cut = {"path": "", "action": "blackhole", "delay_ms": CUT_DELAY_MS}
        servers[2].fault_injector.set_rules([cut], seed=5)
        for srv in servers[:2]:
            srv.fault_injector.set_rules([{**cut, "peer": f"127.0.0.1:{ports[2]}"}], seed=5)
        t0, refused = time.monotonic(), 0
        while True:
            status, body = call(ports[0], "POST", "/index/cut/query", f"Set({new * SHARD_WIDTH}, f=1)".encode())
            if status == 200:
                break
            refused += 1
            assert time.monotonic() - t0 < 2 * CUT_LEASE_S + 30, (status, body)
            time.sleep(0.05)
        stall = time.monotonic() - t0
        print(f"cut off: the first write acknowledged after {stall:.2f} s, {refused} refused before it "
              f"(lease {CUT_LEASE_S} s, requests fail after {CUT_DELAY_MS} ms)")
        # while node 0 may not count node 2 down, a write that node 2 owns fails
        assert refused >= 1
        assert [query(p, "cut", "Count(Row(f=1))") for p in ports[:2]] == [[len(old) + 1]] * 2
        status, body = call(ports[2], "POST", "/index/cut/query", b"Count(Row(f=1))")
        assert status == 503 and "heard from no peer" in body["error"], (status, body)
    finally:
        shutdown(servers)
