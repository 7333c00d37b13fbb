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
and a node whose card failed its probe.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import pytest

import pilosa_tpu.parallel.topology as ref_topology
import pilosa_tpu_torch.parallel.topology as pt_topology
from pilosa_tpu.server import Server as RefServer
from pilosa_tpu.utils.config import Config as RefConfig
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


def _server(pkg, port, data_dir, seeds=None, replica_n=2, coordinator=False):
    kw = dict(
        bind=f"127.0.0.1:{port}", data_dir=str(data_dir), seeds=seeds or [], replica_n=replica_n,
        coordinator=coordinator, anti_entropy_interval=0, result_cache_mode="off",
        route_mode="device", max_writes_per_request=MAX_WRITES, profiler_enabled=False,
        diagnostics_interval=0,
    )
    if pkg == "ref":
        return RefServer(RefConfig(device_init_timeout=0, mesh_enabled=False, **kw))
    return Server(Config(**kw), device="cpu")


def make_cluster(pkg, tmp_path, n=3, replica_n=2, start=None):
    """tests/test_cluster.py's harness: ``n`` nodes on free ports, node 0
    the coordinator; ``start`` limits which nodes open."""
    ports = free_ports(n)
    seeds = [f"http://127.0.0.1:{p}" for p in ports]
    servers = []
    for i in range(n):
        if start is not None and i not in start:
            servers.append(None)
            continue
        s = _server(pkg, ports[i], tmp_path / f"{pkg}{i}", seeds, replica_n, coordinator=(i == 0))
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
