"""Missed-write marks across restarts (C11), writes in flight across a
catch-up (C12), and attributes through a node that missed an attribute
write (C13), on the port's cluster, against numpy.

Three port nodes over real sockets, ``replica_n = 2``, with the helpers
of ``test_torch_replica_catchup``. Each node keeps its marks in
``<data dir>/.cluster/replica_marks.json``, written before the write
that made them is acknowledged, and loads them when it opens. A stale
owner replays on the current owner's copy the writes it applied while
it fetched that copy, and a coordinator writes a stale owner only after
every current owner took the write. A coordinator whose own copies are
stale takes a read's attributes from a current owner, or answers 503.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.parallel.cluster import Cluster
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

from test_torch_cluster import CUT_LEASE_S, _server, call, make_cluster, ok, shutdown
from test_torch_replica_catchup import (
    CUT,
    N_SHARDS,
    check,
    clear_bit,
    close_node2,
    fast_cluster,
    heartbeats,
    load,
    missed_writes,
    reopen_node2,
    set_bit,
    write,
)


def restart(servers, ports, seeds, tmp_path, which, replica_n=2):
    """Close the nodes in ``which`` together, then open them again on
    their data dirs (heartbeats of an hour: the tests run them)."""
    for i, srv in enumerate(servers):
        if srv is not None and i not in which:
            srv.cluster.client.close()
    for i in which:
        servers[i].close()
        servers[i] = None
    for i in which:
        servers[i] = _server("port", ports[i], tmp_path / f"port{i}", seeds, replica_n, coordinator=(i == 0),
                             heartbeat_interval=3600)
        servers[i].open()
    for srv in servers:
        if srv is not None:
            srv.cluster._heartbeat_once()


def local_count(srv, shard):
    """The node's own copy's Count(Row(f=1)) in ``shard``."""
    return srv.api.executor.execute("rc", parse("Count(Row(f=1))"), shards=[shard])[0]


# ------------------------------------------------------------------ C11
def test_marks_survive_a_restart_of_every_node_that_holds_them(tmp_path):
    """C11: node 2 is closed; a Set and two Clears in its shards are
    acknowledged through node 0, so nodes 0 and 1 hold the marks. Both
    restart together before node 2 returns: each loads the marks from
    its data dir. Node 2 then reopens, learns them in its join and
    replaces its stale copies: every read through every node equals
    numpy, and ``sync_holder`` on each node keeps that."""
    servers, ports, seeds = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        m, mine, _ = load(servers, ports)
        close_node2(servers)
        missed_writes(ports, m, mine)
        uri2 = f"http://127.0.0.1:{ports[2]}"
        marked = sorted(servers[0].cluster._stale_shards("rc", uri2))
        assert set(mine[:3]) <= set(marked)
        restart(servers, ports, seeds, tmp_path, (0, 1))
        for srv in servers[:2]:
            names = {(u, i, s) for u, i, s, _ in srv.cluster.marks_snapshot()["marks"]}
            assert {(uri2, "rc", s) for s in marked} <= names
            assert sorted(srv.cluster._stale_shards("rc", uri2)) == marked
            assert srv.cluster.marks_load_s is not None
        check(ports[:2], m)
        reopen_node2("port", servers, ports, seeds, tmp_path, heartbeat_interval=3600)
        assert servers[2].cluster.last_catch_up["shards"] == len(marked)
        check(ports, m)
        heartbeats(servers)
        for srv in servers:
            srv.cluster.sync_holder()
            check(ports, m)
    finally:
        shutdown(servers)


def test_marks_file_merges_with_peers_in_any_order_and_forgets_for_good(tmp_path):
    """The marks file holds the ``marks_snapshot()`` tables. Per writer
    boot the larger number wins whether a node reads its file or a
    peer's /status first, and loading again changes nothing. A covered
    key that the node forgot is gone from the file, so it stays
    forgotten after a restart."""
    servers, ports, seeds = make_cluster("port", tmp_path, n=2, replica_n=1, heartbeat_interval=3600)
    try:
        c0, c1 = servers[0].cluster, servers[1].cluster
        u = "http://127.0.0.1:1"
        mine = {"marks": [[u, "rc", 1, {"a": 3, "b": 1}], [u, "rc", 2, {"a": 1}]],
                "caught": [[u, "rc", 1, {"a": 2}], [u, "rc", 2, {"a": 1}]]}
        theirs = {"marks": [[u, "rc", 1, {"a": 2, "c": 4}]], "caught": [[u, "rc", 1, {"a": 3}]]}
        want = {"marks": {(u, "rc", 1): {"a": 3, "b": 1, "c": 4}, (u, "rc", 2): {"a": 1}},
                "caught": {(u, "rc", 1): {"a": 3}, (u, "rc", 2): {"a": 1}}}

        def tables(c):
            return {name: {(x, i, s): st for x, i, s, st in rows} for name, rows in c.marks_snapshot().items()}

        assert c0._merge_marks(mine)
        path = os.path.join(tmp_path, "port0", ".cluster", "replica_marks.json")
        with open(path) as f:
            on_disk = json.load(f)
        assert {name: {tuple(r[:3]): r[3] for r in rows} for name, rows in on_disk.items()} == tables(c0)
        # file first, then the peer: node 0 restarts and its join reads
        # node 1's /status
        c1._merge_marks(theirs)
        restart(servers, ports, seeds, tmp_path, (0,), replica_n=1)
        c0 = servers[0].cluster
        assert tables(c0) == want
        # loading or merging either again changes nothing; node 1 read
        # node 0's marks on its /status
        assert not c0._load_marks() and not c0._merge_marks(theirs) and not c0._merge_marks(mine)
        assert tables(c1) == want
        # the peer first, then the file: the tables emptied in memory
        # only, as at a restart
        with c0._marks_lock:
            c0._marks.clear(), c0._caught.clear(), c0._rebuild_stale_view()
        assert c0._merge_marks(theirs, persist=False) and c0._load_marks() and tables(c0) == want
        assert sorted(c0._stale_shards("rc", u)) == [1]
        # key 2 is covered; once forgotten it stays so across a restart
        # (node 1 forgets it too, or its /status would revive it)
        for c in (c0, c1):
            c._covered_at[(u, "rc", 2)] = time.monotonic() - 11 * c.lease_s
            c._forget_covered_marks()
        restart(servers, ports, seeds, tmp_path, (0,), replica_n=1)
        c0 = servers[0].cluster
        assert (u, "rc", 2) not in tables(c0)["marks"] and tables(c0)["marks"][(u, "rc", 1)] == want["marks"][(u, "rc", 1)]
    finally:
        shutdown(servers)


# ------------------------------------------------------------------ C12
def wrap_fetch(monkeypatch, node_uri, before=None, after=None):
    """Wrap ``_retrieve_with_backoff`` of the node at ``node_uri``:
    ``before(cluster, field, shard, n)`` runs ahead of its n-th fetch,
    ``after(...)`` once it has the fetched copy, before the caller
    installs it. → the fetches, as (field, shard)"""
    fetched = []
    real = Cluster._retrieve_with_backoff

    def fetch(self, src, index, field, view, shard):
        if self.me.uri != node_uri:
            return real(self, src, index, field, view, shard)
        if before is not None:
            before(self, field, shard, len(fetched))
        data = real(self, src, index, field, view, shard)
        if after is not None:
            after(self, field, shard, len(fetched))
        fetched.append((field, shard))
        return data

    monkeypatch.setattr(Cluster, "_retrieve_with_backoff", fetch)
    return fetched


def test_a_write_a_stale_owner_took_during_its_fetch_is_kept(tmp_path, monkeypatch):
    """C12: node 2 reopens with stale copies. While its join fetches
    node 0's copy of one of them, a Set lands on node 2 (as a
    coordinator's first leg would) and reaches node 0 only after node 2
    replaced its copy. Node 2 replays the Set on node 0's copy: both
    copies count it, and so does every read through every node."""
    servers, ports, seeds = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        m, mine, shared = load(servers, ports)
        shard = shared[0]
        col = shard * SHARD_WIDTH + 200
        close_node2(servers)
        missed_writes(ports, m, mine)
        clear_bit(ports[0], m, 1, min(c for c in m.rows[1] if c // SHARD_WIDTH == shard))
        uri2 = f"http://127.0.0.1:{ports[2]}"
        landed = []

        def before(cluster, field, s, n):
            if field == "f" and s == shard and not landed:
                cluster.server.api.executor.execute("rc", parse(f"Set({col}, f=1)"))
                landed.append(col)

        wrap_fetch(monkeypatch, uri2, before=before)
        reopen_node2("port", servers, ports, seeds, tmp_path, heartbeat_interval=3600)
        assert landed == [col]
        servers[0].api.executor.execute("rc", parse(f"Set({col}, f=1)"))
        m.rows[1].add(col)
        assert not servers[2].cluster._stale_shards("rc", uri2)
        assert local_count(servers[2], shard) == local_count(servers[0], shard)
        check(ports, m)
    finally:
        shutdown(servers)


def race_case(kind, c, c2):
    """A write whose ops depend on the copy it lands on, for
    ``test_a_write_that_resets_a_column_or_row_is_exact_after_the_replay``:
    (field g's options, its writes before node 2 closes, the writes node 2
    misses, the write that races node 2's fetch, numpy's answers after
    them to the Row reads, and to the cluster-only reads)."""
    if kind == "mutex":
        # column c: row 0, then 1 (missed), then 2; c2 stays in row 1
        rows = np.array([2, 1])
        want = {f"Row(g={r})": sorted(np.array([c, c2])[rows == r].tolist()) for r in (0, 1, 2)}
        return {"type": "mutex"}, [f"Set({c}, g=0)", f"Set({c2}, g=1)"], [f"Set({c}, g=1)"], f"Set({c}, g=2)", want, {}
    if kind == "int":
        # depth 1 before; the missed values need 10 planes, the raced one 2
        vals = np.array([3, 600])
        cols = np.array([c, c2])
        want = {"Row(g == 3)": [c], "Row(g == 600)": [c2], "Row(g > 100)": sorted(cols[vals > 100].tolist())}
        return ({"type": "int"}, [f"Set({c}, g=1)"], [f"Set({c}, g=1000)", f"Set({c2}, g=600)"], f"Set({c}, g=3)",
                want, {"Sum(field=g)": {"value": int(vals.sum()), "count": 2}})
    # ClearRow: row 1 loses c, which only the current copy holds
    want = {"Row(g=1)": [], "Row(g=2)": [c2]}
    return {}, [f"Set({c2}, g=1)", f"Set({c2}, g=2)"], [f"Set({c}, g=1)"], "ClearRow(g=1)", want, {}


@pytest.mark.parametrize("kind", ["mutex", "int", "clear_row"])
def test_a_write_that_resets_a_column_or_row_is_exact_after_the_replay(tmp_path, monkeypatch, kind):
    """C12: node 2 missed a write to field g in a shard it shares with
    node 0. While its join replaces that shard, a write whose ops depend
    on the copy it lands on (a mutex Set, an int value, a ClearRow)
    reaches node 0 after node 2 fetched node 0's copy, then node 2
    before it installs that copy. Node 2's ops clear only what its old
    copy held; its replay first clears the whole column or row on the
    fetched copy, so both copies and every read through every node
    equal numpy."""
    servers, ports, seeds = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        _, _, shared = load(servers, ports)
        shard = shared[0]
        c, c2 = shard * SHARD_WIDTH + 500, shard * SHARD_WIDTH + 501
        options, first, missed, raced, want, cluster_only = race_case(kind, c, c2)
        ok(ports[0], "POST", "/index/rc/field/g", {"options": options} if options else {})
        for pql in first:
            write(ports[0], pql)
        close_node2(servers)
        for pql in missed:
            write(ports[0], pql)
        landed = []

        def after(cluster, field, s, n):
            if field == "g" and s == shard and not landed:
                for srv in (servers[0], cluster.server):  # the current owner first
                    srv.api.executor.execute("rc", parse(raced))
                landed.append(raced)

        wrap_fetch(monkeypatch, f"http://127.0.0.1:{ports[2]}", after=after)
        reopen_node2("port", servers, ports, seeds, tmp_path, heartbeat_interval=3600)
        assert landed == [raced]
        assert servers[2].cluster.last_catch_up["shards"] >= 1
        for srv in (servers[0], servers[2]):
            for pql, cols in want.items():
                got = srv.api.executor.execute("rc", parse(pql), shards=[shard])[0]
                assert sorted(int(x) for x in got.columns()) == cols, (srv.cluster.me.id, pql)
        for port in ports:
            for pql, expect in {**want, **cluster_only}.items():
                (got,) = ok(port, "POST", "/index/rc/query", pql.encode())["results"]
                assert (got["columns"] if pql.startswith("Row(") else got) == expect, (port, pql)
    finally:
        shutdown(servers)


def test_a_catch_up_finishes_while_writes_keep_landing_in_its_shard(tmp_path, monkeypatch):
    """C12: node 2 reopens with stale copies; ahead of every fetch of
    its catch-up a Set in the shard being fetched is acknowledged
    through node 0 (so it lands on node 2 while node 2 fetches). The
    catch-up still finishes in the join, and every Set is counted
    through every node."""
    servers, ports, seeds = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        m, mine, _ = load(servers, ports)
        close_node2(servers)
        missed_writes(ports, m, mine)
        uri2 = f"http://127.0.0.1:{ports[2]}"
        sets = []

        def before(cluster, field, s, n):
            col = s * SHARD_WIDTH + 300 + n
            status, body = call(ports[0], "POST", "/index/rc/query", f"Set({col}, f=1)".encode())
            assert status == 200, body
            sets.append(col)

        fetched = wrap_fetch(monkeypatch, uri2, before=before)
        reopen_node2("port", servers, ports, seeds, tmp_path, heartbeat_interval=3600)
        m.rows[1].update(sets)
        assert len(fetched) >= 3 and len(sets) == len(fetched)
        assert servers[2].cluster.last_catch_up["shards"] == 3
        assert not any(srv.cluster._stale_shards("rc", uri2) for srv in servers)
        for s in mine[:3]:
            assert local_count(servers[2], s) == local_count(servers[0 if servers[0].cluster.topology.owns(
                servers[0].cluster.me.id, "rc", s) else 1], s)
        check(ports, m)
    finally:
        shutdown(servers)


def test_a_coordinator_writes_a_stale_owner_after_the_current_one(tmp_path, monkeypatch):
    """C12: a write that a stale owner took before its catch-up began is
    in the current owner's copy when the stale owner fetches it: node 1
    coordinates a Set in a shard whose owner list puts node 2 first,
    while node 2's copy is marked stale; the other owner applies it
    before node 2 does. After node 2's catch-up every read is exact."""
    servers, ports, _ = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        m, _, _ = load(servers, ports)
        c1 = servers[1].cluster
        ids = [srv.cluster.me.id for srv in servers]
        shard = next(s for s in range(N_SHARDS) if c1.shard_nodes("rc", s)[0].id == ids[2])
        other = ids.index(c1.shard_nodes("rc", shard)[1].id)
        uri2 = servers[2].cluster.me.uri
        mark = {"index": "rc", "entries": {}, "marks": [[uri2, "rc", shard, {"test": 1}]]}
        for srv in servers:
            srv.cluster._merge_marks(mark)
        order = []
        real = Fragment.set_bit

        def set_bit(self, row, col):
            node = next(i for i in range(3) if self.path and self.path.startswith(str(tmp_path / f"port{i}")))
            if self.field == "f":
                order.append(node)
            return real(self, row, col)

        monkeypatch.setattr(Fragment, "set_bit", set_bit)
        col = shard * SHARD_WIDTH + 400
        write(ports[1], f"Set({col}, f=1)")
        m.rows[1].add(col)
        assert order == [other, 2]
        assert servers[2].cluster._catch_up() == [("rc", shard)]
        check(ports, m)
    finally:
        shutdown(servers)


# ------------------------------------------------------------------ C14
JOIN_S = 20.0  # the most a test waits for node 2's catch-up


def race_catch_up(servers, coord, shard):
    """Start node 2's catch-up in a thread; return once it has returned,
    or once node ``coord`` has the mark it catches up (its barrier
    reached that node). → (the thread, the list its answer goes to)"""
    c, c2 = servers[coord].cluster, servers[2].cluster
    done, got = threading.Event(), []

    def run():
        try:
            got.append(c2._catch_up())
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True, name="test-catch-up")
    t.start()
    deadline = time.monotonic() + JOIN_S
    while not (done.wait(0.02) or c2.me.uri in c._stale_uris("rc", shard)):
        assert time.monotonic() < deadline, "node 2's catch-up neither returned nor reached the coordinator"
    return t, got


@pytest.mark.parametrize("kind", ["set", "clear", "import"])
def test_a_write_begun_before_its_coordinator_learned_a_mark_is_kept(tmp_path, monkeypatch, kind):
    """C14: node 2's copy of a shard whose owner list puts node 2 first
    is marked stale on both owners; the third node, which owns no copy
    of it, has not learned the mark. That node coordinates a write
    there: its leg to node 2 lands on the stale copy first. Ahead of its
    leg to the other owner node 2 starts its catch-up, which fetches
    that owner's copy; the leg goes on once the catch-up has returned or
    has reached the coordinator. After the ack and the catch-up node 2's
    copy counts what the other owner's does, every read through every
    node equals numpy, and an anti-entropy pass on each node changes no
    answer (a Clear stays cleared)."""
    servers, ports, _ = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        m, _, _ = load(servers, ports)
        c0 = servers[0].cluster
        ids = [srv.cluster.me.id for srv in servers]
        shard = next(s for s in range(4 * N_SHARDS) if c0.shard_nodes("rc", s)[0].id == ids[2])
        other = ids.index(c0.shard_nodes("rc", shard)[1].id)
        coord = 3 - other - 2
        cc = servers[coord].cluster
        if kind == "clear" and not any(c // SHARD_WIDTH == shard for c in m.rows[1]):
            set_bit(ports[0], m, 1, shard * SHARD_WIDTH + 7)
        uri_other, uri2 = servers[other].cluster.me.uri, servers[2].cluster.me.uri
        mark = {"index": "rc", "entries": {}, "marks": [[uri2, "rc", shard, {"test": 1}]]}
        for srv in (servers[other], servers[2]):
            srv.cluster._merge_marks(mark)
        assert not cc._stale_uris("rc", shard)
        raced = []
        if kind == "import":
            first_leg = threading.Event()
            real_import = cc.client.import_node

            def import_node(uri, *args, **kwargs):
                if uri == uri_other and not raced:
                    assert first_leg.wait(JOIN_S), "the coordinator's leg to node 2 did not end"
                    raced.append(race_catch_up(servers, coord, shard))
                out = real_import(uri, *args, **kwargs)
                if uri == uri2:
                    first_leg.set()
                return out

            monkeypatch.setattr(cc.client, "import_node", import_node)
        else:
            real_leg = Cluster._timed_query_node

            def leg(self, span, node, index, pql, shards, write=False):
                if self is cc and write and node.id == ids[other] and not raced:
                    raced.append(race_catch_up(servers, coord, shard))
                return real_leg(self, span, node, index, pql, shards, write=write)

            monkeypatch.setattr(Cluster, "_timed_query_node", leg)
        if kind == "clear":
            col = min(c for c in m.rows[1] if c // SHARD_WIDTH == shard)
            write(ports[coord], f"Clear({col}, f=1)")
            m.rows[1].discard(col)
        else:
            col = shard * SHARD_WIDTH + 500
            if kind == "set":
                write(ports[coord], f"Set({col}, f=1)")
            else:
                ok(ports[coord], "POST", "/index/rc/field/f/import", {"rowIDs": [1], "columnIDs": [col]})
            m.rows[1].add(col)
        monkeypatch.undo()
        ((t, got),) = raced
        t.join(JOIN_S)
        assert not t.is_alive() and got == [[("rc", shard)]], got
        assert not any(srv.cluster._stale_uris("rc", shard) for srv in servers)
        assert local_count(servers[2], shard) == local_count(servers[other], shard)
        check(ports, m)
        for srv in servers:
            srv.cluster.sync_holder()
        assert local_count(servers[2], shard) == local_count(servers[other], shard)
        check(ports, m)
    finally:
        shutdown(servers)


LEG_S = 2.0  # a write leg's time limit in the barrier's liveness test


@pytest.mark.parametrize("how", ["closed", "cut"])
def test_a_silent_coordinator_keeps_a_shard_stale_no_longer_than_the_bound(tmp_path, how):
    """C14, the barrier's liveness: node 2's copy of a shard that nodes 0
    and 2 own is marked stale on every node, and node 1 goes silent. A
    closed node 1 refuses the barrier and is not waited for: node 2's
    first catch-up replaces the copy. A node 1 cut off from node 2 both
    ways (with the short lease, and a write leg's time limit of
    ``LEG_S``, from the cut on) is waited for while it may still write:
    the shard stays stale until ``down_after_s + leg_timeout_s`` after
    node 2 last heard node 1, and is current right after. Then every
    read through nodes 0 and 2 equals numpy."""
    servers, ports, _ = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        m, _, shared = load(servers, ports)
        c0, c2 = servers[0].cluster, servers[2].cluster
        shard = shared[0]
        mark = {"index": "rc", "entries": {}, "marks": [[c2.me.uri, "rc", shard, {"test": 1}]]}
        for srv in servers:
            srv.cluster._merge_marks(mark)
        node = {srv.cluster.me.id: n for srv in servers for n in c2.nodes if n.id == srv.cluster.me.id}
        node0, node1 = node[c0.me.id], node[servers[1].cluster.me.id]
        node2 = next(n for n in c0.nodes if n.id == c2.me.id)
        if how == "closed":
            for srv in (servers[0], servers[2]):
                srv.cluster.client.close()  # no idle connection holds node 1's listener
            servers[1].close()
            servers[1] = None
            t0 = time.monotonic()
            assert c2._catch_up() == [("rc", shard)]
            print(f"closed: caught up in {time.monotonic() - t0:.3f} s")
        else:
            c2._probe(node1)
            lease = c0.lease_s
            for srv in servers:
                srv.cluster.lease_s, srv.cluster.down_after_s = CUT_LEASE_S, 2 * CUT_LEASE_S
            c2.leg_timeout_s = LEG_S
            servers[2].fault_injector.set_rules([{**CUT, "peer": f"127.0.0.1:{ports[1]}"}], seed=5)
            servers[1].fault_injector.set_rules([{**CUT, "peer": f"127.0.0.1:{ports[2]}"}], seed=5)
            bound = c2._heard_at(node1) + c2.down_after_s + c2.leg_timeout_s
            tries = []
            while True:
                # a heartbeat's probes: nodes 0 and 2 keep hearing each other
                c0._probe(node2)
                c2._probe(node0)
                got = c2._catch_up()
                tries.append(time.monotonic())
                if got:
                    break
                assert tries[-1] < bound + JOIN_S, "node 2 stayed stale past the barrier's bound"
                time.sleep(0.1)
            assert got == [("rc", shard)]
            assert len(tries) > 1 and bound < tries[-1] < bound + JOIN_S
            print(f"cut: caught up {tries[-1] - bound:.3f} s past the bound, after {len(tries)} tries")
            # the reads below make no heartbeat: under the short lease a
            # stall of the process would fence the node that serves them
            for srv in servers:
                srv.cluster.lease_s, srv.cluster.down_after_s = lease, 2 * lease
        assert not c2._stale_shards("rc", c2.me.uri)
        check([ports[0], ports[2]], m)
    finally:
        shutdown(servers)


# ------------------------------------------------------------------ C13
def attrs_answer(port, pql):
    status, body = call(port, "POST", "/index/rc/query", pql.encode())
    if status == 503:
        assert "missed acknowledged writes" in body["error"] or "heard" in body["error"], body
        return None
    assert status == 200, body
    return body


def test_a_node_with_stale_copies_serves_current_attrs_or_refuses(tmp_path, monkeypatch):
    """C13: node 0 and node 2 cannot reach each other; node 1 reaches
    both. Once node 0 counts node 2 down it acknowledges a Set in a
    shard node 2 owns without it, then a SetRowAttrs and a
    SetColumnAttrs, and node 1 relays the marks. Then ``Row(f=1)`` and
    ``Options(Row(f=1), columnAttrs=true)`` through node 2, over the
    shards node 1 owns (node 2 reaches a current owner of each), answer
    the new attributes (taken from node 1) or 503, never the old ones.
    A read takes no attribute RPC on a healthy node, nor on node 2 after
    the Set and before the attribute writes (its attr stores are
    current)."""
    servers, ports, _ = fast_cluster("port", tmp_path)
    try:
        m, _, shared = load(servers, ports)
        c0, id1 = servers[0].cluster, servers[1].cluster.me.id
        shards = [s for s in range(N_SHARDS) if c0.topology.owns(id1, "rc", s)]
        cols = sorted(c for c in m.rows[1] if c // SHARD_WIDTH in shards)
        col = cols[0]
        row = f"Options(Row(f=1), shards={shards})"
        with_attrs = f"Options(Row(f=1), columnAttrs=true, shards={shards})"
        write(ports[0], 'SetRowAttrs(f, 1, color="red")')
        write(ports[0], f'SetColumnAttrs({col}, tag="old")')
        for srv in servers:
            monkeypatch.setattr(srv.cluster, "_current_attrs", _no_rpc, raising=False)
        body = attrs_answer(ports[2], row)
        assert body["results"][0]["attrs"] == {"color": "red"}
        assert attrs_answer(ports[2], with_attrs)["columnAttrs"] == [{"id": col, "attrs": {"tag": "old"}}]
        monkeypatch.undo()
        servers[0].fault_injector.set_rules([{**CUT, "peer": f"127.0.0.1:{ports[2]}"}], seed=5)
        servers[2].fault_injector.set_rules([{**CUT, "peer": f"127.0.0.1:{ports[0]}"}], seed=5)
        write(ports[0], f"Set({shared[0] * SHARD_WIDTH + 100}, f=2)")
        uri2 = servers[2].cluster.me.uri
        assert shared[0] in servers[2].cluster._stale_shards("rc", uri2)
        monkeypatch.setattr(servers[2].cluster, "_current_attrs", _no_rpc, raising=False)
        body = attrs_answer(ports[2], row)
        assert body is None or body["results"][0]["attrs"] == {"color": "red"}, body
        monkeypatch.undo()
        write(ports[0], 'SetRowAttrs(f, 1, color="blue")')
        write(ports[0], f'SetColumnAttrs({col}, tag="new")')
        served = 0
        for _ in range(3):
            body = attrs_answer(ports[2], row)
            if body is not None:
                assert body["results"][0]["attrs"] == {"color": "blue"}, body
                assert body["results"][0]["columns"] == cols
                served += 1
            body = attrs_answer(ports[2], with_attrs)
            if body is not None:
                assert body["columnAttrs"] == [{"id": col, "attrs": {"tag": "new"}}], body
                served += 1
            time.sleep(0.3)
        assert served
    finally:
        shutdown(servers)


def _no_rpc(*args, **kwargs):
    raise AssertionError("a node whose attr stores are current asked a peer for attributes")
