"""A replica that missed acknowledged writes serves none of them until it
has caught up (C8-C10), on the port's cluster, against numpy.

Three port nodes over real sockets (``test_torch_cluster.make_cluster``),
``replica_n = 2``. A write that leaves an owner out (it refused, or is
counted down) marks that owner's copy of the shard stale on every node
that may serve; no node reads a stale copy, and the owner replaces it
with a current owner's copy (never a union) before it serves the shard
again. After each acknowledged Set, Clear or ``import-value`` clear, every
read through every node is exact or a 503: right after a partition heals,
after a restart, under a one-way partition, under a cut between two nodes
that both reach the third, and after ``sync_holder`` on every node. A
node whose peers do not hear it fences itself (503) before they write
without it. The ``test_reference_*`` cases pin the reference's stale
answers in the same scenarios.
"""

import json
import time

import pytest

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

from test_torch_cluster import (
    CUT_DELAY_MS,
    CUT_LEASE_S,
    _server,
    call,
    make_cluster,
    ok,
    query,
    shutdown,
)

N_SHARDS = 16
READS = ("Count(Row(f=1))", "TopN(f, n=2)", "Row(f=1)", "Sum(field=v)")
CUT = {"path": "", "action": "blackhole", "delay_ms": CUT_DELAY_MS}
WAIT_S = 2 * CUT_LEASE_S + 30  # the most a write may take to be acknowledged


class Model:
    """numpy's side: rows 1 and 2 of f as column sets, v's values."""

    def __init__(self):
        self.rows = {1: set(), 2: set()}
        self.vals = {}

    def want(self, pql):
        if pql == "Count(Row(f=1))":
            return len(self.rows[1])
        if pql == "TopN(f, n=2)":
            pairs = sorted(((r, len(c)) for r, c in self.rows.items() if c), key=lambda rc: (-rc[1], rc[0]))
            return [{"id": r, "count": c} for r, c in pairs]
        if pql == "Row(f=1)":
            return sorted(self.rows[1])
        assert pql == "Sum(field=v)"
        return {"value": sum(self.vals.values()), "count": len(self.vals)}


def answer(status, body, pql):
    """A read's JSON in numpy's shape (a Row's columns)."""
    if status != 200:
        return None
    (got,) = body["results"]
    return got["columns"] if pql.startswith("Row(") else got


def load(servers, ports):
    """Index rc (f, and v an int field) over ``N_SHARDS`` shards through
    node 0, with every node healthy. → (the model, node 2's shards, the
    shards node 0 and node 2 both own)"""
    m = Model()
    ok(ports[0], "POST", "/index/rc", {})
    ok(ports[0], "POST", "/index/rc/field/f", {})
    ok(ports[0], "POST", "/index/rc/field/v", {"options": {"type": "int", "min": -1000, "max": 1000}})
    rows, cols, vcols, vals = [], [], [], []
    for s in range(N_SHARDS):
        for k in range(12):
            col = s * SHARD_WIDTH + k
            for r in (1, 2):
                if (k + r) % 3:
                    rows.append(r), cols.append(col), m.rows[r].add(col)
            if k < 5:
                vcols.append(col), vals.append(10 * k - s)
                m.vals[col] = 10 * k - s
    ok(ports[0], "POST", "/index/rc/field/f/import", {"rowIDs": rows, "columnIDs": cols})
    ok(ports[0], "POST", "/index/rc/field/v/import-value", {"columnIDs": vcols, "values": vals})
    c0 = servers[0].cluster
    ids = [srv.cluster.me.id for srv in servers]
    mine = [s for s in range(N_SHARDS) if c0.topology.owns(ids[2], "rc", s)]
    shared = [s for s in mine if c0.topology.owns(ids[0], "rc", s)]
    assert len(mine) >= 3 and shared
    check(ports, m)
    return m, mine, shared


def check(ports, m, may_refuse=()):
    """Every read through every node in ``ports`` equals numpy; through a
    node in ``may_refuse`` it may instead be a 503."""
    for port in ports:
        for pql in READS:
            status, body = call(port, "POST", "/index/rc/query", pql.encode())
            if status == 503 and port in may_refuse:
                continue
            assert (status, answer(status, body, pql)) == (200, m.want(pql)), (port, pql, status, body)


def write(port, pql, deadline=WAIT_S):
    """Send ``pql`` through ``port`` until it is acknowledged (a write
    that may not leave an owner out yet fails). → its seconds"""
    t0 = time.monotonic()
    while True:
        status, body = call(port, "POST", "/index/rc/query", pql.encode())
        if status == 200:
            return time.monotonic() - t0
        assert time.monotonic() - t0 < deadline, (pql, status, body)
        time.sleep(0.05)


def set_bit(port, m, row, col):
    write(port, f"Set({col}, f={row})")
    m.rows[row].add(col)


def clear_bit(port, m, row, col):
    write(port, f"Clear({col}, f={row})")
    m.rows[row].discard(col)


def missed_writes(ports, m, mine):
    """A Set of row 1, a Clear of row 1 and a Clear of row 2 in node 2's
    shards through node 0: after them Count(Row(f=1)) and TopN differ from
    node 2's old copy."""
    set_bit(ports[0], m, 1, mine[0] * SHARD_WIDTH + 100)
    clear_bit(ports[0], m, 1, min(c for c in m.rows[1] if c // SHARD_WIDTH == mine[1]))
    clear_bit(ports[0], m, 2, min(c for c in m.rows[2] if c // SHARD_WIDTH == mine[2]))


def cut_off(servers, ports, peers_only=False):
    """Blackhole every path between node 2 and its peers (each request
    fails after ``CUT_DELAY_MS``, as a timeout does): node 2's own client
    too, unless ``peers_only``."""
    if not peers_only:
        servers[2].fault_injector.set_rules([CUT], seed=5)
    for srv in servers[:2]:
        srv.fault_injector.set_rules([{**CUT, "peer": f"127.0.0.1:{ports[2]}"}], seed=5)


def heal(servers):
    for srv in servers:
        srv.fault_injector.clear()
    heartbeats(servers)


def heartbeats(servers):
    """Two heartbeats of each node, in turn: each has heard every other
    since that one last heard it."""
    for _ in range(2):
        for srv in servers:
            srv.cluster._heartbeat_once()


def short_lease(servers):
    for srv in servers:
        srv.cluster.lease_s, srv.cluster.down_after_s = CUT_LEASE_S, 2 * CUT_LEASE_S


def fast_cluster(pkg, tmp_path):
    servers, ports, seeds = make_cluster(pkg, tmp_path, heartbeat_interval=0.1)
    if pkg == "port":
        short_lease(servers)
    return servers, ports, seeds


def close_node2(servers):
    for srv in servers[:2]:
        srv.cluster.client.close()  # no idle connection holds node 2's listener
    servers[2].close()
    servers[2] = None
    for srv in servers[:2]:
        srv.cluster._heartbeat_once()


def reopen_node2(pkg, servers, ports, seeds, tmp_path, **extra):
    servers[2] = _server(pkg, ports[2], tmp_path / f"{pkg}2", seeds, 2, **extra)
    servers[2].open()


# ------------------------------------------------------------------ C8
def test_a_healed_node_is_exact_right_after_the_heal(tmp_path):
    """C8: node 2 is cut off; once nodes 0 and 1 count it down they
    acknowledge a Set and two Clears in its shards without it. Right
    after the heal (one heartbeat of each node) every read through each
    node equals numpy: node 2 learned the marks from its peers' /status
    before its lease came back, and reads its stale shards from a
    current owner until it has replaced them."""
    servers, ports, _ = fast_cluster("port", tmp_path)
    try:
        m, mine, _ = load(servers, ports)
        cut_off(servers, ports)
        missed_writes(ports, m, mine)
        check(ports[:2], m)
        heal(servers)
        check(ports, m)
    finally:
        shutdown(servers)


def test_reference_serves_a_stale_copy_after_a_heal(tmp_path):
    """The reference's C8, pinned: after the heal node 2 counts its own
    copy of the shard it missed the Set in, one short of numpy, with no
    error."""
    servers, ports, _ = fast_cluster("ref", tmp_path)
    try:
        m, mine, _ = load(servers, ports)
        cut_off(servers, ports)
        set_bit(ports[0], m, 1, mine[0] * SHARD_WIDTH + 100)
        heal(servers)
        assert query(ports[2], "rc", READS[0]) == [m.want(READS[0]) - 1]
    finally:
        shutdown(servers)


# ----------------------------------------------------------- C8, C10
def test_a_restarted_node_is_exact_and_anti_entropy_keeps_the_clear(tmp_path):
    """C8 and C10: node 2 is closed; a Clear and a Set of f, and an
    ``import-value`` clear of v, all in its shards, are acknowledged
    through node 0. Node 2 reopens on its data dir: every read through
    every node equals numpy (its join replaced the stale copies, where a
    union would keep the cleared bits). Then ``sync_holder`` runs on each
    node in turn, and every read stays exact: no pass brings a cleared
    bit back."""
    servers, ports, seeds = make_cluster("port", tmp_path, heartbeat_interval=3600)
    try:
        m, mine, _ = load(servers, ports)
        close_node2(servers)
        missed_writes(ports, m, mine)
        col = min(c for c in m.vals if c // SHARD_WIDTH == mine[0])
        ok(ports[0], "POST", "/index/rc/field/v/import-value", {"columnIDs": [col], "clear": True})
        del m.vals[col]
        check(ports[:2], m)
        reopen_node2("port", servers, ports, seeds, tmp_path, heartbeat_interval=3600)
        check(ports, m)
        heartbeats(servers)
        for srv in servers:
            srv.cluster.sync_holder()
            check(ports, m)
    finally:
        shutdown(servers)


def test_reference_brings_a_cleared_bit_back_by_anti_entropy(tmp_path):
    """The reference's C10, pinned: a Clear through node 0 while node 2 is
    closed, in a shard nodes 0 and 2 own. Node 2's join unions its old
    copy with node 0's and keeps the bit; node 0's anti-entropy pass then
    unions node 2's block back in, and node 0 counts the cleared bit
    again, with no error."""
    servers, ports, seeds = make_cluster("ref", tmp_path, heartbeat_interval=3600)
    try:
        m, _, shared = load(servers, ports)
        close_node2(servers)
        shard = shared[0]
        clear_bit(ports[0], m, 1, min(c for c in m.rows[1] if c // SHARD_WIDTH == shard))
        pql = f"Options(Count(Row(f=1)), shards=[{shard}])"
        want = sum(1 for c in m.rows[1] if c // SHARD_WIDTH == shard)
        assert query(ports[0], "rc", pql) == [want]
        reopen_node2("ref", servers, ports, seeds, tmp_path, heartbeat_interval=3600)
        heartbeats(servers)
        servers[0].cluster.sync_holder()
        assert query(ports[0], "rc", pql) == [want + 1]
    finally:
        shutdown(servers)


# ------------------------------------------------------------------ C9
@pytest.mark.parametrize("both_ways", [False, True], ids=["one_way", "both_ways"])
def test_a_partitioned_node_is_exact_or_refuses(tmp_path, both_ways):
    """C9: node 0's client cannot reach node 2 (and, ``both_ways``, node
    2's cannot reach node 0), while node 1 reaches both. Once node 0
    counts node 2 down it acknowledges a Set and two Clears in node 2's
    shards without it: node 1 relays the marks to node 2 before node 0
    acknowledges. Every read through node 2 is exact or a 503 (one way,
    node 0's /status says it has not heard node 2, which fences itself),
    and through nodes 0 and 1 exact."""
    servers, ports, _ = fast_cluster("port", tmp_path)
    try:
        m, mine, _ = load(servers, ports)
        servers[0].fault_injector.set_rules([{**CUT, "peer": f"127.0.0.1:{ports[2]}"}], seed=5)
        if both_ways:
            servers[2].fault_injector.set_rules([{**CUT, "peer": f"127.0.0.1:{ports[0]}"}], seed=5)
        missed_writes(ports, m, mine)
        for _ in range(3):
            check(ports, m, may_refuse=(ports[2],))
            time.sleep(0.3)
    finally:
        shutdown(servers)


def test_reference_serves_a_stale_copy_under_a_one_way_partition(tmp_path):
    """The reference's C9, pinned: node 0 cannot reach node 2, counts it
    dead at its first failed probe and acknowledges a Set in node 2's
    shard without it; node 2, which reaches everyone, counts its own copy,
    one short of numpy, with no error."""
    servers, ports, _ = fast_cluster("ref", tmp_path)
    try:
        m, mine, _ = load(servers, ports)
        servers[0].fault_injector.set_rules([{**CUT, "peer": f"127.0.0.1:{ports[2]}"}], seed=5)
        set_bit(ports[0], m, 1, mine[0] * SHARD_WIDTH + 100)
        assert query(ports[0], "rc", READS[0]) == [m.want(READS[0])]
        assert query(ports[2], "rc", READS[0]) == [m.want(READS[0]) - 1]
    finally:
        shutdown(servers)


# ----------------------------------------------------------- self-fence
def test_a_node_no_peer_hears_fences_itself_before_they_write_without_it(tmp_path):
    """Every peer's client blackholes node 2, while node 2 reaches them:
    its lease holds, and no mark can reach it. It reads on its peers'
    /status that they have not heard it for a lease and answers 503
    before node 0, which counts it down after two, acknowledges a Set in
    its shard; nodes 0 and 1 are exact."""
    servers, ports, _ = fast_cluster("port", tmp_path)
    try:
        m, mine, _ = load(servers, ports)
        cut_off(servers, ports, peers_only=True)
        col = mine[0] * SHARD_WIDTH + 100
        t0, fenced = time.monotonic(), None
        while True:
            status, body = call(ports[2], "POST", "/index/rc/query", READS[0].encode())
            if status == 503 and fenced is None:
                assert "has not heard from this node" in body["error"], body
                fenced = time.monotonic() - t0
            status, body = call(ports[0], "POST", "/index/rc/query", f"Set({col}, f=1)".encode())
            if status == 200:
                acked = time.monotonic() - t0
                break
            assert time.monotonic() - t0 < WAIT_S, (status, body)
            time.sleep(0.05)
        m.rows[1].add(col)
        print(f"self-fence: node 2 fenced after {fenced} s, the write without it acknowledged after {acked:.2f} s")
        assert fenced is not None and fenced < acked
        check(ports, m, may_refuse=(ports[2],))
        status, body = call(ports[2], "POST", "/index/rc/query", READS[0].encode())
        assert status == 503 and "has not heard from this node" in body["error"], (status, body)
    finally:
        shutdown(servers)


# --------------------------------------------------------- availability
@pytest.mark.parametrize("how", ["closed", "silent"])
def test_a_down_node_costs_the_others_no_503_and_is_exact_once_back(tmp_path, how):
    """Node 2 is closed, or silent to every peer (each path blackholed
    both ways). Nodes 0 and 1 acknowledge a Set and two Clears in its
    shards, and every read through them over every shard is exact, with
    no 503. Once node 2 is back (reopened on its data dir, or healed),
    every read through every node is exact."""
    servers, ports, seeds = fast_cluster("port", tmp_path)
    try:
        m, mine, _ = load(servers, ports)
        if how == "closed":
            close_node2(servers)
        else:
            cut_off(servers, ports)
        missed_writes(ports, m, mine)
        check(ports[:2], m)
        if how == "closed":
            reopen_node2("port", servers, ports, seeds, tmp_path, heartbeat_interval=0.1)
            short_lease(servers)
            heartbeats(servers)
        else:
            heal(servers)
        check(ports, m)
    finally:
        shutdown(servers)


# ------------------------------------------------------------ the marks
def test_marks_merge_in_any_order_from_many_threads(tmp_path):
    """Marks and catch-up records are per writer boot maximums: merged
    from 16 threads in random orders (the announces and the /status
    answers of many peers at once), the stale copies are exactly those
    whose largest mark passes their largest record."""
    import random
    import sys
    import threading

    servers, _, _ = make_cluster("port", tmp_path, n=2, replica_n=1, heartbeat_interval=3600)
    try:
        c = servers[0].cluster
        rng = random.Random(15)
        uris = [f"http://127.0.0.1:{p}" for p in (1, 2, 3)]
        boots = ["a", "b", "c"]
        bodies = [
            {name: [[rng.choice(uris), "rc", rng.randrange(8), {rng.choice(boots): rng.randrange(1, 40)}]
                    for _ in range(30)]}
            for name in ("marks", "caught") for _ in range(40)
        ]
        want_marks, want_caught = {}, {}
        for body in bodies:
            for name, table in (("marks", want_marks), ("caught", want_caught)):
                for uri, index, shard, stamps in body.get(name, ()):
                    cur = table.setdefault((uri, index, shard), {})
                    for boot, seq in stamps.items():
                        cur[boot] = max(cur.get(boot, 0), seq)
        want = {
            (uri, shard)
            for (uri, _, shard), stamps in want_marks.items()
            if any(seq > want_caught.get((uri, "rc", shard), {}).get(boot, 0) for boot, seq in stamps.items())
        }
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            chunks = [bodies[i::16] for i in range(16)]
            for chunk in chunks:
                rng.shuffle(chunk)
            lost = []

            def merge(chunk):
                # each merge is on disk when it returns, whatever the
                # other threads write meanwhile
                for b in chunk:
                    c._merge_marks(b)
                    with open(c._marks_path) as f:
                        disk = {name: {tuple(r[:3]): r[3] for r in rows} for name, rows in json.load(f).items()}
                    lost.extend(r for name, rows in b.items() for r in rows
                                if any(disk[name].get(tuple(r[:3]), {}).get(k, 0) < v for k, v in r[3].items()))

            threads = [threading.Thread(target=merge, args=(ch,)) for ch in chunks]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads) and not lost, lost[:3]
        finally:
            sys.setswitchinterval(switch)
        got = {(uri, shard) for uri in uris for shard in c._stale_shards("rc", uri)}
        assert got == want and want
        # the marks file holds every merge: none lost between two writers
        with open(c._marks_path) as f:
            on_disk = json.load(f)
        assert {name: sorted(map(str, rows)) for name, rows in on_disk.items()} == {
            name: sorted(map(str, rows)) for name, rows in c.marks_snapshot().items()}
    finally:
        shutdown(servers)
