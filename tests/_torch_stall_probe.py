"""Two probes of the port's three-node CPU cluster under load, run by
hand beside busy loops (``python3 -c "while True: pass" &`` per core):

    JAX_PLATFORMS=cpu python tests/_torch_stall_probe.py heard 4
    JAX_PLATFORMS=cpu python tests/_torch_stall_probe.py merge 15

``heard`` runs the set-up of ``test_torch_cluster``'s cut-off test
(lease 1 s: index, field, import, a Count through each node) and prints,
per run, the status of each Count, the marks-file writes, the largest
age of any node's last hearing of a peer, the longest stall of the whole
process (a 5 ms sleeper's overshoot) and the phases of stalls past 0.2 s.
``merge`` repeats ``test_torch_replica_catchup``'s
``test_marks_merge_in_any_order_from_many_threads`` and prints how many
runs failed.
"""

import os
import pathlib
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402

import test_torch_cluster as tc  # noqa: E402


def heard_run(tmp):
    servers, ports, _ = tc.make_cluster("port", tmp, heartbeat_interval=0.1)
    worst = {"age": 0.0, "stall": 0.0, "events": []}
    phase = ["setup"]
    stop = threading.Event()

    def sample():
        last = time.monotonic()
        while not stop.is_set():
            time.sleep(0.005)
            now = time.monotonic()
            stall = now - last - 0.005
            last = now
            worst["stall"] = max(worst["stall"], stall)
            if stall > 0.2:
                worst["events"].append((phase[0], round(stall, 3)))
            for srv in servers:
                for n in srv.cluster._peers(alive_only=False):
                    at = srv.cluster._heard.get(n.id)
                    if at is not None:
                        worst["age"] = max(worst["age"], now - at)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        for srv in servers:
            srv.cluster.lease_s, srv.cluster.down_after_s = tc.CUT_LEASE_S, 2 * tc.CUT_LEASE_S
        c0, node2 = servers[0].cluster, servers[2].cluster.me.id
        phase[0] = "index"
        tc.ok(ports[0], "POST", "/index/cut", {})
        tc.ok(ports[0], "POST", "/index/cut/field/f", {})
        old = [s for s in range(64) if c0.topology.owns(node2, "cut", s)][:4]
        phase[0] = "import"
        tc._import(ports[0], "cut", "f", [1] * len(old), [s * SHARD_WIDTH for s in old])
        phase[0] = "query"
        statuses = [tc.call(p, "POST", "/index/cut/query", b"Count(Row(f=1))")[0] for p in ports]
        time.sleep(0.3)
        writes = sum(srv.cluster.marks_file["writes"] for srv in servers)
    finally:
        stop.set()
        th.join()
        tc.shutdown(servers)
    return statuses, writes, round(worst["age"], 3), round(worst["stall"], 3), worst["events"][:5]


def main(mode, runs):
    failed = 0
    for i in range(runs):
        tmp = pathlib.Path(tempfile.mkdtemp())
        if mode == "heard":
            print(i, heard_run(tmp), flush=True)
            continue
        import test_torch_replica_catchup as rc

        try:
            rc.test_marks_merge_in_any_order_from_many_threads(tmp)
        except AssertionError as e:
            failed += 1
            print(i, "failed", str(e)[:160], flush=True)
    if mode == "merge":
        print(f"{failed} of {runs} runs failed")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
