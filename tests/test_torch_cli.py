"""The port's command line (``python -m pilosa_tpu_torch``) against the
reference's, on the CPU.

Counterparts of tests/test_cli.py, each run twice on the same input: the
port's CLI against the port's ``Server(device="cpu")``, and the
reference's CLI against the reference ``Server``; the outputs must
agree. Then what the port adds: ``--device``, ``--processes``/
``--seeds``/``--coordinator`` starting a supervisor or a cluster node,
the loader's frames and bulk load, and backup/restore of a cluster with
``fragment_checksum``.
"""

import json
import re
import tarfile

import numpy as np
import pytest

from pilosa_tpu import cli as ref_cli
from pilosa_tpu import loader as ref_loader
from pilosa_tpu import roaring as ref_roaring
from pilosa_tpu.parallel import movement as ref_movement
from pilosa_tpu.server import Server as RefServer
from pilosa_tpu.utils.config import Config as RefConfig
from pilosa_tpu_torch import cli, loader, roaring
from pilosa_tpu_torch.parallel import movement
from pilosa_tpu_torch.server import Server
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.config import Config, load_config



def _open(cls, config_cls, path, **kw):
    cfg = config_cls(bind="127.0.0.1:0", data_dir=str(path), anti_entropy_interval=0, profiler_enabled=False,
                     diagnostics_interval=0, result_cache_mode="off", **kw)
    s = cls(cfg, device="cpu") if cls is Server else cls(cfg)
    s.open()
    s.wait_mesh(60)
    return s


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(reference server, port server), each on a data dir of its own."""
    root = tmp_path_factory.mktemp("cli")
    ref = _open(RefServer, RefConfig, root / "ref")
    port = _open(Server, Config, root / "port")
    yield ref, port
    port.close()
    ref.close()


def both(servers, capsys, argv: list) -> tuple:
    """``argv`` through the reference CLI on the reference server, then
    through the port's on the port's: ((rc, out, err), (rc, out, err)).
    ``{host}`` in argv names each server, and the server's address in
    the output reads ``{host}`` again."""
    outs = []
    for main, srv in ((ref_cli.main, servers[0]), (cli.main, servers[1])):
        capsys.readouterr()
        host = f"127.0.0.1:{srv.port}"
        rc = main([a.replace("{host}", host) for a in argv])
        out, err = capsys.readouterr()
        outs.append((rc, out.replace(host, "{host}"), err.replace(host, "{host}")))
    return tuple(outs)


def query(srv, index: str, pql: str):
    import json
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/index/{index}/query", data=pql.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())["results"]


def test_cli_import_export_roundtrip(servers, tmp_path, capsys):
    csv = tmp_path / "data.csv"
    csv.write_text("1,10\n1,20\n2,10\n3,%d\n" % (3 * SHARD_WIDTH + 5))
    ref, port = both(servers, capsys, ["import", str(csv), "--host", "{host}", "-i", "ie", "-f", "f", "--create"])
    assert ref == port and ref[0] == 0 and "imported 4 records into ie/f" in ref[1]
    ref, port = both(servers, capsys, ["export", "--host", "{host}", "-i", "ie", "-f", "f"])
    assert ref == port and ref[0] == 0
    assert "1,10" in ref[1] and "1,20" in ref[1] and "2,10" in ref[1] and f"3,{3 * SHARD_WIDTH + 5}" in ref[1]


def test_cli_import_values(servers, tmp_path, capsys):
    csv = tmp_path / "vals.csv"
    csv.write_text("10,5\n20,-3\n70000,12\n")
    ref, port = both(servers, capsys, ["import", str(csv), "--host", "{host}", "-i", "iv", "-f", "v", "--create",
                                       "--values"])
    assert ref == port and ref[0] == 0
    assert servers[1].holder.index("iv").field("v").value(10) == (5, True)
    assert servers[1].holder.index("iv").field("v").value(20) == (-3, True)
    for pql in ("Sum(field=v)", "Min(field=v)", "Max(field=v)", "Row(v < 0)"):
        assert query(servers[0], "iv", pql) == query(servers[1], "iv", pql)


def test_cli_check_and_inspect(tmp_path, capsys):
    good = tmp_path / "good"
    good.write_bytes(roaring.serialize(roaring.Bitmap.from_values(np.array([1, 2, SHARD_WIDTH + 7], dtype=np.uint64))))
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x00\x01garbage")
    outs = []
    for main in (ref_cli.main, cli.main):
        capsys.readouterr()
        rcs = (main(["check", str(good)]), main(["check", str(good), str(bad)]), main(["inspect", str(good)]))
        outs.append((rcs, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[1][0] == (0, 1, 0)
    assert "OK (3 bits" in outs[1][1] and "CORRUPT" in outs[1][1] and "bits: 3" in outs[1][1]


def test_cli_config(tmp_path, capsys):
    """config --generate, generate-config and config --config: the
    reference's text, the supervisor's restart backoff keys included."""
    cfg_file = tmp_path / "c.toml"
    cfg_file.write_text('bind = "0.0.0.0:9999"\nreplica-n = 3\ncoordinator-address = "10.0.0.1:8476"\n')
    for argv in (["config", "--generate"], ["generate-config"], ["config", "--config", str(cfg_file)]):
        capsys.readouterr()
        assert ref_cli.main(list(argv)) == 0
        want = capsys.readouterr().out
        assert cli.main(list(argv)) == 0
        got = capsys.readouterr().out
        assert got == want and "supervisor-restart-backoff-max-s = 10.0" in got
    assert 'bind = "0.0.0.0:9999"' in got and "replica-n = 3" in got and 'coordinator-address = "10.0.0.1:8476"' in got


def test_config_env_precedence(tmp_path):
    from pilosa_tpu.utils.config import load_config as ref_load_config

    cfg_file = tmp_path / "c.toml"
    cfg_file.write_text('bind = "file:1"\ndata-dir = "/from-file"\n')
    env = {"PILOSA_TPU_BIND": "env:2", "PILOSA_TPU_REPLICA_N": "5", "PILOSA_TPU_COORDINATOR": "true",
           "PILOSA_TPU_SEEDS": "a,b", "PILOSA_TPU_NUM_PROCESSES": "4"}
    cfg = load_config(str(cfg_file), env=env, overrides={"bind": "flag:3"})
    ref = ref_load_config(str(cfg_file), env=env, overrides={"bind": "flag:3"})
    assert cfg.bind == ref.bind == "flag:3"  # flag wins
    assert cfg.data_dir == ref.data_dir == "/from-file"  # file when no env/flag
    assert cfg.replica_n == ref.replica_n == 5 and cfg.coordinator is ref.coordinator is True
    assert cfg.seeds == ref.seeds == ["a", "b"]
    assert cfg.num_processes == ref.num_processes == 4


def _skeleton(text: str) -> str:
    """The explain text without its measured and estimated numbers."""
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", text)


def test_cli_explain_and_analyze(servers, tmp_path, capsys):
    csv = tmp_path / "ex.csv"
    csv.write_text("1,10\n1,20\n")
    ref, port = both(servers, capsys, ["import", str(csv), "--host", "{host}", "-i", "e", "-f", "f", "--create"])
    assert ref == port
    # plan only: the cost table renders with the chosen path marked
    ref, port = both(servers, capsys, ["explain", "Count(Row(f=1))", "--host", "{host}", "-i", "e"])
    assert ref[0] == port[0] == 0
    out = port[1]
    assert "route mode:" in out and "host" in out and "device" in out
    assert "* " in out and "results:" not in out
    assert _skeleton(out).splitlines()[:3] == _skeleton(ref[1]).splitlines()[:3]
    # analyze: measured actuals + results
    ref, port = both(servers, capsys, ["explain", "Count(Row(f=1))", "--host", "{host}", "-i", "e", "--analyze"])
    assert ref[0] == port[0] == 0
    assert "measured" in port[1] and "error x" in port[1] and "results: [2]" in port[1]
    assert [ln for ln in port[1].splitlines() if ln.startswith("results:")] == [
        ln for ln in ref[1].splitlines() if ln.startswith("results:")]
    # raw JSON passthrough
    import json

    ref, port = both(servers, capsys, ["explain", "Count(Row(f=1))", "--host", "{host}", "-i", "e", "--json"])
    assert json.loads(port[1])["explain"]["calls"][0]["call"] == json.loads(ref[1])["explain"]["calls"][0]["call"] == "Count"


def test_cli_replay_and_doctor(servers, tmp_path, capsys):
    """A capture replayed against both servers: no divergence on either;
    doctor's bundle walks the same debug endpoints on both."""
    import json

    capture = tmp_path / "cap.jsonl"
    records = [{"t": 0.001 * i, "index": "e", "pql": pql, "status": 200, "call": pql.split("(")[0], "ms": 1.0}
               for i, pql in enumerate(["Count(Row(f=1))", "Row(f=1)", "TopN(f, n=2)"] * 2)]
    capture.write_text("".join(json.dumps(r) + "\n" for r in records))
    ref, port = both(servers, capsys, ["replay", str(capture), "--host", "{host}", "--json", "--speed", "100"])
    assert ref[0] == port[0] == 0
    rr, pr = json.loads(ref[1]), json.loads(port[1])
    assert rr["recorded"] == pr["recorded"]
    assert (pr["replay"]["divergence"], pr["replay"]["completed"]) == (rr["replay"]["divergence"], 6) == (0, 6)
    ref, port = both(servers, capsys, ["doctor", "--host", "{host}", "--compact"])
    assert ref[0] == port[0] == 0
    rb, pb = json.loads(ref[1]), json.loads(port[1])
    assert sorted(pb["endpoints"]) == sorted(rb["endpoints"]) and pb["doctorErrors"] == 0


def test_server_runs_on_the_card_unless_told(tmp_path):
    """``server`` takes the card by default and raises without one;
    ``--device cpu`` is the only way onto the plain versions."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["server", "--bind", "127.0.0.1:0", "--data-dir", str(tmp_path / "d")])


@pytest.mark.parametrize("flags", [["--processes", "2"], ["--seeds", "http://127.0.0.1:1"], ["--coordinator"]])
def test_server_refuses_the_cluster_options(tmp_path, flags):
    """The options that the port refused before it had a cluster layer
    and a supervisor start a server that answers: a supervisor of two
    children sharing the public port, a cluster node (its seed list
    names itself) and a one-node coordinator. SIGTERM ends each with 0."""
    import os
    import signal
    import subprocess
    import sys
    import time
    import urllib.request

    (port,) = _free_ports(1)
    flags = [f"http://127.0.0.1:{port}" if f.startswith("http://") else f for f in flags]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    log = tmp_path / "server.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch", "server", "--device", "cpu", "--bind", f"127.0.0.1:{port}",
         "--data-dir", str(tmp_path / "d"), "--replica-n", "1"] + flags,
        env=env, stdout=open(log, "w"), stderr=subprocess.STDOUT,
    )
    ready = "processes serving" if "--processes" in flags else "device cpu: ready"
    try:
        deadline = time.monotonic() + 120
        while ready not in log.read_text():
            assert proc.poll() is None and time.monotonic() < deadline, log.read_text()
            time.sleep(0.2)

        def post(path, body):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        post("/index/i", b"{}")
        post("/index/i/field/f", b"{}")
        post("/index/i/field/f/import", json.dumps({"rowIDs": [1, 1, 1], "columnIDs": [3, SHARD_WIDTH + 3, 5 * SHARD_WIDTH]}).encode())
        assert post("/index/i/query", b"Count(Row(f=1))") == {"results": [3]}
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
    assert rc == 0, log.read_text()


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _bits(seed: int, n: int, shards: int, rows: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, rows, n).astype(np.uint64),
            rng.integers(0, shards * SHARD_WIDTH, n).astype(np.uint64))


def test_loader_frames_are_the_references_bytes():
    rows, cols = _bits(5, 50_000, 6, 16)
    cols[:100] = 0  # duplicates
    for batch in (1 << 20, 7_000):
        got = loader.build_frames(rows, cols, batch_bits=batch)
        want = ref_loader.build_frames(rows, cols, batch_bits=batch)
        assert [(s, bytes(f), n) for s, f, n in got] == [(s, bytes(f), n) for s, f, n in want]
    for fmt, lines in (("csv", ["1,10", "", "2,70000,ts"]), ("jsonl", ['{"rowID": 1, "columnID": 10}', '{"row": 2, "col": 5}'])):
        g, w = loader.parse_records(lines, fmt), ref_loader.parse_records(lines, fmt)
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
    assert loader.detect_format("x.ndjson") == ref_loader.detect_format("x.ndjson") == "jsonl"


def test_bulk_load_and_import_roaring_give_the_references_counts(servers, tmp_path, capsys):
    """``bulk_load`` of numpy bits and ``import --roaring`` of a CSV into
    both servers: the same Counts and TopN on both."""
    rows, cols = _bits(6, 40_000, 5, 4)
    stats = []
    for srv, mod in ((servers[0], ref_loader), (servers[1], loader)):
        uri = f"http://127.0.0.1:{srv.port}"
        for path, body in ((f"/index/bl", b"{}"), (f"/index/bl/field/g", b"{}")):
            import urllib.request

            urllib.request.urlopen(urllib.request.Request(uri + path, data=body, method="POST"), timeout=30).read()
        st = mod.bulk_load(uri, "bl", "g", rows, cols, batch_bits=16_384, pipeline=2)
        stats.append({k: st[k] for k in ("bits", "bytes", "posts", "frames", "backoffs429")})
    assert stats[0] == stats[1] and stats[1]["posts"] == stats[1]["frames"] > 1
    csv = tmp_path / "r.csv"
    r2, c2 = _bits(7, 3_000, 3, 3)
    csv.write_text("".join(f"{r},{c}\n" for r, c in zip(r2.tolist(), c2.tolist())))
    ref, port = both(servers, capsys, ["import", str(csv), "--roaring", "--host", "{host}", "-i", "br", "-f", "h",
                                       "--create", "--batch-size", "1000"])
    assert ref[0] == port[0] == 0
    assert re.sub(r"in [\d.]+s \([\d.]+ Mbit/s", "", ref[1]) == re.sub(r"in [\d.]+s \([\d.]+ Mbit/s", "", port[1])
    for pql in ["Count(Row(g=%d))" % r for r in range(4)] + ["Count(Intersect(Row(g=1), Row(g=2)))", "TopN(g, n=4)"]:
        assert query(servers[0], "bl", pql) == query(servers[1], "bl", pql)
    for pql in ("Count(Row(h=0))", "TopN(h, n=3)", "Count(Union(Row(h=1), Row(h=2)))"):
        assert query(servers[0], "br", pql) == query(servers[1], "br", pql)
    assert query(servers[1], "br", "Count(Row(h=2))") == [len(np.unique(c2[r2 == 2]))]
    want = len(np.unique(cols[rows == 1]))
    assert query(servers[1], "bl", "Count(Row(g=1))") == [want]


def test_backup_restore_roundtrip(servers, tmp_path, capsys):
    """Each CLI backs up a two-node cluster of its own package (each
    node a replica of every shard, so the schema dump's shard list does
    not depend on placement), loaded with the same bits through the bulk
    lane; the tars hold the same
    bytes, each frame's ``fragment_checksum`` is the reference's, and
    ``restore`` into each solo server gives the source's Counts and
    export."""
    import urllib.request

    rows, cols = _bits(8, 5_000, 4, 3)
    tars, counts, clusters = {}, {}, []
    try:
        for name, main, srv_cls, cfg_cls, load in (("ref", ref_cli.main, RefServer, RefConfig, ref_loader),
                                                   ("port", cli.main, Server, Config, loader)):
            ports = _free_ports(2)
            seeds = [f"http://127.0.0.1:{p}" for p in ports]
            nodes = []
            for i, p in enumerate(ports):
                cfg = cfg_cls(bind=f"127.0.0.1:{p}", data_dir=str(tmp_path / f"{name}{i}"), seeds=seeds,
                              coordinator=(i == 0), replica_n=2, anti_entropy_interval=0, result_cache_mode="off",
                              profiler_enabled=False, diagnostics_interval=0)
                nodes.append(srv_cls(cfg, device="cpu") if srv_cls is Server else srv_cls(cfg))
                nodes[-1].open()
                clusters.append(nodes[-1])
            for n in nodes:
                n.cluster._heartbeat_once()
            for path, body in (("/index/bk", b"{}"), ("/index/bk/field/f", b"{}")):
                urllib.request.urlopen(urllib.request.Request(seeds[0] + path, data=body, method="POST"), timeout=30).read()
            load.bulk_load(seeds[1], "bk", "f", rows, cols)
            assert all(n.holder.index("bk").available_shards() for n in nodes)
            tars[name] = tmp_path / f"{name}.tar"
            capsys.readouterr()
            assert main(["backup", "--host", f"127.0.0.1:{ports[1]}", "-i", "bk", "-o", str(tars[name])]) == 0
            assert "fragments" in capsys.readouterr().out
            counts[name] = [query(nodes[0], "bk", f"Count(Row(f={r}))") for r in range(3)]
    finally:
        for n in clusters:
            n.cluster.close()
            n.cluster.client.close()
        for n in clusters:
            n.close()
    assert counts["ref"] == counts["port"]
    src_counts = counts["port"]
    members = {}
    for name, path in tars.items():
        with tarfile.open(path) as tar:
            members[name] = {m.name: tar.extractfile(m).read() for m in tar.getmembers()}
    assert members["ref"] == members["port"]
    frames = [v for k, v in members["port"].items() if "/fragments/" in k]
    assert frames and all(movement.fragment_checksum(f) == ref_movement.fragment_checksum(f) for f in frames)
    ref, port = both(servers, capsys, ["restore", str(tars["port"]), "--host", "{host}", "--rename", "bk2"])
    assert ref == port and ref[0] == 0
    for r in range(3):
        assert query(servers[0], "bk2", f"Count(Row(f={r}))") == query(servers[1], "bk2", f"Count(Row(f={r}))") == src_counts[r]
    ref, port = both(servers, capsys, ["export", "--host", "{host}", "-i", "bk2", "-f", "f"])
    assert ref == port


def test_fragment_checksum_matches_reference():
    rng = np.random.default_rng(9)
    for n in (0, 1, 5_000):
        bm = ref_roaring.Bitmap.from_values(np.unique(rng.integers(0, 1 << 24, n)).astype(np.uint64))
        data = ref_roaring.serialize(bm)
        assert movement.fragment_checksum(data) == ref_movement.fragment_checksum(data)


def test_movement_lane_accounts_as_the_reference():
    """The copied admission lane (idle until the cluster layer) admits,
    paces and accounts a transfer sequence as the reference's does:
    progress rows, the meter's totals, a failed transfer, the token
    bucket's verdicts."""

    def drive(mod):
        lane = mod.MovementLane(max_concurrent=2, max_mbit=8.0)  # 1 MB/s, 1 s of burst
        with lane.transfer("pull", "i", "f", "standard", 3, "n1") as row:
            row["bytes"] = 700
            lane.account("pull", 700)
        with pytest.raises(RuntimeError), lane.transfer("restore", "i", shard=4):
            raise RuntimeError("adopt failed")
        lane.account("push", 300)
        paid = [lane.throttle(n) for n in (0, 400_000, 500_000)]
        unpaced = mod.MovementLane().throttle(10 << 20)
        snap = lane.snapshot()
        for r in snap["recent"]:
            r.pop("seconds")
        totals = ("bytesByDirection", "bytesTotal", "fragmentsTotal", "throttleWaits")
        meter = {k: snap["meter"][k] for k in totals}
        return snap["recent"], snap["active"], snap["maxConcurrent"], snap["maxMbit"], meter, paid, unpaced

    got, want = drive(movement), drive(ref_movement)
    assert got == want
    assert [r["state"] for r in got[0]] == ["done", "failed"] and got[4]["bytesTotal"] == 1000
