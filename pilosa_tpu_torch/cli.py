"""CLI: server / import / export / config / check / inspect subcommands.

Reference: pilosa_tpu/cli.py (after cmd/pilosa/main.go + ctl/). The same
subcommands, flags and output, for the port:

    python -m pilosa_tpu_torch server --bind 127.0.0.1:10101 --data-dir ~/.pilosa

``server`` runs on the CUDA card unless given ``--device cpu`` (the plain
torch versions of the kernels); no config key or environment variable
selects the device. ``--seeds`` and ``--coordinator`` start a cluster
node (parallel/cluster.py); ``--processes N`` above 1 runs a supervisor
(server/supervisor.py) of N child servers on the same device, sharing
the public port. A config with ``coordinator-address`` joins the
multi-host process group when the server opens (parallel/multihost.py).

The client commands (``import``, ``export``, ``explain``, ``replay``,
``backup``, ``restore``, ``doctor``) and the supervisor's parent speak
HTTP and import neither torch nor the server runtime.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
import urllib.error
import urllib.request

import numpy as np

def _base_uri(host: str) -> str:
    """--host accepts `host:port` (http) or a scheme-qualified URI
    (`https://host:port` for TLS servers)."""
    if host.startswith(("http://", "https://")):
        return host.rstrip("/")
    return f"http://{host}"


_SSL_CTX = None  # set by subcommands when --tls-skip-verify is passed


def _http(method: str, url: str, body: bytes | None = None, ctype: str = "application/json"):
    req = urllib.request.Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, context=_SSL_CTX) as resp:
        return json.loads(resp.read() or b"{}")


def _http_raw(method: str, url: str, body: bytes | None = None,
              ctype: str = "application/octet-stream") -> bytes:
    """Like _http but for octet-stream payloads (fragment frames)."""
    req = urllib.request.Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, context=_SSL_CTX) as resp:
        return resp.read()


_RESTORE_MAX_RETRIES_429 = 64


def _post_with_backoff(url: str, body: bytes, ctype: str) -> dict:
    """POST honoring 429/Retry-After (docs/resize.md): restore streams
    whole-fragment frames through the public bulk lane, so it must yield
    to admission control exactly like the loader — retry the SAME frame
    (import-roaring union-adopt is idempotent) after the advertised
    pause, bounded so a wedged server fails the restore instead of
    hanging it."""
    for _ in range(_RESTORE_MAX_RETRIES_429):
        try:
            raw = _http_raw("POST", url, body, ctype=ctype)
            return json.loads(raw or b"{}")
        except urllib.error.HTTPError as e:
            if e.code != 429:
                raise
            try:
                retry_after = float(e.headers.get("Retry-After") or 0.05)
            except ValueError:
                retry_after = 0.05
            e.close()
            time.sleep(min(max(retry_after, 0.01), 5.0))
    raise RuntimeError(
        f"restore: {url} still answering 429 after "
        f"{_RESTORE_MAX_RETRIES_429} attempts"
    )


def _apply_skip_verify(args) -> None:
    global _SSL_CTX
    if getattr(args, "tls_skip_verify", False):
        import ssl

        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        _SSL_CTX = ctx
    else:
        _SSL_CTX = None  # never inherit skip-verify from a prior invocation


def cmd_server(args) -> int:
    from pilosa_tpu_torch.utils.config import load_config

    cfg = load_config(
        args.config,
        overrides={
            "bind": args.bind,
            "data_dir": args.data_dir,
            "coordinator": args.coordinator or None,
            "seeds": args.seeds.split(",") if args.seeds else None,
            "replica_n": args.replica_n,
            "serving_processes": args.processes,
            "tls_certificate": args.tls_certificate,
            "tls_key": args.tls_key,
            "tls_skip_verify": args.tls_skip_verify or None,
        },
    )
    if cfg.serving_processes > 1:
        # multi-process serving (docs/multiprocess.md): the parent is a
        # SUPERVISOR — spawn/watch/drain N child servers sharing the
        # public port, each on --device. Deliberately before any torch
        # import: the parent is a lifecycle manager and must hold no
        # CUDA context (the children each pay their own). CLI flags
        # that override the config file travel to children as env
        # (argv keeps only per-child bind/data-dir/config/device).
        from pilosa_tpu_torch.server.supervisor import Supervisor

        passthrough = {}
        for key in ("tls_certificate", "tls_key"):
            value = getattr(args, key)
            if value is not None:
                passthrough[key] = value
        if args.tls_skip_verify:
            passthrough["tls_skip_verify"] = "1"
        sup = Supervisor(
            cfg, config_path=args.config, argv_overrides=passthrough,
            device=args.device,
        )
        return sup.run_forever()
    import threading

    from pilosa_tpu_torch.server import Server

    srv = Server(cfg, device=args.device)
    srv.open()
    # each line in one write: the children of a fleet share their
    # parent's stdout, and print() writes the text and its newline apart,
    # so two children's lines could run together
    sys.stdout.write(f"pilosa-tpu server listening on {srv.uri}\n")
    sys.stdout.flush()

    def report_device() -> None:
        # the probe runs off the thread: say once where queries will run
        if srv.wait_mesh(None):
            ok, reason = srv.device_verdict
            sys.stdout.write(f"device {srv.device}: {'ready' if ok else 'FAILED'} ({reason})\n")
            sys.stdout.flush()

    threading.Thread(target=report_device, daemon=True, name="device-verdict").start()
    profiler = None
    if args.cpu_profile:
        # reference: the server command's cpu-profile flag. A SAMPLING
        # profiler over ALL threads (cProfile hooks only the enabling
        # thread — request handling runs on the HTTP server's worker
        # threads, which it would never see); the dump is folded-stack
        # text, directly consumable by flamegraph tooling. The output
        # path is opened up front so a bad path fails at startup, not
        # after hours of serving.
        from pilosa_tpu_torch.utils.profiling import WholeRunSampler

        profiler = WholeRunSampler(open(args.cpu_profile, "w"))
        profiler.start()
    stop = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            signal.pause()
    except KeyboardInterrupt:
        pass
    finally:
        if profiler is not None:
            try:
                profiler.stop()
                print(f"cpu profile written to {args.cpu_profile}", flush=True)
            except OSError as e:
                print(f"cpu profile write failed: {e}", flush=True)
        srv.close()
        # what this server ran on its device: each kernel's launches by
        # mode (all 0 on the CPU, where the plain versions run)
        from pilosa_tpu_torch.ops import _cuda

        # one write, as the listening and device lines
        sys.stdout.write("kernel launches " + json.dumps({
            n: {"launches": k.launches, "modes": k.modes}
            for n, k in _cuda.KERNELS.items() if k.launches
        }) + "\n")
        sys.stdout.flush()
    return 0


def cmd_import(args) -> int:
    """Bulk import (reference: ctl/import.go). Two lanes:

    - default: CSV rows of `rowID,columnID[,timestamp]` (or, with
      --values, `columnID,value`) POSTed as JSON batches to /import
      (/import-value) — key translation and time views supported;
    - ``--roaring``: the wire-speed bulk lane (docs/ingest.md) — CSV or
      JSONL/NDJSON records vectorized into per-shard serialized roaring
      frames and streamed to /import-roaring with bounded pipelining
      and 429/Retry-After backoff. IDs only (roaring frames carry no
      keys), standard view, set fields.
    """
    _apply_skip_verify(args)
    root = _base_uri(args.host)
    base = f"{root}/index/{args.index}/field/{args.field}"
    if args.roaring:
        from pilosa_tpu_torch import loader

        if args.values:
            print("--roaring is a bit lane; use the default lane for "
                  "--values (BSI) imports", file=sys.stderr)
            return 2
        fmt = args.format or (
            "jsonl" if args.path == "-" else loader.detect_format(args.path)
        )
        f = sys.stdin if args.path == "-" else open(args.path)
        with f:
            rows, cols = loader.parse_records(f, fmt)
        if args.create:
            _http("POST", f"{root}/index/{args.index}", b"{}")
            _http("POST", base, json.dumps({}).encode())
        stats = loader.bulk_load(
            root,
            args.index,
            args.field,
            rows,
            cols,
            pipeline=args.pipeline,
            batch_bits=args.batch_size,
            ssl_context=_SSL_CTX,
        )
        print(
            f"imported {stats['bits']} bits into "
            f"{args.index}/{args.field} via {stats['posts']} roaring "
            f"frames in {stats['seconds']}s "
            f"({stats['mbitSetPerS']} Mbit/s, "
            f"{stats['backoffs429']} backoffs)"
        )
        return 0
    rows, cols, timestamps, values = [], [], [], []
    f = sys.stdin if args.path == "-" else open(args.path)
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if args.values:
                cols.append(int(parts[0]))
                values.append(int(parts[1]))
            else:
                rows.append(int(parts[0]))
                cols.append(int(parts[1]))
                if len(parts) > 2:
                    timestamps.append(parts[2])
    if args.create:
        _http("POST", f"{root}/index/{args.index}", b"{}")
        opts = {"options": {"type": "int"}} if args.values else {}
        _http("POST", base, json.dumps(opts).encode())
    batch = args.batch_size
    if args.values:
        for i in range(0, len(cols), batch):
            payload = {"columnIDs": cols[i : i + batch], "values": values[i : i + batch]}
            _http("POST", base + "/import-value", json.dumps(payload).encode())
    else:
        for i in range(0, len(cols), batch):
            payload = {"rowIDs": rows[i : i + batch], "columnIDs": cols[i : i + batch]}
            if timestamps:
                payload["timestamps"] = timestamps[i : i + batch]
            _http("POST", base + "/import", json.dumps(payload).encode())
    print(f"imported {len(cols)} records into {args.index}/{args.field}")
    return 0


def cmd_export(args) -> int:
    _apply_skip_verify(args)
    url = f"{_base_uri(args.host)}/export?index={args.index}&field={args.field}"
    req = urllib.request.Request(url)
    with urllib.request.urlopen(req, context=_SSL_CTX) as resp:
        sys.stdout.write(resp.read().decode())
    return 0


def cmd_explain(args) -> int:
    """EXPLAIN / EXPLAIN ANALYZE over HTTP (docs/observability.md):
    POSTs the query with ``?explain=true`` (plan only — nothing
    executes) or ``?explain=analyze`` (execute + measured actuals next
    to each estimate) and renders the router cost table, residency
    classification, mesh verdict, and wave batchability."""
    _apply_skip_verify(args)
    mode = "analyze" if args.analyze else "true"
    url = f"{_base_uri(args.host)}/index/{args.index}/query?explain={mode}"
    if args.shards:
        url += f"&shards={args.shards}"
    out = _http("POST", url, args.query.encode(), ctype="text/plain")
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    plan = out.get("explain", out)
    print(f"query:      {plan.get('query')}")
    print(f"route mode: {plan.get('routeMode')}"
          f"  crossover words: {plan.get('crossoverWords'):.0f}")
    wave = plan.get("waveScheduler", {})
    print(f"wave:       batchable={wave.get('batchable')}"
          f" ({wave.get('reason')})")
    for i, c in enumerate(plan.get("calls", [])):
        print(f"call {i}: {c.get('call')}  route={c.get('route')}"
              + (f"  actual={c.get('actualRoute')}"
                 f" {c.get('actualSeconds', 0) * 1e3:.3f}ms"
                 if "actualSeconds" in c else ""))
        if "estimatedWorkWords" in c:
            print(f"  work estimate: {c['estimatedWorkWords']} words")
        for path, cand in sorted(c.get("candidates", {}).items()):
            mark = "*" if cand.get("chosen") else " "
            line = (f"  {mark} {path:<7}"
                    f" est {cand['estimatedSeconds'] * 1e3:9.3f}ms")
            if "measuredSeconds" in cand:
                line += (f"  measured {cand['measuredSeconds'] * 1e3:9.3f}ms"
                         f"  error x{cand['errorRatio']:.2f}")
            print(line)
        res = c.get("residency")
        if res and res.get("tiered"):
            print(f"  residency: tiered, coldUploadWords="
                  f"{res.get('coldUploadWords')}")
        mesh = c.get("mesh")
        if mesh is not None:
            print(f"  mesh: supported={mesh.get('supported')}"
                  f" ({mesh.get('reason')})")
    if "actualTotalSeconds" in plan:
        print(f"total: {plan['actualTotalSeconds'] * 1e3:.3f}ms"
              + (f"  readback: {plan['actualReadbackSeconds'] * 1e3:.3f}ms"
                 if "actualReadbackSeconds" in plan else ""))
    if "results" in out:
        print(f"results: {json.dumps(out['results'])[:400]}")
    return 0


def cmd_replay(args) -> int:
    """Replay a captured workload against a live server
    (docs/workload.md).  ``capture`` is a JSONL file, a directory of
    spill segments (``workload-capture-path``), or ``-`` for stdin
    (pipe ``curl .../debug/workload?format=capture`` straight in).
    Default pacing preserves the recorded arrival spacing; ``--speed N``
    scales it, ``--qps N`` replays at a fixed rate, ``--closed-loop C``
    discards spacing and drives C back-to-back clients.  The report is
    bench-row-shaped JSON: QPS, p50/p95, error rate, and the divergence
    count vs the recorded statuses."""
    import json as _json
    import tempfile

    from pilosa_tpu_torch.utils import workload

    _apply_skip_verify(args)
    path = args.capture
    tmp_path = None
    if path == "-":
        with tempfile.NamedTemporaryFile(
            "w", suffix=".jsonl", delete=False
        ) as tmp:
            tmp.write(sys.stdin.read())
            path = tmp_path = tmp.name
    try:
        records = workload.load_capture(path)
    finally:
        if tmp_path is not None:
            os.unlink(tmp_path)
    recorded = workload.recorded_summary(records)
    report = workload.replay(
        records,
        _base_uri(args.host),
        speed=args.speed,
        qps=args.qps,
        closed_loop=args.closed_loop,
        workers=args.workers,
        timeout=args.timeout,
        ssl_context=_SSL_CTX,  # --tls-skip-verify
    )
    out = {"recorded": recorded, "replay": report}
    if args.json:
        print(_json.dumps(out, indent=2))
        # same contract as the text path (docs/workload.md): divergence
        # is the exit code signal either way
        return 0 if report["divergence"] == 0 else 1
    print(
        f"replayed {report['completed']}/{report['records']} records in "
        f"{report['elapsedSeconds']:.2f}s ({report['mode']}): "
        f"{report['qps']:.1f} qps  p50 {report['p50Ms']:.2f}ms  "
        f"p95 {report['p95Ms']:.2f}ms  errors {report['errorRate']:.4f}  "
        f"divergence {report['divergence']}"
    )
    for call, c in report["perCall"].items():
        rec = recorded["perCall"].get(call, {})
        print(
            f"  {call:<10} sent={c['sent']:<6} share={c['share']:<7}"
            f" qps={c['qps']:<9} p50={c['p50Ms']}ms"
            f" (recorded share={rec.get('share')}, qps={rec.get('qps')})"
            + (f"  DIVERGED={c['divergence']}" if c["divergence"] else "")
        )
    return 0 if report["divergence"] == 0 else 1


def cmd_backup(args) -> int:
    """Whole-index backup over the bulk lane (docs/resize.md).

    Discovers the member list from ``GET /status``, takes a
    checksum-stamped fragment inventory from every node, dedups by
    (field, view, shard) — replicas carry identical serialized frames,
    verified by content digest — then streams each unique fragment's
    serialized roaring frame off a node that owns it via
    ``/internal/fragment/data``.  The tar holds the schema dump, every
    frame, and the translate stores (column + per keyed field), plus a
    manifest with per-fragment checksums so restore can verify adoption.
    """
    import tarfile
    import io as _io

    from pilosa_tpu_torch.parallel.movement import fragment_checksum

    _apply_skip_verify(args)
    root = _base_uri(args.host)
    index = args.index
    status = _http("GET", root + "/status")
    nodes = [
        n["uri"].rstrip("/") for n in status.get("nodes") or [] if n.get("uri")
    ] or [root]

    schema = _http("GET", root + "/schema")
    idx_def = next(
        (i for i in schema.get("indexes", []) if i["name"] == index), None
    )
    if idx_def is None:
        print(f"backup: index {index!r} not found on {root}", file=sys.stderr)
        return 1

    # one row per unique fragment; first owner wins, divergent replica
    # checksums are surfaced (anti-entropy hasn't converged — the backup
    # still proceeds with the first copy, verified below)
    frags: dict[tuple[str, str, int], tuple[str, str]] = {}
    divergent = 0
    for uri in nodes:
        try:
            inv = _http(
                "GET",
                f"{uri}/internal/fragment/inventory?index={index}&checksums=1",
            )
        except (urllib.error.URLError, OSError) as e:
            print(f"backup: skipping unreachable {uri}: {e}", file=sys.stderr)
            continue
        for row in inv.get("fragments", []):
            key = (row["field"], row["view"], int(row["shard"]))
            have = frags.get(key)
            if have is None:
                frags[key] = (row.get("checksum", ""), uri)
            elif have[0] and row.get("checksum") and have[0] != row["checksum"]:
                divergent += 1
    if divergent:
        print(
            f"backup: WARNING {divergent} fragment(s) diverge across "
            "replicas (anti-entropy pending); backing up first copy",
            file=sys.stderr,
        )

    out_path = args.out or f"{index}.backup.tar"
    manifest: dict = {
        "formatVersion": 1,
        "index": index,
        "fragments": [],
        "translate": {"columns": 0, "fields": {}},
    }
    total_bytes = 0
    with tarfile.open(out_path, "w") as tar:

        def put(name: str, data: bytes) -> None:
            info = tarfile.TarInfo(f"{index}/{name}")
            info.size = len(data)
            tar.addfile(info, _io.BytesIO(data))

        put(
            "schema.json",
            json.dumps({"indexes": [idx_def]}, indent=2).encode(),
        )

        for (field, view, shard), (checksum, uri) in sorted(frags.items()):
            data = _http_raw(
                "GET",
                f"{uri}/internal/fragment/data?index={index}&field={field}"
                f"&view={view}&shard={shard}",
            )
            actual = fragment_checksum(data)
            if checksum and actual != checksum:
                # a write landed between inventory and fetch — the frame
                # is still internally consistent; record what we stored
                checksum = actual
            put(f"fragments/{field}/{view}/{shard}", data)
            total_bytes += len(data)
            manifest["fragments"].append({
                "field": field,
                "view": view,
                "shard": shard,
                "bytes": len(data),
                "checksum": checksum,
            })

        def pull_translate(field: str | None) -> list:
            qs = f"index={index}&offset=0"
            if field:
                qs += f"&field={field}"
            resp = _http("GET", f"{root}/internal/translate/data?{qs}")
            return [[e["k"], e["id"]] for e in resp.get("entries", [])]

        if idx_def.get("options", {}).get("keys"):
            entries = pull_translate(None)
            put("translate/columns.json", json.dumps(entries).encode())
            manifest["translate"]["columns"] = len(entries)
        for f_def in idx_def.get("fields", []):
            if f_def.get("options", {}).get("keys"):
                entries = pull_translate(f_def["name"])
                put(
                    f"translate/field-{f_def['name']}.json",
                    json.dumps(entries).encode(),
                )
                manifest["translate"]["fields"][f_def["name"]] = len(entries)

        put("manifest.json", json.dumps(manifest, indent=2).encode())

    print(
        f"backup: {index} -> {out_path}: {len(manifest['fragments'])} "
        f"fragments, {total_bytes} frame bytes, "
        f"{manifest['translate']['columns']} column keys, "
        f"{sum(manifest['translate']['fields'].values())} row keys"
    )
    return 0


def cmd_restore(args) -> int:
    """Restore a backup tar into a (possibly different, possibly
    resized) cluster (docs/resize.md).  Order matters: schema first (to
    every node — apply_schema is idempotent), then translate entries (so
    restored bitmaps decode under the same key→ID bindings they were
    written with), then every fragment frame through the PUBLIC
    import-roaring route — the coordinator fans each frame out to
    whatever nodes own that shard under the CURRENT topology, each
    owner adopting it via one group-committed WAL append, and 429
    admission pushback is honored with Retry-After pacing."""
    import tarfile

    from pilosa_tpu_torch.parallel.movement import fragment_checksum

    _apply_skip_verify(args)
    root = _base_uri(args.host)
    with tarfile.open(args.path, "r") as tar:
        names = tar.getnames()
        prefix = names[0].split("/", 1)[0] if names else ""

        def get(name: str) -> bytes:
            f = tar.extractfile(f"{prefix}/{name}")
            if f is None:
                raise FileNotFoundError(f"{prefix}/{name} missing from tar")
            return f.read()

        manifest = json.loads(get("manifest.json"))
        schema = json.loads(get("schema.json"))
        source = manifest["index"]
        target = args.rename or source
        if target != source:
            for idx_def in schema.get("indexes", []):
                if idx_def["name"] == source:
                    idx_def["name"] = target

        status = _http("GET", root + "/status")
        nodes = [
            n["uri"].rstrip("/")
            for n in status.get("nodes") or []
            if n.get("uri")
        ] or [root]

        schema_body = json.dumps(schema).encode()
        for uri in nodes:
            _http("POST", uri + "/schema", schema_body)

        applied_keys = 0
        for member in names:
            rel = member.split("/", 1)[1] if "/" in member else member
            if not rel.startswith("translate/"):
                continue
            entries = json.loads(get(rel))
            field = None
            if rel.startswith("translate/field-"):
                field = rel[len("translate/field-"):-len(".json")]
            body: dict = {"index": target, "entries": entries}
            if field:
                body["field"] = field
            payload = json.dumps(body).encode()
            for uri in nodes:
                _http("POST", uri + "/internal/translate/apply", payload)
            applied_keys += len(entries)

        restored = 0
        mismatched = 0
        for row in manifest["fragments"]:
            data = get(
                f"fragments/{row['field']}/{row['view']}/{row['shard']}"
            )
            if row.get("checksum") and fragment_checksum(data) != row["checksum"]:
                mismatched += 1
                print(
                    f"restore: {row['field']}/{row['view']}/{row['shard']}: "
                    "frame bytes do not match manifest checksum — "
                    "tar corrupt, refusing to adopt",
                    file=sys.stderr,
                )
                continue
            _post_with_backoff(
                f"{root}/index/{target}/field/{row['field']}"
                f"/import-roaring/{row['shard']}?view={row['view']}",
                data,
                ctype="application/octet-stream",
            )
            restored += 1

    print(
        f"restore: {source} -> {target} on {root}: {restored} fragments, "
        f"{applied_keys} translate keys, {mismatched} corrupt frame(s) skipped"
    )
    return 0 if mismatched == 0 else 1


def _doctor_node_bundle(root: str, host_label: str, timeout: float) -> dict:
    """One node's full debug-surface bundle: the core routes plus a
    walk of the directory served by ``GET /debug/`` (so a debug
    endpoint added to the server is collected with no doctor change).
    Endpoints that fail are recorded as errors, not fatal: a half-dead
    node is exactly when a bundle is wanted."""

    def fetch(path: str, is_json: bool):
        req = urllib.request.Request(root + path)
        with urllib.request.urlopen(
            req, context=_SSL_CTX, timeout=timeout
        ) as resp:
            raw = resp.read()
            ctype = resp.headers.get("Content-Type", "")
        # the response's own Content-Type wins over the index's hint:
        # a doctor query string can change the representation (e.g.
        # /debug/profile defaults to folded text but the bundle fetches
        # ?format=speedscope, which is JSON)
        if "application/json" in ctype or (is_json and not ctype):
            return json.loads(raw or b"{}")
        return {"text": raw.decode(errors="replace")}

    bundle: dict = {"host": host_label, "endpoints": {}}
    errors = 0

    def collect(path: str, is_json: bool) -> None:
        nonlocal errors
        try:
            bundle["endpoints"][path] = fetch(path, is_json)
        except Exception as e:  # pilosa: allow(broad-except) — doctor's
            # JOB is recording what a sick node could not answer
            errors += 1
            bundle["endpoints"][path] = {"doctorError": repr(e)}

    for path in ("/status", "/info", "/version", "/schema"):
        collect(path, True)
    collect("/metrics", False)
    try:
        index = fetch("/debug/", True)
    except Exception as e:  # pilosa: allow(broad-except) — fall back to
        # nothing: the core routes above are already in the bundle
        bundle["debugIndexError"] = repr(e)
        index = {"endpoints": []}
        errors += 1
    bundle["debugIndex"] = index
    for ep in index.get("endpoints", []):
        q = ep.get("doctor")
        if q is None:
            continue
        collect(ep["path"] + q, bool(ep.get("json", True)))
    bundle["doctorErrors"] = errors
    return bundle


def cmd_doctor(args) -> int:
    """Snapshot the ENTIRE debug surface of a live node into one JSON
    bundle for offline diagnosis (docs/profiling.md).  With ``--fleet``
    (docs/multiprocess.md), walk the node's ``/debug/processes`` view
    and collect a full sub-bundle from every co-resident serving
    process too — one command captures the whole multi-process box."""
    _apply_skip_verify(args)
    root = _base_uri(args.host)
    bundle = _doctor_node_bundle(root, args.host, args.timeout)
    errors = bundle["doctorErrors"]
    if args.fleet:
        procs = bundle["endpoints"].get("/debug/processes") or {}
        fleet: dict = {}
        rows = procs.get("processes") if isinstance(procs, dict) else None
        for row in rows or []:
            uri = (row or {}).get("uri") or ""
            if not uri or uri.rstrip("/") == root:
                continue
            sub = _doctor_node_bundle(uri.rstrip("/"), uri, args.timeout)
            errors += sub["doctorErrors"]
            fleet[uri] = sub
        bundle["fleet"] = fleet
        bundle["doctorErrors"] = errors
    out = json.dumps(bundle, indent=None if args.compact else 2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
        print(
            f"doctor bundle: {len(bundle['endpoints'])} endpoints, "
            f"{errors} errors -> {args.out}"
        )
    else:
        print(out)
    return 0 if errors == 0 else 1


def cmd_config(args) -> int:
    from pilosa_tpu_torch.utils.config import config_template, dump_config, load_config

    if args.generate:
        print(config_template(), end="")
    else:
        print(dump_config(load_config(args.config)), end="")
    return 0


def cmd_generate_config(args) -> int:
    """Alias for `config --generate` (reference has both spellings)."""
    args.config = None
    args.generate = True
    return cmd_config(args)


def cmd_check(args) -> int:
    """Validate fragment files are parseable (reference: ctl/check.go)."""
    from pilosa_tpu_torch import roaring

    ok = True
    for path in args.paths:
        try:
            with open(path, "rb") as f:
                data = f.read()
            bm, consumed = roaring.deserialize(data)
            n_ops = roaring.replay_ops(bm, data[consumed:])
            print(f"{path}: OK ({bm.count()} bits, {n_ops} ops replayed)")
        except Exception as e:  # pilosa: allow(broad-except) — the
            # check command's JOB is classifying any failure as CORRUPT
            ok = False
            print(f"{path}: CORRUPT — {e}")
    return 0 if ok else 1


def cmd_inspect(args) -> int:
    """Dump fragment contents (reference: ctl/inspect.go)."""
    from pilosa_tpu_torch import roaring
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    with open(args.path, "rb") as f:
        data = f.read()
    bm, consumed = roaring.deserialize(data)
    roaring.replay_ops(bm, data[consumed:])
    values = bm.values()
    rows = np.unique(values // np.uint64(SHARD_WIDTH))
    print(f"bits: {values.size}  rows: {rows.size}  ops-log bytes: {len(data) - consumed}")
    for r in rows.tolist()[: args.max_rows]:
        count = bm.range_count(r * SHARD_WIDTH, (r + 1) * SHARD_WIDTH)
        print(f"  row {r}: {count} bits")
    return 0


def main(argv: list[str] | None = None) -> int:
    # torch is imported by cmd_server's solo path alone: the client
    # commands and the supervisor's parent never load it, so
    # `python -m pilosa_tpu_torch doctor` answers in milliseconds and
    # the supervisor holds no CUDA context
    p = argparse.ArgumentParser(prog="pilosa-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("server", help="run the server")
    s.add_argument("--bind", default=None)
    s.add_argument("--data-dir", default=None)
    s.add_argument("--config", default=None)
    s.add_argument("--coordinator", action="store_true")
    s.add_argument("--seeds", default=None, help="comma-separated peer URIs")
    s.add_argument("--replica-n", type=int, default=None)
    s.add_argument(
        "--processes",
        type=int,
        default=None,
        metavar="N",
        help="multi-process serving (config serving-processes): run N "
             "shard-owning child servers on --device sharing the public "
             "port via SO_REUSEPORT (docs/multiprocess.md)",
    )
    s.add_argument(
        "--device",
        default="cuda",
        help="where queries run: cuda (the default; the kernels) or cpu "
             "(their plain torch versions)",
    )
    s.add_argument("--tls-certificate", default=None, help="PEM cert; serves HTTPS")
    s.add_argument("--tls-key", default=None, help="PEM private key")
    s.add_argument(
        "--tls-skip-verify",
        action="store_true",
        help="trust self-signed peer certificates",
    )
    s.add_argument(
        "--cpu-profile",
        default=None,
        metavar="FILE",
        help="write a folded-stack sampling profile (flamegraph input) on shutdown",
    )
    s.set_defaults(fn=cmd_server)

    s = sub.add_parser("import", help="CSV/JSONL bulk import")
    s.add_argument("path", help="input file or - for stdin")
    s.add_argument("--host", default="127.0.0.1:10101",
                   help="host:port or https://host:port for TLS servers")
    s.add_argument("--tls-skip-verify", action="store_true",
                   help="trust self-signed server certificates")
    s.add_argument("-i", "--index", required=True)
    s.add_argument("-f", "--field", required=True)
    s.add_argument("--create", action="store_true", help="create index/field first")
    s.add_argument("--values", action="store_true", help="columnID,value rows (int field)")
    s.add_argument("--batch-size", type=int, default=100_000,
                   help="records per POST (default lane) / positions per "
                        "roaring frame (--roaring)")
    s.add_argument("--roaring", action="store_true",
                   help="wire-speed bulk lane: build per-shard roaring "
                        "frames client-side and stream them to "
                        "/import-roaring (docs/ingest.md)")
    s.add_argument("--format", choices=["csv", "jsonl", "ndjson"],
                   default=None,
                   help="input record format for --roaring (default: by "
                        "file extension; stdin defaults to jsonl)")
    s.add_argument("--pipeline", type=int, default=4,
                   help="concurrent in-flight frames for --roaring")
    s.set_defaults(fn=cmd_import)

    s = sub.add_parser("export", help="CSV export")
    s.add_argument("--host", default="127.0.0.1:10101",
                   help="host:port or https://host:port for TLS servers")
    s.add_argument("--tls-skip-verify", action="store_true",
                   help="trust self-signed server certificates")
    s.add_argument("-i", "--index", required=True)
    s.add_argument("-f", "--field", required=True)
    s.set_defaults(fn=cmd_export)

    s = sub.add_parser(
        "explain", help="EXPLAIN / EXPLAIN ANALYZE a PQL query"
    )
    s.add_argument("query", help="PQL query string")
    s.add_argument("--host", default="127.0.0.1:10101",
                   help="host:port or https://host:port for TLS servers")
    s.add_argument("--tls-skip-verify", action="store_true",
                   help="trust self-signed server certificates")
    s.add_argument("-i", "--index", required=True)
    s.add_argument("--shards", default=None, help="comma-separated shard list")
    s.add_argument("--analyze", action="store_true",
                   help="execute too and attach measured actuals")
    s.add_argument("--json", action="store_true", help="raw JSON output")
    s.set_defaults(fn=cmd_explain)

    s = sub.add_parser(
        "replay", help="replay a captured workload against a live server"
    )
    s.add_argument(
        "capture",
        help="JSONL capture file, spill-segment directory, or - for stdin",
    )
    s.add_argument("--host", default="127.0.0.1:10101",
                   help="host:port or https://host:port for TLS servers")
    s.add_argument("--tls-skip-verify", action="store_true",
                   help="trust self-signed server certificates")
    s.add_argument("--speed", type=float, default=1.0,
                   help="scale recorded arrival spacing by N (default 1.0)")
    s.add_argument("--qps", type=float, default=None,
                   help="replay at a fixed rate instead of recorded spacing")
    s.add_argument("--closed-loop", type=int, default=None, metavar="C",
                   help="C back-to-back clients (throughput mode; "
                        "discards spacing)")
    s.add_argument("--workers", type=int, default=8,
                   help="open-loop worker connections (default 8)")
    s.add_argument("--timeout", type=float, default=30.0,
                   help="per-request timeout seconds")
    s.add_argument("--json", action="store_true", help="raw JSON report")
    s.set_defaults(fn=cmd_replay)

    s = sub.add_parser(
        "backup",
        help="back up one index (fragments + translate + schema) to a tar",
    )
    s.add_argument("--host", default="127.0.0.1:10101",
                   help="any cluster member; host:port or https://host:port")
    s.add_argument("--tls-skip-verify", action="store_true",
                   help="trust self-signed server certificates")
    s.add_argument("-i", "--index", required=True)
    s.add_argument("-o", "--out", default=None, metavar="FILE",
                   help="output tar path (default: {index}.backup.tar)")
    s.set_defaults(fn=cmd_backup)

    s = sub.add_parser(
        "restore",
        help="restore a backup tar into a cluster (any topology)",
    )
    s.add_argument("path", help="backup tar written by `backup`")
    s.add_argument("--host", default="127.0.0.1:10101",
                   help="any cluster member; host:port or https://host:port")
    s.add_argument("--tls-skip-verify", action="store_true",
                   help="trust self-signed server certificates")
    s.add_argument("--rename", default=None, metavar="NEW",
                   help="restore under a different index name")
    s.set_defaults(fn=cmd_restore)

    s = sub.add_parser(
        "doctor",
        help="snapshot every debug endpoint of a live node into one "
             "JSON bundle",
    )
    s.add_argument("--host", default="127.0.0.1:10101",
                   help="host:port or https://host:port for TLS servers")
    s.add_argument("--tls-skip-verify", action="store_true",
                   help="trust self-signed server certificates")
    s.add_argument("--out", default=None, metavar="FILE",
                   help="write the bundle here instead of stdout")
    s.add_argument("--fleet", action="store_true",
                   help="multi-process box: also bundle every "
                        "co-resident serving process listed by "
                        "/debug/processes (docs/multiprocess.md)")
    s.add_argument("--timeout", type=float, default=15.0,
                   help="per-endpoint timeout seconds")
    s.add_argument("--compact", action="store_true",
                   help="single-line JSON (default: indented)")
    s.set_defaults(fn=cmd_doctor)

    s = sub.add_parser("config", help="print effective config")
    s.add_argument("--config", default=None)
    s.add_argument("--generate", action="store_true", help="emit a template")
    s.set_defaults(fn=cmd_config)

    s = sub.add_parser(
        "generate-config", help="emit a TOML config template"
    )
    s.set_defaults(fn=cmd_generate_config)

    s = sub.add_parser("check", help="validate fragment files")
    s.add_argument("paths", nargs="+")
    s.set_defaults(fn=cmd_check)

    s = sub.add_parser("inspect", help="dump a fragment file")
    s.add_argument("path")
    s.add_argument("--max-rows", type=int, default=20)
    s.set_defaults(fn=cmd_inspect)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
