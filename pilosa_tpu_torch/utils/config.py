"""Configuration: TOML file + PILOSA_TPU_* env vars + CLI flags.

Reference: server/config.go (three-layer TOML + PILOSA_* env + pflags;
`pilosa config` prints the effective config, generate-config emits a
template). Same precedence: flags > env > file > defaults.
"""

from __future__ import annotations

import os

try:
    import tomllib
except ImportError:  # Python < 3.11: the stdlib module's PyPI ancestor
    import tomli as tomllib
from dataclasses import dataclass, field, fields


@dataclass
class Config:
    bind: str = "127.0.0.1:10101"
    data_dir: str = "~/.pilosa_tpu"
    # cluster
    name: str = ""  # node id; derived from bind when empty
    coordinator: bool = False
    seeds: list[str] = field(default_factory=list)  # peer URIs
    replica_n: int = 1
    # background loops
    anti_entropy_interval: float = 600.0  # seconds; 0 disables
    heartbeat_interval: float = 2.0  # peer liveness probe period
    diagnostics_interval: float = 3600.0  # snapshot period; 0 disables
    # serving front end (docs/serving.md): "event" = the asyncio
    # accept/read/write loop with keep-alive multiplexing and bounded
    # admission, the only one the port serves (the reference's
    # "threaded" listener is refused)
    serving_mode: str = "event"
    # open-connection cap for the event front end (0 = unlimited);
    # connections past it get 503 + Retry-After at accept
    max_connections: int = 0
    # bounded admission wait queue PER CLASS (query/write/control); a
    # request arriving with the class queue full gets 429 + Retry-After
    # instead of parking (0 = unbounded — not recommended)
    admission_queue_depth: int = 256
    # seconds an idle keep-alive connection is held before the server
    # closes it (0 = never reap)
    keepalive_idle_s: float = 75.0
    # seconds a client gets to deliver a request head or body once it
    # starts one — the slowloris cut (0 disables; also the TLS
    # handshake timeout on the event front end)
    request_read_timeout_s: float = 10.0
    # query-class worker threads for the event front end (execution
    # stays on a bounded pool; the event loop only owns I/O and
    # admission). 0 = auto: max(32, min(64, 4x cores)) — sized to wave
    # occupancy, not cores: query workers park as wave followers or in
    # GIL-released device calls. The write class gets half, control a
    # quarter (min 4).
    http_worker_threads: int = 0
    # limits
    max_writes_per_request: int = 5000
    long_query_time: float = 0.0  # seconds; log slower queries (0 = off)
    log_path: str = ""  # append server log lines to a file ("" = stderr)
    # device mesh (serving-path SPMD over all local devices)
    mesh_enabled: bool = True
    mesh_words_axis: int = 1  # >1 splits the packed word dim across devices
    # seconds to wait for the card to prove healthy (a fresh-subprocess
    # CUDA probe) before queries and imports are let through; past it,
    # or on a failed probe, they answer 503 with the reason until a
    # restart. 0 disables the probe (trust the card to come up).
    device_init_timeout: float = 300.0
    # seconds a query/import arriving DURING the device probe window
    # waits for the verdict before being served 503 + Retry-After (the
    # probe gate keeps the first CUDA call off an unproven card; see
    # Server._query_gate). 0 = never wait, 503 immediately while probing.
    query_gate_wait: float = 60.0
    # multi-host process group (the reference's jax.distributed group).
    # Not ported (ROADMAP.md A13b-2): the port's Server refuses a config
    # that sets coordinator_address, as it refuses seeds and coordinator
    # (the cluster, ROADMAP.md A10).
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    # query routing (docs/query-routing.md): per-call host/device
    # routing by a calibrated cost model. "auto" compares estimated work
    # against the online crossover; "host"/"device"/"mesh" pin every
    # read to one engine.
    route_mode: str = "auto"  # auto | host | device
    # device stack budget in bytes — the aggregate cap on resident query
    # stacks (dense stacks + hot-row slots + tiered container stores;
    # docs/device-residency.md). 0 = auto: the legacy
    # PILOSA_TPU_STACK_BUDGET env override if set, else 70% of the
    # device's reported HBM limit, else 2 GiB.
    device_stack_budget_bytes: int = 0
    # >0 pins the crossover (words of packed-bitmap work below which a
    # read runs on the host); 0 derives it from the calibrated model
    route_crossover_words: float = 0.0
    # cost-model seeds, refined online by EWMAs over measured calls
    route_dispatch_ms: float = 1.0  # device dispatch overhead seed
    route_readback_ms: float = 2.0  # device→host readback latency seed
    route_device_words_per_s: float = 25e9  # device scan roofline
    # mesh (explicit-SPMD) route seeds — the third router path
    # (docs/spmd.md): shard_map dispatch overhead and collective-readback
    # latency, refined online like the device seeds; the scan term
    # divides by the attached mesh's device count
    route_mesh_dispatch_ms: float = 2.0
    route_mesh_readback_ms: float = 2.0
    # seconds a persisted device-probe verdict stays valid: within the
    # TTL the next boot (or bench run) reuses it instead of paying the
    # full device-init-timeout probe against a card known to fail
    device_probe_ttl: float = 900.0
    # cross-query wave coalescing (docs/query-batching.md): concurrent
    # sync device-routed queries share one dispatch+readback wave.
    # "adaptive" opens a straggler window only under observed
    # concurrency; "always" waits the full window per wave; "off"
    # restores the one-wave-per-request path.
    batch_mode: str = "adaptive"  # off | adaptive | always
    # microseconds the wave leader holds the wave open for stragglers
    # (the adaptive mode additionally caps this at half the readback-RTT
    # EWMA, so a local device never waits longer than its RTT is worth)
    batch_window_us: float = 250.0
    # queries per wave before an immediate flush
    batch_max_queries: int = 64
    # fault tolerance (docs/fault-tolerance.md)
    # per-query time budget in milliseconds (0 = unlimited): propagated
    # across fan-out hops via X-Pilosa-Deadline-Ms with the REMAINING
    # budget, bounding socket timeouts, retries, and wave waits;
    # exhaustion returns HTTP 504
    query_timeout_ms: float = 0.0
    # extra attempts (after the first) for idempotent node→node RPCs —
    # reads, status probes, anti-entropy pulls; never writes/imports.
    # 0 disables retries.
    rpc_retries: int = 2
    # capped exponential backoff with full jitter between retries:
    # delay ~ U(0, min(cap, base * 2^attempt))
    rpc_backoff_base_ms: float = 20.0
    rpc_backoff_cap_ms: float = 500.0
    # per-peer circuit breaker: after `threshold` consecutive RPC
    # failures the peer fast-fails (one BreakerOpenError instead of a
    # data-plane timeout per query) until a `cooldown` half-open probe
    # or a successful heartbeat closes it
    breaker_enabled: bool = True
    breaker_failure_threshold: int = 3
    breaker_cooldown_ms: float = 5000.0
    # deterministic fault injection (chaos rehearsal): a JSON list of
    # rules applied to this node's OUTGOING data-plane RPCs, seeded for
    # reproducibility; also settable at runtime via /debug/faults
    fault_rules: str = ""
    fault_seed: int = 0
    # filesystem fault injection (docs/durability.md): a JSON list of
    # rules applied to the durable write protocol's primitives (ops-log
    # appends, snapshot writes, fsyncs, renames, dir-fsyncs), seeded by
    # the shared fault-seed; drives the disk-fault chaos suite
    fs_fault_rules: str = ""
    # movement admission lane (docs/resize.md): bulk data movement —
    # rebalance pulls, anti-entropy handoff pushes, restore adopts —
    # holds one of this many concurrent transfer slots, so a resize
    # can't monopolize the node's threads or the peer's import lane
    movement_max_concurrent: int = 4
    # aggregate movement byte-rate ceiling in megabits/second (token
    # bucket with 1 s of burst); 0 = line rate. Lets an operator drain
    # a node without starving serving traffic of bandwidth.
    movement_max_mbit: float = 0.0
    # durability (docs/durability.md): when an ops-log append becomes
    # durable relative to the write acknowledgement. "always" fsyncs
    # inside every append; "batch" group-fsyncs all dirty WAL files once
    # at the request's acknowledgement barrier (the default — group
    # commit); "off" never fsyncs (page-cache-only, acknowledged writes
    # can die with the OS)
    wal_fsync_mode: str = "batch"
    # background ops-log→snapshot compaction worker threads per holder
    compaction_workers: int = 1
    # queued+in-flight compactions past which the event front end's
    # write lane answers 429 + Retry-After instead of growing the
    # ops logs (and crash-replay time) without bound; 0 = no limit
    compaction_max_debt: int = 64
    # concurrent fragment opens (snapshot deserialize + ops-log replay)
    # during Holder.open — restart-to-serving is bounded by the slowest
    # fragment, not the sum; <=1 loads serially. Device upload stays
    # lazy (first query per stack) either way.
    holder_load_workers: int = 8
    # fragment-count floor below which Holder.open loads serially even
    # with workers configured: at small counts pool spin-up costs more
    # than it overlaps (BENCH_INGEST_r08: parallel 0.159s vs serial
    # 0.066s over 12 fragments). 0 always parallelizes.
    holder_load_min_fragments: int = 32
    # flight recorder (docs/observability.md): always-on tail-based
    # retention of slow/errored query evidence, served by GET
    # /debug/flightrec. Disabling it removes the retention decision from
    # the settle path entirely (the bench's instrumented-off baseline).
    flightrec_enabled: bool = True
    # ring-buffer capacity: retained entries past it evict oldest-first
    flightrec_entries: int = 256
    # floor under the rolling p95 retention threshold, in milliseconds —
    # a uniformly fast call type must not retain its own p95 noise
    flightrec_min_ms: float = 25.0
    # continuous profiling plane (docs/profiling.md): a background
    # sampler over sys._current_frames() aggregates folded stacks into
    # a ring of rotating time segments so GET /debug/profile serves a
    # flame graph of the recent past instantly. Disabling removes the
    # sampler thread entirely (the bench's profiler-off baseline).
    profiler_enabled: bool = True
    # samples per second; the overhead gate (make bench-profile) holds
    # at the default — raise for finer stacks on a box with headroom
    profiler_hz: float = 20.0
    # seconds per ring segment, and retained segments: history depth is
    # segment-s × segments (defaults: 16 minutes)
    profiler_segment_s: float = 60.0
    profiler_segments: int = 16
    # saturation probes (docs/profiling.md): the event-loop lag probe,
    # worker-utilization sampling, and the GIL-contention estimator
    # thread behind GET /debug/saturation. Lock-contention counting is
    # structural (the shim costs one nonblocking attempt) and stays on
    # regardless.
    saturation_probes_enabled: bool = True
    # settle-time router-decision audit (docs/query-routing.md):
    # router_misroute_total / router_estimate_error_ratio and the
    # /debug/vars routerAudit drift section; disable for the bench's
    # instrumented-off baseline
    router_audit_enabled: bool = True
    # workload intelligence plane (docs/workload.md): always-on
    # continuous capture of every settled public query (fingerprint,
    # latency, route, status) feeding the heavy-hitter sketch, the
    # cachability estimate, and GET /debug/workload. Disabling removes
    # the plane from the settle path entirely (the bench's capture-off
    # baseline).
    workload_capture_enabled: bool = True
    # in-memory capture ring capacity (records; oldest evict first)
    workload_capture_entries: int = 4096
    # fraction of settled queries recorded into the ring/spill
    # (deterministic every-Nth sampling; the sketch and SLO engine
    # observe every query regardless)
    workload_sample_rate: float = 1.0
    # heavy-hitter sketch size: distinct fingerprints tracked with full
    # per-fingerprint stats (SpaceSaving top-K)
    workload_top_k: int = 64
    # directory for durable capture spill ("" = in-memory ring only):
    # sampled records accumulate into size/age-bounded JSONL segments
    # replayable by `pilosa_tpu replay`
    workload_capture_path: str = ""
    # spill segment bounds: a segment is cut when its buffered records
    # exceed this many bytes or this age in seconds, whichever first
    # (both evaluated as records arrive — an idle server's buffered
    # tail flushes at shutdown; capture is best-effort by design)
    workload_spill_max_bytes: int = 4_000_000
    workload_spill_max_age_s: float = 60.0
    # spill segments retained on disk (oldest deleted past the cap)
    workload_spill_segments: int = 8
    # mutation-stamped cross-request result cache (docs/result-cache.md):
    # byte budget for retained settled results (0 disables the cache —
    # equivalent to result-cache-mode = "off")
    result_cache_bytes: int = 64_000_000
    # admission threshold: results whose measured execution cost is
    # below this are not cached (the 0.2ms Count is cheaper to recompute
    # than to ledger)
    result_cache_min_cost_ms: float = 1.0
    # "on" serves repeated reads from settled results; "off" makes the
    # cache fully inert (the bench's cache-off baseline)
    result_cache_mode: str = "on"
    # SLO objectives (docs/workload.md grammar), comma/semicolon-
    # separated: "<call>:p95<50ms:99.9" (99.9% of <call> queries settle
    # OK within 50ms) or "<call>:errors:99.9" (availability only);
    # "*" matches any call type. "" disables the SLO engine.
    slo_targets: str = ""
    # structured access log: "json" emits one JSON line per request
    # (method, route, status, latency, bytes, trace id, fingerprint)
    # to the server log sink; "" disables (the default)
    access_log_format: str = ""
    # multi-process serving (docs/multiprocess.md): the reference's
    # supervisor of N child servers sharing the public port, and its
    # plumbing into each child. The port serves in one process until
    # the supervisor is ported (ROADMAP.md A10): Server refuses
    # serving_processes != 1 and any of the three paths below.
    serving_processes: int = 1
    # an extra public host:port a child binds with SO_REUSEPORT
    shared_bind: str = ""
    # unix socket where an accept-and-pass parent delivers connections
    fd_pass_socket: str = ""
    # the supervisor's fleet-state JSON
    supervisor_state: str = ""
    # metrics
    metric_service: str = "prometheus"  # prometheus | statsd | none
    statsd_host: str = ""  # host:port for metric_service = "statsd"
    # TLS (reference: server/config.go tls.certificate / tls.key /
    # tls.skip-verify). Setting certificate+key serves HTTPS; skip_verify
    # disables peer-certificate verification on the internal client (for
    # self-signed deployments, as upstream).
    tls_certificate: str = ""
    tls_key: str = ""
    tls_skip_verify: bool = False

    @property
    def host(self) -> str:
        return self.bind.split(":")[0]

    @property
    def port(self) -> int:
        return int(self.bind.split(":")[1])

    @property
    def scheme(self) -> str:
        return "https" if self.tls_certificate else "http"

    @property
    def uri(self) -> str:
        return f"{self.scheme}://{self.bind}"

    @property
    def node_id(self) -> str:
        return self.name or self.bind


_ENV_PREFIX = "PILOSA_TPU_"


def _coerce(value: str, default):
    """Coerce an env string to the type of the field's default value."""
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, list):
        return [s for s in value.split(",") if s]
    return value


def load_config(
    path: str | None = None, env: dict | None = None, overrides: dict | None = None
) -> Config:
    """defaults ← TOML file ← env ← explicit overrides (CLI flags)."""
    cfg = Config()
    if path:
        with open(path, "rb") as f:
            data = tomllib.load(f)
        for f_def in fields(Config):
            key = f_def.name.replace("_", "-")
            if key in data:
                setattr(cfg, f_def.name, data[key])
            elif f_def.name in data:
                setattr(cfg, f_def.name, data[f_def.name])
    env = env if env is not None else os.environ
    defaults = Config()
    for f_def in fields(Config):
        env_key = _ENV_PREFIX + f_def.name.upper()
        if env_key in env:
            setattr(
                cfg,
                f_def.name,
                _coerce(env[env_key], getattr(defaults, f_def.name)),
            )
    for k, v in (overrides or {}).items():
        if v is not None:
            setattr(cfg, k, v)
    return cfg


def config_template() -> str:
    """TOML template (reference: `pilosa generate-config`)."""
    return (
        'bind = "127.0.0.1:10101"\n'
        'data-dir = "~/.pilosa_tpu"\n'
        'name = ""\n'
        "coordinator = false\n"
        "seeds = []\n"
        "replica-n = 1\n"
        "anti-entropy-interval = 600.0\n"
        "heartbeat-interval = 2.0\n"
        "diagnostics-interval = 3600.0\n"
        'serving-mode = "event"\n'
        "max-connections = 0\n"
        "admission-queue-depth = 256\n"
        "keepalive-idle-s = 75.0\n"
        "request-read-timeout-s = 10.0\n"
        "http-worker-threads = 0\n"
        "max-writes-per-request = 5000\n"
        "long-query-time = 0.0\n"
        'log-path = ""\n'
        "mesh-enabled = true\n"
        "mesh-words-axis = 1\n"
        "device-init-timeout = 300.0\n"
        "query-gate-wait = 60.0\n"
        'coordinator-address = ""\n'
        "num-processes = 0\n"
        "process-id = -1\n"
        'route-mode = "auto"\n'
        "device-stack-budget-bytes = 0\n"
        "route-crossover-words = 0.0\n"
        "route-dispatch-ms = 1.0\n"
        "route-readback-ms = 2.0\n"
        "route-device-words-per-s = 25e9\n"
        "route-mesh-dispatch-ms = 2.0\n"
        "route-mesh-readback-ms = 2.0\n"
        "device-probe-ttl = 900.0\n"
        'batch-mode = "adaptive"\n'
        "batch-window-us = 250.0\n"
        "batch-max-queries = 64\n"
        "query-timeout-ms = 0.0\n"
        "rpc-retries = 2\n"
        "rpc-backoff-base-ms = 20.0\n"
        "rpc-backoff-cap-ms = 500.0\n"
        "breaker-enabled = true\n"
        "breaker-failure-threshold = 3\n"
        "breaker-cooldown-ms = 5000.0\n"
        'fault-rules = ""\n'
        "fault-seed = 0\n"
        'fs-fault-rules = ""\n'
        "movement-max-concurrent = 4\n"
        "movement-max-mbit = 0.0\n"
        'wal-fsync-mode = "batch"\n'
        "compaction-workers = 1\n"
        "compaction-max-debt = 64\n"
        "holder-load-workers = 8\n"
        "holder-load-min-fragments = 32\n"
        "flightrec-enabled = true\n"
        "flightrec-entries = 256\n"
        "flightrec-min-ms = 25.0\n"
        "profiler-enabled = true\n"
        "profiler-hz = 20.0\n"
        "profiler-segment-s = 60.0\n"
        "profiler-segments = 16\n"
        "saturation-probes-enabled = true\n"
        "router-audit-enabled = true\n"
        "workload-capture-enabled = true\n"
        "workload-capture-entries = 4096\n"
        "workload-sample-rate = 1.0\n"
        "workload-top-k = 64\n"
        'workload-capture-path = ""\n'
        "workload-spill-max-bytes = 4000000\n"
        "workload-spill-max-age-s = 60.0\n"
        "workload-spill-segments = 8\n"
        "result-cache-bytes = 64000000\n"
        "result-cache-min-cost-ms = 1.0\n"
        'result-cache-mode = "on"\n'
        'slo-targets = ""\n'
        'access-log-format = ""\n'
        "serving-processes = 1\n"
        'shared-bind = ""\n'
        'fd-pass-socket = ""\n'
        'supervisor-state = ""\n'
        'metric-service = "prometheus"\n'
        'statsd-host = ""\n'
        'tls-certificate = ""\n'
        'tls-key = ""\n'
        "tls-skip-verify = false\n"
    )


def dump_config(cfg: Config) -> str:
    out = []
    for f_def in fields(Config):
        v = getattr(cfg, f_def.name)
        key = f_def.name.replace("_", "-")
        if isinstance(v, str):
            out.append(f'{key} = "{v}"')
        elif isinstance(v, bool):
            out.append(f"{key} = {str(v).lower()}")
        elif isinstance(v, list):
            out.append(f"{key} = {v!r}")
        else:
            out.append(f"{key} = {v}")
    return "\n".join(out) + "\n"
