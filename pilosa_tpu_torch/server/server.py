"""Server runtime: lifecycle wiring of holder, API, HTTP, background loops.

Reference: pilosa_tpu/server/server.py (after server.go: Server, Open,
anti-entropy ticker, monitorRuntime). ``Server(config, device="cuda")``
answers the reference's HTTP API from the port's executor and kernels on
one torch device; ``device="cpu"`` runs the plain torch versions (the
tests). Single-node by default; seeds or ``coordinator`` in the config
attach the cluster layer (parallel/cluster.py), which swaps in
scatter-gather routers and the /internal/* data-plane routes, each node
answering its legs on its own device. A supervised child (server/
supervisor.py) joins the shared public port after its cluster join and
takes its share of the card's stack budget. A config with
``coordinator_address`` joins the multi-host process group in ``open``
(parallel/multihost.py); the serving mesh stays this process's own.

On a card, a fresh subprocess first proves that CUDA initializes
(``_probe_device``). Until its verdict lands, queries and imports answer
503 + Retry-After; after a failed verdict they keep answering 503 with
the reason, and schema and admin routes serve. Nothing moves the
process to the CPU: the caller chooses the device.
"""

from __future__ import annotations

import json
import os
import threading
import time

import torch

from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.ops import resolve_device
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.http import HTTPServer, ThreadedHTTPServer
from pilosa_tpu_torch.utils.config import Config

# the probe's child: the first CUDA context and one launch on the card
_PROBE_BODY = "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()"
# process-wide probe verdict, (ok, reason): the CUDA context is
# process-global, so one probe answers for every Server of the process
_DEVICE_PROBE: "tuple[bool, str] | None" = None
# mesh-attach failure is process-global too (same error for every
# Server); warn once, not once per server
_MESH_ATTACH_WARNED = False


def _fleet_size(config: Config) -> int:
    """How many serving processes share this process's card: the
    supervisor's state file lists its children (all on one device, the
    parent's ``--device``); 1 for a process that is not supervised or
    whose state file cannot be read."""
    if not config.supervisor_state:
        return 1
    try:
        with open(os.path.expanduser(config.supervisor_state)) as f:
            return max(1, len(json.load(f).get("processes", [])))
    except (OSError, ValueError, AttributeError):
        return 1


class Server:
    def __init__(self, config: Config | None = None, device="cuda"):
        """``device`` is where queries run: ``"cuda"`` (the default;
        raises without a card) or ``"cpu"`` for the plain torch
        versions. There is no config knob for it."""
        self.config = config or Config()
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            # an explicit index: resolving the current device would make
            # the CUDA context in this process before the probe
            dev = torch.device("cuda", 0)
        self.device = resolve_device(dev)
        from pilosa_tpu_torch.utils.stats import make_stats

        self.stats = make_stats(
            self.config.metric_service, self.config.statsd_host
        )
        from pilosa_tpu_torch.utils.log import Logger

        self.logger = Logger(
            os.path.expanduser(self.config.log_path)
            if self.config.log_path
            else None
        )
        # WAL acknowledgement policy (docs/durability.md) is process-
        # global — set it before the holder exists so even open()-time
        # repairs write under the configured mode
        from pilosa_tpu_torch.utils import durable

        durable.set_wal_fsync_mode(self.config.wal_fsync_mode)
        self.holder = Holder(
            os.path.expanduser(self.config.data_dir),
            compaction_workers=self.config.compaction_workers,
            load_workers=self.config.holder_load_workers,
            load_min_fragments=self.config.holder_load_min_fragments,
            stats=self.stats,
        )
        self.cluster = None
        # deterministic fault injection (docs/fault-tolerance.md):
        # always constructed — zero cost unarmed — so the /debug/faults
        # route can arm rules on a live node; the cluster's outgoing
        # client chain consults this same instance
        from pilosa_tpu_torch.parallel.faultinject import FaultInjector, FSFaultInjector

        self.fault_injector = FaultInjector.from_config(self.config)
        # filesystem fault layer (docs/durability.md): installed process-
        # wide in open() ONLY when rules are armed — the durable write
        # protocol consults the hook at every primitive, and the chaos
        # suite needs the faults to land exactly where real disk faults
        # would. Uninstalled in close().
        self.fs_fault_injector = FSFaultInjector.from_config(self.config)
        # first-class device stack budget (docs/device-residency.md):
        # the config knob wins over the PILOSA_TPU_STACK_BUDGET env
        # resolution; 0 leaves auto-resolution in place
        from pilosa_tpu_torch.executor import compile as query_compile

        # unconditional: a 0 (auto) config must CLEAR any override a
        # previous Server in this process installed, or its budget
        # would silently leak into this one's auto-resolution
        query_compile.set_stack_budget(
            self.config.device_stack_budget_bytes or None
        )
        # the N children of a supervised fleet share one card: each
        # default budget is 1/N of the one-process default (a configured
        # budget wins); unconditional for the same reason as above
        query_compile.set_card_share(_fleet_size(self.config))
        # per-call host/device cost router (docs/query-routing.md),
        # seeded from config; the SAME router instance survives the
        # late mesh attach so its calibration carries over
        from pilosa_tpu_torch.executor.router import QueryRouter

        router = QueryRouter(
            mode=self.config.route_mode,
            stats=self.stats,
            dispatch_seed_s=self.config.route_dispatch_ms / 1e3,
            readback_seed_s=self.config.route_readback_ms / 1e3,
            device_wps=self.config.route_device_words_per_s,
            crossover_words=self.config.route_crossover_words,
            mesh_dispatch_seed_s=self.config.route_mesh_dispatch_ms / 1e3,
            mesh_readback_seed_s=self.config.route_mesh_readback_ms / 1e3,
            audit_enabled=self.config.router_audit_enabled,
        )
        # mesh_ctx=None here: MeshContext.auto() counts the cards, which
        # must wait for the probe; open() attaches a mesh AFTER the
        # listener is serving when there are two or more
        self.api = API(
            self.holder,
            device=self.device,
            stats=self.stats,
            mesh_ctx=None,
            max_writes=self.config.max_writes_per_request,
            router=router,
            batch_mode=self.config.batch_mode,
            batch_window_us=self.config.batch_window_us,
            batch_max_queries=self.config.batch_max_queries,
        )
        self.http: HTTPServer | None = None
        self.profiler = None
        self.diagnostics = None
        self._anti_entropy_timer: threading.Timer | None = None
        self._closed = False
        self._mesh_attach_thread: threading.Thread | None = None
        # set when the attach thread has finished (probe verdict and
        # mesh decision landed). Starts UNSET so the gate holds queries
        # from the instant the listener serves — the attach thread is
        # only created later in open(), and a gate keyed on the thread
        # object alone would wave traffic through that window onto an
        # unprobed card.
        self._mesh_ready = threading.Event()
        # (ok, reason) of this server's device: None while the probe
        # runs; True at once on the CPU
        self.device_verdict: "tuple[bool, str] | None" = (
            (True, "cpu: no probe") if self.device.type == "cpu" else None
        )
        self.probe_seconds: float | None = None

    def open(self) -> None:
        """holder load → HTTP up → cluster join → device probe and mesh
        attach (off the thread) → background loops (reference:
        Server.Open). The listener must serve BEFORE the cluster join:
        a peer that probed a bound-but-not-serving node would hang in
        the accept backlog for the full client timeout instead of
        getting an instant connection-refused — concurrent cold starts
        then stack 30s timeouts on each other."""
        if (
            self.config.shared_bind or self.config.fd_pass_socket
        ) and self.config.serving_mode == "threaded":
            # refuse BEFORE any background thread starts: a misconfig
            # raising mid-open would leak profiler/saturation threads
            raise ValueError(
                "multi-process serving (shared-bind / fd-pass-socket) "
                "requires serving-mode = \"event\" — the threaded "
                "listener has no shared-listener support"
            )
        if self.fs_fault_injector.armed:
            # before holder.open(): crash-recovery rehearsals target the
            # load path (snapshot reads, torn-tail truncation) too
            from pilosa_tpu_torch.utils import durable

            durable.install_fs_hook(self.fs_fault_injector)
        self.holder.open()
        # event-driven front end by default (docs/serving.md); the
        # thread-per-request listener stays as a rollback knob and as
        # the latency baseline the event loop is measured against
        server_cls = (
            ThreadedHTTPServer
            if self.config.serving_mode == "threaded"
            else HTTPServer
        )
        self.http = server_cls(
            (self.config.host, self.config.port), self.api, stats=self.stats
        )
        if server_cls is HTTPServer:
            # admission/backpressure knobs (docs/serving.md): these
            # replace the old fixed request_queue_size accept backlog
            self.http.max_connections = self.config.max_connections
            self.http.admission_queue_depth = self.config.admission_queue_depth
            self.http.keepalive_idle_s = self.config.keepalive_idle_s
            self.http.request_read_timeout_s = self.config.request_read_timeout_s
            self.http.worker_threads = self.config.http_worker_threads
            # write-class backpressure tied to compaction debt
            # (docs/durability.md): past the limit, imports get 429 +
            # Retry-After instead of growing ops logs without bound
            self.http.compaction_max_debt = self.config.compaction_max_debt
            self.http.compaction_debt = self.holder.compactor.debt
        if self.config.tls_certificate:
            # serve HTTPS (reference: tls.certificate/tls.key). The context
            # is handed to the listener, which wraps each accepted
            # connection with a deferred handshake — see HTTPServer.
            # get_request for why the listening socket itself must NOT be
            # wrapped (handshake would run on the accept thread).
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(
                os.path.expanduser(self.config.tls_certificate),
                os.path.expanduser(self.config.tls_key) or None,
            )
            self.http.ssl_context = ctx
        self.http.node_id = self.config.node_id
        # config-sized flight recorder (docs/observability.md) replaces
        # the listener's default one; wired to this server's logger so
        # the structured slow-query line lands in the configured sink
        from pilosa_tpu_torch.utils.flightrec import FlightRecorder

        self.http.flightrec = FlightRecorder(
            capacity=self.config.flightrec_entries,
            min_latency_s=self.config.flightrec_min_ms / 1e3,
            stats=self.stats,
            log=self.logger.log,
            enabled=self.config.flightrec_enabled,
        )
        # config-sized workload-intelligence plane (docs/workload.md)
        # replaces the listener's default one: capture ring + durable
        # spill + heavy-hitter sketch + SLO engine. slo-targets parse
        # failures raise HERE, at boot — a typo'd objective discovered
        # when the dashboard stays empty would defeat the point.
        from pilosa_tpu_torch.utils.workload import WorkloadPlane

        self.http.workload = WorkloadPlane(
            enabled=self.config.workload_capture_enabled,
            capacity=self.config.workload_capture_entries,
            sample_rate=self.config.workload_sample_rate,
            top_k=self.config.workload_top_k,
            capture_path=(
                os.path.expanduser(self.config.workload_capture_path)
                if self.config.workload_capture_path
                else None
            ),
            spill_max_bytes=self.config.workload_spill_max_bytes,
            spill_max_age_s=self.config.workload_spill_max_age_s,
            spill_segments=self.config.workload_spill_segments,
            slo_targets=self.config.slo_targets,
            stats=self.stats,
            log=self.logger.log,
        )
        # config-sized result cache (docs/result-cache.md) replaces the
        # listener's default one; the cache's per-entry byte cap feeds
        # the workload plane's cachability estimator so repeats of
        # never-admittable giant results stop counting as servable
        from pilosa_tpu_torch.utils.resultcache import ResultCache

        self.http.result_cache = ResultCache(
            max_bytes=self.config.result_cache_bytes,
            min_cost_ms=self.config.result_cache_min_cost_ms,
            mode=self.config.result_cache_mode,
            stats=self.stats,
        )
        self.api.result_cache = self.http.result_cache
        self.http.workload.cache_byte_cap = (
            self.http.result_cache.entry_byte_cap
        )
        # continuous profiling + saturation plane (docs/profiling.md):
        # the config-sized sampler replaces the listener's None slot and
        # STARTS here — a flame graph of the last minute is one curl
        # away for the life of the process; the saturation monitor gets
        # the module-level metrics sink (hot locks are constructed deep
        # inside core/executor where no client is in scope) and its GIL
        # probe thread
        from pilosa_tpu_torch.utils import saturation
        from pilosa_tpu_torch.utils.profiler import SamplingProfiler

        saturation.set_stats(self.stats)
        self.profiler = SamplingProfiler(
            hz=self.config.profiler_hz,
            segment_s=self.config.profiler_segment_s,
            segments=self.config.profiler_segments,
            stats=self.stats,
            enabled=self.config.profiler_enabled,
        )
        self.profiler.start()
        self.http.profiler = self.profiler
        self.http.saturation = saturation.SaturationMonitor(
            stats=self.stats,
            enabled=self.config.saturation_probes_enabled,
        )
        self.http.saturation.start()
        if self.config.access_log_format not in ("", "json"):
            raise ValueError(
                "access-log-format must be \"\" or \"json\", got "
                f"{self.config.access_log_format!r}"
            )
        self.http.access_log_json = self.config.access_log_format == "json"
        self.http.long_query_time = self.config.long_query_time
        self.http.query_timeout_ms = self.config.query_timeout_ms
        self.http.fault_injector = self.fault_injector
        self.http.fs_fault_injector = self.fs_fault_injector
        self.http.log = self.logger.log
        self.http.gate = self._query_gate
        self.http.gate_reason = self._gate_reason
        # multi-process fleet state (docs/multiprocess.md): a supervised
        # child reads the supervisor's state file to serve the stitched
        # GET /debug/processes view
        self.http.supervisor_state_path = (
            os.path.expanduser(self.config.supervisor_state)
            if self.config.supervisor_state
            else None
        )
        if self.config.seeds or self.config.coordinator:
            from pilosa_tpu_torch.parallel.cluster import Cluster

            self.cluster = Cluster(self)
            self.api.cluster = self.cluster
            # routes/routers must be live before the first request or a
            # client could be silently served local-only (and peers 404)
            self.cluster.attach()
        self.http.serve_background()
        if self.config.coordinator_address:
            # join the static process group once the listener serves
            # (peers' health probes succeed while this waits for the
            # group), before the device bring-up (the reference's
            # server.py:293-303)
            from pilosa_tpu_torch.parallel import multihost

            multihost.init_distributed(
                self.config.coordinator_address,
                self.config.num_processes or None,
                self.config.process_id if self.config.process_id >= 0 else None,
            )
        # Device bring-up OFF-THREAD, even with the mesh disabled (the
        # probe protects EVERY first CUDA call, not just the mesh
        # attach): boot must not depend on the card. Schema, admin and
        # control-plane routes serve at once; queries and imports wait
        # at the gate for the verdict. attach_mesh rebinds whole
        # objects, so in-flight queries see either the old or the new
        # executor.
        t = threading.Thread(
            target=self._attach_mesh_when_ready, daemon=True,
            name="mesh-attach",
        )
        t.start()
        self._mesh_attach_thread = t
        if self.cluster is not None:
            # the join waits for the cluster, not for the card: a node's
            # queries answer 503 until its own verdict lands, and its
            # peers fail those legs over meanwhile (parallel/cluster.py)
            self.cluster.join()
        # multi-process serving (docs/multiprocess.md): join the shared
        # public port only NOW — after the cluster join has completed —
        # so the kernel (reuseport) or the parent (fd-pass) never routes
        # a public connection to a child that cannot serve its shard
        # subset yet (readiness gating before the port is announced)
        if self.config.shared_bind:
            host, _, port = self.config.shared_bind.rpartition(":")
            self.http.add_shared_listener(host, int(port))
            self.logger.log(
                "shared public listener bound via SO_REUSEPORT on "
                f"{self.config.shared_bind}"
            )
        if self.config.fd_pass_socket:
            self.http.add_fd_listener(
                os.path.expanduser(self.config.fd_pass_socket)
            )
            self.logger.log(
                "adopting accept-and-pass connections from "
                f"{self.config.fd_pass_socket}"
            )
        self._schedule_anti_entropy()
        from pilosa_tpu_torch.server.diagnostics import DiagnosticsCollector

        self.diagnostics = DiagnosticsCollector(self)
        self.api.diagnostics = self.diagnostics
        self.diagnostics.open()

    @staticmethod
    def _probe_device(timeout_s: float, ttl_s: float = 0.0) -> "tuple[bool, str]":
        """Prove that CUDA initializes and launches, in a FRESH
        subprocess: a card that hangs at its first call must hang the
        child, never this process. → (ok, reason). The verdict is cached
        process-wide (the CUDA context is process-global), and a
        NEGATIVE one persists for ``ttl_s`` in the port's own probe
        cache file (utils/probecache.py), so a known-bad card does not
        cost a fresh timeout on every boot; a positive verdict is never
        trusted across boots."""
        global _DEVICE_PROBE
        if _DEVICE_PROBE is not None:
            return _DEVICE_PROBE
        import subprocess
        import sys

        from pilosa_tpu_torch.utils import probecache

        cached = probecache.load(ttl_s, "cuda")
        if cached is not None and not cached["ok"]:
            _DEVICE_PROBE = (False, "a failed CUDA probe within device-probe-ttl (probe cache)")
            return _DEVICE_PROBE
        try:
            proc = subprocess.run(
                [sys.executable, "-c", _PROBE_BODY],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE,
                timeout=timeout_s,
            )
            if proc.returncode == 0:
                _DEVICE_PROBE = (True, "cuda probe passed")
            else:
                tail = proc.stderr.decode(errors="replace").strip().splitlines()[-1:] or [""]
                _DEVICE_PROBE = (False, f"CUDA probe exited {proc.returncode}: {tail[0][:200]}")
        except subprocess.TimeoutExpired:
            _DEVICE_PROBE = (False, f"CUDA did not initialize within {timeout_s:.0f}s")
        except Exception as e:  # noqa: BLE001 — fork failure, ...: the card is unproven
            _DEVICE_PROBE = (False, f"CUDA probe failed to run: {e}")
        probecache.store(_DEVICE_PROBE[0], "cuda")
        return _DEVICE_PROBE

    def _attach_mesh_when_ready(self) -> None:
        try:
            self._attach_mesh_inner()
        finally:
            if self.device_verdict is None:
                self.device_verdict = (False, "device probe did not finish")
            self._mesh_ready.set()  # verdict landed

    def _attach_mesh_inner(self) -> None:
        if self.device.type == "cuda":
            timeout_s = self.config.device_init_timeout
            t0 = time.monotonic()
            verdict = (
                self._probe_device(timeout_s, self.config.device_probe_ttl)
                if timeout_s > 0
                else (True, "probe disabled (device-init-timeout = 0)")
            )
            self.probe_seconds = time.monotonic() - t0
            self.device_verdict = verdict
            if not verdict[0]:
                # loud, and no CPU fallback: queries and imports answer
                # 503 with this reason until a restart
                self.logger.log(f"{self.device} failed its probe ({verdict[1]}): queries and imports answer 503")
                return
        if not self.config.mesh_enabled or self.device.type != "cuda":
            return
        try:
            ctx = self._make_mesh_context()
        except Exception as e:  # noqa: BLE001 — serve on the one card
            global _MESH_ATTACH_WARNED
            if not _MESH_ATTACH_WARNED:
                _MESH_ATTACH_WARNED = True
                self.logger.log(f"mesh attach failed (serving on {self.device}): {e}")
            return
        # MeshContext.auto() is None with one card: serve on it
        if ctx is not None and not self._closed:
            self.api.attach_mesh(ctx)

    def _query_gate(self, wait: bool = True) -> bool:
        """Hold query/import dispatch off the card until the probe
        verdict lands, and for good after a failed one: a query during
        the probe window would make the process's first CUDA call, the
        hang the probe exists to keep out of this process. Keyed on
        the ``_mesh_ready`` event (set when the attach thread finishes),
        which is unset from construction — so the gate also covers the
        open() window where the listener already serves but the attach
        thread hasn't been created yet. With ``wait``, blocks up to
        ``query_gate_wait`` for the verdict; past that the HTTP layer
        serves 503 + Retry-After with ``_gate_reason``.
        ``queries_gated`` counts every request turned away or held."""
        if self._mesh_ready.is_set() and self.device_verdict[0]:
            return True
        self.stats.count("queries_gated")
        if not wait or not self._mesh_ready.wait(self.config.query_gate_wait):
            return False
        return self.device_verdict[0]

    def _gate_reason(self) -> str:
        verdict = self.device_verdict
        if verdict is None:
            return "device probe in progress; retry"
        return f"{self.device} failed its probe: {verdict[1]} (queries and imports answer 503 until a restart)"

    def wait_mesh(self, timeout: float | None = None) -> bool:
        """Block until the off-thread mesh attach finishes (tests and
        scripted drivers that assert on sharded execution right after
        open). True when the attach thread is done (attached or failed);
        False on timeout. No-op truth when mesh was disabled."""
        t = self._mesh_attach_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def _make_mesh_context(self):
        """Serving mesh over this process's cards: None with one card
        (parallel/mesh.py ``MeshContext.auto``), so one H100 serves on
        ``cuda:0``. Local even in a multi-host group: a program over a
        mesh that spans processes is a collective every rank must enter,
        and an HTTP query reaches one node only, so a global serving mesh
        would hang the first query; queries across hosts scatter-gather
        through the cluster layer (parallel/cluster.py), each node
        reducing on its own device."""
        from pilosa_tpu_torch.parallel.mesh import MeshContext

        return MeshContext.auto(words_axis=self.config.mesh_words_axis)

    def _schedule_anti_entropy(self) -> None:
        interval = self.config.anti_entropy_interval
        if interval <= 0 or self._closed:
            return

        def tick():
            try:
                if self.cluster is not None:
                    self.cluster.sync_holder()
            finally:
                self._schedule_anti_entropy()

        self._anti_entropy_timer = threading.Timer(interval, tick)
        self._anti_entropy_timer.daemon = True
        self._anti_entropy_timer.name = "anti-entropy"
        self._anti_entropy_timer.start()

    @property
    def port(self) -> int:
        """Actual bound port (useful when config requested :0)."""
        return self.http.server_address[1] if self.http else self.config.port

    @property
    def uri(self) -> str:
        return f"{self.config.scheme}://{self.config.host}:{self.port}"

    def close(self) -> None:
        self._closed = True
        # reap the attach thread (bounded — a wedged probe must not hang
        # shutdown): a daemon thread logging after close would otherwise
        # interleave with the embedding process's own output
        t = self._mesh_attach_thread
        if t is not None:
            t.join(timeout=10.0)
        if self.diagnostics is not None:
            self.diagnostics.close()
        if self._anti_entropy_timer is not None:
            self._anti_entropy_timer.cancel()
        if self.cluster is not None:
            self.cluster.close()
        self.api.scheduler.close()
        if self.profiler is not None:
            self.profiler.stop()
        if self.http is not None:
            self.http.saturation.stop()
            # flush the open workload spill segment before the listener
            # dies — a capture cut off mid-segment replays short
            self.http.workload.close()
            self.http.shutdown()
            self.http.server_close()
        self.stats.close()
        self.holder.close()
        if self.fs_fault_injector.armed:
            from pilosa_tpu_torch.utils import durable

            durable.install_fs_hook(None)
        self.logger.close()
