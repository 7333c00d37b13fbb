"""HTTP transport: the reference's route surface over the API façade.

Reference: http/handler.go (gorilla/mux routes). JSON is the primary wire
format with ``application/x-protobuf`` content negotiation on the query
and import routes (reference parity; see encoding/); routes and payload
field names match the reference so existing clients port over:

    POST   /index/{index}/query?shards=0,2
    POST   /index/{index}                    DELETE /index/{index}
    GET    /index/{index}
    POST   /index/{index}/field/{field}      DELETE /index/{index}/field/{field}
    POST   /index/{index}/field/{field}/import
    POST   /index/{index}/field/{field}/import-value
    POST   /index/{index}/field/{field}/import-roaring/{shard}
    GET    /schema        POST /schema
    GET    /status  /info  /version  /metrics  /debug/vars  /debug/traces
    GET    /export?index=i&field=f
    GET    /index/{index}/field/{field}/fragment/data?shard=N[&format=pilosa|official]
    GET    /internal/fragment/nodes?index=i&shard=3
    POST   /internal/translate/keys     (JSON or protobuf TranslateKeysRequest)
    (further /internal/* data-plane routes live in the cluster layer)
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
import time
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

from pilosa_tpu_torch import __version__, encoding
from pilosa_tpu_torch.executor import ExecutionError
from pilosa_tpu_torch.parallel import resilience
from pilosa_tpu_torch.parallel.resilience import DeadlineExceededError
from pilosa_tpu_torch.parallel.topology import ShardUnavailableError
from pilosa_tpu_torch.server.api import RequestTooLargeError
from pilosa_tpu_torch.pql import PQLError
from pilosa_tpu_torch.utils import GLOBAL_TRACER, StatsClient
from pilosa_tpu_torch.utils import tracing

_ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("POST", re.compile(r"^/index/([^/]+)/query$"), "query"),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)/import$"), "import_bits"),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)/import-value$"), "import_values"),
    (
        "POST",
        re.compile(r"^/index/([^/]+)/field/([^/]+)/import-roaring/(\d+)$"),
        "import_roaring",
    ),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)$"), "create_field"),
    ("DELETE", re.compile(r"^/index/([^/]+)/field/([^/]+)$"), "delete_field"),
    ("POST", re.compile(r"^/index/([^/]+)$"), "create_index"),
    ("DELETE", re.compile(r"^/index/([^/]+)$"), "delete_index"),
    ("GET", re.compile(r"^/index/([^/]+)$"), "get_index"),
    ("GET", re.compile(r"^/$"), "console"),
    ("GET", re.compile(r"^/schema$"), "get_schema"),
    ("POST", re.compile(r"^/schema$"), "post_schema"),
    ("GET", re.compile(r"^/status$"), "status"),
    ("GET", re.compile(r"^/info$"), "info"),
    ("GET", re.compile(r"^/version$"), "version"),
    ("GET", re.compile(r"^/metrics$"), "metrics"),
    ("GET", re.compile(r"^/debug/?$"), "debug_index"),
    ("GET", re.compile(r"^/debug/vars$"), "debug_vars"),
    ("GET", re.compile(r"^/debug/profile$"), "debug_profile"),
    ("GET", re.compile(r"^/debug/saturation$"), "debug_saturation"),
    ("GET", re.compile(r"^/debug/processes$"), "debug_processes"),
    ("GET", re.compile(r"^/debug/cluster$"), "debug_cluster"),
    ("GET", re.compile(r"^/debug/resources$"), "debug_resources"),
    ("GET", re.compile(r"^/debug/traces$"), "debug_traces"),
    ("GET", re.compile(r"^/debug/flightrec$"), "debug_flightrec"),
    ("GET", re.compile(r"^/debug/workload$"), "debug_workload"),
    ("GET", re.compile(r"^/debug/slo$"), "debug_slo"),
    ("GET", re.compile(r"^/debug/sanitize$"), "debug_sanitize"),
    ("GET", re.compile(r"^/debug/faults$"), "debug_faults"),
    ("POST", re.compile(r"^/debug/faults$"), "debug_faults_set"),
    ("DELETE", re.compile(r"^/debug/faults$"), "debug_faults_clear"),
    ("GET", re.compile(r"^/debug/pprof/profile$"), "pprof_profile"),
    ("GET", re.compile(r"^/debug/pprof/goroutine$"), "pprof_goroutine"),
    ("GET", re.compile(r"^/debug/pprof/heap$"), "pprof_heap"),
    ("GET", re.compile(r"^/export$"), "export"),
    (
        "GET",
        re.compile(r"^/index/([^/]+)/field/([^/]+)/fragment/data$"),
        "fragment_export",
    ),
    ("GET", re.compile(r"^/internal/fragment/nodes$"), "fragment_nodes"),
    ("POST", re.compile(r"^/internal/translate/keys$"), "translate_keys"),
]


# the debug-surface directory served by GET /debug/ — (path, one-line
# description, serves-JSON, doctor query string or None to skip in the
# `pilosa_tpu doctor` bundle).  Keep in lockstep with _ROUTES: a debug
# route absent here is invisible to operators and to doctor.
_DEBUG_ENDPOINTS: list[tuple[str, str, bool, str | None]] = [
    ("/debug/", "this directory: every debug endpoint, one line each", True, None),
    ("/debug/vars", "counters/gauges/histograms plus per-subsystem state snapshots", True, ""),
    ("/debug/profile", "continuous profiler: folded flame-graph stacks (?seconds=N, ?segment=, ?format=speedscope|segments)", False, "?format=speedscope"),
    ("/debug/saturation", "USE verdict: event-loop lag, worker utilization, GIL estimate, lock contention (?window=S)", True, ""),
    ("/debug/processes", "multi-process fleet view: supervisor state + per-process saturation verdicts stitched over localhost (?window=S)", True, ""),
    ("/debug/cluster", "cluster movement view: state, rebalance thread, per-transfer progress, throttle + throughput meter", True, ""),
    ("/debug/resources", "unified per-subsystem used/limit/pressure resource ledger", True, ""),
    ("/debug/flightrec", "retained slow/errored query evidence (?trace_id=, &format=perfetto)", True, ""),
    ("/debug/workload", "heavy-hitter fingerprints + cachability estimate (?top=, ?format=capture)", True, ""),
    ("/debug/slo", "per-call-type SLO burn rates and budget remaining", True, ""),
    ("/debug/sanitize", "concurrency sanitizer: observed lock graph, cycles, loop-thread findings (PILOSA_TPU_SANITIZE=1)", True, ""),
    ("/debug/faults", "armed fault-injection rules, RPC + filesystem (POST/DELETE to arm/clear)", True, ""),
    ("/debug/traces", "recent tracing spans (?trace_id=, ?format=chrome)", True, ""),
    ("/debug/pprof/profile", "BLOCKING on-demand sampling profile (?seconds=, default 5)", False, "?seconds=1"),
    ("/debug/pprof/goroutine", "current stack of every live thread", False, ""),
    ("/debug/pprof/heap", "top allocation sites via tracemalloc (?top=)", True, ""),
]


def snapshot_envelope(section: dict) -> dict:
    """Uniform freshness envelope for every ``/debug/vars`` section:
    ``snapshotMonotonicS`` (this process's monotonic clock — diff two
    scrapes to age a snapshot without NTP hazards) and ``generatedAt``
    (ISO-8601 UTC wall time, for correlating with external logs; never
    used in arithmetic).  Sections used to carry inconsistent timestamp
    fields — some wall-clock, most absent — so "how stale is this
    snapshot" had no uniform answer."""
    out = dict(section)
    out["snapshotMonotonicS"] = time.monotonic()
    out["generatedAt"] = datetime.now(timezone.utc).isoformat()
    return out


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "pilosa-tpu/" + __version__

    # quiet default request logging; stats cover it
    def handle_one_request(self):
        try:
            super().handle_one_request()
        except (ConnectionResetError, BrokenPipeError, TimeoutError):
            # client tore the connection down mid-request — close quietly
            # instead of spraying a per-disconnect traceback from the
            # handler thread
            self.close_connection = True

    def log_message(self, fmt, *args):
        pass

    @property
    def api(self):
        return self.server.api

    @property
    def stats(self) -> StatsClient:
        return self.server.stats

    def _dispatch(self, method: str) -> None:
        parsed = urlparse(self.path)
        self.query_params = parse_qs(parsed.query)
        self.route_name = ""
        # per-request response/attribution state mined by the JSON
        # access log (docs/workload.md): send_response/send_header
        # overrides fill status + bytes, h_query fills the fingerprint
        self._resp_status = 0
        self._resp_bytes = 0
        self._trace_id = None
        self._workload_fp = None
        t0 = time.perf_counter()
        # propagated trace context (coordinator → data plane): a remote
        # node's spans join the coordinator's trace and parent onto its
        # fan-out span instead of starting a disconnected trace
        trace_id = self.headers.get(tracing.TRACE_HEADER)
        parent_span = self.headers.get(tracing.PARENT_HEADER)
        with GLOBAL_TRACER.activate(trace_id, parent_span):
            for m, pattern, name in _ROUTES:
                if m != method:
                    continue
                match = pattern.match(parsed.path)
                if match:
                    self.route_name = name
                    self.stats.count("http_requests", tags={"route": name})
                    # every route pays the same span + per-route latency
                    # histogram here — handlers cannot opt out of either
                    # (the observability analyzer rule pins this down)
                    with self.stats.timer(
                        "http_request_seconds", tags={"route": name}
                    ):
                        with GLOBAL_TRACER.span(f"http.{name}") as sp:
                            self._trace_id = sp.trace_id
                            self._guarded(
                                getattr(self, "h_" + name), *match.groups()
                            )
                    self._access_log(
                        method, parsed.path, time.perf_counter() - t0
                    )
                    return
            # extra (/internal/*) routes get the same error mapping, a
            # span so remote data-plane work appears in the stitched
            # trace, and the same per-route histogram (route=internal)
            with self.stats.timer(
                "http_request_seconds", tags={"route": "internal"}
            ):
                with GLOBAL_TRACER.span("http.internal", path=parsed.path) as sp:
                    self._trace_id = sp.trace_id
                    handled = self._guarded(
                        self.server.handle_extra, self, method, parsed.path
                    )
        if handled is False:
            self._json({"error": "not found"}, code=404)
        self._access_log(method, parsed.path, time.perf_counter() - t0)

    def _access_log(self, method: str, path: str, seconds: float) -> None:
        """Structured JSON access log (config access-log-format=json,
        docs/workload.md): one line per request — method, route,
        status, latency, response bytes, trace id, and (query routes)
        the workload fingerprint — so log pipelines index requests
        without regexes.  Off by default; the status/bytes fields are
        captured by the send_response/send_header overrides below, so
        enabling it costs one json.dumps per request and nothing when
        disabled."""
        if not getattr(self.server, "access_log_json", False):
            return
        entry = {
            "event": "access",
            "method": method,
            "path": path,
            "route": self.route_name or "internal",
            "status": self._resp_status,
            "latencyMs": round(seconds * 1e3, 3),
            "bytes": self._resp_bytes,
            "traceId": self._trace_id,
        }
        if self._workload_fp is not None:
            entry["fingerprint"] = self._workload_fp
        self.server.log("access " + json.dumps(entry))

    def send_response(self, code, message=None):
        # the access log's status attribution: every response path
        # (handlers, _error, send_error) funnels through here
        self._resp_status = code
        super().send_response(code, message)

    def send_header(self, keyword, value):
        if keyword.lower() == "content-length":
            try:
                self._resp_bytes = int(value)
            except (TypeError, ValueError):
                pass
        super().send_header(keyword, value)

    def _guarded(self, fn, *args):
        """Run a route handler with the error→status mapping applied.
        The mapping itself lives in ``_error_status`` — the ONE table,
        shared with the workload capture so the recorded status can
        never drift from the status the client received."""
        try:
            return fn(*args)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-response
        except Exception as e:  # pilosa: allow(broad-except) — the
            # route error chokepoint: anything a handler leaks maps to
            # a status via _error_status instead of killing the
            # connection thread
            code = self._error_status(e)
            if encoding.AVAILABLE and isinstance(e, encoding.DecodeError):
                self._error(f"bad protobuf body: {e}", code=code)
            elif code == 500:
                self._error(f"internal: {e!r}", code=code)
            else:
                self._error(str(e), code=code)
        return None

    @staticmethod
    def _error_status(e: BaseException) -> int:
        """The HTTP status a handler error maps to — the single source
        for ``_guarded`` (the response) and the workload capture (the
        recorded status).  Ordering matters only for subclass pairs:
        RequestTooLargeError subclasses ExecutionError, so 413 checks
        first; Deadline/ShardUnavailable/DecodeError are disjoint from
        the 400 group (RuntimeError / protobuf Error bases)."""
        if isinstance(e, RequestTooLargeError):
            return 413
        if isinstance(e, (ExecutionError, PQLError, ValueError, KeyError)):
            return 400
        if isinstance(e, DeadlineExceededError):
            # the labeled per-query timeout (docs/fault-tolerance.md):
            # 504, never a generic 500/503 — a budget cut is the
            # client's contract working, not a server fault
            return 504
        if isinstance(e, ShardUnavailableError):
            return 503
        if encoding.AVAILABLE and isinstance(e, encoding.DecodeError):
            return 400
        return 500

    def _error(self, msg: str, code: int) -> None:
        """Error response in the negotiated wire format (reference:
        handler errors land in QueryResponse.err / ImportResponse.err for
        protobuf clients, plain JSON otherwise). Only the query and
        import routes carry an err field in their protobuf responses;
        every other route's errors are JSON regardless of negotiation
        (e.g. translate_keys — TranslateKeysResponse has no err field)."""
        if self._wants_proto() and self.route_name.startswith("import"):
            self._proto(encoding.protoser.import_response_to_bytes(msg), code=code)
        elif self._wants_proto() and self.route_name == "query":
            self._proto(
                encoding.protoser.response_to_bytes({"results": [], "error": msg}),
                code=code,
            )
        else:
            self._json({"error": msg}, code=code)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    # ------------------------------------------------------------- helpers
    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _json_body(self) -> dict:
        body = self._body()
        if not body:
            return {}
        try:
            return json.loads(body)
        except json.JSONDecodeError as e:
            raise ValueError(f"bad JSON body: {e}") from e

    def _json(self, obj, code: int = 200, extra_headers: dict | None = None) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _text(self, text: str, content_type: str = "text/plain", code: int = 200) -> None:
        self._bytes(text.encode(), content_type=content_type, code=code)

    def _bytes(
        self, data: bytes, content_type: str = "application/octet-stream", code: int = 200
    ) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _shards_param(self) -> list[int] | None:
        raw = self.query_params.get("shards")
        if not raw:
            return None
        return [int(s) for s in raw[0].split(",") if s != ""]

    def _proto_body(self) -> bool:
        """True when the request body is protobuf-encoded."""
        return encoding.AVAILABLE and encoding.CONTENT_TYPE in self.headers.get(
            "Content-Type", ""
        )

    def _wants_proto(self) -> bool:
        """Content negotiation (reference: http/handler.go checks
        Content-Type/Accept for application/x-protobuf). An explicit
        ``Accept: application/json`` wins even for protobuf request
        bodies (proto-in/JSON-out)."""
        accept = self.headers.get("Accept", "")
        if "application/json" in accept:
            return False
        return self._proto_body() or (
            encoding.AVAILABLE and encoding.CONTENT_TYPE in accept
        )

    def _proto(self, data: bytes, code: int = 200, extra_headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", encoding.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    # -------------------------------------------------------------- routes
    def _gate(self) -> bool:
        """Device-probe gate for routes whose work reaches the card:
        during the probe window a query must not be the first CUDA call
        of the process. The server-side gate waits a bounded slice for
        the verdict; while it is pending, or after a failed verdict,
        serve 503 + Retry-After with the server's reason instead of
        dispatching."""
        if self.server.gate():
            return True
        self._body()  # drain: an unread body would corrupt keep-alive framing
        # same wire-format negotiation as _error(), plus Retry-After — a
        # protobuf client must get a decodable QueryResponse/ImportResponse
        # error envelope, not a JSON body it can't parse
        msg = self.server.gate_reason()
        headers = {"Retry-After": "2"}
        if self._wants_proto() and self.route_name.startswith("import"):
            self._proto(
                encoding.protoser.import_response_to_bytes(msg),
                code=503,
                extra_headers=headers,
            )
        elif self._wants_proto() and self.route_name == "query":
            self._proto(
                encoding.protoser.response_to_bytes({"results": [], "error": msg}),
                code=503,
                extra_headers=headers,
            )
        else:
            self._json({"error": msg}, code=503, extra_headers=headers)
        return False

    def _query_context(self) -> "resilience.QueryContext":
        """Per-query resilience context (docs/fault-tolerance.md): the
        deadline budget — an explicit ``X-Pilosa-Deadline-Ms`` header
        (the remaining budget of an upstream hop, or a client opting
        into a tighter bound) wins over the server's configured
        ``query-timeout-ms`` default — plus the ``?allow-partial=true``
        opt-in for labeled partial results under replica loss.

        On the event-driven front end the deadline starts ticking at
        ADMISSION, not here: the accept loop installs the Deadline it
        created when the request head arrived (docs/serving.md), so time
        spent queued behind other work counts against the budget — a
        query must never get a fresh clock just because it waited."""
        deadline = getattr(self, "admission_deadline", None)
        if deadline is None:
            deadline = resilience.deadline_from_header(
                self.headers.get(resilience.DEADLINE_HEADER)
            )
        if deadline is None and self.server.query_timeout_ms > 0:
            deadline = resilience.Deadline(self.server.query_timeout_ms / 1e3)
        allow_partial = self.query_params.get("allow-partial", [""])[
            0
        ].lower() in ("true", "1")
        return resilience.QueryContext(
            deadline=deadline, allow_partial=allow_partial
        )

    def h_query(self, index: str) -> None:
        if not self._gate():
            return
        body = self._body()
        proto = self._wants_proto()
        shards = self._shards_param()
        if self._proto_body():
            pql, req_shards = encoding.protoser.query_request_from_bytes(body)
            shards = shards or req_shards
        else:
            pql = body.decode()
        want_profile = self.query_params.get("profile", [""])[0].lower() in (
            "true",
            "1",
        )
        explain = self.query_params.get("explain", [""])[0].lower()
        if explain in ("true", "1", "plan"):
            # EXPLAIN (docs/observability.md): the plan alone — router
            # cost table per candidate path, residency classification,
            # mesh verdict, wave batchability — NOTHING executes
            plan = self.api.explain(index, pql, shards)
            self._enrich_cache_candidacy(plan, index, pql, shards)
            self._json({"explain": plan})
            return
        # EXPLAIN ANALYZE is JSON-only, like ?profile=true — a protobuf
        # QueryResponse has no explain slot, so don't pay the plan walk
        # for a payload that could never be delivered
        analyze = explain == "analyze" and not proto
        # EXPLAIN ANALYZE snapshots the plan BEFORE execution so the
        # estimates it shows are the ones this very run decided with
        # (execution feeds the calibration EWMAs, moving them)
        plan = self.api.explain(index, pql, shards) if analyze else None
        if plan is not None:
            self._enrich_cache_candidacy(plan, index, pql, shards)
        qctx = self._query_context()
        # ?profile and EXPLAIN ANALYZE must measure a REAL execution —
        # a cached serve has no per-call actuals; lookups are bypassed
        # (fills still happen: a profiled run settles a valid result)
        cache = getattr(self.api, "result_cache", None)
        bypass = (
            cache.bypass()
            if cache is not None and (want_profile or analyze)
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        err: BaseException | None = None
        resp = None
        # the profile collector is always installed (a handful of dict
        # appends per query) so the long-query log can name the slow
        # shard group even when the client didn't ask for a profile —
        # and so the flight recorder has full evidence at settle time
        # for a query nobody marked in advance
        with resilience.use_query_context(qctx):
            with tracing.profile_query() as prof:
                with self.stats.timer("query_seconds", tags={"index": index}):
                    with GLOBAL_TRACER.span("pql.query", index=index) as sp:
                        prof.trace_id = sp.trace_id
                        try:
                            with bypass:
                                resp = self.server.query_router(
                                    index, pql, shards
                                )
                        except Exception as e:  # noqa: BLE001 — held for
                            # the flight recorder's settle decision
                            # (errored queries retain), re-raised below
                            # into _guarded's canonical status mapping
                            err = e
        elapsed = time.perf_counter() - t0
        cache_out = (
            cache.consume_outcome() if cache is not None else None
        )
        prof.total_seconds = elapsed
        wait = getattr(self, "admission_wait_s", None)
        if wait is not None:
            # the event front end's admission-lane wait for THIS request
            # (docs/serving.md): the queue-or-query attribution
            prof.admission_wait = wait
        if qctx.deadline is not None:
            prof.deadline = {
                "budgetS": qctx.deadline.budget_s,
                "remainingS": qctx.deadline.remaining(),
            }
        # workload fingerprint (docs/workload.md): the query's identity
        # in the heavy-hitter sketch — computed once here (a cached
        # dict hit on repeated traffic) and shared by the flight
        # recorder entry, the slow-query log line, the access log, and
        # the capture record below
        wl = getattr(self.server, "workload", None)
        fp = wl_call = None
        if wl is not None and wl.enabled:
            fp, wl_call = wl.fingerprint(index, pql, shards)
            self._workload_fp = fp
            if (
                fp is not None
                and cache_out is not None
                and cache_out.get("outcome") == "hit"
            ):
                # measured hit next to the cachability estimate
                # (/debug/workload servableFraction vs actualHitFraction)
                wl.record_cache_hit(fp)
        self._flightrec_settle(
            index, pql, prof, elapsed, err, fp=fp, wl=wl,
            cache_out=cache_out,
        )
        if err is not None:
            self._workload_record(
                wl, fp, wl_call, index, pql, prof, elapsed,
                self._error_status(err), 0, shards=shards,
            )
            raise err
        slow = self.server.long_query_time
        if slow > 0 and elapsed >= slow:
            worst = prof.slowest()
            where = ""
            if worst is not None:
                shard_list = worst.get("shards")
                where = (
                    f" slowest={worst['call']}"
                    + (f" node={worst['node']}" if "node" in worst else "")
                    + (f" shards={shard_list}" if shard_list else "")
                    + f" ({worst['seconds']:.3f}s)"
                )
            rank = wl.rank(fp) if wl is not None and fp is not None else None
            cache_tag = (
                f" cache={cache_out['outcome']}"
                if cache_out is not None and "outcome" in cache_out
                else ""
            )
            self.server.log(
                f"long query ({elapsed:.3f}s) index={index}"
                f" trace={prof.trace_id} fp={fp} rank={rank}{cache_tag}"
                f"{where}: {pql[:200]}"
            )
        if proto:
            self._proto(encoding.protoser.response_to_bytes(resp))
        else:
            if want_profile:
                resp = dict(resp)
                resp["profile"] = prof.to_json()
            if analyze:
                resp = dict(resp)
                resp["explain"] = self._merge_explain_actuals(plan, prof)
            self._json(resp)
        # recorded AFTER the response ships so the capture carries the
        # real result size (send_header stashed Content-Length)
        self._workload_record(
            wl, fp, wl_call, index, pql, prof, elapsed, 200,
            getattr(self, "_resp_bytes", 0), shards=shards,
        )

    def _workload_record(
        self, wl, fp: str | None, call_type: str | None, index: str,
        pql: str, prof, elapsed: float, status: int, nbytes: int,
        shards: list[int] | None = None,
    ) -> None:
        """Feed the settled query to the workload plane: fingerprint →
        sketch + per-fingerprint stats + SLO windows + (sampled) the
        capture ring.  ``call_type`` comes from the fingerprinter's
        parse (never ``_readback``, which can lead prof.calls under
        wave concurrency).  The mutation stamp recorded alongside is
        the cachability signal (docs/workload.md)."""
        if wl is None or not wl.enabled or fp is None:
            return
        route = next(
            (c.get("route") for c in prof.calls if c.get("route")), None
        )
        wl.record(
            index,
            pql,
            fp,
            call_type or "?",
            elapsed,
            status,
            nbytes,
            route=route,
            trace_id=prof.trace_id,
            stamp=self.api.mutation_stamp(index),
            arrival=getattr(self, "arrival_monotonic", None),
            shards=shards,
        )

    def _flightrec_settle(
        self, index: str, pql: str, prof, elapsed: float,
        err: BaseException | None, fp: str | None = None, wl=None,
        cache_out: dict | None = None,
    ) -> None:
        """Hand the settled query to the flight recorder — the evidence
        thunk (full profile + the trace's buffered spans) is only paid
        when the recorder decides to retain.  The entry carries the
        query's workload fingerprint and its CURRENT heavy-hitter rank
        (docs/workload.md), so a retained slow query links straight to
        "how often does this exact query run" in /debug/workload."""
        rec = getattr(self.server, "flightrec", None)
        if rec is None or not rec.enabled:
            return
        if prof.calls:
            call_type = prof.calls[0]["call"]
        else:
            call_type = pql.split("(", 1)[0].strip() or "?"

        def entry() -> dict:
            out = {
                "traceId": prof.trace_id,
                "index": index,
                "query": pql[:500],
                "node": self.server.node_id,
                "profile": prof.to_json(),
                "spans": (
                    GLOBAL_TRACER.spans_for_trace(prof.trace_id)
                    if prof.trace_id
                    else []
                ),
            }
            if cache_out is not None:
                # result-cache verdict for this serve (hit/miss/skip +
                # fill outcome) — a retained slow query answers "why
                # wasn't this a cache hit" directly
                out["resultCache"] = cache_out
            if fp is not None:
                out["fingerprint"] = fp
                if wl is not None:
                    # rank is resolved lazily HERE — only retained
                    # queries pay the O(k) sketch walk
                    out["workloadRank"] = wl.rank(fp)
            sampler = getattr(self.server, "profiler", None)
            if sampler is not None and sampler.enabled:
                # continuous-profiler linkage (docs/profiling.md): the
                # segment ids overlapping this query's wall-clock window
                # — the retained slow query links straight to the flame
                # graph that contains it (/debug/profile?segment=ID)
                now = time.monotonic()
                out["profilerSegments"] = sampler.segments_overlapping(
                    now - elapsed, now
                )
            return out

        rec.settle(call_type, elapsed, entry, error=err)

    def _enrich_cache_candidacy(
        self, plan: dict, index: str, pql: str,
        shards: list[int] | None,
    ) -> None:
        """Add the MEASURED half of the EXPLAIN cache verdict: the
        structural candidacy (api.explain) knows the thresholds, the
        workload plane knows this fingerprint's measured cost and
        result size — an admitted-in-principle query whose measured
        mean cost sits below result-cache-min-cost-ms (or whose results
        exceed the per-entry byte cap) reports skipped, with why."""
        verdict = plan.get("resultCache")
        cache = getattr(self.api, "result_cache", None)
        wl = getattr(self.server, "workload", None)
        if (
            verdict is None
            or cache is None
            or wl is None
            or not wl.enabled
            or not verdict.get("admitted")
        ):
            return
        fp, _ = wl.fingerprint(index, pql, shards)
        with wl._lock:
            st = wl._fp_stats.get(fp)
            measured = st.to_json() if st is not None else None
        if measured is None:
            return
        verdict["fingerprint"] = fp
        verdict["measuredMeanMs"] = measured["meanMs"]
        mean_bytes = measured["resultBytesTotal"] / max(
            1, measured["observed"]
        )
        verdict["measuredMeanBytes"] = round(mean_bytes, 1)
        if measured["meanMs"] < cache.min_cost_ms:
            verdict["admitted"] = False
            verdict["reason"] = (
                f"measured mean cost {measured['meanMs']}ms is below "
                f"result-cache-min-cost-ms ({cache.min_cost_ms}ms) — "
                "not worth a ledger slot"
            )
        elif 0 < cache.entry_byte_cap < mean_bytes:
            verdict["admitted"] = False
            verdict["reason"] = (
                f"measured mean result size {round(mean_bytes)} bytes "
                f"exceeds the per-entry byte cap "
                f"({cache.entry_byte_cap} bytes)"
            )

    @staticmethod
    def _merge_explain_actuals(plan: dict, prof) -> dict:
        """EXPLAIN ANALYZE: attach each call's measured actuals next to
        the estimates the plan carries, plus the per-path error ratio
        for the route that actually ran."""
        actuals = [e for e in prof.calls if e["call"] != "_readback"]
        readback = sum(
            e["seconds"] for e in prof.calls if e["call"] == "_readback"
        )
        dev_calls = sum(
            1 for e in actuals if e.get("route") in ("device", "mesh")
        )
        for p, actual in zip(plan.get("calls", []), actuals):
            p["actualSeconds"] = actual["seconds"]
            actual_route = actual.get("route") or p.get("route")
            p["actualRoute"] = actual_route
            measured = actual["seconds"]
            if actual_route in ("device", "mesh") and readback:
                # the shared readback wave's cost, split across the
                # device-routed calls that rode it — same attribution
                # the router audit uses
                measured += readback / max(1, dev_calls)
            chosen = p.get("candidates", {}).get(actual_route)
            if chosen and chosen.get("estimatedSeconds"):
                chosen["measuredSeconds"] = measured
                chosen["errorRatio"] = (
                    measured / chosen["estimatedSeconds"]
                )
        plan["actualTotalSeconds"] = prof.total_seconds
        if readback:
            plan["actualReadbackSeconds"] = readback
        if prof.wave is not None:
            plan["wave"] = prof.wave
        if prof.admission_wait is not None:
            plan["admissionWaitSeconds"] = prof.admission_wait
        return plan

    def h_create_index(self, index: str) -> None:
        body = self._json_body()
        self.api.create_index(index, body.get("options", {}))
        self.server.broadcast_schema()
        self._json({"success": True})

    def h_delete_index(self, index: str) -> None:
        self.api.delete_index(index)
        self.server.broadcast_deletion(index)
        self._json({"success": True})

    def h_get_index(self, index: str) -> None:
        for idx in self.api.schema()["indexes"]:
            if idx["name"] == index:
                self._json(idx)
                return
        self._json({"error": f"index {index!r} not found"}, code=404)

    def h_create_field(self, index: str, field: str) -> None:
        body = self._json_body()
        self.api.create_field(index, field, body.get("options", {}))
        self.server.broadcast_schema()
        self._json({"success": True})

    def h_delete_field(self, index: str, field: str) -> None:
        self.api.delete_field(index, field)
        self.server.broadcast_deletion(index, field)
        self._json({"success": True})

    def _import_payload(self, values: bool) -> dict:
        if self._proto_body():
            body = self._body()
            if values:
                return encoding.protoser.import_value_request_from_bytes(body)
            return encoding.protoser.import_request_from_bytes(body)
        return self._json_body()

    def _import_ok(self) -> None:
        if self._wants_proto():
            self._proto(encoding.protoser.import_response_to_bytes())
        else:
            self._json({"success": True})

    def _record_ingest(
        self, route: str, nbytes: int, bits: int = 0, started: float | None = None
    ) -> None:
        """Ingest observability (docs/ingest.md): per-route byte/bit
        counters + the batch-latency histogram, and the rolling meter
        the /debug/resources "ingest" row reads."""
        meter = getattr(self.server, "ingest_meter", None)
        if meter is not None:
            meter.record(nbytes, bits)
        if self.stats is not None:
            self.stats.count("import_bytes_total", nbytes, tags={"route": route})
            if bits:
                self.stats.count("import_bits_total", bits)
            if started is not None:
                self.stats.timing(
                    "import_batch_seconds", time.perf_counter() - started
                )

    def h_import_bits(self, index: str, field: str) -> None:
        if not self._gate():
            return
        t0 = time.perf_counter()
        body_len = int(self.headers.get("Content-Length") or 0)
        payload = self._import_payload(values=False)
        self.server.import_router(index, field, payload, values=False)
        cols = payload.get("columnIDs")
        self._record_ingest(
            "import", body_len, len(cols) if cols is not None else 0, t0
        )
        self._import_ok()

    def h_import_values(self, index: str, field: str) -> None:
        if not self._gate():
            return
        t0 = time.perf_counter()
        body_len = int(self.headers.get("Content-Length") or 0)
        payload = self._import_payload(values=True)
        self.server.import_router(index, field, payload, values=True)
        cols = payload.get("columnIDs")
        self._record_ingest(
            "import-value", body_len, len(cols) if cols is not None else 0, t0
        )
        self._import_ok()

    def h_import_roaring(self, index: str, field: str, shard: str) -> None:
        if not self._gate():
            return
        param_view = self.query_params.get("view", [""])[0]
        if self._proto_body():
            data, view = encoding.protoser.import_roaring_request_from_bytes(
                self._body()
            )
            # envelope view wins; fall back to ?view= then "standard"
            view = view or param_view or "standard"
        else:
            data = self._body()
            view = param_view or "standard"
        t0 = time.perf_counter()
        # clustered nodes swap this router for the replica fan-out that
        # streams the SAME frame bytes to every shard owner
        bits = self.server.roaring_router(index, field, int(shard), data, view)
        self._record_ingest("import-roaring", len(data), int(bits or 0), t0)
        self._import_ok()

    def h_console(self) -> None:
        """Embedded query console (reference parity: the v0.x WebUI,
        embedded via statik; here one self-contained HTML file)."""
        import importlib.resources

        html = (
            importlib.resources.files("pilosa_tpu_torch.server")
            .joinpath("console.html")
            .read_text(encoding="utf-8")
        )
        self._text(html, content_type="text/html; charset=utf-8")

    def h_get_schema(self) -> None:
        self._json(self.api.schema())

    def h_post_schema(self) -> None:
        self.api.apply_schema(self._json_body())
        self._json({"success": True})

    def h_status(self) -> None:
        self._json(
            {
                "state": self.api.state(),
                "nodes": self.api.hosts(),
                "localID": self.server.node_id,
                "topologyEpoch": self.api.topology_epoch(),
                # True while this node's translate stores are awaiting a
                # full reconcile (boot / post-demotion): a fencing
                # promoter pulls such unverified chains FIRST so verified
                # peers' entries win any conflict
                "translatePending": self.api.translate_pending(),
                # full per-index shard inventory piggybacks on the
                # heartbeat (reference: availableShards travels in
                # gossip ClusterStatus) — peers route reads from this
                # cache instead of polling node_shards per read
                "shards": self.api.node_inventories(),
            }
        )

    def h_info(self) -> None:
        self._json(self.api.info())

    def h_version(self) -> None:
        self._json({"version": __version__})

    def h_metrics(self) -> None:
        self._text(self.stats.prometheus(), content_type="text/plain; version=0.0.4")

    def h_debug_vars(self) -> None:
        out = self.stats.expvar()
        # every section below carries the uniform snapshotMonotonicS +
        # generatedAt envelope (snapshot_envelope): sections used to mix
        # wall-clock timestamps with none at all, so snapshot staleness
        # had no consistent answer
        # device-cache effectiveness counters (tests assert the write
        # path stays incremental; operators read them here)
        out["stackCache"] = snapshot_envelope(
            self.api.executor.compiler.stacks.stats_snapshot()
        )
        # tiered compressed residency: container tiers, hot/cold row
        # promotion + demotion, per-container resident bytes
        # (docs/device-residency.md)
        out["deviceResidency"] = snapshot_envelope(
            self.api.executor.compiler.stacks.residency_snapshot()
        )
        # live cost-router calibration: mode, crossover, and the EWMAs
        # behind every host/device decision (docs/query-routing.md)
        out["queryRouting"] = snapshot_envelope(
            self.api.executor.router.snapshot()
        )
        # settle-time router-decision audit: per-path estimate-error
        # drift and the misroute matrix (docs/query-routing.md)
        out["routerAudit"] = snapshot_envelope(
            self.api.executor.router.audit.snapshot()
        )
        # cross-query wave coalescing: waves, occupancy, dedup hits
        # (docs/query-batching.md)
        out["queryBatching"] = snapshot_envelope(self.api.scheduler.snapshot())
        # explicit-SPMD mesh execution: device count, mesh geometry,
        # per-program-family call counts, fallbacks (docs/spmd.md)
        out["meshExecution"] = snapshot_envelope(
            self.api.executor.compiler.mesh_snapshot()
        )
        # serving front end: connection counts, admission queue state,
        # per-class concurrency limits (docs/serving.md)
        out["serving"] = snapshot_envelope(self.server.serving_snapshot())
        # durable write protocol: WAL fsync mode + dirty-file count, and
        # the background compactor's queue/debt state (docs/durability.md)
        from pilosa_tpu_torch.utils import durable

        out["durability"] = snapshot_envelope(
            {
                "wal": durable.wal_snapshot(),
                "compaction": self.api.holder.compactor.snapshot(),
            }
        )
        # workload-intelligence plane health: capture ring depth,
        # sampled/dropped counts, sketch size, spill segments — the
        # analysis itself serves at /debug/workload (docs/workload.md)
        out["workload"] = snapshot_envelope(
            self.server.workload.vars_snapshot()
        )
        # mutation-stamped result cache: ledger, hit/miss/eviction/
        # invalidation counters, admission skips (docs/result-cache.md)
        cache = getattr(self.api, "result_cache", None)
        if cache is not None:
            out["resultCache"] = snapshot_envelope(cache.snapshot())
        self._json(out)

    def h_debug_index(self) -> None:
        """``GET /debug/``: the debug-surface directory — every debug
        endpoint with a one-line description (there are a dozen now and
        nothing listed them).  ``pilosa_tpu doctor`` walks this list to
        snapshot the whole surface into one offline bundle, so a new
        debug route added HERE is automatically collected.  The
        ``doctor`` field reflects LIVE state: a healthy node with the
        profiler configured off must not make doctor exit non-zero
        over the 404 that endpoint correctly serves."""
        prof = getattr(self.server, "profiler", None)
        out = []
        for p, d, j, q in _DEBUG_ENDPOINTS:
            if p == "/debug/profile" and (prof is None or not prof.enabled):
                q = None
            out.append(
                {"path": p, "description": d, "json": j, "doctor": q}
            )
        self._json({"endpoints": out})

    def h_debug_profile(self) -> None:
        """The continuous profiler's surface (docs/profiling.md): a
        flame graph of the recent past, served instantly from the
        segment ring — nothing to arm in advance.  ``?seconds=N`` merges
        the segments covering the last N seconds, ``?segment=ID`` one
        retained historical segment (the id a flight-recorder entry
        carries), ``?format=speedscope`` speedscope.app JSON instead of
        folded text, ``?format=segments`` the ring index."""
        prof = getattr(self.server, "profiler", None)
        if prof is None:
            self._json({"error": "profiler not wired"}, code=404)
            return
        fmt = self.query_params.get("format", ["folded"])[0]
        if fmt == "segments":
            self._json(snapshot_envelope(prof.snapshot()))
            return
        if not prof.enabled:
            self._json(
                {"error": "profiler disabled (config profiler-enabled)"},
                code=404,
            )
            return
        seconds_raw = self.query_params.get("seconds", [""])[0]
        segment_raw = self.query_params.get("segment", [""])[0]
        seconds = float(seconds_raw) if seconds_raw else None
        segment = int(segment_raw) if segment_raw else None
        try:
            if fmt in ("speedscope", "json"):
                self._json(prof.speedscope(seconds=seconds, segment=segment))
            else:
                self._text(prof.folded(seconds=seconds, segment=segment))
        except KeyError as e:
            self._json({"error": str(e)}, code=404)

    def h_debug_saturation(self) -> None:
        """The USE-style saturation verdict (docs/profiling.md): event-
        loop lag, worker-pool utilization, the GIL-wait estimate, and
        hot-lock contention, each normalized to a [0,1] pressure, with
        the binding resource named for the window (``?window=S``,
        default 60)."""
        mon = getattr(self.server, "saturation", None)
        if mon is None:
            self._json({"error": "saturation monitor not wired"}, code=404)
            return
        window = float(self.query_params.get("window", ["60"])[0])
        self._json(
            snapshot_envelope(
                mon.report(
                    window_s=window, serving=self.server.serving_snapshot()
                )
            )
        )

    def h_debug_processes(self) -> None:
        """The reference's multi-process fleet view (docs/multiprocess.md)
        on an unsupervised node: each node's LIVE ``/debug/saturation``
        verdict, the local one for a node with no URI (the supervisor
        that would add parent metadata is not ported: ROADMAP A10).
        ``?window=S`` forwards to each saturation report (default 60)."""
        window = self.query_params.get("window", ["60"])[0]
        float(window)  # validate before forwarding into the fleet
        out: dict = {"supervised": False, "processes": []}
        members = [
            {"uri": n.get("uri"), "id": n.get("id")}
            for n in self.api.hosts()
        ]
        for m in members:
            row = {
                k: m[k]
                for k in (
                    "index", "id", "uri", "bind", "pid", "ready",
                    "restarts", "lastExitCode",
                )
                if k in m
            }
            uri = m.get("uri") or ""
            if not uri:
                # solo node with no cluster: report the local verdict
                mon = getattr(self.server, "saturation", None)
                if mon is not None:
                    rep = mon.report(
                        window_s=float(window),
                        serving=self.server.serving_snapshot(),
                    )
                    row.update(self._saturation_digest(rep))
                out["processes"].append(row)
                continue
            try:
                rep = self._fetch_fleet_json(
                    f"{uri}/debug/saturation?window={window}"
                )
                row.update(self._saturation_digest(rep))
            except Exception as e:  # pilosa: allow(broad-except) — the
                # fleet view's JOB includes naming which process could
                # not answer (a crashed child mid-restart is the
                # interesting row, not a reason to 500 the whole view)
                row["error"] = repr(e)
            out["processes"].append(row)
        self._json(snapshot_envelope(out))

    @staticmethod
    def _saturation_digest(rep: dict) -> dict:
        """The per-process slice of a /debug/saturation report the
        fleet view stitches: verdict + pressures + sharing mode, not
        the full probe histograms (doctor bundles those per node)."""
        digest = {
            "binding": rep.get("binding"),
            "verdict": rep.get("verdict"),
            "pressures": rep.get("pressures"),
            "sharedListener": (rep.get("serving") or {}).get(
                "sharedListener"
            ),
            "connectionsOpen": (rep.get("serving") or {}).get(
                "connectionsOpen"
            ),
        }
        if "recommendation" in rep:
            digest["recommendation"] = rep["recommendation"]
        return digest

    def _fetch_fleet_json(self, url: str, timeout: float = 5.0) -> dict:
        import ssl
        import urllib.request

        ctx = None
        if url.startswith("https://"):
            # co-resident children share the node's own (often self-
            # signed) certificate — verification adds nothing on
            # localhost and would break the default TLS recipe
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        req = urllib.request.Request(url)
        with urllib.request.urlopen(req, timeout=timeout, context=ctx) as r:
            return json.loads(r.read() or b"{}")

    def h_debug_cluster(self) -> None:
        """The cluster movement view (docs/resize.md): cluster state +
        topology epoch, whether a rebalance pull is in flight, every
        IN-FLIGHT transfer's progress row (direction, fragment, peer,
        bytes, age), recent completions, and the movement meter
        (window Mbit/s, throttle waits) — the surface an operator
        watches while adding or draining a node."""
        cluster = getattr(self.api, "cluster", None)
        if cluster is None:
            # solo fallback, the /debug/processes precedent: the surface
            # stays probeable (doctor bundles every /debug/ endpoint) and
            # says there is no movement plane rather than erroring
            self._json(snapshot_envelope({"clustered": False}))
            return
        t = cluster._rebalance_thread
        self._json(
            snapshot_envelope({
                "clustered": True,
                "state": cluster.state,
                "localID": cluster.me.id,
                "topologyEpoch": cluster.topology.epoch,
                "rebalance": {
                    "inFlight": bool(t is not None and t.is_alive()),
                    "thread": t.name if t is not None else None,
                },
                "movement": cluster.movement.snapshot(),
            })
        )

    def h_debug_resources(self) -> None:
        """The unified resource ledger (docs/profiling.md): the byte
        accounting scattered across the codebase — device residency
        ledger, WAL/ops-log debt, compaction debt, the capture/tracer/
        flight-recorder rings, connections, workers, process RSS —
        consolidated into one per-subsystem used/limit/pressure view,
        sorted so the fullest subsystem reads first."""
        from pilosa_tpu_torch.utils import durable, saturation
        from pilosa_tpu_torch.utils.tracing import MAX_SPANS

        subs: dict[str, dict] = {}

        def row(name: str, used, limit, unit: str, **extra) -> None:
            pressure = (
                round(used / limit, 4) if limit else None
            )
            subs[name] = {
                "used": used,
                "limit": limit or None,
                "unit": unit,
                "pressure": pressure,
                **extra,
            }
            if self.stats is not None and pressure is not None:
                self.stats.gauge(
                    "resource_pressure", pressure, tags={"subsystem": name}
                )
            if unit == "bytes" and self.stats is not None:
                self.stats.gauge(
                    "resource_bytes", float(used), tags={"subsystem": name}
                )

        # device residency: the stack cache's aggregate byte ledger.
        # The budget is read WITHOUT forcing resolution — the HBM query
        # initializes the JAX backend, and this control-plane route does
        # not pass the device-probe gate (limit reads None until a
        # query resolved it)
        from pilosa_tpu_torch.executor import compile as query_compile

        stacks = self.api.executor.compiler.stacks
        row(
            "deviceResidency",
            stacks.resident_bytes,
            query_compile.stack_budget_if_resolved(),
            "bytes",
        )
        # WAL / ops-log debt (crash-replay bytes) + compaction queue
        wal = self.api.holder.wal_ledger()
        row(
            "walOpsLog",
            wal["opsLogBytes"],
            None,
            "bytes",
            pendingOps=wal["pendingOps"],
            fragments=wal["fragments"],
            maxOpLogFill=wal["maxOpLogFill"],
            fsync=durable.wal_snapshot(),
        )
        comp = self.api.holder.compactor
        debt = comp.debt()
        max_debt = getattr(self.server, "compaction_max_debt", 0) or 0
        row("compaction", debt, max_debt, "compactions",
            workers=comp.workers)
        # bulk-ingest lane (docs/ingest.md): rolling window throughput +
        # lifetime totals from the import routes' meter
        meter = getattr(self.server, "ingest_meter", None)
        if meter is not None:
            ing = meter.snapshot()
            row(
                "ingest",
                ing["bytesTotal"],
                None,
                "bytes",
                bitsTotal=ing["bitsTotal"],
                postsTotal=ing["postsTotal"],
                windowSeconds=ing["windowSeconds"],
                recentBytesPerS=ing["recentBytesPerS"],
                recentMbitSetPerS=ing["recentMbitSetPerS"],
            )
        # movement lane (docs/resize.md): bulk data movement byte totals
        # + window rate, with slot occupancy as the pressure fraction
        cluster = getattr(self.api, "cluster", None)
        if cluster is not None:
            mv = cluster.movement.snapshot()
            row(
                "movement",
                len(mv["active"]),
                mv["maxConcurrent"],
                "transfers",
                bytesTotal=mv["meter"]["bytesTotal"],
                fragmentsTotal=mv["meter"]["fragmentsTotal"],
                throttleWaits=mv["meter"]["throttleWaits"],
                recentMbitPerS=mv["meter"]["recentMbitPerS"],
                maxMbit=mv["maxMbit"],
            )
        # evidence rings
        rec = getattr(self.server, "flightrec", None)
        if rec is not None:
            row("flightrecRing", len(rec.entries()), rec.capacity, "entries",
                enabled=rec.enabled)
        wl = getattr(self.server, "workload", None)
        if wl is not None:
            ws = wl.vars_snapshot()
            row("workloadCaptureRing", ws["captureRingDepth"],
                ws["captureRingCapacity"], "entries", enabled=ws["enabled"])
            row("workloadSpill", ws["spillSegments"], None, "segments",
                pendingRecords=ws["spillPendingRecords"])
        # result-cache byte ledger (docs/result-cache.md): used vs the
        # result-cache-bytes budget; the row() helper publishes the
        # resource_bytes{subsystem="result-cache"} gauge alongside
        cache = getattr(self.api, "result_cache", None)
        if cache is not None:
            cs = cache.snapshot()
            row(
                "result-cache",
                cs["usedBytes"],
                cs["maxBytes"] or None,
                "bytes",
                entries=cs["entries"],
                hits=cs["hits"],
                misses=cs["misses"],
                evictions=cs["evictions"],
                invalidations=cs["invalidations"],
                mode=cs["mode"],
            )
        row("tracerRing", GLOBAL_TRACER.depth(), MAX_SPANS, "spans")
        # serving front end: connections + per-class worker occupancy
        serving = self.server.serving_snapshot()
        row(
            "connections",
            serving.get("connectionsOpen", 0),
            serving.get("maxConnections", 0) or None,
            "connections",
            mode=serving.get("mode"),
        )
        for cls, adm in (serving.get("admission") or {}).items():
            row(
                f"workers.{cls}",
                adm["inFlight"],
                adm["limit"],
                "threads",
                queueDepth=adm["queueDepth"],
                queueCap=adm["queueCap"],
            )
        # process memory against the cgroup ceiling (if any)
        rss = saturation.rss_bytes()
        if rss is not None:
            row("processRss", rss, saturation.memory_limit_bytes(), "bytes",
                threads=threading.active_count())
        ranked = sorted(
            subs,
            key=lambda k: -(subs[k]["pressure"] or 0.0),
        )
        self._json(
            snapshot_envelope(
                {
                    "subsystems": {k: subs[k] for k in ranked},
                    "fullest": (
                        ranked[0]
                        if ranked and subs[ranked[0]]["pressure"]
                        else None
                    ),
                }
            )
        )

    def h_debug_flightrec(self) -> None:
        """The flight recorder's surface (docs/observability.md):
        retained slow/errored query evidence.  ``?trace_id=`` returns
        one entry with the full profile and spans;
        ``?trace_id=&format=perfetto`` (or ``chrome``) exports the
        retained spans as Chrome trace-event JSON — loadable in
        Perfetto even after the live tracer ring rotated them out."""
        rec = getattr(self.server, "flightrec", None)
        if rec is None:
            self._json({"error": "flight recorder not wired"}, code=404)
            return
        trace_id = self.query_params.get("trace_id", [""])[0]
        fmt = self.query_params.get("format", [""])[0]
        if trace_id:
            if fmt in ("perfetto", "chrome"):
                out = rec.perfetto(trace_id, node_id=self.server.node_id)
                if out is None:
                    self._json(
                        {"error": f"trace {trace_id!r} not retained"}, code=404
                    )
                    return
                self._json(out)
                return
            e = rec.entry(trace_id)
            if e is None:
                self._json(
                    {"error": f"trace {trace_id!r} not retained"}, code=404
                )
                return
            self._json(e)
            return
        self._json(rec.snapshot())

    def h_debug_workload(self) -> None:
        """The workload-intelligence report (docs/workload.md): top-K
        heavy-hitter fingerprints with per-fingerprint latency/churn
        stats and the cachability estimate.  ``?top=N`` bounds the
        listing; ``?format=capture`` exports the sampled capture ring
        as JSONL — directly consumable by ``pilosa_tpu replay`` (the
        zero-config capture→replay path; spill segments on disk are
        the durable alternative)."""
        wl = getattr(self.server, "workload", None)
        if wl is None:
            self._json({"error": "workload plane not wired"}, code=404)
            return
        fmt = self.query_params.get("format", [""])[0]
        if fmt == "capture":
            body = "".join(
                json.dumps(r, separators=(",", ":")) + "\n"
                for r in wl.capture_records()
            )
            self._bytes(body.encode(), content_type="application/x-ndjson")
            return
        top = int(self.query_params.get("top", ["20"])[0])
        self._json(wl.report(top=top))

    def h_debug_slo(self) -> None:
        """Per-call-type SLO state (docs/workload.md): burn rates over
        the 5m/1h windows, budget remaining, and the parsed targets.
        Gauges republish on scrape so /metrics agrees with this view."""
        wl = getattr(self.server, "workload", None)
        if wl is None:
            self._json({"error": "workload plane not wired"}, code=404)
            return
        wl.slo.publish_gauges()
        self._json(wl.slo.snapshot())

    def h_debug_sanitize(self) -> None:
        """Concurrency-sanitizer report (docs/concurrency.md): the
        observed holds-A-while-acquiring-B lock graph, per-lock hold
        times, lock-order cycles, event-loop-thread blocking acquires,
        and — when PILOSA_TPU_SANITIZE_STATIC points at the analyzer's
        --emit-lock-graph output — observed edges the static call-graph
        closure failed to predict.  Inert (enabled=false) unless the
        process started with PILOSA_TPU_SANITIZE=1."""
        from pilosa_tpu_torch.utils import sanitize

        self._json(sanitize.report())

    def h_debug_traces(self) -> None:
        """Recent spans, or one trace by id. ``?trace_id=`` filters to a
        single trace; with ``format=chrome`` the cluster layer (when
        attached) fetches that trace's remote spans from every peer via
        GET /internal/trace and stitches one Perfetto-loadable file —
        the coordinating HTTP span with each node's spans nested inside
        on its own process track."""
        trace_id = self.query_params.get("trace_id", [""])[0]
        chrome = self.query_params.get("format", [""])[0] == "chrome"
        if chrome:
            if trace_id:
                fetch = self.server.trace_fetch
                by_node = (
                    fetch(trace_id)
                    if fetch is not None
                    else {
                        self.server.node_id: GLOBAL_TRACER.spans_for_trace(
                            trace_id
                        )
                    }
                )
                self._json(tracing.chrome_trace_stitched(by_node))
            else:
                self._json(GLOBAL_TRACER.chrome_trace())
        elif trace_id:
            self._json({"spans": GLOBAL_TRACER.spans_for_trace(trace_id)})
        else:
            self._json({"spans": GLOBAL_TRACER.recent()})

    # fault-injection debug surface (docs/fault-tolerance.md): inspect,
    # arm, and clear this node's OUTGOING data-plane fault rules at
    # runtime — chaos rehearsal on a live cluster without a restart
    def _fault_injector(self):
        inj = self.server.fault_injector
        if inj is None:
            raise ValueError(
                "fault injection is not wired on this server (runtime "
                "Server instances install an injector at open())"
            )
        return inj

    def h_debug_faults(self) -> None:
        out = self._fault_injector().snapshot()
        fs = getattr(self.server, "fs_fault_injector", None)
        if fs is not None:
            # filesystem fault layer (docs/durability.md): read-only
            # here — FS rules arm via config (fs-fault-rules), because
            # installing the process-wide hook mid-flight would race
            # in-progress write protocols
            out["fs"] = fs.snapshot()
        self._json(out)

    def h_debug_faults_set(self) -> None:
        body = self._json_body()
        rules = body.get("rules", [])
        if not isinstance(rules, list):
            raise ValueError("'rules' must be a JSON list of fault rules")
        self._fault_injector().set_rules(rules, seed=body.get("seed"))
        self._json({"success": True, "rules": len(rules)})

    def h_debug_faults_clear(self) -> None:
        self._fault_injector().clear()
        self._json({"success": True})

    # /debug/pprof analogue (reference: net/http/pprof in http/handler.go)
    def h_pprof_profile(self) -> None:
        from pilosa_tpu_torch.utils import profiling

        seconds = float(self.query_params.get("seconds", ["5"])[0])
        self._text(profiling.sample_profile(seconds), content_type="text/plain")

    def h_pprof_goroutine(self) -> None:
        from pilosa_tpu_torch.utils import profiling

        self._text(profiling.thread_dump(), content_type="text/plain")

    def h_pprof_heap(self) -> None:
        from pilosa_tpu_torch.utils import profiling

        top = int(self.query_params.get("top", ["50"])[0])
        self._json(profiling.heap_profile(top))

    def h_export(self) -> None:
        index = self.query_params.get("index", [None])[0]
        field = self.query_params.get("field", [None])[0]
        if not index or not field:
            raise ValueError("export requires index= and field= params")
        shard = self.query_params.get("shard", [None])[0]
        csv = self.api.export_csv(index, field, int(shard) if shard else None)
        self._text(csv, content_type="text/csv")

    def h_fragment_export(self, index: str, field: str) -> None:
        """Serialized fragment bitmap; ?format=pilosa|official selects the
        cookie-12348 fragment layout or the stock-client 32-bit
        RoaringFormatSpec (reference analogue: RetrieveShardFromURI, made
        public so stock roaring tooling can pull fragments)."""
        shard = self.query_params.get("shard", ["0"])[0]
        view = self.query_params.get("view", ["standard"])[0]
        fmt = self.query_params.get("format", ["pilosa"])[0]
        data = self.api.fragment_data(index, field, int(shard), view, fmt)
        self._bytes(data, content_type="application/octet-stream")

    def h_translate_keys(self) -> None:
        """String keys → IDs (reference: POST /internal/translate/keys).
        Accepts a protobuf TranslateKeysRequest or JSON
        {"index", "field"?, "keys", "lookupOnly"?}; replies in kind
        (errors are always JSON — TranslateKeysResponse has no err
        field). Unknown keys on a lookup-only request come back as 0.
        Goes through the server's translate_router so the cluster layer
        can forward ID allocation to the translate primary."""
        if self._proto_body():
            req = encoding.protoser.translate_keys_request_from_bytes(self._body())
        else:
            j = self._json_body()
            req = {
                "index": j.get("index", ""),
                "field": j.get("field", ""),
                "keys": j.get("keys", []),
                "create": not j.get("lookupOnly", False),
            }
        ids = self.server.translate_router(
            req["index"], req["field"] or None, req["keys"], req["create"]
        )
        if self._wants_proto():
            self._proto(encoding.protoser.translate_keys_response_to_bytes(ids))
        else:
            self._json({"ids": [i or 0 for i in ids]})

    def h_fragment_nodes(self) -> None:
        index = self.query_params.get("index", [None])[0]
        shard = self.query_params.get("shard", ["0"])[0]
        if not index:
            raise ValueError("index= required")
        self._json(self.api.shard_nodes(index, int(shard)))


class _ServerCore:
    """Front-end-independent server state: the API binding, the router
    hooks the cluster layer swaps in, and the /internal extra-route
    table.  Shared by the event-driven listener (server/eventloop.py —
    the default) and the legacy thread-per-request listener below, so
    the cluster layer and the runtime Server wire one attribute surface
    regardless of serving mode."""

    def _init_core(self, api, stats: StatsClient | None) -> None:
        self.ssl_context = None  # set by Server.open() for TLS serving
        self.api = api
        self.stats = stats or StatsClient()
        self.node_id = "local"
        self.long_query_time = 0.0
        # per-query deadline default (config query-timeout-ms; 0 = off)
        self.query_timeout_ms = 0.0
        # the runtime Server installs its FaultInjector here so the
        # /debug/faults routes drive the same rule set the node's
        # outgoing data-plane client consults
        self.fault_injector = None
        # ... and its FSFaultInjector (docs/durability.md) so GET
        # /debug/faults reports the armed disk-fault rules too
        self.fs_fault_injector = None
        # device-probe gate: the runtime Server swaps in a hook that
        # blocks query/import dispatch (bounded) until the backend probe
        # verdict lands — True = proceed, False = serve 503 + Retry-After
        # with ``gate_reason()`` as the error
        self.gate = lambda: True
        self.gate_reason = lambda: "device probe in progress; retry"
        # cluster layer swaps in a cross-node trace collector:
        # trace_id -> {node_id: [span dicts]} for stitched chrome export
        self.trace_fetch = None
        # the runtime Server replaces this with its configured Logger's
        # log; the default gives standalone HTTPServers the same sink
        from pilosa_tpu_torch.utils.log import Logger

        self.log = Logger().log
        # always-on flight recorder (docs/observability.md): tail-based
        # retention of slow/errored query evidence, served by GET
        # /debug/flightrec.  Default-constructed so embedded/standalone
        # listeners record too; Server.open replaces it with the
        # config-sized one.  The log thunk indirects through self so the
        # runtime Server's later log swap is picked up.
        from pilosa_tpu_torch.utils.flightrec import FlightRecorder

        self.flightrec = FlightRecorder(
            stats=self.stats, log=lambda msg: self.log(msg)
        )
        # workload-intelligence plane (docs/workload.md): continuous
        # query capture + heavy-hitter sketch + SLO engine, fed by
        # h_query at every settle.  Default-constructed like the flight
        # recorder so embedded/standalone listeners measure too;
        # Server.open replaces it with the config-sized one.
        from pilosa_tpu_torch.utils.workload import WorkloadPlane

        self.workload = WorkloadPlane(
            stats=self.stats, log=lambda msg: self.log(msg)
        )
        # mutation-stamped cross-request result cache (docs/result-
        # cache.md): default-constructed like the flight recorder so
        # embedded/standalone listeners serve repeats from settled
        # results too; Server.open replaces it with the config-sized
        # one.  Attached to the API façade — consult/fill live in
        # API.query, the cluster coordinator consults before fan-out.
        from pilosa_tpu_torch.utils.resultcache import ResultCache

        self.result_cache = ResultCache(stats=self.stats)
        api.result_cache = self.result_cache
        self.workload.cache_byte_cap = self.result_cache.entry_byte_cap
        # continuous sampling profiler (docs/profiling.md): Server.open
        # installs a config-sized, STARTED SamplingProfiler; embedded/
        # standalone listeners leave it None (/debug/profile 404s) —
        # starting a sampler thread must be an explicit choice
        self.profiler = None
        # saturation probes (docs/profiling.md): default-constructed so
        # the event loop's lag probe and the lock families report even
        # on embedded listeners; the GIL probe thread only starts when
        # Server.open calls saturation.start()
        from pilosa_tpu_torch.utils.saturation import SaturationMonitor

        self.saturation = SaturationMonitor(stats=self.stats)
        # structured JSON access log (config access-log-format=json);
        # off by default — the access-log emitter checks this flag
        self.access_log_json = False
        self.extra_routes: dict = {}
        # sync queries land in the API façade, which hands them to the
        # cross-query wave scheduler (api.scheduler) instead of calling
        # the executor directly — concurrent clients share device
        # dispatch/readback waves (docs/query-batching.md)
        self.query_router = lambda index, pql, shards: api.query(index, pql, shards)
        self.import_router = self._local_import
        # bulk-lane twin of import_router: the cluster layer swaps this
        # for the replica fan-out (identical frame bytes to all owners)
        self.roaring_router = self._local_roaring
        # ingest throughput meter behind the /debug/resources "ingest"
        # row and the import_* metric family (docs/ingest.md)
        from pilosa_tpu_torch.utils.stats import IngestMeter

        self.ingest_meter = IngestMeter()
        # cluster layer swaps this for a primary-forwarding version — ID
        # allocation on a non-primary node would fork the key space
        self.translate_router = (
            lambda index, field, keys, create: api.translate_keys(
                index, field, keys, create=create
            )
        )
        self.broadcast_schema = lambda: None
        self.broadcast_deletion = lambda index, field=None: None

    def _local_import(self, index: str, field: str, payload: dict, values: bool) -> None:
        if values:
            self.api.import_values(index, field, payload)
        else:
            self.api.import_bits(index, field, payload)

    def _local_roaring(
        self, index: str, field: str, shard: int, data: bytes, view: str
    ) -> int:
        return self.api.import_roaring(index, field, shard, data, view=view)

    def handle_extra(self, handler: Handler, method: str, path: str) -> bool:
        for (m, pattern), fn in self.extra_routes.items():
            if m == method:
                match = pattern.match(path)
                if match:
                    fn(handler, *match.groups())
                    return True
        return False


# the default front end: the asyncio accept/read/write loop with
# keep-alive multiplexing and bounded admission (docs/serving.md).
# Imported at the bottom so eventloop.py can subclass Handler above;
# the name HTTPServer stays here because the runtime Server, the
# cluster tests, and the package __init__ all import it from this
# module.
from pilosa_tpu_torch.server.eventloop import EventHTTPServer as HTTPServer  # noqa: E402
