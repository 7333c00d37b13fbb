"""Event-driven HTTP front end: asyncio accept/read/write loop.

Replaces the thread-per-request ``ThreadingHTTPServer`` stack that
plateaued at c32 (BENCH_SWEEP_r06_cpu: sync_count_qps_c32 = 0.88x c1 —
parked OS threads + a connect-storm-sized accept backlog).  Design
(docs/serving.md):

- ONE event-loop thread owns all socket I/O: accept, HTTP/1.1 head/body
  reads with keep-alive multiplexing, slow-client timeouts, and response
  writes.  Ten thousand idle connections cost ten thousand coroutines,
  not ten thousand OS threads.
- Admission control between read and execution: per-class (query /
  write / control) concurrency limits with bounded wait queues.  A full
  queue answers 429 + Retry-After immediately — load sheds at the door
  instead of stacking invisible thread queues (a fixed
  ``request_queue_size`` accept backlog is not the limiter).
- Execution stays on a BOUNDED worker pool: the parsed request is handed
  to a worker thread that runs the existing ``Handler`` route logic over
  in-memory files, so concurrent sync queries still meet in the
  WaveScheduler and coalesce into shared device readback waves — the
  pool turns over at wave cadence while excess requests wait in
  admission, not on parked threads.
- The per-query deadline (X-Pilosa-Deadline-Ms / query-timeout-ms)
  starts when the request head arrives: a query that exhausts its budget
  while queued gets the labeled 504 and never executes.

The event loop itself must never block: no socket/file I/O, no
``time.sleep``, no thread spawns inside coroutines — the ``asyncpurity``
analyzer rule enforces this, with ``run_in_executor`` as the one
sanctioned hand-off to blocking code.
"""

from __future__ import annotations

import asyncio
import io
import os
import re
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.parallel import resilience
from pilosa_tpu_torch.server.http import Handler, _ServerCore
from pilosa_tpu_torch.utils import StatsClient, sanitize

# combined request-line + headers byte cap (http.server's _MAXLINE era
# limit); past it the client gets 431 and the connection closes
MAX_HEADER_BYTES = 65536
# asyncio stream high-water: sized so a multi-MiB import-roaring body
# buffers in few loop wakeups instead of 64 KiB dribbles (see the
# start_server call); per-connection memory stays bounded at 2x this
STREAM_BUFFER_BYTES = 1 << 20

# listen backlog: the kernel absorbs a connect burst while the loop
# accepts; admission control (not the backlog) is the real limiter, so
# this needs no per-deployment knob
LISTEN_BACKLOG = 1024

_CLASS_QUERY = "query"
_CLASS_WRITE = "write"
_CLASS_CONTROL = "control"


def route_class(method: str, path: str) -> str:
    """Admission class of a request path: queries (public + internal
    fan-out legs), writes (imports), control (everything else — status,
    schema, metrics, debug).  Control is deliberately its own small
    lane: a query flood must not starve /status heartbeats, or the
    cluster would dead-mark a node that is merely busy."""
    p = path.split("?", 1)[0]
    if p.endswith("/query") and p.startswith("/index/"):
        return _CLASS_QUERY
    if p.startswith("/internal/query"):
        return _CLASS_QUERY
    if "/import" in p:
        return _CLASS_WRITE
    return _CLASS_CONTROL


class _Abort(Exception):
    """Terminate a connection with one final error response."""

    def __init__(self, code: int, reason: str, message: str,
                 retry_after: str | None = None):
        super().__init__(message)
        self.code = code
        self.reason = reason  # queries_rejected{reason=} tag value
        self.message = message
        self.retry_after = retry_after


class _ConnState:
    """Per-connection watchdog state for the timeout sweeper.

    Slow-client cuts (keep-alive idle reap, slowloris head/body
    timeouts) are enforced by ONE periodic sweeper task over these
    records instead of a ``wait_for`` wrapper per read — three timer
    handles per request is measurable overhead on the c1 hot path, and
    DoS cuts don't need precision timing."""

    __slots__ = ("writer", "phase", "since", "aborted", "readahead")

    IDLE = 0  # between requests (keep-alive)
    HEAD = 1  # reading request line + headers
    BODY = 2  # reading the body
    BUSY = 3  # dispatched / writing the response (deadline governs)

    def __init__(self, writer):
        self.writer = writer
        # a connection that has sent NOTHING yet gets the idle grace
        # (held-open connection pools are the normal case — the 10k
        # smoke test holds exactly these); the slowloris window starts
        # at the first byte of a request head
        self.phase = _ConnState.IDLE
        self.since = time.monotonic()
        self.aborted = False
        # bytes read past a head's CRLFCRLF (pipelined body prefix /
        # next request) — consumed by the body read before the socket
        self.readahead = b""

    def enter(self, phase: int) -> None:
        self.phase = phase
        self.since = time.monotonic()


class _BufferedHandler(Handler):
    """One fully-read request executed against in-memory files.

    The event loop owns the real socket; a worker thread runs this shim,
    which re-parses the raw request through ``BaseHTTPRequestHandler``
    machinery (one parser for every request) and
    dispatches through the unchanged ``Handler`` route table.  The
    response accumulates in ``wfile`` (a BytesIO) for the loop to write
    back; ``close_connection`` reports the keep-alive decision."""

    def __init__(self, server, raw: bytes, client_address, deadline=None,
                 admission_wait: float | None = None,
                 arrival: float | None = None):
        # deliberately NOT calling super().__init__: the socketserver
        # constructor runs the blocking per-connection protocol; this
        # shim replaces exactly that part
        self.server = server
        self.client_address = client_address
        self.rfile = io.BytesIO(raw)
        self.wfile = io.BytesIO()
        # admission-time deadline: _query_context prefers this over
        # re-parsing the header so queue wait counts against the budget
        self.admission_deadline = deadline
        # measured admission-lane wait for THIS request: the profile
        # and the flight recorder attribute queue time vs query time
        # from it (docs/observability.md)
        self.admission_wait_s = admission_wait
        # monotonic instant the request HEAD started arriving: the
        # workload capture stamps records with it so replayed arrival
        # spacing reflects offered load, not settle times
        # (docs/workload.md)
        self.arrival_monotonic = arrival
        self.close_connection = True
        self.requestline = ""
        self.request_version = ""
        self.command = ""
        self._run()

    def handle_expect_100(self) -> bool:
        # the event loop already answered the interim 100 before it read
        # the body; writing another into the buffered response would
        # prepend a stray interim status
        return True

    def _run(self) -> None:
        self.raw_requestline = self.rfile.readline(65537)
        if not self.raw_requestline:
            return
        if len(self.raw_requestline) > 65536:
            self.requestline = ""
            self.send_error(414)
            return
        if not self.parse_request():
            return  # parse_request already wrote the error response
        method = getattr(self, "do_" + self.command, None)
        if method is None:
            self.send_error(501, f"Unsupported method ({self.command!r})")
            return
        method()


class EventHTTPServer(_ServerCore):
    """HTTP front end bound to an API façade — the event-driven default.

    The ``query_router`` / ``import_router`` hooks, ``extra_routes``,
    ``ssl_context`` and ``serve_background``/``shutdown``/``server_close``
    are what the runtime Server wires; the listener internals are an
    asyncio loop on one background thread."""

    def __init__(self, addr: tuple[str, int], api, stats: StatsClient | None = None):
        # bind in the constructor (like socketserver) so server_address
        # is final before serve_background — Server.open publishes the
        # bound port to the cluster join before the loop thread starts
        self.socket = socket.create_server(addr, backlog=LISTEN_BACKLOG)
        self.server_address = self.socket.getsockname()
        self._init_core(api, stats)
        # admission knobs (config: docs/configuration.md); Server.open
        # overwrites these from Config before serve_background
        self.max_connections = 0  # 0 = unlimited
        self.admission_queue_depth = 256  # per class; 0 = unbounded
        self.keepalive_idle_s = 75.0  # idle keep-alive reap; 0 = never
        self.request_read_timeout_s = 10.0  # slowloris head/body cut
        self.worker_threads = 0  # query-class concurrency; 0 = auto
        # write-lane backpressure tied to compaction debt (docs/
        # durability.md): when the holder's queued+in-flight compactions
        # exceed the limit, write-class requests get 429 + Retry-After —
        # unchecked ingest past compaction capacity grows every ops log
        # (and crash-replay time) without bound. 0 disables; the debt
        # callable is wired by Server.open.
        self.compaction_max_debt = 0
        self.compaction_debt = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._stop: asyncio.Event | None = None
        self._pool: ThreadPoolExecutor | None = None
        self._admission: dict[str, "_Admission"] = {}
        self._conn_tasks: set[asyncio.Task] = set()
        self._conns: set[_ConnState] = set()
        self._conn_count = 0
        self._started = threading.Event()
        self._closed = False

    # ------------------------------------------------------------ lifecycle
    def serve_background(self) -> threading.Thread:
        t = threading.Thread(
            target=self._run_loop, daemon=True, name="http-eventloop"
        )
        self._thread = t
        t.start()
        # the caller may connect immediately (the listener is already
        # bound, so connects queue in the backlog) but waiting for the
        # loop avoids a read-side race in zero-delay tests
        self._started.wait(5.0)
        return t

    def shutdown(self) -> None:
        self._closed = True
        loop, stop = self._loop, self._stop
        if loop is not None and stop is not None and loop.is_running():
            loop.call_soon_threadsafe(stop.set)
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def server_close(self) -> None:
        self._closed = True
        try:
            self.socket.close()
        except OSError:
            pass
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        # under PILOSA_TPU_SANITIZE=1 every blocking acquire of a
        # non-loop_safe lock on THIS thread becomes a finding — the
        # runtime check behind the static loop-purity rule
        sanitize.mark_loop_thread()
        try:
            loop.run_until_complete(self._serve())
        finally:
            sanitize.unmark_loop_thread()
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            finally:
                asyncio.set_event_loop(None)
                loop.close()

    def _class_limits(self) -> dict[str, int]:
        # auto query concurrency is sized to WAVE OCCUPANCY, not cores:
        # query workers spend their life parked as wave followers or in
        # GIL-released device calls, so capping them at the core count
        # starves the scheduler of wave-mates under fan-in (measured
        # here: a 2-core box with an 8-slot query lane put c32 BELOW c8
        # — the exact plateau this front end removes). Floor 32, ceiling
        # 64 (= batch-max-queries, one full wave).
        wt = self.worker_threads or max(32, min(64, (os.cpu_count() or 4) * 4))
        return {
            _CLASS_QUERY: wt,
            _CLASS_WRITE: max(2, wt // 2),
            _CLASS_CONTROL: max(4, wt // 4),
        }

    async def _serve(self) -> None:
        self._stop = asyncio.Event()
        limits = self._class_limits()
        # pool size = sum of class caps: an admission slot always implies
        # a worker thread, so acquiring the semaphore IS the queue exit
        self._pool = ThreadPoolExecutor(
            max_workers=sum(limits.values()), thread_name_prefix="http-worker"
        )
        depth = self.admission_queue_depth
        self._admission = {
            cls: _Admission(limit, depth) for cls, limit in limits.items()
        }
        loop = asyncio.get_running_loop()
        loop.set_exception_handler(self._loop_exception)
        kwargs: dict = {}
        if self.ssl_context is not None:
            kwargs["ssl"] = self.ssl_context
            # a TCP-open-no-ClientHello client must not hold a
            # handshake slot forever — same slow-client cut as the
            # plaintext head read
            kwargs["ssl_handshake_timeout"] = (
                self.request_read_timeout_s or None
            )
        server = await asyncio.start_server(
            self._handle_conn,
            sock=self.socket,
            # stream buffer sized for BULK bodies, not heads: with the
            # old 64 KiB limit a 2 MiB import-roaring frame drained in
            # ~16-32 read() wakeups, each queued behind whatever GIL
            # hold a numpy-crunching worker had in flight — measured
            # ~100ms per body under sustained ingest. Heads keep the
            # MAX_HEADER_BYTES cap via the explicit check in _read_head
            # (LimitOverrunError at this limit stays the backstop).
            limit=STREAM_BUFFER_BYTES,
            backlog=LISTEN_BACKLOG,
            **kwargs,
        )
        sweeper = asyncio.ensure_future(self._sweep_slow_clients())
        lag_probe = None
        if self.saturation is not None and self.saturation.enabled:
            lag_probe = asyncio.ensure_future(self._lag_probe())
        self._started.set()
        try:
            await self._stop.wait()
        finally:
            if lag_probe is not None:
                lag_probe.cancel()
            sweeper.cancel()
            server.close()
            await server.wait_closed()
            for t in list(self._conn_tasks):
                t.cancel()
            if self._conn_tasks:
                await asyncio.gather(*self._conn_tasks, return_exceptions=True)

    async def _sweep_slow_clients(self) -> None:
        """The slow-client watchdog: one periodic pass over open
        connections enforces the keep-alive idle reap and the slowloris
        head/body timeouts.  Centralized so the per-request hot path
        carries no timer bookkeeping; granularity is a fraction of the
        smallest configured cut (DoS defenses don't need precision)."""
        cuts = [
            t for t in (self.request_read_timeout_s, self.keepalive_idle_s)
            if t and t > 0
        ]
        interval = max(0.05, min(min(cuts), 2.0) / 4) if cuts else 2.0
        while True:
            await asyncio.sleep(interval)
            now = time.monotonic()
            for conn in list(self._conns):
                try:
                    age = now - conn.since
                    if conn.phase == _ConnState.IDLE:
                        if 0 < self.keepalive_idle_s < age:
                            conn.aborted = True
                            conn.writer.close()  # silent reap: nothing owed
                    elif conn.phase in (_ConnState.HEAD, _ConnState.BODY):
                        if 0 < self.request_read_timeout_s < age:
                            reason = (
                                "header_timeout"
                                if conn.phase == _ConnState.HEAD
                                else "body_timeout"
                            )
                            self._reject(reason)
                            conn.aborted = True
                            msg = (
                                "timed out reading request head"
                                if conn.phase == _ConnState.HEAD
                                else "timed out reading request body"
                            )
                            await self._write_simple(
                                conn.writer, 408, msg, retry_after="1",
                                close=True,
                            )
                            conn.writer.close()
                except Exception:  # pilosa: allow(broad-except) — one
                    # torn-down connection must not kill the watchdog
                    # for every other connection
                    continue

    async def _lag_probe(self) -> None:
        """The event-loop saturation probe (docs/profiling.md): a
        scheduled wakeup per tick, recording how late the loop actually
        ran it — the loop's run-queue delay, which is exactly what every
        queued response write and head parse waits behind.  The same
        tick samples each admission class's in-flight/limit fraction so
        worker-pool utilization is a windowed distribution, not a
        single scrape's instantaneous guess."""
        interval = 0.1
        mon = self.saturation
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(interval)
            mon.observe_loop_lag(max(0.0, time.monotonic() - t0 - interval))
            for cls, adm in self._admission.items():
                mon.observe_worker_util(
                    cls, adm.in_flight / max(1, adm.limit)
                )

    def _loop_exception(self, loop, context) -> None:
        # an exception nothing awaited: a bug by definition (the
        # 10k-connection smoke test asserts this counter stays 0)
        self.stats.count("eventloop_unhandled_exceptions")
        self.log(f"event loop unhandled exception: {context.get('message')}"
                 f" {context.get('exception')!r}")

    # ---------------------------------------------------------- connection
    def serving_snapshot(self) -> dict:
        adm = {
            cls: {
                "limit": a.limit,
                "queueDepth": a.waiting,
                "queueCap": a.depth,
                "inFlight": a.in_flight,
            }
            for cls, a in self._admission.items()
        }
        return {
            "mode": "event",
            "connectionsOpen": self._conn_count,
            "maxConnections": self.max_connections,
            "admission": adm,
            # the reference's public-port sharing mode: one process
            # serves alone until the supervisor is ported (ROADMAP A10)
            "sharedListener": {"mode": "none"},
        }

    def _set_conn_gauge(self) -> None:
        self.stats.gauge("connections_open", float(self._conn_count))

    def _reject(self, reason: str) -> None:
        self.stats.count("queries_rejected", tags={"reason": reason})

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        conn = _ConnState(writer)
        self._conns.add(conn)
        self._conn_count += 1
        self._set_conn_gauge()
        self.stats.count("connections_accepted")
        try:
            if 0 < self.max_connections < self._conn_count:
                self._reject("max_connections")
                await self._write_simple(
                    writer, 503, "server connection limit reached",
                    retry_after="1", close=True,
                )
                return
            await self._conn_loop(reader, writer, conn)
        except asyncio.CancelledError:
            raise  # shutdown path — propagate so gather() settles
        except (ConnectionResetError, BrokenPipeError, TimeoutError):
            pass  # client tore the connection down — close quietly
        except Exception as e:  # pilosa: allow(broad-except) — the
            # per-connection chokepoint: a handler bug must kill ONE
            # connection, never the accept loop
            self.stats.count("eventloop_unhandled_exceptions")
            # error path only: one bounded line to stderr under the
            # logger lock, exceptional by construction
            self.log(f"connection handler error: {e!r}")  # pilosa: allow(loop-purity)
        finally:
            if task is not None:
                self._conn_tasks.discard(task)
            self._conns.discard(conn)
            self._conn_count -= 1
            self._set_conn_gauge()
            writer.close()

    async def _conn_loop(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         conn: _ConnState) -> None:
        assert self._stop is not None
        while not self._stop.is_set():
            try:
                head = await self._read_head(reader, conn)
            except _Abort as e:
                self._reject(e.reason)
                await self._write_simple(
                    writer, e.code, e.message,
                    retry_after=e.retry_after, close=True,
                )
                return
            if head is None:
                return  # clean close: EOF, idle reap, or slowloris cut
            # conn.since was stamped when the head's first byte arrived
            # (_read_head's enter(HEAD)) — capture it BEFORE the body
            # phase re-stamps it; this is the arrival the workload
            # capture records for replay spacing
            arrival = conn.since
            try:
                method, path, headers, head = self._parse_head(head)
                cls = route_class(method, path)
                # the budget clock starts NOW — admission-queue wait and
                # body-read time both spend it (acceptance: a query that
                # exhausts its budget while queued never executes).
                # QUERY class only: the deadline governs query routes
                # alone (_query_context), so an
                # import or /status probe queued past query-timeout-ms
                # must not start 504ing — a busy-but-alive node's
                # heartbeats dying at admission is the dead-marking the
                # dedicated control lane exists to prevent
                deadline = None
                if cls == _CLASS_QUERY:
                    deadline = resilience.deadline_from_header(
                        headers.get(resilience.DEADLINE_HEADER.lower())
                    )
                    if deadline is None and self.query_timeout_ms > 0:
                        deadline = resilience.Deadline(
                            self.query_timeout_ms / 1e3
                        )
                body = await self._read_body(reader, writer, headers, conn)
            except _Abort as e:
                self._reject(e.reason)
                await self._write_simple(
                    writer, e.code, e.message,
                    retry_after=e.retry_after, close=True,
                )
                return
            if body is None:
                return  # client disconnected mid-body (or slow-body cut)
            if cls == _CLASS_QUERY:
                # result-cache fast path (docs/result-cache.md): a
                # repeated read query whose mutation-stamped key is
                # cached is answered RIGHT HERE on the loop thread —
                # no admission lane, no worker-pool hop, no GIL-bound
                # re-execution.  Pure CPU (memoized parse + dict hit),
                # so the loop's no-blocking contract holds.
                served = await self._serve_cached(
                    writer, method, path, headers, body, arrival
                )
                if served is not None:
                    if not served:
                        return
                    conn.enter(_ConnState.IDLE)
                    continue
            conn.enter(_ConnState.BUSY)
            keep = await self._admit_and_dispatch(
                writer, cls, head + body, deadline, arrival
            )
            if not keep:
                return
            conn.enter(_ConnState.IDLE)

    async def _read_head(self, reader: asyncio.StreamReader,
                         conn: _ConnState) -> bytes | None:
        """Request head (request line + headers + CRLFCRLF), or None on
        clean EOF / a watchdog cut.  The idle reap and the slowloris
        timeout are enforced by the sweeper task via ``conn.phase`` —
        the reads themselves carry no timers.

        Read incrementally rather than with ``readuntil``: the stream
        limit is sized for bulk import BODIES (STREAM_BUFFER_BYTES), so
        the MAX_HEADER_BYTES cap must be enforced here, MID-STREAM — a
        header flood has to die at the cap, not once a terminator shows
        up.  Bytes past the CRLFCRLF (a pipelined body prefix) stay in
        ``conn.readahead`` for ``_read_body``."""
        pending = conn.readahead
        conn.readahead = b""
        if not pending:
            first = await reader.read(1)
            if not first:
                return None  # EOF between requests (or watchdog close)
            pending = first
        conn.enter(_ConnState.HEAD)
        buf = bytearray(pending)
        while True:
            idx = buf.find(b"\r\n\r\n")
            if idx >= 0:
                head = bytes(buf[: idx + 4])
                if len(head) > MAX_HEADER_BYTES:
                    raise _Abort(
                        431, "header_too_large",
                        f"request head exceeds {MAX_HEADER_BYTES} bytes",
                    )
                conn.readahead = bytes(buf[idx + 4 :])
                return head
            if len(buf) > MAX_HEADER_BYTES:
                raise _Abort(
                    431, "header_too_large",
                    f"request head exceeds {MAX_HEADER_BYTES} bytes",
                )
            chunk = await reader.read(65536)
            if not chunk:
                return None  # hung up mid-head, or the sweeper's 408 cut
            buf += chunk

    def _parse_head(self, head: bytes) -> tuple[str, str, dict, bytes]:
        """(method, path, lowercase-header dict, possibly-rewritten head).
        Parsing here is minimal — admission routing and framing only; the
        worker-side shim re-parses with the stdlib machinery."""
        try:
            text = head.decode("iso-8859-1")
            request_line, _, header_text = text.partition("\r\n")
            method, path, _version = request_line.split(" ", 2)
        except ValueError:
            raise _Abort(400, "bad_request", "malformed request line") from None
        headers: dict[str, str] = {}
        for line in header_text.split("\r\n"):
            if not line:
                continue
            key, sep, value = line.partition(":")
            if not sep:
                continue
            k = key.strip().lower()
            v = value.strip()
            if k == "content-length" and headers.get(k, v) != v:
                # conflicting Content-Length values: the loop would
                # frame by one while a downstream parser may honor the
                # other — the classic request-smuggling split on a
                # keep-alive connection; refuse outright
                raise _Abort(
                    400, "bad_request", "conflicting Content-Length headers"
                )
            if k == "transfer-encoding" and k in headers:
                # merge duplicates so the chunked check below sees every
                # declared coding, not just the first line's
                headers[k] += ", " + v
                continue
            headers.setdefault(k, v)
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _Abort(
                501, "unsupported_transfer_encoding",
                "chunked request bodies are not supported; "
                "send Content-Length",
            )
        return method.upper(), path, headers, head

    async def _read_body(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         headers: dict, conn: _ConnState) -> bytes | None:
        try:
            length = int(headers.get("content-length") or 0)
        except ValueError:
            raise _Abort(400, "bad_request", "bad Content-Length") from None
        if "100-continue" in headers.get("expect", "").lower():
            # answer the interim 100 from the loop; the worker-side
            # shim's handle_expect_100 is a no-op so the buffered
            # response never carries a second interim status
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        if length <= 0:
            return b""
        conn.enter(_ConnState.BODY)  # sweeper owns the slow-body cut
        pending = conn.readahead
        if pending:
            # body prefix already buffered by the incremental head read
            if len(pending) >= length:
                conn.readahead = pending[length:]
                return pending[:length]
            conn.readahead = b""
        try:
            rest = await reader.readexactly(length - len(pending))
        except asyncio.IncompleteReadError:
            if not conn.aborted:
                self.stats.count("connections_aborted_midbody")
            return None
        return pending + rest if pending else rest

    # public query path: POST /index/{name}/query, optionally with a
    # ?shards= scope — the ONLY shape the cache fast path serves; any
    # other param (explain/profile/...) or the /internal legs take the
    # worker path untouched
    _CACHE_PATH_RE = re.compile(r"^/index/([^/?]+)/query(?:\?(.*))?$")

    async def _serve_cached(self, writer, method: str, path: str,
                            headers: dict, body: bytes,
                            arrival: float | None) -> bool | None:
        """Serve a repeated read query straight from the event loop
        (docs/result-cache.md).  Returns None when the worker path must
        run, else the keep-alive verdict.  Everything here is pure CPU
        — the asyncpurity contract for loop-thread code."""
        cache = getattr(self, "result_cache", None)
        if cache is None or not cache.enabled or method != "POST":
            return None
        m = self._CACHE_PATH_RE.match(path)
        if m is None:
            return None
        index, qs = m.group(1), m.group(2) or ""
        shards = None
        if qs:
            params = dict(
                p.partition("=")[::2] for p in qs.split("&") if p
            )
            if set(params) - {"shards"}:
                return None  # explain/profile/proto knobs: worker path
            raw_shards = params.get("shards", "")
            if raw_shards:
                try:
                    shards = [
                        int(s) for s in raw_shards.split(",") if s != ""
                    ]
                except ValueError:
                    return None  # malformed scope: worker owns the 4xx
        # content negotiation: the cache holds JSON bytes — protobuf
        # requests/accepts take the worker path (http.py _wants_proto)
        if "protobuf" in headers.get("content-type", "") or (
            "protobuf" in headers.get("accept", "")
        ):
            return None
        t0 = time.perf_counter()
        try:
            pql = body.decode()
        except UnicodeDecodeError:
            return None
        entry = cache.lookup_pql(self.api, index, pql, shards)
        if entry is None:
            return None
        close = "close" in headers.get("connection", "").lower()
        head = (
            "HTTP/1.1 200 OK\r\n"
            f"Server: pilosa-tpu/{__version__}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {entry.nbytes}\r\n"
            + ("Connection: close\r\n" if close else "")
            + "\r\n"
        ).encode()
        writer.write(head + entry.body)
        try:
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            return False
        elapsed = time.perf_counter() - t0
        self.stats.count("queries_served", tags={"path": "cache"})
        self._settle_cached(index, pql, shards, elapsed, entry.nbytes,
                            arrival)
        return not close

    def _settle_cached(self, index: str, pql: str,
                       shards: list[int] | None, elapsed: float,
                       nbytes: int, arrival: float | None) -> None:
        """Observability settle for a loop-served hit: the workload
        plane and flight recorder must see cached serves too, or the
        measured hit rate and the heavy-hitter ranks would go dark for
        exactly the hottest traffic.  Spill is skipped (file I/O has no
        place on the loop thread); the in-memory capture ring still
        records."""
        wl = getattr(self, "workload", None)
        fp = None
        if wl is not None and wl.enabled:
            fp, call_type = wl.fingerprint(index, pql, shards)
            wl.record(
                index, pql, fp, call_type, elapsed, 200, nbytes,
                route="cache", stamp=self.api.mutation_stamp(index),
                arrival=arrival, shards=shards, spill=False,
            )
            wl.record_cache_hit(fp)
        rec = getattr(self, "flightrec", None)
        if rec is not None and rec.enabled:
            call_type = pql.split("(", 1)[0].strip() or "?"

            def entry() -> dict:
                out = {
                    "index": index,
                    "query": pql[:500],
                    "node": self.node_id,
                    "resultCache": {"outcome": "hit"},
                }
                if fp is not None:
                    out["fingerprint"] = fp
                return out

            rec.settle(call_type, elapsed, entry)

    async def _admit_and_dispatch(self, writer, cls: str,
                                  raw: bytes, deadline,
                                  arrival: float | None = None) -> bool:
        """Admission control + worker hand-off.  Returns False when the
        connection must close."""
        adm = self._admission[cls]
        if (
            cls == _CLASS_WRITE
            and self.compaction_max_debt > 0
            and self.compaction_debt is not None
            and self.compaction_debt() > self.compaction_max_debt
        ):
            self._reject("compaction_debt")
            # the write path is ahead of compaction capacity: shed the
            # write at the door (429, keep-alive intact — the body was
            # fully consumed) instead of letting ops logs and crash-
            # replay time grow without bound (docs/durability.md)
            await self._write_simple(
                writer, 429,
                "compaction debt exceeds compaction-max-debt; retry",
                retry_after="1", close=False,
            )
            return True
        if adm.depth > 0 and adm.waiting >= adm.depth:
            self._reject("queue_full")
            # bounded queues are the backpressure contract: shed load
            # HERE with a Retry-After hint instead of queueing into
            # deadline exhaustion (docs/serving.md); keep-alive survives
            # — the body was fully consumed, framing is intact
            await self._write_simple(
                writer, 429,
                f"admission queue full for {cls} requests; retry",
                retry_after="1", close=False,
            )
            return True
        self.stats.observe(
            "admission_queue_depth", float(adm.waiting), tags={"class": cls}
        )
        adm.waiting += 1
        t0 = time.monotonic()
        try:
            await adm.sem.acquire()
        finally:
            adm.waiting -= 1
        wait_s = time.monotonic() - t0
        self.stats.timing(
            "admission_wait_seconds", wait_s, tags={"class": cls},
        )
        adm.in_flight += 1
        try:
            if deadline is not None and deadline.expired():
                # the labeled 504 (docs/fault-tolerance.md): the budget
                # died in the admission queue — never execute
                self._reject("deadline")
                await self._write_simple(
                    writer, 504,
                    f"query deadline exceeded ({deadline.budget_s * 1e3:.0f}ms "
                    "budget exhausted in admission queue)",
                    close=False,
                )
                return True
            loop = asyncio.get_running_loop()
            # the worker may ship bytes straight to the socket ONLY when
            # nothing is queued in the transport: drain() waits for the
            # high-water mark, not empty, so a slow-reading client can
            # leave a prior response's tail buffered — a direct send then
            # would interleave behind-the-transport bytes on the wire.
            # Checked here (loop thread) and monotone: the loop never
            # writes during BUSY, so an empty buffer stays empty.
            direct_ok = (
                self.ssl_context is None
                and writer.transport.get_write_buffer_size() == 0
            )
            payload, close = await loop.run_in_executor(
                self._pool, self._run_request, raw, writer, deadline,
                direct_ok, wait_s, arrival,
            )
        finally:
            adm.in_flight -= 1
            adm.sem.release()
        if payload:
            # remainder the worker's direct send couldn't ship (full
            # socket buffer, or the TLS path): the transport owns the
            # backpressure from here
            writer.write(payload)
            await writer.drain()
        return not close

    def _run_request(self, raw: bytes, writer, deadline,
                     direct_ok: bool = False,
                     admission_wait: float | None = None,
                     arrival: float | None = None) -> tuple[bytes, bool]:
        """Worker-thread half: run the buffered request through the
        route table; returns (unsent response bytes, close_connection).

        Plaintext responses are shipped straight from the worker with a
        single non-blocking send: the client's reply must not wait on
        an event-loop wakeup (~0.5ms of cross-thread signaling on a
        busy host) — the loop's own resume overlaps the client's next
        request instead.  Safe because exactly one writer touches a
        connection while a request is dispatched (the loop never writes
        during BUSY, the sweeper skips BUSY), and ``direct_ok`` is set
        only when the loop saw the transport buffer EMPTY at dispatch —
        a slow-reading client with a prior response's tail still queued
        gets its reply through the transport, in order.  Whatever the
        socket buffer cannot take — and the whole payload on TLS
        connections, where the transport owns the record layer —
        returns to the loop."""
        peer = writer.get_extra_info("peername") or ("", 0)
        try:
            h = _BufferedHandler(self, raw, peer, deadline, admission_wait,
                                 arrival)
            out = h.wfile.getvalue()
            close = h.close_connection
            if not out:
                out, close = (
                    self._plain_error(500, "handler produced no response"),
                    True,
                )
        except Exception as e:  # pilosa: allow(broad-except) — last-resort
            # mapping: Handler._guarded catches handler errors, so only
            # parser/shim bugs land here; they must cost one 500, not a
            # silently dropped connection
            self.log(f"buffered handler error: {e!r}")
            out, close = self._plain_error(500, f"internal: {e!r}"), True
        if direct_ok:
            sock = writer.get_extra_info("socket")
            if sock is not None:
                try:
                    sent = os.write(sock.fileno(), out)
                    out = out[sent:]
                except (BlockingIOError, InterruptedError):
                    pass  # kernel buffer full: the loop ships the rest
                except (OSError, ValueError):
                    return b"", True  # client went away; loop closes
        return out, close

    # ------------------------------------------------------------ responses
    @staticmethod
    def _plain_error(code: int, message: str) -> bytes:
        import json as _json

        body = _json.dumps({"error": message}).encode()
        head = (
            f"HTTP/1.1 {code} {_REASONS.get(code, 'Error')}\r\n"
            f"Server: pilosa-tpu/{__version__}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode()
        return head + body

    async def _write_simple(self, writer, code: int, message: str,
                            retry_after: str | None = None,
                            close: bool = False) -> None:
        import json as _json

        body = _json.dumps({"error": message}).encode()
        lines = [
            f"HTTP/1.1 {code} {_REASONS.get(code, 'Error')}",
            f"Server: pilosa-tpu/{__version__}",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}",
        ]
        if retry_after is not None:
            lines.append(f"Retry-After: {retry_after}")
        if close:
            lines.append("Connection: close")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        try:
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass


_REASONS = {
    400: "Bad Request",
    408: "Request Timeout",
    414: "URI Too Long",
    429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error",
    501: "Not Implemented",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}


class _Admission:
    """One admission class: a concurrency semaphore (slots = worker
    threads reserved for the class) plus a bounded wait queue counted by
    ``waiting``.  All state is touched only from the event loop, so no
    lock is needed."""

    __slots__ = ("sem", "limit", "depth", "waiting", "in_flight")

    def __init__(self, limit: int, depth: int):
        self.sem = asyncio.Semaphore(limit)
        self.limit = limit
        self.depth = depth
        self.waiting = 0
        self.in_flight = 0
