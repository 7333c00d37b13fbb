"""Internal node→node HTTP client — the data-plane communication backend.

Reference: pilosa_tpu/parallel/client.py (after http/client.go:
InternalClient: QueryNode, Import, ImportRoaring, FragmentBlocks,
BlockData, RetrieveShardFromURI, SendMessage). JSON bodies (with base64
roaring payloads for bitmap data) over HTTP; every call takes the peer's
base URI so one client serves all peers. Host code only: the legs it
carries run on each peer's own card.
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
import time
from urllib.parse import urlsplit

from pilosa_tpu_torch.utils import tracing
from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER


class PeerError(RuntimeError):
    """A node→node RPC failed.  ``status`` carries the HTTP status code
    when the peer answered with one (None for transport-level failures
    — refused/reset/timeout), so callers classify structurally instead
    of string-matching the message."""

    def __init__(self, uri: str, detail: str, status: int | None = None,
                 retry_after: float | None = None):
        super().__init__(f"peer {uri}: {detail}")
        self.uri = uri
        self.status = status
        # parsed Retry-After seconds on a 429/503 backpressure answer
        self.retry_after = retry_after

    @property
    def retryable(self) -> bool:
        """Safe to retry/fail over: transport failures and server-side
        5xx are transient by classification; a 4xx is a permanent
        request error that every replica would refuse identically.
        (429 backpressure is 4xx by design: an immediate in-query retry
        against an admission-full peer is exactly the herd the 429 is
        shedding — see ``backpressure``.)"""
        return self.status is None or self.status >= 500

    @property
    def backpressure(self) -> bool:
        """The peer is alive but shedding load (HTTP 429 from its
        admission queue): not retryable in-query, and NOT a breaker
        failure — a healthy-but-busy peer must not be dead-marked."""
        return self.status == 429


class BreakerOpenError(PeerError):
    """Fast-fail from an OPEN circuit breaker: no round trip was made.
    Retryable by classification — the CLUSTER layer fails the leg over
    to a replica (the per-peer retry loop never re-attempts an open
    peer; the breaker gate runs before every attempt)."""

    def __init__(self, uri: str, detail: str):
        super().__init__(uri, detail, status=None)


class _ConnectionPool:
    """Keep-alive ``http.client`` connections per peer URI.

    The fan-out RPC path used to pay a fresh TCP (+TLS) setup per call
    (urlopen); under the event-driven front end every peer holds its
    connections open, so node→node RPCs reuse a small per-peer pool
    instead.  Idle connections are reaped after ``idle_ttl_s`` —
    comfortably below the server's keepalive-idle-s default (75s), so
    the client discards before the server does and stale-socket races
    stay rare.  Thread-safe; connections are checked out exclusively."""

    __slots__ = ("max_idle_per_peer", "idle_ttl_s", "_lock", "_idle")

    def __init__(self, max_idle_per_peer: int = 8, idle_ttl_s: float = 30.0):
        self.max_idle_per_peer = max_idle_per_peer
        self.idle_ttl_s = idle_ttl_s
        self._lock = threading.Lock()
        self._idle: dict[str, list[tuple[http.client.HTTPConnection, float]]] = {}

    def acquire(self, uri: str) -> http.client.HTTPConnection | None:
        """A pooled live-ish connection for the peer, or None (caller
        dials fresh).  Stale entries are closed on the way past."""
        now = time.monotonic()
        with self._lock:
            bucket = self._idle.get(uri)
            stale: list[http.client.HTTPConnection] = []
            conn = None
            while bucket:
                cand, last = bucket.pop()
                if now - last > self.idle_ttl_s:
                    stale.append(cand)
                    continue
                conn = cand
                break
        for c in stale:
            c.close()
        return conn

    def release(self, uri: str, conn: http.client.HTTPConnection) -> None:
        overflow = None
        with self._lock:
            bucket = self._idle.setdefault(uri, [])
            if len(bucket) >= self.max_idle_per_peer:
                overflow = conn
            else:
                bucket.append((conn, time.monotonic()))
        if overflow is not None:
            overflow.close()

    def evict(self, uri: str) -> int:
        """Close and drop every idle connection for a peer — called on
        transport-level failure (the sibling sockets are likely just as
        dead) and when the peer's circuit breaker opens."""
        with self._lock:
            bucket = self._idle.pop(uri, [])
        for conn, _ in bucket:
            conn.close()
        return len(bucket)

    def close(self) -> None:
        with self._lock:
            buckets, self._idle = list(self._idle.values()), {}
        for bucket in buckets:
            for conn, _ in bucket:
                conn.close()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {uri: len(b) for uri, b in self._idle.items() if b}


class InternalClient:
    def __init__(self, timeout: float = 30.0, skip_verify: bool = False):
        self.timeout = timeout
        # reference: tls.skip-verify — trust self-signed peer certs on the
        # node→node data plane. The context is built lazily so plain-HTTP
        # clusters never import ssl.
        self.skip_verify = skip_verify
        self._ssl_ctx = None
        self._pool = _ConnectionPool()

    def _context(self, uri: str):
        if not (self.skip_verify and uri.startswith("https:")):
            return None
        if self._ssl_ctx is None:
            import ssl

            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            self._ssl_ctx = ctx
        return self._ssl_ctx

    def evict_peer(self, uri: str) -> None:
        """Drop the peer's pooled connections (resilience layer calls
        this when the peer's circuit breaker opens — a fast-failed peer
        must reconnect from scratch once it recovers)."""
        self._pool.evict(uri)

    def close(self) -> None:
        self._pool.close()

    def _dial(self, uri: str, timeout: float) -> http.client.HTTPConnection:
        parts = urlsplit(uri)
        host = parts.hostname or ""
        if parts.scheme == "https":
            import ssl  # noqa: F401 — context may come from _context()

            return http.client.HTTPSConnection(
                host, parts.port, timeout=timeout, context=self._context(uri)
            )
        return http.client.HTTPConnection(host, parts.port, timeout=timeout)

    def _request(
        self,
        method: str,
        uri: str,
        path: str,
        body: bytes | None = None,
        timeout: float | None = None,
        content_type: str = "application/json",
    ) -> bytes:
        # deferred import: resilience imports this module at load time
        from pilosa_tpu_torch.parallel import resilience

        headers: dict[str, str] = {}
        if body is not None:
            headers["Content-Type"] = content_type
        # per-query deadline budget: cap the socket timeout at the
        # remaining budget and forward it (decremented by construction —
        # the header always carries what is LEFT at send time) so the
        # receiving hop bounds its own work to the same promise
        deadline = resilience.current_deadline()
        if deadline is not None:
            rem = deadline.remaining()
            if rem <= 0:
                raise deadline.exceeded(f"RPC to {uri}{path}")
            timeout = min(self.timeout if timeout is None else timeout, rem)
            headers[resilience.DEADLINE_HEADER] = str(int(rem * 1e3))
        # trace propagation (Inject): the receiving node's spans join the
        # caller's trace and parent onto the span active on this thread
        ctx = GLOBAL_TRACER.current_context()
        if ctx is not None:
            headers[tracing.TRACE_HEADER] = ctx[0]
            if ctx[1]:
                headers[tracing.PARENT_HEADER] = ctx[1]
        t = self.timeout if timeout is None else timeout
        # one transparent redial on a stale pooled socket, and only for
        # GETs: a POSTed write re-sent after an ambiguous failure could
        # be a duplicated write — non-idempotent requests surface the
        # PeerError and let the resilience layer decide
        attempts = 2 if method == "GET" else 1
        for attempt in range(attempts):
            conn = self._pool.acquire(uri)
            reused = conn is not None
            if conn is None:
                conn = self._dial(uri, t)
            else:
                conn.timeout = t
                if conn.sock is not None:
                    conn.sock.settimeout(t)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                will_close = resp.will_close
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if reused and attempt + 1 < attempts:
                    # stale keep-alive socket (server reaped it between
                    # calls): the sibling pool entries are suspect too
                    self._pool.evict(uri)
                    continue
                if not reused:
                    # fresh-dial failure: the peer itself is unhealthy —
                    # drop any idle siblings so recovery reconnects clean
                    self._pool.evict(uri)
                raise PeerError(uri, str(e)) from e
            if will_close:
                conn.close()
            else:
                self._pool.release(uri, conn)
            if status >= 400:
                retry_after = None
                raw_ra = resp.getheader("Retry-After")
                if raw_ra is not None:
                    try:
                        retry_after = float(raw_ra)
                    except ValueError:
                        retry_after = None
                raise PeerError(
                    uri,
                    f"HTTP {status}: {data.decode(errors='replace')}",
                    status=status,
                    retry_after=retry_after,
                )
            prof = tracing.current_profile()
            if prof is not None:
                prof.note_rpc_bytes(len(data))
            return data
        raise AssertionError("unreachable: request loop exits via return/raise")

    def _json(
        self,
        method: str,
        uri: str,
        path: str,
        body: dict | None = None,
        timeout: float | None = None,
    ) -> dict:
        payload = json.dumps(body).encode() if body is not None else None
        return json.loads(
            self._request(method, uri, path, payload, timeout=timeout) or b"{}"
        )

    # ------------------------------------------------------------ queries
    def query_node(
        self, uri: str, index: str, pql: str, shards: list[int] | None
    ) -> list:
        """Execute PQL on a peer restricted to given shards; returns the
        DECODED typed results (reference: InternalClient.QueryNode).
        Peers respond framed (JSON control + raw packed-word blobs, see
        encoding/frame.py); the JSON branch below exists for test
        doubles and non-cluster servers, not version skew — the
        internal wire assumes a uniform-version cluster."""
        from pilosa_tpu_torch.encoding import frame
        from pilosa_tpu_torch.parallel.resultwire import decode_result

        raw = self._request(
            "POST",
            uri,
            "/internal/query",
            json.dumps(
                {"index": index, "query": pql, "shards": shards}
            ).encode(),
        )
        if frame.is_frame(raw):
            control, blobs = frame.decode_frame(raw)
            return [decode_result(d, blobs) for d in control["results"]]
        return [decode_result(d) for d in json.loads(raw)["results"]]

    def query_batch_node(self, uri: str, entries: list[dict]) -> list:
        """Several fan-out legs to ONE peer as a single multi-query RPC
        (POST /internal/query/batch) — the cross-query wave scheduler's
        cluster half: wave-mates targeting the same remote node pay one
        HTTP round trip instead of one each.  Each entry carries its own
        ``traceId``/``parentSpanId`` (one request cannot carry N header
        contexts), so per-query trace propagation survives coalescing.
        Returns one element per entry: the decoded result list, or a
        PeerError instance for entries the peer failed (per-entry error
        isolation — one bad query must not fail its RPC-mates)."""
        from pilosa_tpu_torch.encoding import frame
        from pilosa_tpu_torch.parallel.resultwire import decode_result

        raw = self._request(
            "POST",
            uri,
            "/internal/query/batch",
            json.dumps({"queries": entries}).encode(),
        )
        if frame.is_frame(raw):
            control, blobs = frame.decode_frame(raw)
        else:
            control, blobs = json.loads(raw), []
        out: list = []
        for ent in control["queries"]:
            if "error" in ent:
                out.append(PeerError(uri, ent["error"]))
            else:
                out.append([decode_result(d, blobs) for d in ent["results"]])
        return out

    def fetch_trace(self, uri: str, trace_id: str) -> list[dict]:
        """One trace's spans buffered on a peer (GET /internal/trace) —
        the coordinator stitches them under its own spans for export."""
        resp = self._json("GET", uri, f"/internal/trace?trace_id={trace_id}")
        return resp.get("spans", [])

    def node_shards(self, uri: str, index: str) -> list[int]:
        resp = self._json("GET", uri, f"/internal/shards?index={index}")
        return resp["shards"]

    def status(self, uri: str, timeout: float | None = None) -> dict:
        """Liveness probe; callers pass a short timeout so a hung peer
        doesn't stall heartbeats for the full data-plane timeout."""
        return self._json("GET", uri, "/status", timeout=timeout)

    # ------------------------------------------------------------ imports
    def import_node(
        self, uri: str, index: str, field: str, payload: dict, values: bool
    ) -> list[str]:
        """Deliver one shard slice; returns the URIs that APPLIED it (the
        receiver may have re-forwarded to the current owners). The fat id
        vectors travel as raw u64 blobs (framed; see encoding/frame.py) —
        a wide import fan-out pays 8 bytes/column, not JSON int text."""
        from pilosa_tpu_torch.encoding import frame

        control = dict(payload)
        blobs: list[bytes] = []
        for key in ("columnIDs", "rowIDs"):
            v = control.get(key)
            if v is not None and len(v):
                control[f"{key}Bin"] = len(blobs)
                blobs.append(frame.pack_u64(control.pop(key)))
        vals = control.get("values") if values else None
        if vals is not None and len(vals):
            control["valuesBin"] = len(blobs)
            # values are SIGNED ints (BSI fields)
            import numpy as np

            blobs.append(np.asarray(control.pop("values"), np.int64).tobytes())
        kind = "import-value" if values else "import"
        raw = self._request(
            "POST",
            uri,
            f"/internal/{kind}/{index}/{field}",
            frame.encode_frame(control, blobs),
            content_type=frame.CONTENT_TYPE,
        )
        resp = json.loads(raw or b"{}")
        applied = resp.get("appliedBy") if isinstance(resp, dict) else None
        return applied if isinstance(applied, list) else [uri]

    def import_roaring(
        self, uri: str, index: str, field: str, view: str, shard: int, data: bytes
    ) -> None:
        """Deliver one serialized roaring frame to ONE node (the
        internal node-local route): the replica fan-out and the resize
        handoff both stream the SAME frame bytes here per owner — the
        receiver applies locally, never re-fans-out (the public
        import-roaring route is the one that fans out)."""
        self._request(
            "POST",
            uri,
            f"/internal/import-roaring/{index}/{field}/{shard}?view={view}",
            data,
        )

    # ------------------------------------------------------- anti-entropy
    def fragment_blocks(
        self, uri: str, index: str, field: str, view: str, shard: int
    ) -> dict[int, str]:
        """block id → checksum hex (reference: FragmentBlocks)."""
        resp = self._json(
            "GET",
            uri,
            f"/internal/fragment/blocks?index={index}&field={field}"
            f"&view={view}&shard={shard}",
        )
        return {int(b["block"]): b["checksum"] for b in resp["blocks"]}

    def block_data(self, uri: str, index: str, field: str, view: str,
                   shard: int, block: int):
        """One AE block's (rows, cols) pairs — framed raw u64 arrays
        (JSON branch: test doubles / non-cluster servers only)."""
        from pilosa_tpu_torch.encoding import frame

        raw = self._request(
            "GET",
            uri,
            f"/internal/fragment/block/data?index={index}&field={field}"
            f"&view={view}&shard={shard}&block={block}",
        )
        if frame.is_frame(raw):
            control, blobs = frame.decode_frame(raw)
            if not control.get("n"):
                return [], []
            return frame.unpack_u64(blobs[0]), frame.unpack_u64(blobs[1])
        resp = json.loads(raw)
        return resp["rows"], resp["cols"]

    def set_attrs(self, uri: str, payload: dict) -> None:
        """Apply a coordinator-timestamped attr write on a peer."""
        self._json("POST", uri, "/internal/attrs/set", payload)

    def attr_blocks(self, uri: str, index: str, field: str | None) -> dict[int, str]:
        """Attr-store block id → checksum hex; field=None targets the
        index's column attrs (reference: attr block sync)."""
        path = f"/internal/attrs/blocks?index={index}"
        if field:
            path += f"&field={field}"
        resp = self._json("GET", uri, path)
        return {int(b["block"]): b["checksum"] for b in resp["blocks"]}

    def attr_block_data(
        self, uri: str, index: str, field: str | None, block: int
    ) -> dict[int, dict]:
        path = f"/internal/attrs/block/data?index={index}&block={block}"
        if field:
            path += f"&field={field}"
        resp = self._json("GET", uri, path)
        return {int(k): v for k, v in resp["attrs"].items()}

    def retrieve_fragment(
        self, uri: str, index: str, field: str, view: str, shard: int
    ) -> bytes:
        """Full fragment contents as serialized roaring (reference:
        RetrieveShardFromURI)."""
        raw = self._request(
            "GET",
            uri,
            f"/internal/fragment/data?index={index}&field={field}"
            f"&view={view}&shard={shard}",
        )
        return raw

    def fragment_inventory(
        self, uri: str, index: str, checksums: bool = False
    ) -> list[dict]:
        """[{field, view, shard}] a peer holds for an index;
        ``checksums=True`` adds each fragment's serialized-frame content
        digest (the movement convergence witness — docs/resize.md)."""
        path = f"/internal/fragment/inventory?index={index}"
        if checksums:
            path += "&checksums=1"
        resp = self._json("GET", uri, path)
        return resp["fragments"]

    def internal_status(self, uri: str) -> dict:
        """Data-plane status: cluster state plus the per-fragment
        content-checksum map — what anti-entropy and the resize bench
        compare across owners to PROVE convergence (docs/resize.md)."""
        return self._json("GET", uri, "/internal/status")

    # ------------------------------------------------------- translation
    def translate_entries(
        self,
        uri: str,
        index: str,
        field: str | None,
        offset: int,
        holes: list[int] | None = None,
    ) -> list[tuple[str, int]]:
        """``holes`` lists ids ≤ offset the caller lacks (fork
        vacancies); the sender includes its bindings for them — an
        `id > offset` scan can never re-deliver those. Hole ids travel
        in the query string, CHUNKED: a mass displacement could
        otherwise exceed the server's request-line limit and fail the
        tail permanently. Extra chunks use an offset past any real id so
        only the requested holes come back."""
        entries, _sh = self.translate_tail(uri, index, field, offset, holes)
        return entries

    def translate_tail(
        self,
        uri: str,
        index: str,
        field: str | None,
        offset: int,
        holes: list[int] | None = None,
    ) -> tuple[list[tuple[str, int]], list[int]]:
        """Full tailing answer: (entries, sender_holes) — the sender's
        own known vacancies, for the puller to adopt."""
        no_tail = 1 << 62  # ids allocate densely from 1; never reached

        def fetch(off: int, hs: list[int]):
            path = f"/internal/translate/data?index={index}&offset={off}"
            if field:
                path += f"&field={field}"
            if hs:
                path += "&holes=" + ",".join(str(i) for i in hs)
            resp = self._json("GET", uri, path)
            return (
                [(e["k"], e["id"]) for e in resp["entries"]],
                resp.get("senderHoles", []),
            )

        chunk = 512
        holes = list(holes or ())
        entries, sender_holes = fetch(offset, holes[:chunk])
        for lo in range(chunk, len(holes), chunk):
            # hole ids are ≤ the caller's watermark ≤ no_tail, so the
            # sender's `i <= offset` guard admits every requested id
            e2, _sh2 = fetch(no_tail, holes[lo : lo + chunk])
            entries.extend(e2)
        return entries, sender_holes

    # --------------------------------------------------------- broadcast
    def remove_node(self, uri: str, node_id: str, node_uri: str | None = None) -> None:
        self._json(
            "POST",
            uri,
            "/internal/cluster/resize/remove-node",
            {"id": node_id, "uri": node_uri, "broadcast": False},
        )

    def send_schema(self, uri: str, schema: dict) -> None:
        """Peer schema sync; the internal route skips create-time name
        validation so replication of pre-validation names never fails."""
        self._json("POST", uri, "/internal/schema/apply", schema)


def encode_words_b64(words) -> str:
    import numpy as np

    return base64.b64encode(np.asarray(words, dtype=np.uint32).tobytes()).decode()


def decode_words_b64(data: str):
    import numpy as np

    return np.frombuffer(base64.b64decode(data), dtype=np.uint32).copy()
