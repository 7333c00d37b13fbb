"""Client-side bulk loader — the wire-speed ingest lane's front half
(docs/ingest.md). Reference: pilosa_tpu/loader.py; the frames are its
bytes (the port's ``roaring.build`` is a copy of its builders).

Reads CSV / JSONL (= NDJSON) bit records, partitions them by shard,
builds serialized roaring container payloads with the vectorized
builders in ``roaring/build.py`` (sort → shard-split → columnar
container passes — never a per-bit ``Set``), and streams the frames to
``POST /index/{i}/field/{f}/import-roaring/{shard}`` over a bounded
pipeline of keep-alive connections, honoring the server's 429 /
Retry-After compaction-debt admission gate (the retry IS the protocol:
the server sheds load when durability can't keep up, the loader paces
itself to it).

Used by ``python -m pilosa_tpu_torch import --roaring``; the public
entry points are ``parse_records`` and ``bulk_load``.
"""

from __future__ import annotations

import http.client
import json
import queue
import threading
import time
import urllib.parse

import numpy as np

from pilosa_tpu_torch.roaring import build as roaring_build
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

# positions per frame: bounds client memory and per-POST latency while
# keeping the per-request overhead (HTTP round trip + WAL append +
# barrier) amortized over ~a shard's worth of bits
DEFAULT_BATCH_BITS = 1 << 20
DEFAULT_PIPELINE = 4
MAX_RETRIES_429 = 64  # a wedged compactor fails loudly, eventually


class LoaderError(RuntimeError):
    pass


def detect_format(path: str) -> str:
    """File-extension format sniff: .csv → csv, .jsonl/.ndjson/.json →
    jsonl; anything else defaults to csv (the reference importer's
    format)."""
    p = path.lower()
    if p.endswith((".jsonl", ".ndjson", ".json")):
        return "jsonl"
    return "csv"


def parse_records(lines, fmt: str = "csv") -> tuple[np.ndarray, np.ndarray]:
    """Parse bit records into (rows, cols) uint64 vectors.

    csv: ``rowID,columnID`` per line (extra columns ignored — the
    timestamp column of the reference's import format is not part of
    the roaring lane, which writes the standard view only).
    jsonl/ndjson: one object per line; keys ``rowID``/``row`` and
    ``columnID``/``col``/``column`` accepted."""
    rows: list[int] = []
    cols: list[int] = []
    if fmt in ("jsonl", "ndjson"):
        for line in lines:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            r = obj.get("rowID", obj.get("row"))
            c = obj.get("columnID", obj.get("col", obj.get("column")))
            if r is None or c is None:
                raise LoaderError(
                    f"jsonl record missing rowID/columnID: {line[:80]!r}"
                )
            rows.append(int(r))
            cols.append(int(c))
    elif fmt == "csv":
        for line in lines:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) < 2:
                raise LoaderError(f"csv record needs rowID,columnID: {line!r}")
            rows.append(int(parts[0]))
            cols.append(int(parts[1]))
    else:
        raise LoaderError(f"unknown format {fmt!r} (csv|jsonl|ndjson)")
    return (
        np.asarray(rows, dtype=np.uint64),
        np.asarray(cols, dtype=np.uint64),
    )


def build_frames(
    rows: np.ndarray,
    cols: np.ndarray,
    batch_bits: int = DEFAULT_BATCH_BITS,
    shard_width: int = SHARD_WIDTH,
) -> list[tuple[int, bytes, int]]:
    """(rows, cols) → ``[(shard, frame_bytes, n_bits), ...]`` via the
    no-sort columnar builder (roaring/build.py:shard_payloads). The
    input is pre-sliced to ``batch_bits`` records so one POST never
    carries more than that many positions (bounds client memory and
    per-request latency)."""
    rows = np.asarray(rows, dtype=np.uint64)
    cols = np.asarray(cols, dtype=np.uint64)
    out: list[tuple[int, bytes, int]] = []
    for i in range(0, max(cols.size, 1), batch_bits):
        out.extend(
            roaring_build.shard_payloads(
                rows[i : i + batch_bits],
                cols[i : i + batch_bits],
                shard_width,
            )
        )
    return out


class _Conn:
    """One keep-alive connection to the target host with transparent
    single-redial (the server reaps idle keep-alives; a long build gap
    between posts must not fail the batch)."""

    def __init__(self, base_uri: str, timeout: float, ssl_context=None):
        u = urllib.parse.urlsplit(base_uri)
        self.https = u.scheme == "https"
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if self.https else 80)
        self.timeout = timeout
        self.ssl_context = ssl_context
        self._conn = None

    def _connect(self):
        if self.https:
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout,
                context=self.ssl_context,
            )
        return http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )

    def post(self, path: str, body: bytes) -> tuple[int, bytes, str | None]:
        """POST with one transparent redial on a dead keep-alive socket.
        Returns (status, body, retry_after)."""
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = self._connect()
            try:
                self._conn.request(
                    "POST", path, body,
                    headers={"Content-Type": "application/octet-stream"},
                )
                resp = self._conn.getresponse()
                data = resp.read()
                return resp.status, data, resp.headers.get("Retry-After")
            except (OSError, http.client.HTTPException):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None


def stream_load(
    base_uri: str,
    index: str,
    field: str,
    batches,
    *,
    view: str = "standard",
    pipeline: int = DEFAULT_PIPELINE,
    batch_bits: int = DEFAULT_BATCH_BITS,
    timeout: float = 60.0,
    ssl_context=None,
    shard_width: int = SHARD_WIDTH,
    stop=None,
) -> dict:
    """The sustained-ingest pipeline: ``batches`` yields (rows, cols)
    vector pairs; the calling thread BUILDS per-shard roaring frames
    (the vectorized columnar passes) while ``pipeline`` keep-alive
    workers STREAM already-built frames concurrently — construction and
    delivery overlap, so sustained throughput is bounded by the slower
    half, not their sum. The bounded queue applies backpressure to the
    builder when the server is the constraint.

    Returns a stats dict: bits/bytes/posts delivered, elapsed seconds
    (covering build AND delivery), sustained Mbit/s (million set bits
    per second), and 429-backoff counts. Every frame is either
    delivered (2xx after the server's durability barrier) or the load
    raises — no silent partial success; 429s back off per the server's
    Retry-After and retry the SAME frame (idempotent: the adopt is a
    union). ``stop`` (an optional ``threading.Event``) ends the load
    cleanly between batches — the bench's timed-phase cutoff."""
    work: queue.Queue = queue.Queue(maxsize=max(4, 4 * pipeline))
    n_workers = max(1, pipeline)
    errors: list[BaseException] = []
    stats_lock = threading.Lock()
    stats = {"bits": 0, "bytes": 0, "posts": 0, "backoffs429": 0, "frames": 0}
    path_base = f"/index/{index}/field/{field}/import-roaring"
    _DONE = object()

    def worker() -> None:
        conn = _Conn(base_uri, timeout, ssl_context)
        try:
            while True:
                item = work.get()
                if item is _DONE:
                    return
                if errors:
                    continue  # drain so the producer never blocks
                shard, frame, n_bits = item
                path = f"{path_base}/{shard}?view={view}"
                for _retry in range(MAX_RETRIES_429):
                    status, body, retry_after = conn.post(path, frame)
                    if status == 429:
                        # compaction-debt admission gate: the server is
                        # protecting crash-replay time — wait as told
                        with stats_lock:
                            stats["backoffs429"] += 1
                        try:
                            delay = float(retry_after or 0.1)
                        except ValueError:
                            delay = 0.1
                        time.sleep(min(max(delay, 0.01), 5.0))
                        continue
                    if status != 200:
                        raise LoaderError(
                            f"import-roaring shard {shard}: HTTP {status} "
                            f"{body[:200]!r}"
                        )
                    break
                else:
                    raise LoaderError(
                        f"import-roaring shard {shard}: still 429 after "
                        f"{MAX_RETRIES_429} backoffs (compactor wedged?)"
                    )
                with stats_lock:
                    stats["bits"] += n_bits
                    stats["bytes"] += len(frame)
                    stats["posts"] += 1
        except BaseException as e:  # noqa: BLE001 — re-raised by the caller
            errors.append(e)
            # keep draining until the sentinel: with every worker dead a
            # bounded-queue put in the producer would deadlock otherwise
            while work.get() is not _DONE:
                pass
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=worker, daemon=True, name=f"bulk-load_{i}")
        for i in range(n_workers)
    ]
    for t in threads:
        t.start()
    try:
        for rows, cols in batches:
            if errors or (stop is not None and stop.is_set()):
                break
            for shard, frame, n_bits in build_frames(
                rows, cols, batch_bits, shard_width
            ):
                stats["frames"] += 1
                work.put((shard, frame, n_bits))
    finally:
        for _ in threads:
            work.put(_DONE)
        for t in threads:
            t.join()
    elapsed = time.perf_counter() - t0
    if errors:
        raise errors[0]
    stats["seconds"] = round(elapsed, 4)
    stats["mbitSetPerS"] = round(stats["bits"] / max(elapsed, 1e-9) / 1e6, 4)
    stats["pipeline"] = n_workers
    return stats


def bulk_load(
    base_uri: str,
    index: str,
    field: str,
    rows: np.ndarray,
    cols: np.ndarray,
    **kwargs,
) -> dict:
    """One-shot form of ``stream_load`` over a single (rows, cols)
    batch — the CLI's lane."""
    return stream_load(base_uri, index, field, [(rows, cols)], **kwargs)
