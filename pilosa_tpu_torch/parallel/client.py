"""The node→node data plane's error types and word codec.

Reference: pilosa_tpu/parallel/client.py (after http/client.go). The
port serves one node, so of the reference's module it keeps what the
serving path reads: ``PeerError`` and ``BreakerOpenError``, which the
retry and breaker layers (``parallel/resilience.py``) and the fault
injector classify, and the base64 word codec of ``resultwire``. The
``InternalClient`` transport, its connection pool and the fault-injecting
subclass come with the cluster (ROADMAP.md A10).
"""

from __future__ import annotations

import base64


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


def encode_words_b64(words) -> str:
    import numpy as np

    return base64.b64encode(np.asarray(words, dtype=np.uint32).tobytes()).decode()


def decode_words_b64(data: str):
    import numpy as np

    return np.frombuffer(base64.b64decode(data), dtype=np.uint32).copy()
