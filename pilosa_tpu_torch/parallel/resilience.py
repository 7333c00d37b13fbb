"""Resilient RPC layer: retries, circuit breakers, and query deadlines.

The distributed read path treats per-node failure as routine (reference:
cluster.go serves degraded reads from live replicas; arxiv 2112.09017
treats node loss as an expected event at TPU-pod scale).  This module
is the policy half of that stance, wrapped around the raw transport in
``parallel/client.py``:

- ``RetryPolicy`` — capped exponential backoff with FULL jitter
  (delay ~ U(0, min(cap, base·2^attempt))), applied only to idempotent
  RPCs: reads and anti-entropy pulls.  Writes and imports are NEVER
  retried here — a duplicated write is a correctness bug, a duplicated
  read is free.  /status probes are single-shot too: the heartbeat
  cadence is their retry loop.
- ``CircuitBreaker`` — per-peer closed → open → half-open machine: after
  ``threshold`` consecutive failures the peer costs one fast-fail
  (``BreakerOpenError``) instead of a full data-plane timeout per query;
  after ``cooldown`` one trial request probes recovery.  A successful
  /status probe (the heartbeat) closes the breaker from any state, so
  breaker state and heartbeat dead-marks converge on the same verdict.
- ``Deadline`` / ``QueryContext`` — a per-query time budget
  (config ``query-timeout-ms``), carried across fan-out hops in the
  ``X-Pilosa-Deadline-Ms`` header with the REMAINING budget at send
  time, so retries and wave waits can never exceed what the client was
  promised.  Exhaustion raises the labeled ``DeadlineExceededError``
  (HTTP 504), never a generic transport error.
- ``ResilientClient`` — the wrapper every data-plane call site outside
  client.py must route through (the ``resilience`` analyzer rule pins
  this down): read methods retry + pass the breaker gate, write methods
  pass straight through (breaker-observed, never retried, never gated —
  a skipped write owner is silent data loss).

See docs/fault-tolerance.md for operator-facing semantics.
"""

from __future__ import annotations

import random
import threading
import time

from pilosa_tpu_torch.utils import tracing
from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER

# fan-out hops forward the REMAINING budget (milliseconds, integer) in
# this header; the receiving node installs it as its own deadline, so
# each hop's clock only measures its own share (no cross-node clock
# comparison — the header carries a duration, never a timestamp)
DEADLINE_HEADER = "X-Pilosa-Deadline-Ms"

# breaker-state gauge values (stats: breaker_state{peer=...})
BREAKER_CLOSED = 0
BREAKER_HALF_OPEN = 1
BREAKER_OPEN = 2


class DeadlineExceededError(RuntimeError):
    """The per-query time budget ran out (HTTP 504). Distinct from
    transport errors so a deadline cut is never misread as a dead peer."""


class Deadline:
    """Monotonic countdown from a seconds budget."""

    __slots__ = ("budget_s", "_t0", "_clock")

    def __init__(self, budget_s: float, clock=time.monotonic):
        self.budget_s = budget_s
        self._clock = clock
        self._t0 = clock()

    def remaining(self) -> float:
        return self.budget_s - (self._clock() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def exceeded(self, what: str) -> DeadlineExceededError:
        return DeadlineExceededError(
            f"query deadline exceeded ({self.budget_s * 1e3:.0f}ms budget "
            f"exhausted at {what})"
        )


class QueryContext:
    """Per-query resilience state, installed thread-locally for the
    request's duration: the deadline budget, the ``?allow-partial=true``
    opt-in, and the shards a partial-mode query had to skip (surfaced
    as the response's ``partialShards`` annotation)."""

    __slots__ = ("deadline", "allow_partial", "partial_shards")

    def __init__(
        self,
        deadline: Deadline | None = None,
        allow_partial: bool = False,
    ):
        self.deadline = deadline
        self.allow_partial = allow_partial
        self.partial_shards: list[int] = []


_TLS = threading.local()


class _UseContext:
    """Context manager installing a QueryContext on this thread (nested
    installs restore the outer one on exit)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: QueryContext | None):
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_TLS, "query_ctx", None)
        _TLS.query_ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _TLS.query_ctx = self._prev
        return False


def use_query_context(ctx: QueryContext | None) -> _UseContext:
    return _UseContext(ctx)


def current_query_context() -> QueryContext | None:
    return getattr(_TLS, "query_ctx", None)


def current_deadline() -> Deadline | None:
    ctx = current_query_context()
    return ctx.deadline if ctx is not None else None


class RetryPolicy:
    """Capped exponential backoff with full jitter.  ``retries`` counts
    EXTRA attempts after the first (0 disables retries).  The RNG and
    sleep are injectable so the chaos suite drives the policy with a
    seeded RNG and a recording no-op sleep."""

    __slots__ = ("retries", "base_s", "cap_s", "_rng", "_sleep")

    def __init__(
        self,
        retries: int = 2,
        base_s: float = 0.02,
        cap_s: float = 0.5,
        rng: random.Random | None = None,
        sleep=time.sleep,
    ):
        self.retries = max(0, int(retries))
        self.base_s = base_s
        self.cap_s = cap_s
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay before retry number ``attempt + 1``:
        U(0, min(cap, base·2^attempt)) — the AWS-architecture-blog
        shape, which decorrelates a thundering herd of retriers."""
        ceiling = min(self.cap_s, self.base_s * (2.0 ** attempt))
        return self._rng.uniform(0.0, max(0.0, ceiling))

    def sleep(self, seconds: float) -> None:
        self._sleep(seconds)


class CircuitBreaker:
    """Per-peer failure gate: closed (counting consecutive failures) →
    open after ``threshold`` (every gated call fast-fails) → half-open
    after ``cooldown_s`` (exactly ONE trial request passes; success
    closes, failure re-opens for another cooldown).  ``clock`` is
    injectable for deterministic transition tests."""

    __slots__ = ("threshold", "cooldown_s", "_clock", "_lock", "_state",
                 "_fails", "_opened_at", "_probing")

    def __init__(
        self, threshold: int = 3, cooldown_s: float = 5.0, clock=time.monotonic
    ):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._fails = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> int:
        with self._lock:
            if (
                self._state == BREAKER_OPEN
                and self._clock() - self._opened_at >= self.cooldown_s
            ):
                return BREAKER_HALF_OPEN
            return self._state

    def allow(self) -> bool:
        """True when a request may proceed. In half-open, only the first
        caller gets the trial slot until its outcome is recorded."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if (
                self._state == BREAKER_OPEN
                and self._clock() - self._opened_at >= self.cooldown_s
            ):
                self._state = BREAKER_HALF_OPEN
                self._probing = False
            if self._state == BREAKER_HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> int:
        with self._lock:
            self._state = BREAKER_CLOSED
            self._fails = 0
            self._probing = False
            return self._state

    def record_failure(self) -> int:
        with self._lock:
            now = self._clock()
            if self._state == BREAKER_HALF_OPEN:
                # the trial failed: back to open for another cooldown
                self._state = BREAKER_OPEN
                self._opened_at = now
                self._probing = False
            elif self._state == BREAKER_CLOSED:
                self._fails += 1
                if self._fails >= self.threshold:
                    self._state = BREAKER_OPEN
                    self._opened_at = now
            # already open: don't extend the cooldown — ungated probes
            # (status) failing while open must not starve half-open
            return self._state

    def release_trial(self) -> None:
        """Free the half-open trial slot WITHOUT recording an outcome:
        the attempt died locally (e.g. a deadline cut before any socket
        I/O), so the peer's health is unknown — leaking the slot would
        block every future trial until a heartbeat success."""
        with self._lock:
            self._probing = False


class BreakerRegistry:
    """One CircuitBreaker per peer URI, created lazily.  Disabled mode
    (config ``breaker-enabled = false``) hands out a permanently-closed
    no-op so call sites stay branch-free."""

    def __init__(
        self,
        enabled: bool = True,
        threshold: int = 3,
        cooldown_s: float = 5.0,
        clock=time.monotonic,
        stats=None,
    ):
        self.enabled = enabled
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._stats = stats
        self._lock = threading.Lock()
        self._by_uri: dict[str, CircuitBreaker] = {}

    def get(self, uri: str) -> CircuitBreaker | None:
        if not self.enabled:
            return None
        with self._lock:
            br = self._by_uri.get(uri)
            if br is None:
                br = self._by_uri[uri] = CircuitBreaker(
                    self.threshold, self.cooldown_s, clock=self._clock
                )
            return br

    def note(self, uri: str, state: int) -> None:
        """Publish the breaker-state gauge after a transition-capable
        event (0 closed, 1 half-open, 2 open)."""
        if self._stats is not None:
            self._stats.gauge("breaker_state", float(state), tags={"peer": uri})

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            items = list(self._by_uri.items())
        return {uri: br.state for uri, br in items}


class ResilientClient:
    """The one sanctioned wrapper around ``InternalClient`` for
    data-plane call sites (parallel/cluster.py).  Read methods in
    ``RETRYABLE_METHODS`` pass the per-peer breaker gate and retry
    retryable failures under the RetryPolicy (bounded by the current
    query deadline); write methods in ``WRITE_METHODS`` delegate
    straight through — observed by the breaker, never retried, never
    gated.  Everything else (``_json`` control-plane helpers, attrs)
    delegates to the inner client untouched.

    The two method sets are load-bearing: the ``resilience`` analyzer
    rule asserts they stay disjoint and that the canonical write RPCs
    never migrate into the retry scope.
    """

    # idempotent RPCs: reads and anti-entropy pulls. NOT status: the
    # liveness probe is single-shot by design — the heartbeat cadence
    # is its retry loop, and a hung peer must cost one probe timeout
    # before dead-marking, not retries × timeout (the concurrent-probe
    # heartbeat fix would be undone by in-probe retries).
    RETRYABLE_METHODS = frozenset({
        "query_node",
        "query_batch_node",
        "node_shards",
        "fetch_trace",
        "fragment_blocks",
        "block_data",
        "attr_blocks",
        "attr_block_data",
        "retrieve_fragment",
        "fragment_inventory",
        "internal_status",
        "translate_entries",
        "translate_tail",
    })
    # never retried, never breaker-gated (a write must reach every
    # alive owner or fail loudly — fast-failing an owner silently drops
    # its replica)
    WRITE_METHODS = frozenset({
        "query_node_once",
        "import_node",
        "import_roaring",
        "set_attrs",
        "send_schema",
        "remove_node",
    })

    def __init__(self, inner, breakers: BreakerRegistry, policy: RetryPolicy,
                 stats=None):
        self._inner = inner
        self.breakers = breakers
        self.policy = policy
        self._stats = stats

    # -------------------------------------------------- retried reads
    def query_node(self, uri, index, pql, shards):
        return self._call("query_node", uri, index, pql, shards)

    def query_batch_node(self, uri, entries):
        return self._call("query_batch_node", uri, entries)

    def status(self, uri, timeout=None):
        """Single-shot liveness probe: never retried (the heartbeat
        cadence is the retry loop) and never breaker-gated (something
        must be allowed to discover recovery mid-cooldown) — but its
        outcome drives the breaker, so a successful heartbeat closes
        it from any state."""
        return self._single_shot("status", uri, timeout=timeout)

    def node_shards(self, uri, index):
        return self._call("node_shards", uri, index)

    def fetch_trace(self, uri, trace_id):
        return self._call("fetch_trace", uri, trace_id)

    def fragment_blocks(self, uri, index, field, view, shard):
        return self._call("fragment_blocks", uri, index, field, view, shard)

    def block_data(self, uri, index, field, view, shard, block):
        return self._call("block_data", uri, index, field, view, shard, block)

    def attr_blocks(self, uri, index, field):
        return self._call("attr_blocks", uri, index, field)

    def attr_block_data(self, uri, index, field, block):
        return self._call("attr_block_data", uri, index, field, block)

    def retrieve_fragment(self, uri, index, field, view, shard):
        return self._call("retrieve_fragment", uri, index, field, view, shard)

    def fragment_inventory(self, uri, index, checksums=False):
        return self._call("fragment_inventory", uri, index, checksums)

    def internal_status(self, uri):
        return self._call("internal_status", uri)

    def translate_entries(self, uri, index, field, offset, holes=None):
        return self._call("translate_entries", uri, index, field, offset, holes)

    def translate_tail(self, uri, index, field, offset, holes=None):
        return self._call("translate_tail", uri, index, field, offset, holes)

    # ------------------------------------------- pass-through writes
    def query_node_once(self, uri, index, pql, shards):
        """The write fan-out's single-shot query RPC: same wire call as
        query_node, but OUTSIDE the retry scope (a replayed Set/Clear
        is a duplicated write) and outside the breaker gate (skipping a
        write owner silently drops its replica — the write path's
        _probe_alive re-probe is the liveness check).  The breaker still
        observes the outcome."""
        return self._single_shot("query_node", uri, index, pql, shards)

    def import_node(self, uri, index, field, payload, values):
        return self._single_shot("import_node", uri, index, field, payload, values)

    def import_roaring(self, uri, index, field, view, shard, data):
        return self._single_shot("import_roaring", uri, index, field, view, shard, data)

    def set_attrs(self, uri, payload):
        return self._single_shot("set_attrs", uri, payload)

    def send_schema(self, uri, schema):
        return self._single_shot("send_schema", uri, schema)

    def remove_node(self, uri, node_id, node_uri=None):
        return self._single_shot("remove_node", uri, node_id, node_uri)

    def __getattr__(self, name):
        # control-plane helpers (_json/_request) and attrs (timeout,
        # skip_verify) delegate untouched; tests may also override them
        # per-instance, which shadows this hook
        return getattr(self._inner, name)

    # ----------------------------------------------------- machinery
    def _note_failure(self, uri, breaker) -> None:
        """Record a peer failure and, when it OPENS the breaker, evict
        the transport's pooled keep-alive connections for that peer —
        a fast-failed peer's sockets are dead weight, and its recovery
        must reconnect from scratch (docs/serving.md)."""
        state = breaker.record_failure()
        self.breakers.note(uri, state)
        if state == BREAKER_OPEN:
            evict = getattr(self._inner, "evict_peer", None)
            if evict is not None:
                evict(uri)

    def _single_shot(self, name, uri, *args, **kwargs):
        """One ungated, unretried attempt (writes and /status probes):
        the breaker observes PeerError outcomes; a locally-died attempt
        (deadline cut before socket I/O) records nothing — the peer's
        health is unknown — and frees any half-open trial slot."""
        from pilosa_tpu_torch.parallel.client import PeerError

        breaker = self.breakers.get(uri)
        try:
            out = getattr(self._inner, name)(uri, *args, **kwargs)
        except PeerError as e:
            if e.backpressure:
                # 429 from the peer's admission queue: the peer is alive
                # and shedding load — neither a breaker failure (it
                # would dead-mark a healthy-but-busy node) nor a success
                if self._stats is not None:
                    self._stats.count(
                        "rpc_backpressure", tags={"method": name}
                    )
                if breaker is not None:
                    breaker.release_trial()
            elif breaker is not None:
                self._note_failure(uri, breaker)
            raise
        except BaseException:
            if breaker is not None:
                breaker.release_trial()
            raise
        if breaker is not None:
            self.breakers.note(uri, breaker.record_success())
        return out

    def _call(self, name, uri, *args, **kwargs):
        from pilosa_tpu_torch.parallel.client import BreakerOpenError, PeerError

        breaker = self.breakers.get(uri)
        fn = getattr(self._inner, name)
        attempts = self.policy.retries + 1
        for attempt in range(attempts):
            if breaker is not None and not breaker.allow():
                raise BreakerOpenError(
                    uri,
                    "circuit breaker open (peer failing); fast-fail "
                    "without a data-plane round trip",
                )
            try:
                out = fn(uri, *args, **kwargs)
            except PeerError as e:
                if e.backpressure:
                    # non-retryable-with-backoff: an in-query retry
                    # against an admission-full peer is the herd its
                    # 429 is shedding. Surface it (the caller's
                    # failover can pick another replica, or the client
                    # honors e.retry_after) without a breaker failure —
                    # the peer is alive, just busy.
                    if self._stats is not None:
                        self._stats.count(
                            "rpc_backpressure", tags={"method": name}
                        )
                    if breaker is not None:
                        breaker.release_trial()
                    raise
                if breaker is not None:
                    self._note_failure(uri, breaker)
                if not e.retryable or attempt + 1 >= attempts:
                    raise
                delay = self.policy.backoff(attempt)
                d = current_deadline()
                if d is not None and d.remaining() <= delay:
                    # no budget left for the backoff + another attempt:
                    # surface the transport error now; the caller's
                    # failover/deadline handling takes it from here
                    raise
                if self._stats is not None:
                    self._stats.count("rpc_retries", tags={"method": name})
                prof = tracing.current_profile()
                if prof is not None:
                    # per-query retry attribution: the flight recorder /
                    # ?profile=true evidence names WHICH hop retried,
                    # not just that some global counter moved
                    prof.note_retry(name, uri, attempt + 1)
                with GLOBAL_TRACER.span(
                    "rpc.retry", method=name, attempt=attempt + 1
                ):
                    self.policy.sleep(delay)
            except BaseException:
                # the attempt died locally (deadline cut before socket
                # I/O): the peer's health is unknown — record nothing,
                # but free any half-open trial slot this attempt took
                if breaker is not None:
                    breaker.release_trial()
                raise
            else:
                if breaker is not None:
                    self.breakers.note(uri, breaker.record_success())
                return out
        raise AssertionError("unreachable: retry loop exits via return/raise")


def deadline_from_header(value: "str | None") -> Deadline | None:
    """Parse an ``X-Pilosa-Deadline-Ms`` header value (the REMAINING
    budget in milliseconds) into a Deadline; None for absent or
    malformed values — both hops must agree on this, so there is
    exactly one parser."""
    if not value:
        return None
    try:
        return Deadline(max(0.0, float(value) / 1e3))
    except ValueError:
        return None


def make_resilient_client(config, stats=None, injector=None):
    """Build the full node→node client chain from config:
    InternalClient transport → fault injection (always present so the
    debug route can arm rules at runtime) → retry/breaker wrapper."""
    from pilosa_tpu_torch.parallel.faultinject import FaultInjectingClient

    inner = FaultInjectingClient(
        skip_verify=config.tls_skip_verify, injector=injector
    )
    policy = RetryPolicy(
        retries=config.rpc_retries,
        base_s=config.rpc_backoff_base_ms / 1e3,
        cap_s=config.rpc_backoff_cap_ms / 1e3,
    )
    breakers = BreakerRegistry(
        enabled=config.breaker_enabled,
        threshold=config.breaker_failure_threshold,
        cooldown_s=config.breaker_cooldown_ms / 1e3,
        stats=stats,
    )
    return ResilientClient(inner, breakers, policy, stats=stats)
