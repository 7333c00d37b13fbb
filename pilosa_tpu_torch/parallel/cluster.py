"""Cluster: static membership, scatter-gather routing, anti-entropy,
join recovery.

Reference: pilosa_tpu/parallel/cluster.py (after cluster.go: cluster,
ResizeJob, states; gossip/ (memberlist), broadcast.go, holder_syncer.go,
executor.go (mapReduce/mapperRemote)). Host code: every node answers its
read legs through its own ``WaveScheduler`` on its own card. Design
departures from the Go original:

- membership is a static seed list + HTTP heartbeats instead of memberlist
  gossip — the same fixed-process-group model as ``torch.distributed``;
  elasticity is join-time pull recovery (a new node fetches fragments it
  now owns) rather than a coordinator-driven ResizeJob push;
- node→node payloads are JSON with base64 roaring/packed words instead of
  protobuf (see parallel/client.py);
- schema changes broadcast by POSTing the full schema to peers
  (apply_schema is idempotent), replacing CreateIndex/CreateField messages.

Read fan-out: every shard is executed by its first alive owner ("primary");
per-call results reduce with type-specific merges (counts add, row segments
concatenate — shards are disjoint column ranges; TopN/GroupBy merge by key).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import traceback
from collections import deque
from typing import Any

import numpy as np

from pilosa_tpu_torch.executor import ExecutionError, RowResult
from pilosa_tpu_torch.executor.executor import WRITE_CALLS, apply_options, unwrap_options
from pilosa_tpu_torch.parallel.resultwire import (  # noqa: F401 (re-exported)
    decode_result,
    encode_result,
)
from pilosa_tpu_torch.parallel import resilience
from pilosa_tpu_torch.parallel.client import PeerError
from pilosa_tpu_torch.parallel.movement import MovementLane, fragment_checksum
from pilosa_tpu_torch.parallel.resilience import (
    DeadlineExceededError,
    make_resilient_client,
)
from pilosa_tpu_torch.parallel.topology import (
    STATE_DEGRADED,
    STATE_NORMAL,
    STATE_REMOVED,
    STATE_RESIZING,
    STATE_STARTING,
    Node,
    ShardUnavailableError,
    Topology,
)
from pilosa_tpu_torch.core import EXISTENCE_FIELD
from pilosa_tpu_torch.core.view import VIEW_BSI
from pilosa_tpu_torch.encoding import frame
from pilosa_tpu_torch.pql import Call, parse
from pilosa_tpu_torch.roaring import serialize
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils import durable, sanitize, tracing
from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER

# the 503 texts of a peer's device gate (server.Server._gate_reason): the
# peer is alive and answers heartbeats, but its card serves no query —
# its verdict is pending, or its card failed the probe (for good, until
# a restart; the port never answers from the CPU instead)
GATE_PENDING = "device probe in progress"
GATE_FAILED = "failed its probe"
# the 503 texts of a node that is up but must not answer a read from its
# own copy (_check_leg): the copy missed acknowledged writes, a peer has
# not heard the node for a lease, or it has not joined yet. A coordinator
# fails such a leg over to another owner without dead-marking the node.
STALE_COPY = "missed acknowledged writes"
UNHEARD = "has not heard from this node"
STARTING = "cluster state STARTING"
NOT_SERVING = (GATE_PENDING, GATE_FAILED, STALE_COPY, UNHEARD, STARTING)

HEARTBEAT_INTERVAL = 2.0


# the least time a node may hear from no peer before it stops
# coordinating queries; a peer counts as down after twice its lease
# (Cluster.__init__)
LEASE_S = 15.0


# a peer that relays a missed-write mark to the node it names waits this
# long for an answer: well under the writer's own RPC timeout, so the
# writer hears the relay's failure rather than timing out on the relay
RELAY_TIMEOUT_S = 5.0
# a peer that a catch-up's barrier asks (C14, Cluster._drain_peers)
# waits this long for the writes it began without the marks being caught
# up; the catching-up node waits twice as long for its answer
DRAIN_WAIT_S = RELAY_TIMEOUT_S
# the shard number of a mark on a node's attribute stores of an index:
# an attribute write that leaves a node out marks them as well as its
# copy of each shard (a node may own no shard yet, C13)
ATTRS_SHARD = -1
# where a node keeps its missed-write marks, under its data dir (C11)
MARKS_FILE = os.path.join(".cluster", "replica_marks.json")


def _refused(err: PeerError) -> bool:
    """The peer refused the connection: nothing listens at its address,
    so it serves no query. A timeout or a reset proves no such thing —
    under load a live peer's /status probe times out."""
    return isinstance(err.__cause__, ConnectionRefusedError)


class RebalanceInFlightError(RuntimeError):
    """A topology change raced an in-flight rebalance pull. Racing the
    pull can drop the only holder of shards it is still fetching, so
    node-remove surfaces the conflict (HTTP 409) instead — wait for
    ``wait_rebalanced`` / the pull thread, then retry."""


class _Leg:
    """One fan-out leg awaiting a (possibly shared) RPC."""

    __slots__ = (
        "index",
        "pql",
        "shards",
        "ctx",
        "deadline",
        "done",
        "results",
        "error",
        "bytes",
    )

    def __init__(self, index: str, pql: str, shards, ctx, deadline=None):
        self.index = index
        self.pql = pql
        self.shards = shards
        self.ctx = ctx  # (trace_id, span_id) of the submitting thread
        self.deadline = deadline  # the SUBMITTER's query deadline
        self.done = threading.Event()
        self.results: list | None = None
        self.error: BaseException | None = None
        # this leg's share of the (possibly shared) RPC response bytes,
        # handed back to the SUBMITTER's profile — the sender thread's
        # profile must not swallow the whole envelope's bytes
        self.bytes = 0


class _NodeLegBatcher:
    """Coalesce concurrent fan-out legs to the SAME peer into one
    multi-query ``POST /internal/query/batch`` — the cluster half of
    cross-query wave coalescing (docs/query-batching.md): when the wave
    scheduler (or simply N concurrent coordinator threads) produces
    several legs for one remote node, they ride one HTTP round trip and
    the remote node settles them in one device readback wave.

    Group-commit only, no timed window: a solo leg goes out immediately
    on the plain single-query RPC (identical wire behavior to the
    pre-batching path), and legs that arrive while a peer's sender is
    busy form the next batch.  Sender duty uses the same
    contend-and-handoff protocol as ``WaveScheduler._await``: a sender
    ships exactly ONE batch and then releases duty so the next waiting
    caller takes over — no caller keeps pumping other threads' batches
    after its own answer landed, and because every transition (enqueue,
    duty claim/release, completion) happens under one condition
    variable, a crashed sender can neither leak the duty flag nor
    strand queued legs.  Per-leg trace context travels in the request
    body; per-leg failures come back as per-entry errors so one bad
    query never fails its RPC-mates."""

    MAX_LEGS = 64

    def __init__(self, cluster: "Cluster"):
        self.cluster = cluster
        self._lock = sanitize.make_lock("_NodeLegBatcher._lock")
        self._cond = threading.Condition(self._lock)
        self._pending: dict[str, deque[_Leg]] = {}
        self._busy: set[str] = set()

    def call(self, node: "Node", index: str, pql: str, shards) -> list:
        leg = _Leg(
            index,
            pql,
            shards,
            GLOBAL_TRACER.current_context(),
            deadline=resilience.current_deadline(),
        )
        if getattr(self.cluster.config, "batch_mode", "adaptive") == "off":
            # no coalescing: one solo-leg send, still spanned + timed
            self._send(node, [leg])
            self._credit_bytes(leg)
            if leg.error is not None:
                raise leg.error
            return leg.results  # type: ignore[return-value]
        uri = node.uri
        with self._cond:
            self._pending.setdefault(uri, deque()).append(leg)
            self._cond.notify_all()
        while True:
            with self._cond:
                while not leg.done.is_set() and (
                    uri in self._busy or not self._pending.get(uri)
                ):
                    self._cond.wait()
                if leg.done.is_set():
                    break
                self._busy.add(uri)
            try:
                self._drain_one(node)
            finally:
                with self._cond:
                    self._busy.discard(uri)
                    self._cond.notify_all()
        self._credit_bytes(leg)
        if leg.error is not None:
            raise leg.error
        return leg.results  # type: ignore[return-value]

    @staticmethod
    def _credit_bytes(leg: _Leg) -> None:
        """Report this leg's RPC-byte share to the SUBMITTER's profile
        (the shared RPC was read on whichever thread held sender duty,
        so the client's automatic accounting landed there instead)."""
        prof = tracing.current_profile()
        if prof is not None:
            prof.note_rpc_bytes(leg.bytes)

    def _drain_one(self, node: "Node") -> None:
        """Ship ONE batch of queued legs (sender duty for a single
        round trip; the caller releases duty afterwards)."""
        with self._cond:
            q = self._pending.get(node.uri)
            if not q:
                return
            legs: list[_Leg] = []
            while q and len(legs) < self.MAX_LEGS:
                legs.append(q.popleft())
        try:
            self._send(node, legs)
        finally:
            for leg in legs:  # transport-level failure: fail every
                # leg of THIS rpc (per-query isolation is the
                # receiver's job; a dead socket has no per-query story)
                if not leg.done.is_set():
                    if leg.error is None and leg.results is None:
                        leg.error = PeerError(
                            node.uri, "batched query RPC aborted"
                        )
                    leg.done.set()
            with self._cond:
                self._cond.notify_all()

    @staticmethod
    def _envelope_context(legs: list[_Leg]):
        """The deadline the (possibly shared) RPC runs under.  The
        sender thread's OWN thread-local deadline must never apply — it
        may be draining other threads' legs, and one nearly-expired
        query would fail or throttle its envelope-mates.  A solo leg
        gets its submitter's deadline; a shared envelope is bounded by
        the LONGEST remaining budget among its legs (so no leg is
        starved by a shorter co-rider — a cut at that bound means every
        leg's budget is spent), or unbounded when any leg is."""
        deadlines = [leg.deadline for leg in legs]
        if any(d is None for d in deadlines):
            return resilience.use_query_context(None)
        widest = max(deadlines, key=lambda d: d.remaining())
        return resilience.use_query_context(
            resilience.QueryContext(deadline=widest)
        )

    def _send(self, node: "Node", legs: list[_Leg]) -> None:
        client = self.cluster.client
        stats = self.cluster.server.stats
        t0 = time.perf_counter()
        # scratch profile: the internal client notes response bytes
        # into the CALLING thread's collector — capture them here and
        # split evenly across the envelope's legs, so each submitter's
        # ?profile=true sees its share instead of the sender's profile
        # swallowing everything (see _credit_bytes)
        scratch = tracing.QueryProfile()
        with GLOBAL_TRACER.span(
            "cluster.fanout_batch", node=node.id, legs=len(legs)
        ):
            try:
                if len(legs) == 1:
                    leg = legs[0]
                    ctx = leg.ctx or (None, None)
                    # solo leg: the plain RPC, under the LEG's trace
                    # context (the sender may be draining another
                    # thread's leg)
                    with GLOBAL_TRACER.detached(ctx[0], ctx[1]):
                        with self._envelope_context([leg]):
                            with tracing.use_profile(scratch):
                                leg.results = client.query_node(
                                    node.uri, leg.index, leg.pql, leg.shards
                                )
                    leg.bytes = scratch.take_rpc_bytes()
                    leg.done.set()
                else:
                    entries = [
                        {
                            "index": leg.index,
                            "query": leg.pql,
                            "shards": leg.shards,
                            "traceId": (leg.ctx or (None, None))[0],
                            "parentSpanId": (leg.ctx or (None, None))[1],
                        }
                        for leg in legs
                    ]
                    with self._envelope_context(legs):
                        with tracing.use_profile(scratch):
                            outs = client.query_batch_node(node.uri, entries)
                    share = scratch.take_rpc_bytes() // len(legs)
                    for leg, out in zip(legs, outs):
                        leg.bytes = share
                        if isinstance(out, Exception):
                            leg.error = out
                        else:
                            leg.results = out
                        leg.done.set()
            except Exception as e:  # noqa: BLE001 — ANY send/decode
                # failure (transport, malformed peer reply, version
                # skew) fails this RPC's legs and keeps the drain loop
                # pumping; letting it propagate would strand the legs
                # still queued behind it. A deadline cut keeps its own
                # type so the submitter surfaces the labeled 504, not a
                # transport error that would trigger pointless failover.
                err = (
                    e
                    if isinstance(e, (PeerError, DeadlineExceededError))
                    else PeerError(
                        node.uri, f"batched query RPC failed: {e!r}"
                    )
                )
                for leg in legs:
                    if not leg.done.is_set():
                        leg.error = err
                        leg.done.set()
        if stats is not None and len(legs) > 1:
            # only genuinely COALESCED envelopes: a solo leg is the
            # plain single-query RPC, already timed as its caller's
            # fanout_rpc_seconds — counting it here would both
            # double-time it and drag legs_per_batch_rpc toward 1,
            # misreading mostly-solo traffic as broken coalescing
            stats.timing(
                "fanout_batch_rpc_seconds",
                time.perf_counter() - t0,
                tags={"node": node.id},
            )
            stats.observe("legs_per_batch_rpc", float(len(legs)))


class Cluster:
    # TopN iterative-deepening rounds before the bounded minCount sweep
    # (up to 256× the initial headroom). Class attr so tests can force
    # the sweep path deterministically.
    TOPN_DEEPEN_ROUNDS = 5

    def __init__(self, server):
        self.server = server
        self.config = server.config
        # liveness by time, unlike the reference, which dead-marks a peer
        # at its first failed /status probe and then leaves it out of
        # writes and shard announces: under load a serving peer's probe
        # times out, and that peer went on answering reads from a stale
        # view of the shards (C5). A write or an announce leaves a peer
        # out only when it refuses that very request (nothing listens
        # there) or has answered no probe for down_after_s (it counts as
        # down: _may_serve). A node that has heard from no peer
        # (an answer or a refusal) for lease_s coordinates no query
        # (_check_ready). lease_s is longer than a heartbeat period and
        # a probe timeout, and down_after_s twice it, so a node that is
        # cut off stops answering from what it knows before the nodes
        # that count it down write without it.
        interval = getattr(self.config, "heartbeat_interval", HEARTBEAT_INTERVAL)
        self.lease_s = max(LEASE_S, 3 * interval)
        self.down_after_s = 2 * self.lease_s
        self._heard: dict[str, float] = {}  # node id -> last answer or refusal
        # node id -> (when the /status it answered was requested, the
        # seconds it said it had not heard this node): the self-fence
        # (_unheard_reason)
        self._unheard: dict[str, tuple[float, float]] = {}
        # Missed-write marks (C8-C10). A write that leaves an owner out
        # (it refused, or counts as down) marks that owner's copy of each
        # shard it wrote as stale, and tells every peer that may serve
        # before the ack. Unlike the reference, whose returning replica
        # answers from the copy it kept until anti-entropy unions the
        # missed bits in (and whose union brings back the bits a missed
        # Clear removed, on every owner), no node reads a shard from a
        # copy marked stale for it, and that copy is replaced by a
        # current owner's, never merged. A mark is (owner uri, index,
        # shard) -> {writer boot: write number}, and a catch-up records
        # the numbers it covered under the same key: both are per-boot
        # maximums, so merging them in any order, from announces or from
        # any /status, neither loses a mark nor revives a covered one.
        self._marks: dict[tuple[str, str, int], dict[str, int]] = {}
        self._caught: dict[tuple[str, str, int], dict[str, int]] = {}
        self._covered_at: dict[tuple[str, str, int], float] = {}
        # index -> shard -> uris whose copy is stale: rebuilt whole under
        # _marks_lock, read lock-free on the read path like _peer_shards
        self._stale_view: dict[str, dict[int, frozenset[str]]] = {}
        self._marks_lock = sanitize.make_lock("Cluster._marks_lock")
        # the two tables live in <data dir>/MARKS_FILE as well (C11): a
        # change is on disk before the merge that made it returns, so
        # before any answer or acknowledgement that rests on it, and a
        # node reloads them before its join's first heartbeat. Writers
        # of one generation share one file write (_persist_marks)
        data_dir = server.holder.path
        self._marks_path = (
            os.path.join(data_dir, MARKS_FILE) if data_dir else None
        )
        self._marks_gen = 0  # bumped under _marks_lock by every change
        self._marks_saved = 0  # the generation on disk
        self._marks_file_lock = sanitize.make_lock("Cluster._marks_file_lock")
        # the file writes made and their seconds; the last load's seconds
        self.marks_file = {"writes": 0, "seconds": 0.0}
        self.marks_load_s: float | None = None
        self._boot = os.urandom(8).hex()
        self._mark_seq = 0
        self._catch_up_lock = sanitize.make_lock("Cluster._catch_up_lock")
        self._catch_up_thread: threading.Thread | None = None
        # the writes this node coordinates that are in flight, by (index,
        # the marks generation they were planned under): a catch-up's
        # barrier waits for those planned before its marks (C14)
        self._in_flight: dict[tuple[str, int], int] = {}
        self._in_flight_cv = threading.Condition(
            sanitize.make_lock("Cluster._in_flight_lock")
        )
        # {"shards", "seconds"} of the last catch-up that replaced any
        self.last_catch_up: dict | None = None
        # the resilient RPC chain (docs/fault-tolerance.md): transport →
        # fault injection (armed via config or /debug/faults) → retry +
        # per-peer circuit breakers. Every data-plane call site below
        # goes through this wrapper — the `resilience` analyzer rule
        # forbids naked InternalClient use here.
        self.client = make_resilient_client(
            self.config,
            stats=server.stats,
            injector=getattr(server, "fault_injector", None),
        )
        # the time limit of one write leg, the client's RPC timeout: a
        # catch-up's barrier waits for no peer unheard for longer than
        # down_after_s plus this (_drain_peers)
        self.leg_timeout_s = self.client.timeout
        # per-peer fan-out leg coalescer: concurrent legs to one node
        # share a multi-query /internal/query/batch RPC (batch-mode=off
        # restores the one-RPC-per-leg path)
        self._legs = _NodeLegBatcher(self)
        me = Node(
            id=self.config.node_id,
            uri=server.uri,
            is_coordinator=self.config.coordinator,
        )
        peers = [
            Node(
                id=uri.replace("https://", "").replace("http://", ""),
                uri=uri,
            )
            for uri in self.config.seeds
            if uri.rstrip("/") != server.uri
        ]
        self.topology = Topology([me] + peers, replica_n=self.config.replica_n)
        self.me = me
        self.state = STATE_STARTING
        self.removed = False  # this node was removed from the cluster
        # shards this node has ever seen per index (local, remote, or
        # routed through it) — lets reads FAIL when a sole owner is down
        # instead of silently returning partial results
        self._known_shards: dict[str, set[int]] = {}
        # last shard list each peer reported per index: a dead-marked
        # peer's shards still enter the scan from here, so a sole owner
        # going down surfaces as ShardUnavailableError at routing instead
        # of a silently partial result
        self._peer_shards: dict[tuple[str, str], set[int]] = {}
        # shards of each index whose holders THIS node has announced to
        # every peer that may serve reads (_tell_peers). A write of a
        # shard outside it announces before it is acknowledged, whether
        # or not the shard is already in _known_shards: a shard can be
        # known here while a peer was never told of it (an earlier
        # writer's announce missed that peer and failed its write)
        self._told_shards: dict[str, set[int]] = {}
        # guards MERGE-and-assign updates of the two shard caches (two
        # concurrent announces/imports would lose one side's update in a
        # get|set race, transiently breaking read-your-writes). Readers
        # stay lock-free: whole-set assignment is atomic.
        self._shard_cache_lock = sanitize.make_lock("Cluster._shard_cache_lock")
        # logical clock over announce applications: a heartbeat /status
        # snapshot is fetched at some clock reading c0, and an announce
        # for (node, index) stamped AFTER c0 proves the snapshot may
        # predate that announce — replacing the set from it would wipe a
        # just-announced holding (lost update → a read routed to a
        # still-pulling owner silently counts zeros). Such entries skip
        # the replace; the next heartbeat heals.
        self._inv_clock = 0
        self._announce_stamp: dict[tuple[str, str], int] = {}
        self._hb_timer: threading.Timer | None = None
        self._rebalance_thread: threading.Thread | None = None
        # movement admission lane (docs/resize.md): EVERY bulk
        # data-movement path — rebalance pulls, anti-entropy handoff
        # pushes, restore adopts arriving via import-roaring — brackets
        # its transfers here, so movement concurrency and byte rate are
        # bounded cluster-wide instead of per-call-site
        self.movement = MovementLane(
            self.config.movement_max_concurrent,
            self.config.movement_max_mbit,
            stats=server.stats,
        )
        self._import_exec = None  # lazy ThreadPoolExecutor for import fan-out
        self._import_exec_lock = sanitize.make_lock("Cluster._import_exec_lock")
        # bounded pool for the concurrent heartbeat /status sweep.
        # Created EAGERLY (threads only spawn on first submit, so this
        # is free) — lazy creation raced close(): a shutdown landing
        # between the None-check and the construction would leak the
        # probe threads past server close.
        from concurrent.futures import ThreadPoolExecutor

        self._hb_exec = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="hb-probe"
        )
        self._closed = False
        # translate-primary failover fencing (reference: translate.go has a
        # FIXED primary; this cluster fails allocation over to the
        # sorted-first alive node, which must first prove its counter is
        # ahead of every allocation the deposed primary replicated):
        #   _translate_fence_ok    — this node may allocate without fencing
        #   _translate_reconcile_pending — full-pull our stores from the
        #       current primary before trusting local caches (set at boot:
        #       a restarted ex-primary can hold never-replicated ids)
        #   _observed_primary_id   — primacy-transition edge detector
        self._translate_fence_ok = False
        self._translate_reconcile_pending = True
        self._observed_primary_id: str | None = None
        self._translate_fence_lock = sanitize.make_lock("Cluster._translate_fence_lock")
        # bumped (under the lock) on every observed primacy transition; a
        # fence that straddles a transition must not stamp itself valid
        self._primacy_gen = 0
        self._reconcile_thread: threading.Thread | None = None
        # allocations whose replicate-before-ack push FAILED, keyed by
        # (index, field): the ack was refused, but the local store keeps
        # the binding — a client retry would otherwise find the keys
        # bound, skip the push, and ack an allocation no peer holds.
        # Every subsequent allocation on the store re-pushes these first.
        self._unpushed_translate: dict[tuple[str, str | None], dict[str, int]] = {}
        self._unpushed_lock = sanitize.make_lock("Cluster._unpushed_lock")
        self._load_marks()

    # ------------------------------------------------------------ membership
    @property
    def nodes(self) -> list[Node]:
        return self.topology.nodes

    def attach(self) -> None:
        """Mount routes and routers BEFORE the listener starts serving:
        a request arriving during the join window must hit the cluster
        router (which rejects with 503 while STARTING), never the local
        default router; peers probing /internal/* must not see 404."""
        self._mount_internal_routes()
        # results cached while this node served solo were never covered
        # by peer invalidation broadcasts — drop them before the first
        # clustered request can read one
        cache = getattr(self.server.api, "result_cache", None)
        if cache is not None:
            cache.clear()
        self.server.http.trace_fetch = self._fetch_cluster_trace
        self.server.http.query_router = self.query
        self.server.http.import_router = self.import_router
        self.server.http.roaring_router = self.import_roaring_router
        self.server.http.translate_router = self._route_translate_keys
        self.server.http.broadcast_schema = self.broadcast_schema
        self.server.http.broadcast_deletion = self.broadcast_deletion

    def join(self) -> None:
        """Heartbeat + announce-if-new + pull recovery, then STARTING →
        NORMAL (reference: cluster state negotiation in Server.Open).
        Runs after the listener is up so concurrent cold starts don't
        stack probe timeouts on bound-but-not-serving sockets."""
        # announce BEFORE the first heartbeat: a moved node adopting a
        # higher-epoch peer list that still carries its OLD address would
        # read itself as removed — announcing first makes every peer
        # replace the stale entry, so the adoption that follows includes
        # our current URI
        self._announce_if_new()
        self._heartbeat_once()
        self._recover_on_join()
        # the heartbeat above learned the missed-write marks from every
        # peer's /status: a copy that missed writes while this node was
        # down is replaced before it turns NORMAL (and until then, and
        # for any shard no current owner could give, it answers no read)
        self._catch_up()
        # inventories refresh AFTER the schema pull: the heartbeat above
        # ran with an empty holder (no indexes yet), so without this a
        # just-(re)started node would serve reads from only its local
        # shards until the next heartbeat tick
        for n in self._peers():
            self._refresh_peer_shards(n)
        self.state = STATE_NORMAL
        self._schedule_heartbeat()

    def _announce_if_new(self) -> None:
        """Cluster growth, the joiner's half (reference: memberlist join →
        cluster.go ResizeJob add). If an alive peer's membership list
        lacks this node, the cluster predates us: announce the join so
        every member inserts us and bumps the topology epoch — which also
        protects us from being reaped by a node that missed the announce
        (it adopts the higher-epoch list instead). Afterwards adopt the
        freshest peer list so a single-seed join still learns the full
        membership before pulling its shards."""
        # ONE status sweep serves the membership check, the announce
        # decision, AND the best-epoch adoption (each /status already
        # carries nodes + epoch + shard inventories)
        statuses: list[tuple[Node, dict]] = []
        for n in self._peers():
            sent = time.monotonic()
            try:
                st = self.client.status(n.uri, timeout=5.0)
            except PeerError:
                continue
            self._learn_from_status(n, st, sent)
            statuses.append((n, st))
            uris = {d.get("uri") for d in st.get("nodes", [])}
            if self.me.uri in uris:
                continue
            try:
                resp = self.client._json(
                    "POST",
                    n.uri,
                    "/internal/cluster/join",
                    {"id": self.me.id, "uri": self.me.uri},
                )
                # the join just bumped the peer's epoch past its snapshot
                # AND inserted us into its list — patch both, or adopting
                # the stale (pre-join) list at the new epoch would read
                # ourselves as removed
                ep = resp.get("topologyEpoch")
                if isinstance(ep, int):
                    st = dict(st)
                    st["topologyEpoch"] = ep
                    # mirror the peer's add_node: it retired any stale
                    # same-id entry (we moved) before inserting us
                    st["nodes"] = [
                        d
                        for d in st.get("nodes", [])
                        if d.get("id") != self.me.id
                        and d.get("uri") != self.me.uri
                    ] + [self.me.to_json()]
                    statuses[-1] = (n, st)
            except PeerError:
                continue
        # Adopt the freshest peer list OUTRIGHT (>=, not >): whether we
        # just announced or are a restarted member whose seed-derived
        # list predates later growth, peers at an equal-or-higher epoch
        # know at least as much as our config does. Without this, a
        # restarted node whose seeds name only the original members would
        # sync epochs in heartbeats but never learn the joined nodes —
        # and route reads across a phantom sub-cluster.
        best: tuple[int, list[dict]] | None = None
        for _n, st in statuses:
            ep = st.get("topologyEpoch")
            peer_nodes = [d for d in st.get("nodes", []) if d.get("uri")]
            if not any(d.get("uri") == self.me.uri for d in peer_nodes):
                # a list lacking us is NOT adoptable while we are booting:
                # either our join POST to this peer failed transiently
                # (adopting would self-remove — one dropped RPC bricking
                # the boot) or it raced the announce. Skip it; a GENUINE
                # removal still converges via the heartbeat path, which
                # requires a strictly-higher-epoch list from a cluster
                # that already knew us.
                continue
            if isinstance(ep, int) and peer_nodes and (
                best is None or ep > best[0]
            ):
                best = (ep, peer_nodes)
        if best is not None and best[0] >= self.topology.epoch:
            my_uris = {x.uri for x in self.nodes}
            if best[0] > self.topology.epoch or {
                d["uri"] for d in best[1]
            } != my_uris:
                self._adopt_topology(*best)

    def add_node(self, node_id: str, uri: str, forward: bool = True) -> bool:
        """Insert a joining node into the local topology (reference:
        cluster.go addNode on a memberlist join event). Idempotent by
        URI — only an ACTUAL insert bumps the epoch, so a direct announce
        racing a forwarded one can't double-bump. Forwards the join to
        every other peer once (forward=False on the forwarded leg stops
        the flood); a peer the forward misses converges by adopting the
        higher-epoch list at its next heartbeat."""
        if any(n.uri == uri for n in self.nodes):
            return False  # idempotent by URI — the guard must NOT match
            # by id, or a member rejoining from a new address would be
            # refused and then self-remove on adopting a list without it
        stale = next((n for n in self.nodes if n.id == node_id), None)
        if stale is not None and stale.id != self.me.id:
            # same id, new address: the node moved — retire the old entry
            self.topology.remove(stale.id)
        node = Node(id=node_id, uri=uri)
        self.topology.add(node)
        if forward:
            for n in self._peers(alive_only=False):
                if n.uri == uri:
                    continue
                try:
                    self.client._json(
                        "POST",
                        n.uri,
                        "/internal/cluster/join",
                        {"id": node_id, "uri": uri, "forwarded": True},
                    )
                except PeerError:
                    pass
        # Growth reshuffles placement among the OLD nodes too
        # (partition % n): pull any shards this node now owns but doesn't
        # hold, or reads routed here would silently undercount. The pull
        # runs OFF the join-handler thread — a synchronous pull would
        # stall the joiner's announce past its RPC timeout on any cluster
        # holding real data. Mid-pull reads may transiently undercount on
        # this node exactly as they would for any not-yet-synced replica;
        # the import re-forward path keeps writes landing correctly.
        # The joiner itself pulls synchronously in _recover_on_join;
        # fragments this node no longer owns hand off at the next
        # anti-entropy pass.
        def rebalance():
            prev_state, self.state = self.state, STATE_RESIZING
            try:
                adopted = self._pull_owned_fragments(
                    [n for n in self._peers() if n.uri != uri]
                )
            finally:
                if self.state == STATE_RESIZING:
                    self.state = prev_state
            self._warmup_adopted(adopted)

        t = threading.Thread(target=rebalance, daemon=True, name="join-rebalance")
        self._rebalance_thread = t
        t.start()
        return True

    def _check_ready(self) -> None:
        self._check_not_removed()
        if self.state == STATE_STARTING:
            raise ShardUnavailableError(
                "cluster state STARTING; retry when the node has joined"
            )
        self._check_lease()

    def _check_lease(self) -> None:
        """The self-fence of a coordinator: it starts no query, and a
        write it coordinates sends no further leg, once it has heard
        from no peer for lease_s or a peer says it has not heard this
        node for that long (``_unheard_reason``)."""
        peers = self._peers(alive_only=False)
        if peers:
            quiet = time.monotonic() - max(self._heard_at(n) for n in peers)
            if quiet > self.lease_s:
                raise ShardUnavailableError(
                    f"this node has heard from no peer for {quiet:.1f} s "
                    f"(lease {self.lease_s:.0f} s): it may be cut off, and "
                    "the others may write without it; it coordinates no "
                    "query until a peer answers"
                )
        reason = self._unheard_reason()
        if reason is not None:
            raise ShardUnavailableError(reason)

    def _unheard_reason(self) -> str | None:
        """The self-fence: why this node may not answer reads, or None.
        The lease above cannot see a node that hears its peers while
        none of them hears it: its lease holds, but they count it down
        after down_after_s and write without it, and their marks cannot
        reach it. Each /status answer says how long its node has not
        heard this one; an answer within lease_s saying more than
        lease_s, from a peer that hears some node (_learn_from_status),
        fences this node. It probes every heartbeat, well under
        lease_s, so it fences itself before any peer may count it
        down, and serves again once that peer hears it."""
        now = time.monotonic()
        for node_id, (at, ago) in list(self._unheard.items()):
            if now - at <= self.lease_s and ago > self.lease_s:
                return (
                    f"peer {node_id} {UNHEARD} for {ago:.1f} s (lease "
                    f"{self.lease_s:.0f} s): it may count this node down "
                    "and write without it; this node answers no read "
                    "until that peer hears it"
                )
        return None

    def _check_leg(self, index: str, shards) -> None:
        """A read leg is answered from this node's own copy only while
        that copy holds every acknowledged write: not while the node
        joins (it learns the marks in ``join``), not while a peer has
        not heard it for a lease, and not for a shard marked stale for
        it. The coordinator fails such a leg over (NOT_SERVING)."""
        if self.state == STATE_STARTING:
            raise ShardUnavailableError(
                f"{STARTING}; its copies may lack writes it missed"
            )
        reason = self._unheard_reason()
        if reason is not None:
            raise ShardUnavailableError(reason)
        mine = self._stale_shards(index, self.me.uri)
        if ATTRS_SHARD in mine:
            # a leg may filter by attributes (TopN attrName=)
            raise ShardUnavailableError(
                f"this node's attributes of {index!r} {STALE_COPY} (marked "
                "stale by the writer); it answers once it has caught up"
            )
        if mine:
            hit = sorted(mine if shards is None else mine.intersection(shards))
            if hit:
                raise ShardUnavailableError(
                    f"this node's copy of shards {hit[:8]} of {index!r} "
                    f"{STALE_COPY} (marked stale by the writer); it "
                    "answers them once it has caught up"
                )

    def close(self) -> None:
        self._closed = True
        if self._hb_timer is not None:
            self._hb_timer.cancel()
        if self._import_exec is not None:
            self._import_exec.shutdown(wait=False)
        self._hb_exec.shutdown(wait=False)
        # drop the pooled keep-alive connections to the peers: each one
        # holds a connection task open on the peer's listener
        self.client.close()

    def _import_pool(self):
        if self._import_exec is None:
            with self._import_exec_lock:
                if self._import_exec is None:
                    from concurrent.futures import ThreadPoolExecutor

                    self._import_exec = ThreadPoolExecutor(
                        max_workers=16, thread_name_prefix="import-fanout"
                    )
        return self._import_exec

    def _peers(self, alive_only: bool = True) -> list[Node]:
        return [
            n
            for n in self.nodes
            if n.id != self.me.id and (n.alive or not alive_only)
        ]

    def _probe_peers(self, peers: list[Node]) -> list[dict | PeerError]:
        """Concurrent /status sweep (bounded thread fan-out): one hung
        peer used to delay dead-marking every peer behind it by up to
        its full 5s probe timeout — serially, a heartbeat over P peers
        with one wedged could stretch to P×5s. Probes overlap; results
        come back aligned with ``peers`` (the PeerError = unreachable).
        All topology/inventory mutation stays on the heartbeat thread."""

        def probe(node: Node) -> dict | PeerError:
            try:
                return self._probe(node)
            except PeerError as e:
                return e

        if len(peers) <= 1:
            return [probe(n) for n in peers]
        try:
            return list(self._hb_exec.map(probe, peers))
        except RuntimeError:
            # close() shut the pool down while this tick was in flight:
            # report everything unreachable; no further ticks schedule
            return [PeerError(n.uri, "cluster closed") for n in peers]

    def _heartbeat_once(self) -> None:
        degraded = False
        # Topology reconciliation is EPOCH-based: every applied add/remove
        # bumps Topology.epoch, and a node that missed the broadcast
        # adopts the higher-epoch membership list wholesale. This
        # converges both directions — a missed removal shrinks us, and a
        # missed JOIN grows us instead of the old behavior of reaping the
        # announced joiner as stale (a node then removed itself).
        # Match on URI, not id: ids are config-dependent (a node's own id
        # may be its `name` while peers know it by host:port).
        best: tuple[int, list[dict]] | None = None
        with self._shard_cache_lock:  # consistent vs in-flight stamps
            c0 = self._inv_clock  # BEFORE any fetch: an announce racing
            # the concurrent sweep stamps > c0, so its (node, index)
            # snapshot entries are skipped rather than wiped
        peers = self._peers(alive_only=False)
        for n, st in zip(peers, self._probe_peers(peers)):
            if isinstance(st, PeerError):
                # one probe that failed without a refusal does not
                # dead-mark (see __init__)
                n.alive = not _refused(st) and self._may_serve(n)
                degraded = True
                continue
            n.alive = True
            self._apply_status_inventory(n, st, c0)
            ep = st.get("topologyEpoch")
            peer_nodes = [d for d in st.get("nodes", []) if d.get("uri")]
            if not isinstance(ep, int) or not peer_nodes:
                continue
            if ep > self.topology.epoch and (best is None or ep > best[0]):
                best = (ep, peer_nodes)
            elif (
                ep == self.topology.epoch
                and best is None
                and n.is_coordinator
                and not self.me.is_coordinator
                and {d["uri"] for d in peer_nodes} != {x.uri for x in self.nodes}
            ):
                # equal epochs with divergent membership (concurrent
                # add/remove applied on disjoint subsets): epochs alone
                # can't order the lists, so the coordinator's view is
                # authoritative — everyone converges to it (reference:
                # the coordinator owns ResizeJob decisions). EXCEPT when
                # the coordinator's list lacks US: per-node epochs aren't
                # comparable, so an equal epoch cannot prove a removal —
                # a joined node whose forward to the coordinator was lost
                # would brick itself. Re-announce instead; the add bumps
                # the coordinator's epoch and everyone converges forward.
                if not any(d["uri"] == self.me.uri for d in peer_nodes):
                    try:
                        self.client._json(
                            "POST",
                            n.uri,
                            "/internal/cluster/join",
                            {"id": self.me.id, "uri": self.me.uri},
                        )
                    except PeerError:
                        pass
                else:
                    best = (ep, peer_nodes)
        if best is not None:
            self._adopt_topology(*best)
        if self.state in (STATE_NORMAL, STATE_DEGRADED):
            self.state = STATE_DEGRADED if degraded else STATE_NORMAL
            # a heal: the probes above learned marks on this node's
            # copies; replace them from a current owner that answered
            # (off this thread — a catch-up moves whole fragments)
            if self._stale_keys_of_mine():
                self._start_catch_up()
        self._forget_covered_marks()
        self._track_translate_primacy()

    def _track_translate_primacy(self) -> None:
        """Edge-detect translate-primacy transitions from the freshly
        updated liveness flags. Losing primacy invalidates the fence (a
        later RE-promotion must re-fence: the interim primary may have
        allocated); a demoted ex-primary arms a full reconcile so any
        never-replicated local allocation is displaced by the surviving
        chain instead of poisoning later fences."""
        try:
            primary = self._translate_primary()
        except ShardUnavailableError:
            return
        with self._translate_fence_lock:
            if primary.id != self._observed_primary_id:
                self._primacy_gen += 1
                if primary.id != self.me.id:
                    self._translate_fence_ok = False
                    if self._observed_primary_id == self.me.id:
                        self._translate_reconcile_pending = True
                self._observed_primary_id = primary.id
        if self._translate_reconcile_pending and self.server.holder is not None:
            self._maybe_reconcile_translations(primary)

    def _adopt_topology(self, epoch: int, node_dicts: list[dict]) -> None:
        """Adopt a peer's higher-epoch membership list. Keeps this node's
        own Node object and known liveness flags; newly learned members
        start alive (the next heartbeat corrects). If the adopted list no
        longer contains us, the cluster converged on our removal."""
        self.topology.epoch = epoch
        if not any(d["uri"] == self.me.uri for d in node_dicts):
            self.removed = True
            self.state = STATE_REMOVED
            return
        new_uris = {d["uri"] for d in node_dicts}
        # members the adopted list no longer carries: a removal this node
        # missed (or whose broadcast is still in flight). Keep their Node
        # objects — a draining victim still serves /internal/* reads, and
        # for replica_n=1 it is the only holder of its former shards.
        dropped = [
            x for x in self.nodes if x.id != self.me.id and x.uri not in new_uris
        ]
        by_uri = {x.uri: x for x in self.nodes}
        new_nodes: list[Node] = []
        grew = False
        for d in node_dicts:
            if d["uri"] == self.me.uri:
                new_nodes.append(self.me)
                continue
            known = by_uri.get(d["uri"])
            if known is not None:
                if known.id != d["id"]:
                    # re-key cached inventories: ids are config-dependent
                    # and adoption aligns ours to the adopted list —
                    # leaving entries under the old id would blind
                    # holder-preferring routing until the next heartbeat
                    with self._shard_cache_lock:
                        for (nid, idx_name) in [
                            k for k in self._peer_shards if k[0] == known.id
                        ]:
                            self._peer_shards[(d["id"], idx_name)] = (
                                self._peer_shards.pop((nid, idx_name))
                            )
                        # the announce stamps guard those same entries:
                        # left under the old id, a just-announced holding
                        # would lose its race protection (and the old-id
                        # stamps would leak)
                        for (nid, idx_name) in [
                            k
                            for k in self._announce_stamp
                            if k[0] == known.id
                        ]:
                            self._announce_stamp[(d["id"], idx_name)] = (
                                self._announce_stamp.pop((nid, idx_name))
                            )
                    known.id = d["id"]
                known.is_coordinator = bool(d.get("isCoordinator"))
                new_nodes.append(known)
            else:
                grew = True
                new_nodes.append(
                    Node(
                        id=d["id"],
                        uri=d["uri"],
                        is_coordinator=bool(d.get("isCoordinator")),
                    )
                )
        self.topology.nodes = sorted(new_nodes, key=lambda x: x.id)
        if grew or dropped:
            # placement reshuffles on growth AND shrink (partition % n):
            # pull any shards this node NOW owns but doesn't hold;
            # fragments we no longer own hand off at the next
            # anti-entropy pass. A shrink pulls from the dropped nodes
            # too — a removal broadcast this node missed (the heartbeat
            # adopting a survivor's post-removal epoch mid-drain) would
            # otherwise strand the victim's sole-copy shards until
            # anti-entropy. OFF the heartbeat thread — a synchronous
            # pull would block liveness ticks for the whole transfer;
            # reads stay exact through the window via holder-preferring
            # routing.
            def rebalance():
                prev_state, self.state = self.state, STATE_RESIZING
                try:
                    adopted = self._pull_owned_fragments(dropped + self._peers())
                finally:
                    if self.state == STATE_RESIZING:
                        self.state = prev_state
                self._warmup_adopted(adopted)

            t = threading.Thread(
                target=rebalance, daemon=True, name="adopt-rebalance"
            )
            self._rebalance_thread = t
            t.start()

    def _schedule_heartbeat(self) -> None:
        if self._closed:
            return

        def tick():
            try:
                self._heartbeat_once()
            finally:
                self._schedule_heartbeat()

        interval = getattr(self.config, "heartbeat_interval", HEARTBEAT_INTERVAL)
        self._hb_timer = threading.Timer(interval, tick)
        self._hb_timer.daemon = True
        self._hb_timer.name = "heartbeat"
        self._hb_timer.start()

    def _check_not_removed(self) -> None:
        if self.removed:
            raise ShardUnavailableError(
                "this node was removed from the cluster; "
                "direct client traffic to a cluster member"
            )

    def shard_nodes(self, index: str, shard: int) -> list[Node]:
        return self.topology.shard_nodes(index, shard)

    def _probe(self, node: Node, timeout: float = 5.0) -> dict:
        """``GET /status`` of a peer, noting when it last answered or
        refused (``_may_serve``, the lease in ``_check_ready``)."""
        sent = time.monotonic()
        try:
            st = self.client.status(node.uri, timeout=timeout)
        except PeerError as e:
            if _refused(e):
                self._heard[node.id] = time.monotonic()
            raise
        # the marks first: the answer ends this node's lease lapse, and
        # it must not serve a copy the answer marks stale meanwhile
        self._learn_from_status(node, st, sent)
        self._heard[node.id] = time.monotonic()
        return st

    def _learn_from_status(self, node: Node, st: dict, sent: float) -> None:
        """What a peer's /status (requested at ``sent``) says beyond its
        inventory: the missed-write marks it knows (so a heartbeat heals
        any announce this node missed) and how long it has not heard
        this node (the self-fence, ``_unheard_reason``; an answer to an
        older request does not replace a newer one's)."""
        self._merge_marks(st.get("replicaMarks"))
        heard = st.get("heardAgoS") or {}
        ago = heard.get(self.me.uri)
        if min(heard.values(), default=0.0) > self.lease_s:
            # the peer has heard from no node for its lease: it
            # coordinates no write (its _check_ready), so its not
            # hearing this node is no reason to fence (a healed node's
            # first answers say so of every peer)
            ago = 0.0
        if isinstance(ago, (int, float)):
            prev = self._unheard.get(node.id)
            if prev is None or sent >= prev[0]:
                self._unheard[node.id] = (sent, float(ago))

    def heard_ago(self) -> dict[str, float]:
        """Seconds since this node last heard each peer, by URI (served
        on /status for the peers' self-fence)."""
        now = time.monotonic()
        return {
            n.uri: round(now - self._heard_at(n), 3)
            for n in self._peers(alive_only=False)
        }

    def _heard_within_lease(self, node: Node) -> bool:
        # a node never heard is not
        return time.monotonic() - self._heard.get(node.id, -1e18) <= self.lease_s

    def _heard_at(self, node: Node) -> float:
        # a node not probed yet counts as heard when first asked about
        return self._heard.setdefault(node.id, time.monotonic())

    def _may_serve(self, node: Node) -> bool:
        """The node may be coordinating queries: it is this node, or it
        has answered or refused a probe within down_after_s. A refusal
        is no lasting proof (the peer may have started since), so
        writes and announces still try such a peer, and only a refusal
        of that very request leaves it out; a peer silent for longer
        counts as down, and they skip it."""
        return node.id == self.me.id or (
            time.monotonic() - self._heard_at(node) < self.down_after_s
        )

    def _probe_alive(self, node: Node) -> bool:
        """Current liveness for WRITES; re-probes a dead-marked peer once
        so a write never relies on a stale heartbeat (a skipped owner
        means silent data loss). Unlike the reference, an owner that may
        still serve (``_may_serve``) is written to whatever the probe
        says unless it refused, and the write fails if it cannot land
        there."""
        if node.id == self.me.id or node.alive:
            return True
        try:
            self._probe(node)
        except PeerError as e:
            return not _refused(e) and self._may_serve(node)
        node.alive = True
        return True

    def _alive_for_read(self, node: Node) -> bool:
        """Heartbeat-state liveness for READ routing — no synchronous
        probe, so one dead peer cannot add probe timeouts to every read
        (reference: cluster.go serves DEGRADED reads from live replicas).
        Staleness is bounded by the heartbeat interval: a recovered peer
        rejoins reads at the next tick; a freshly-dead one fails its RPC,
        which marks it dead and surfaces ShardUnavailableError. Writes
        keep the strict re-probe (_probe_alive)."""
        return node.id == self.me.id or node.alive

    # ---------------------------------------------------------- join recovery
    def _recover_on_join(self) -> None:
        """Pull schema and any fragments this node owns but lacks (the
        elastic-resize analogue of the reference's ResizeJob)."""
        api = self.server.api
        for peer in self._peers():
            try:
                schema = self.client._json("GET", peer.uri, "/schema")
            except PeerError:
                continue
            api.apply_schema(schema, validate=False)
        self._warmup_adopted(self._pull_owned_fragments(self._peers()))

    def _pull_owned_fragments(
        self, sources: list[Node]
    ) -> list[tuple[str, str, str, int]]:
        """Fetch every fragment this node owns under the CURRENT topology
        but does not hold locally, from the given source nodes (the data
        movement half of the reference's ResizeJob). Whole fragments move
        as serialized roaring frames through the movement admission lane
        (docs/resize.md): per-source transfers run on a bounded worker
        pool sized to the lane's slot count, each paying the byte-rate
        throttle before its adopt. Returns the (index, field, view,
        shard) list adopted FRESH — the residency warm-up input."""
        adopted: list[tuple[str, str, str, int]] = []
        for src in sources:
            jobs: list[tuple[str, str, str, int, str | None]] = []
            for idx in self.server.holder.schema():
                idx_name = idx["name"]
                try:
                    inventory = self.client.fragment_inventory(
                        src.uri, idx_name, checksums=True
                    )
                except PeerError:
                    continue
                for frag_info in inventory:
                    shard = frag_info["shard"]
                    if not self.topology.owns(self.me.id, idx_name, shard):
                        continue
                    if src.uri in self._stale_uris(idx_name, shard):
                        # its copy missed acknowledged writes: merged in,
                        # it would bring back the bits a missed Clear
                        # removed (C10)
                        continue
                    jobs.append((
                        idx_name,
                        frag_info["field"],
                        frag_info["view"],
                        shard,
                        frag_info.get("checksum"),
                    ))
            if not jobs:
                continue
            workers = min(self.movement.max_concurrent, len(jobs))
            if workers <= 1:
                for job in jobs:
                    self._pull_one_fragment(src, *job, adopted=adopted)
            else:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="movement-pull"
                ) as pool:
                    list(
                        pool.map(
                            lambda j: self._pull_one_fragment(
                                src, *j, adopted=adopted
                            ),
                            jobs,
                        )
                    )
        # the pull changed this node's holdings: publish the new
        # inventory so cached read routing points here without waiting
        # for the next heartbeat refresh
        for idx_name, idx_obj in list(self.server.holder.indexes.items()):
            self._announce_shards(
                idx_name,
                {self.me.uri: sorted(idx_obj.available_shards())},
                replace=True,
            )
        return adopted

    # serialized-frame transfers retry the SAME frame on 429 (the adopt
    # is an idempotent union), honoring the peer's Retry-After — the
    # loader's backoff discipline (docs/ingest.md), bounded so a peer
    # stuck shedding load fails the transfer to the next AE pass
    MOVEMENT_MAX_RETRIES_429 = 32

    def _retrieve_with_backoff(
        self, src: Node, index: str, field: str, view: str, shard: int
    ) -> bytes:
        for _ in range(self.MOVEMENT_MAX_RETRIES_429):
            try:
                return self.client.retrieve_fragment(
                    src.uri, index, field, view, shard
                )
            except PeerError as e:
                if not e.backpressure:
                    raise
                time.sleep(min(max(e.retry_after or 0.05, 0.01), 5.0))
        raise PeerError(
            src.uri,
            f"fragment pull {index}/{field}/{view}/{shard}: still 429 "
            f"after {self.MOVEMENT_MAX_RETRIES_429} attempts",
            status=429,
        )

    def _import_roaring_with_backoff(
        self, uri: str, index: str, field: str, view: str, shard: int,
        data: bytes,
    ) -> None:
        for _ in range(self.MOVEMENT_MAX_RETRIES_429):
            try:
                self.client.import_roaring(uri, index, field, view, shard, data)
                return
            except PeerError as e:
                if not e.backpressure:
                    raise
                time.sleep(min(max(e.retry_after or 0.05, 0.01), 5.0))
        raise PeerError(
            uri,
            f"fragment push {index}/{field}/{view}/{shard}: still 429 "
            f"after {self.MOVEMENT_MAX_RETRIES_429} attempts",
            status=429,
        )

    def _pull_one_fragment(
        self,
        src: Node,
        index: str,
        field: str,
        view: str,
        shard: int,
        src_checksum: str | None = None,
        adopted: list | None = None,
    ) -> None:
        """One whole-fragment movement through the admission lane.
        Merge even when a local fragment exists: a write that raced in
        mid-join may have created it with only the new bits — skipping
        would orphan the source's older bits until anti-entropy. A
        missing fragment takes the serialized-frame bulk lane; an
        existing one first compares content checksums (identical ⇒
        nothing to move) and only then pays the block-checksum diff.
        PeerError is swallowed — the next pass or source retries."""
        api = self.server.api
        local = self._local_fragment(index, field, view, shard)
        if local is not None and self.me.uri in self._stale_uris(index, shard):
            return  # a stale copy is replaced (_catch_up), never merged
        if local is not None and src_checksum:
            if fragment_checksum(serialize(local.bitmap)) == src_checksum:
                return
        try:
            if local is None:
                with self.movement.transfer(
                    "pull", index, field, view, shard, peer=src.uri
                ) as row:
                    data = self._retrieve_with_backoff(
                        src, index, field, view, shard
                    )
                    row["bytes"] = len(data)
                    self.movement.throttle(len(data))
                    api.import_roaring(index, field, shard, data, view=view)
                    self.movement.account("pull", len(data))
                if adopted is not None:
                    adopted.append((index, field, view, shard))
            else:
                self._sync_fragment(index, field, view, shard, local, src)
        except PeerError:
            return

    # warm-up breadth caps: enough to prime a new node's hot set, small
    # enough that warm-up can't become a second resize's worth of work
    WARMUP_MAX_FRAGMENTS = 64
    WARMUP_ROWS_PER_FRAGMENT = 4

    def _warmup_adopted(
        self, adopted: list[tuple[str, str, str, int]]
    ) -> None:
        """Device-residency warm-up for freshly adopted shards: run each
        fragment's leading rows through the LOCAL read path
        PROMOTE_TOUCHES times, so the touch-driven promotion machinery
        (executor/residency.py) lifts the new node's working set into
        the device tier before client traffic lands on it cold.
        Best-effort by design — a warm-up failure must never fail the
        resize that triggered it."""
        if not adopted:
            return
        from pilosa_tpu_torch.executor import residency

        api = self.server.api
        for index, field, view, shard in adopted[: self.WARMUP_MAX_FRAGMENTS]:
            if view != "standard" or field.startswith("_"):
                continue  # internal fields aren't addressable as Row(f=)
            idx = self.server.holder.index(index)
            f = idx.field(field) if idx is not None else None
            if f is None or f.options.field_type != "set" or f.options.keys:
                # warm plain set fields only: BSI rows aren't queryable
                # as Row(f=id), and keyed rows need a reverse translate
                continue
            frag = self._local_fragment(index, field, view, shard)
            if frag is None:
                continue
            rows = list(frag.row_ids())[: self.WARMUP_ROWS_PER_FRAGMENT]
            for row in rows:
                for _ in range(residency.PROMOTE_TOUCHES):
                    try:
                        api.query(
                            index,
                            f"Count(Row({field}={int(row)}))",
                            shards=[shard],
                        )
                    except Exception:  # pilosa: allow(broad-except) —
                        # warm-up is advisory; the adopt already
                        # committed, so any query-path error here is the
                        # query path's problem, not the resize's
                        return

    def _resolve_node(self, ident: str, uri: str | None = None) -> Node | None:
        """Find a topology node by id or URI. Ids are config-dependent
        (name vs host:port), so admin/peer messages may identify a node
        either way; the URI is canonical."""
        for n in self.nodes:
            if n.id == ident or n.uri == ident:
                return n
            if n.uri in (f"http://{ident}", f"https://{ident}"):
                return n
            if uri and n.uri == uri:
                return n
        return None

    def _broadcast_removal(self, node: Node) -> None:
        # notify every peer INCLUDING the victim — it must stop accepting
        # client writes (silently-lost-writes window otherwise); a failed
        # send is repaired by heartbeat topology reconciliation
        for n in self._peers(alive_only=False):
            try:
                self.client.remove_node(n.uri, node.id, node.uri)
            except PeerError:
                pass

    def remove_node(
        self, ident: str, broadcast: bool = True, uri: str | None = None
    ) -> bool:
        """Drop a node from the topology and rebalance: every surviving
        node re-derives shard ownership and pulls fragments it now owns
        (reference: cluster.go removeNode → ResizeJob; here each node runs
        its own pull instead of a coordinator push). When this node itself
        is the target it enters the REMOVED state: client queries/imports
        are rejected, but /internal/* data-plane routes keep serving so
        survivors can drain its fragments. Returns False if the node is
        unknown. An in-flight rebalance pull is a CONFLICT, not a race
        to win: the pull derives its job list from the pre-remove
        topology, so mutating membership under it can leave this node
        missing fragments whose only holder just left — surface it
        (RebalanceInFlightError → HTTP 409) and let the operator wait."""
        t = self._rebalance_thread
        if t is not None and t.is_alive():
            raise RebalanceInFlightError(
                f"node-remove {ident!r} refused: rebalance pull in "
                f"flight ({t.name}) — wait_rebalanced() first, then "
                "retry (progress: GET /debug/cluster)"
            )
        node = self._resolve_node(ident, uri)
        if node is None:
            if uri:
                # Already absent from our topology: an epoch adoption
                # raced the explicit removal broadcast (the heartbeat
                # adopted a survivor's post-removal list mid-drain). The
                # adoption path's pull runs ASYNC — but this broadcast
                # leg is the victim's synchronous drain barrier, so run
                # the pull here anyway: the victim may be the only
                # holder of shards this node now owns, and the caller
                # (the decommissioned node, an admin script) relies on
                # the data having moved when this returns. prev_state is
                # RESTORED, never forced to NORMAL — a STARTING node
                # must keep rejecting client traffic after the drain.
                # Probe the uri first: it distinguishes a draining victim
                # (still serving /internal/*) from a typo'd identifier —
                # a never-member garbage uri must report failure, not
                # "success" after a pointless cluster-wide sweep.
                try:
                    self.client.status(uri, timeout=5.0)
                except PeerError:
                    return False
                prev_state, self.state = self.state, STATE_RESIZING
                try:
                    self._pull_owned_fragments(
                        [Node(id=ident, uri=uri)] + self._peers()
                    )
                finally:
                    if self.state == STATE_RESIZING:
                        self.state = prev_state
                return True
            return False
        if node.id == self.me.id:
            # self-removal (admin POSTed remove-node to the node being
            # decommissioned): tell the survivors FIRST — they rebalance
            # and drain from us while our internal routes still serve
            if broadcast:
                self._broadcast_removal(node)
            self.removed = True
            self.state = STATE_REMOVED
            return True
        if broadcast:
            self._broadcast_removal(node)
        self.state = STATE_RESIZING
        try:
            self.topology.remove(node.id)
            # the removed node (if still reachable) goes first: for
            # replica_n=1 it is the only holder of its former shards
            self._pull_owned_fragments([node] + self._peers())
        finally:
            if not self.removed:
                self.state = STATE_NORMAL
                if any(not n.alive for n in self._peers(alive_only=False)):
                    self.state = STATE_DEGRADED
        return True

    def _local_fragment(self, index: str, field: str, view: str, shard: int):
        idx = self.server.holder.index(index)
        f = idx.field(field) if idx else None
        v = f.view(view) if f else None
        return v.fragment(shard) if v else None

    # ------------------------------------------------------------- broadcast
    def broadcast_schema(self) -> None:
        # attempt every peer, even ones marked dead — a peer that just came
        # up should not miss schema changes while awaiting the next heartbeat
        schema = self.server.api.schema()
        for n in self._peers(alive_only=False):
            try:
                self.client.send_schema(n.uri, schema)
                n.alive = True
            except PeerError:
                pass

    def broadcast_deletion(self, index: str, field: str | None = None) -> None:
        """Propagate an index/field deletion to every peer (reference:
        broadcast.go DeleteIndexMessage/DeleteFieldMessage; apply_schema is
        additive so deletions need their own message)."""
        if field is None:
            self._purge_shard_caches(index)
        for n in self._peers(alive_only=False):
            try:
                self.client._json(
                    "POST",
                    n.uri,
                    "/internal/schema/delete",
                    {"index": index, "field": field},
                )
                n.alive = True
            except PeerError:
                pass

    # ----------------------------------------------------------- shard scan
    def global_shards(self, index: str) -> list[int]:
        """Union of local shards + cached peer inventories, merged into a
        monotone known-shards cache. ZERO RPCs on the read path: peer
        inventories arrive via synchronous shard ANNOUNCES on every
        transition (router imports creating shards, rebalance-pull
        completion, anti-entropy handoff drops) and ride the heartbeat
        /status exchange — the old per-read node_shards scan put one
        peer RTT per peer under every read (reference analogue:
        availableShards travels in gossip/ClusterStatus, reads never
        poll). Partial-result safety is preserved downstream: a dead
        peer's cached shards still enter the scan, and a shard whose
        only owners are dead raises ShardUnavailableError at routing."""
        idx = self.server.holder.index(index)
        shards: set[int] = set(idx.available_shards()) if idx else set()
        for n in self._peers(alive_only=False):
            shards |= self._peer_shards.get((n.id, index), set())
        with self._shard_cache_lock:
            merged = self._known_shards.get(index, set()) | shards
            self._known_shards[index] = merged  # assignment: lock-free readers
        return sorted(merged)

    def _purge_shard_caches(self, index: str) -> None:
        """Deleting an index must drop BOTH shard caches on this node:
        the monotone known-shards cache would otherwise resurrect ghost
        shards from stale _peer_shards entries when an index is recreated
        under the same name — and reads would fan out to shards that
        never existed."""
        with self._shard_cache_lock:
            self._known_shards.pop(index, None)
            self._told_shards.pop(index, None)
            for key in [k for k in self._peer_shards if k[1] == index]:
                self._peer_shards.pop(key, None)
            # drop the announce stamps too: a stale stamp on a recreated
            # same-name index would suppress heartbeat inventory adoption
            # until some unrelated announce bumps the clock
            for key in [k for k in self._announce_stamp if k[1] == index]:
                self._announce_stamp.pop(key, None)

    def _apply_status_inventory(
        self, node: Node, st: dict, clock0: int | None = None
    ) -> None:
        """Adopt the full per-index inventory a /status response carries
        (heartbeat-time repair for any announce either side missed).
        Whole-set ASSIGNMENT, never in-place mutation — concurrent reads
        iterate these sets lock-free. ``clock0`` is the announce-clock
        reading taken BEFORE the /status fetch: an entry stamped at or
        after it proves an announce raced the fetch, so the snapshot may
        be stale for that (node, index) — skip it rather than wipe the
        just-announced holding (the next heartbeat heals)."""
        inv = st.get("shards")
        if not isinstance(inv, dict):
            return
        with self._shard_cache_lock:
            for idx_name, sh in inv.items():
                key = (node.id, idx_name)
                # strictly greater: stamps post-increment the clock, so
                # an announce applied BEFORE the clock was read carries
                # stamp <= clock0 and the (later-fetched) snapshot is
                # fresher than it — skipping on equality would suppress
                # adoption forever in a quiescent cluster
                if (
                    clock0 is not None
                    and self._announce_stamp.get(key, -1) > clock0
                ):
                    continue
                self._peer_shards[key] = set(sh)

    def _refresh_peer_shards(self, node: Node) -> None:
        """One status round-trip to re-pull a peer's inventory."""
        with self._shard_cache_lock:
            c0 = self._inv_clock
        sent = time.monotonic()
        try:
            st = self.client.status(node.uri, timeout=5.0)
        except PeerError:
            return
        self._learn_from_status(node, st, sent)
        self._apply_status_inventory(node, st, c0)

    def _announce_shards(
        self,
        index: str,
        entries: dict[str, list[int]],
        replace: bool = False,
        marks: list | None = None,
    ) -> list[str]:
        """Tell every peer which nodes (by URI) now hold which shards of
        an index, and apply the same update locally. ``replace`` swaps
        the node's whole inventory (pull/handoff transitions); otherwise
        shards accumulate (imports). Returns the peers that may serve
        but were not told (each as "id: error"): a write refuses its
        ack for them (``_tell_peers``); after a pull or a handoff they
        learn the inventory at their next heartbeat.

        Unlike the reference, which tells only the peers its heartbeat
        holds alive and drops a failed send, every peer that may serve
        (``_may_serve``) is told: untold, such a peer fans a read out
        over the shards it knows and answers a partial count until its
        next heartbeat. A peer that refuses this request is not
        listening; it learns every holder's inventory in ``join``.
        ``marks`` (already merged here) ride along: each peer takes them
        and relays them to the node they name (``_h_shards_announce``)."""
        payload: dict = {"index": index, "entries": entries}
        if replace:
            payload["replace"] = True
        if marks:
            payload["marks"] = marks
        self._apply_shard_entries(payload)
        missed: list[str] = []
        for n in self._peers(alive_only=False):
            if not self._may_serve(n):
                continue
            for attempt in (0, 1):
                try:
                    self.client._json(
                        "POST", n.uri, "/internal/shards/announce", payload
                    )
                    break
                except PeerError as e:
                    if _refused(e):
                        break
                    # sent again once (the announce is idempotent), as a
                    # POST on a stale pooled socket fails; not after a
                    # timeout, which would cost the write another
                    if attempt or isinstance(e.__cause__, TimeoutError):
                        missed.append(f"{n.id}: {e}")
                        break
        return missed

    def _tell_peers(
        self,
        index: str,
        took_write: dict[int, list[str]],
        left_out: dict[int, list[Node]] | None = None,
    ) -> None:
        """A write's announce before its acknowledgement (read-your-
        writes through any node; reads make no RPCs to learn shards):
        for each written shard not yet in ``_told_shards``, name the
        owners that actually took it — a dead owner the fan-out skipped
        must not be advertised as a holder, or reads routed there would
        miss the data. ``left_out`` names, by shard, the owners the write
        skipped (refused, or down): their copies are marked stale, and
        the marks go out even for told shards, since each write's marks
        are new. A peer left untold fails the write with a 503 that
        names it: the data landed, but an acknowledgement would let that
        peer answer partially (or from a copy without it). The client's
        retry announces again."""
        marks = self._mark_left_out(index, left_out or {})
        told = self._told_shards.get(index, set())
        untold = [sh for sh in took_write if sh not in told]
        if not untold and not marks:
            return
        entries: dict[str, list[int]] = {}
        for sh in untold:
            for uri in took_write[sh]:
                entries.setdefault(uri, []).append(sh)
        missed = self._announce_shards(index, entries, marks=marks)
        if missed:
            what = (
                f"shards {sorted(untold)} of {index!r} were written but "
                "peers that serve reads were not told where"
                if untold
                else f"shards {sorted(left_out or ())} of {index!r} were "
                "written without an owner that is down, and peers that "
                "serve reads were not told its copy is stale"
            )
            raise ShardUnavailableError(
                f"{what}: {missed}; the write is not acknowledged, retry it"
            )
        with self._shard_cache_lock:
            self._told_shards[index] = (
                self._told_shards.get(index, set()) | set(untold)
            )

    def _apply_shard_entries(self, payload: dict) -> None:
        # whole-set ASSIGNMENT only (never .update in place): this runs
        # on the HTTP handler thread while concurrent reads iterate the
        # same sets lock-free — set replacement is atomic, mutation isn't
        index = payload["index"]
        with self._shard_cache_lock:
            self._inv_clock += 1
            for uri, sh in payload.get("entries", {}).items():
                node = next((x for x in self.nodes if x.uri == uri), None)
                if node is None or node.id == self.me.id:
                    continue  # local truth comes from the holder
                key = (node.id, index)
                self._announce_stamp[key] = self._inv_clock
                if payload.get("replace"):
                    self._peer_shards[key] = set(sh)
                else:
                    self._peer_shards[key] = (
                        self._peer_shards.get(key, set()) | set(sh)
                    )
            self._known_shards[index] = self._known_shards.get(index, set()) | {
                s for sh in payload.get("entries", {}).values() for s in sh
            }

    # ------------------------------------------------ missed-write marks
    def _mark_left_out(
        self, index: str, left_out: dict[int, list[Node]]
    ) -> list[list]:
        """Mark each left-out owner's copy of its shards stale under one
        new write number of this boot; → the marks on the wire."""
        if not any(left_out.values()):
            return []
        with self._marks_lock:
            self._mark_seq += 1
            stamp = {self._boot: self._mark_seq}
        marks = [
            [n.uri, index, int(sh), stamp]
            for sh, nodes in sorted(left_out.items())
            for n in nodes
        ]
        self._merge_marks({"marks": marks})
        return marks

    def _merge_marks(self, body: dict | None, persist: bool = True) -> bool:
        """Merge marks and catch-up records (``replicaMarks`` of /status,
        an announce, the marks file): per writer boot the larger write
        number wins, in both tables; the tables, these marks included,
        are on disk when this returns (unless ``persist`` is off). →
        whether anything was new."""
        if not body:
            return False
        changed = False
        with self._marks_lock:
            for name, table in (("marks", self._marks), ("caught", self._caught)):
                for uri, index, shard, stamps in body.get(name) or ():
                    key = (uri, index, int(shard))
                    cur = table.get(key)
                    for boot, seq in stamps.items():
                        if cur is None or cur.get(boot, 0) < seq:
                            if cur is None:
                                cur = table[key] = {}
                            cur[boot] = int(seq)
                            changed = True
            if changed:
                self._marks_gen += 1
                self._rebuild_stale_view()
        if persist:
            # also when nothing was new: a concurrent merge of the same
            # marks may not have written them yet
            self._persist_marks()
        return changed

    def _persist_marks(self) -> None:
        """Write both tables to the marks file, atomically and durably,
        once every change merged before this call is in what it writes
        (a caller whose change a concurrent write already covered
        returns without writing)."""
        if self._marks_path is None:
            return
        with self._marks_lock:
            want = self._marks_gen
        with self._marks_file_lock:
            if self._marks_saved >= want:
                return
            t0 = time.perf_counter()
            with self._marks_lock:
                gen = self._marks_gen
                body = self._marks_tables()
            os.makedirs(os.path.dirname(self._marks_path), exist_ok=True)
            durable.atomic_write_file(
                self._marks_path, json.dumps(body), op="marks-write"
            )
            self._marks_saved = gen
            self.marks_file["writes"] += 1
            self.marks_file["seconds"] += time.perf_counter() - t0

    def _load_marks(self) -> bool:
        """Merge the marks file into the tables (a missing file holds no
        marks; the write is atomic, so a file is never torn). Keys
        already covered start their forgetting horizon again
        (``_rebuild_stale_view``). → whether anything was new."""
        if self._marks_path is None:
            return False
        t0 = time.perf_counter()
        try:
            with open(self._marks_path) as f:
                body = json.load(f)
        except FileNotFoundError:
            body = None
        changed = self._merge_marks(body, persist=False)
        if changed:
            # what the file holds needs no write back
            with self._marks_lock:
                gen = self._marks_gen
            with self._marks_file_lock:
                self._marks_saved = max(self._marks_saved, gen)
        self.marks_load_s = time.perf_counter() - t0
        return changed

    def _is_stale(self, key: tuple[str, str, int]) -> bool:
        # under _marks_lock: a write number past what catch-up covered
        caught = self._caught.get(key, {})
        return any(
            seq > caught.get(boot, 0) for boot, seq in self._marks.get(key, {}).items()
        )

    def _rebuild_stale_view(self) -> None:
        # under _marks_lock; whole-dict assignment for lock-free readers
        view: dict[str, dict[int, set[str]]] = {}
        now = time.monotonic()
        for key in self._marks.keys() | self._caught.keys():
            if self._is_stale(key):
                uri, index, shard = key
                view.setdefault(index, {}).setdefault(shard, set()).add(uri)
                self._covered_at.pop(key, None)
            else:
                self._covered_at.setdefault(key, now)
        self._stale_view = {
            index: {s: frozenset(u) for s, u in by_shard.items()}
            for index, by_shard in view.items()
        }

    def _forget_covered_marks(self) -> None:
        """Drop marks a catch-up covered long ago, so /status does not
        carry them forever. Safe whenever: a peer that still holds such
        a mark revives it here, and the node it names only catches up
        once more."""
        horizon = time.monotonic() - 10 * self.lease_s
        with self._marks_lock:
            old = [k for k, t in self._covered_at.items() if t < horizon]
            for key in old:
                self._marks.pop(key, None)
                self._caught.pop(key, None)
                self._covered_at.pop(key, None)
            if old:
                self._marks_gen += 1
        if old:
            self._persist_marks()

    def marks_snapshot(self) -> dict:
        """The marks and catch-up records this node knows (``replicaMarks``
        on /status): ``[owner uri, index, shard, {writer boot: write
        number}]`` each; a copy is stale while a mark's number passes the
        record's."""
        with self._marks_lock:
            return self._marks_tables()

    def _marks_tables(self) -> dict:
        # under _marks_lock
        return {
            name: [[u, i, s, dict(st)] for (u, i, s), st in table.items()]
            for name, table in (("marks", self._marks), ("caught", self._caught))
        }

    def _stale_uris(self, index: str, shard: int) -> frozenset[str]:
        by_shard = self._stale_view.get(index)
        return by_shard.get(shard, frozenset()) if by_shard else frozenset()

    def _stale_shards(self, index: str, uri: str) -> set[int]:
        by_shard = self._stale_view.get(index)
        if not by_shard:
            return set()
        return {s for s, uris in by_shard.items() if uri in uris}

    def _stale_keys_of_mine(self) -> dict[tuple[str, int], dict[str, int]]:
        """(index, shard) -> the marks on this node's stale copies."""
        with self._marks_lock:
            return {
                key[1:]: dict(stamps)
                for key, stamps in self._marks.items()
                if key[0] == self.me.uri and self._is_stale(key)
            }

    def _write_waves(
        self, index: str, shard: int | None, nodes: list[Node]
    ) -> tuple[list[Node], list[Node]]:
        """``nodes`` in the two waves a write reaches them in: those
        whose copy of ``shard`` (of any shard of the index, for None) is
        current, then those whose copy is marked stale. A stale owner
        that takes a write then took it after every current owner did,
        so a catch-up that has not armed its capture yet fetches a copy
        that holds it (C12). Two writes from different coordinators to
        one bit keep no cluster-wide order, as in the reference."""
        by_shard = self._stale_view.get(index)
        if not by_shard:
            return list(nodes), []
        if shard is None:
            stale = {u for uris in by_shard.values() for u in uris}
        else:
            stale = by_shard.get(shard, frozenset())
        return (
            [n for n in nodes if n.uri not in stale],
            [n for n in nodes if n.uri in stale],
        )

    @contextlib.contextmanager
    def _planning(self, index: str):
        """Count a write this node coordinates as in flight, under the
        marks generation it is planned with, from before it reads the
        stale view (``_write_waves``) until its legs and its announce
        have ended (C14). The view it reads is at least that new: the
        view is rebuilt with every bump of the generation, under the
        same lock. A barrier that read a newer generation after merging
        its marks and found this write not yet counted saw it before it
        read the view, so the write sees those marks."""
        with self._marks_lock:
            key = (index, self._marks_gen)
        with self._in_flight_cv:
            self._in_flight[key] = self._in_flight.get(key, 0) + 1
        try:
            yield
        finally:
            with self._in_flight_cv:
                if self._in_flight[key] == 1:
                    del self._in_flight[key]
                else:
                    self._in_flight[key] -= 1
                self._in_flight_cv.notify_all()

    def _drain_writes(self, index: str, marks: list) -> None:
        """A peer's half of a catch-up's barrier (C14): merge the marks
        that the asker catches up, then wait until every write this node
        began on ``index`` under an older marks generation has ended,
        acknowledged or failed. A write planned from then on sees the
        marks, so it reaches the stale owner only after every current
        owner took it (``_write_waves``). Raises ShardUnavailableError
        if such a write is still in flight after DRAIN_WAIT_S."""
        self._merge_marks({"marks": marks})
        with self._marks_lock:
            gen = self._marks_gen
        deadline = time.monotonic() + DRAIN_WAIT_S
        with self._in_flight_cv:
            while any(i == index and g < gen for i, g in self._in_flight):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ShardUnavailableError(
                        f"writes to {index!r} that {self.me.id} began "
                        "before it knew the marks being caught up are "
                        f"still in flight after {DRAIN_WAIT_S:.0f} s"
                    )
                self._in_flight_cv.wait(left)

    def _drain_peers(self, index: str, marks: list) -> bool:
        """A catch-up's barrier before it arms its captures on ``index``
        (C14): every node that may coordinate a write, this one
        included, merges ``marks`` (this node's own, being caught up)
        and answers once no write it began without them is in flight
        (``_drain_writes``). Without it a write whose coordinator had
        not learned a mark may reach this stale copy first and the
        current owner only after this node fetched that owner's copy:
        the capture is not armed yet, so nothing would replay it. After
        the barrier every write reaches this node after the current
        owners took it, or lands after the capture is armed (C12).

        Two kinds of peer are not waited for. One that refuses the
        request is not listening, so it coordinates nothing; one that
        restarted answers with no write of its old boot in flight. One
        this node has not heard for ``down_after_s + leg_timeout_s``
        has fenced itself (by down_after_s it has heard from no peer for
        a lease, or its probe of this node said it was not heard for
        one; ``_check_lease``), so it sends no further write leg, and a
        leg it sent before has ended within its RPC timeout. A peer
        heard more recently that does not answer keeps the index's
        shards stale, as a failed fetch does; the next heartbeat tries
        again. So a closed coordinator delays no catch-up, and one cut
        off keeps the shards stale at most down_after_s + leg_timeout_s
        after this node last heard it (60 s at the default 15 s lease
        and 30 s RPC timeout), plus one heartbeat. A catch-up pays one
        round trip to each peer per index, and waits for the writes
        begun before the marks, at most DRAIN_WAIT_S. → whether every
        peer answered or was skipped."""
        try:
            self._drain_writes(index, marks)
            horizon = self.down_after_s + self.leg_timeout_s
            for n in self._peers(alive_only=False):
                if time.monotonic() - self._heard_at(n) > horizon:
                    continue
                try:
                    self.client._json(
                        "POST", n.uri, "/internal/marks/drain",
                        {"index": index, "marks": marks},
                        timeout=2 * DRAIN_WAIT_S,
                    )
                except PeerError as e:
                    if not _refused(e):
                        raise ShardUnavailableError(
                            f"{n.id} did not drain its writes: {e}"
                        ) from e
        except ShardUnavailableError as e:
            self.server.logger.log(f"catch-up of {index} waits: {e}")
            return False
        return True

    def _owned_shards(self, index: str, node: Node) -> dict[int, list[Node]]:
        """Every known shard of ``index`` that ``node`` owns, for the
        marks of a write that reaches all of them (a broadcast write)."""
        return {
            s: [node]
            for s in self.global_shards(index)
            if self.topology.owns(node.id, index, s)
        }

    def _relay_marks(self, payload: dict) -> None:
        """Pass an announce's marks on to the nodes they name, where this
        node may be serving with them: the writer cannot reach a node it
        counts down, which may still be serving (C9: node 0 cannot reach
        node 2, but node 2 reaches its peers). A relay that fails without
        a refusal fails this announce, so the write is a 503 naming the
        node; a node that refuses serves nothing and learns the marks in
        ``join``."""
        by_uri: dict[str, list] = {}
        for mark in payload.get("marks") or ():
            by_uri.setdefault(mark[0], []).append(mark)
        for uri, marks in by_uri.items():
            node = next((n for n in self.nodes if n.uri == uri), None)
            if node is None or node.id == self.me.id or not self._may_serve(node):
                continue
            try:
                self.client._json(
                    "POST",
                    uri,
                    "/internal/shards/announce",
                    {"index": payload["index"], "entries": {}, "marks": marks,
                     "relayed": True},
                    timeout=RELAY_TIMEOUT_S,
                )
            except PeerError as e:
                if _refused(e):
                    continue
                raise ShardUnavailableError(
                    f"{node.id} may be serving, and the mark that its copy "
                    f"{STALE_COPY} could not be relayed to it: {e}"
                ) from e

    def _start_catch_up(self) -> None:
        t = self._catch_up_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._catch_up, daemon=True, name="catch-up")
        self._catch_up_thread = t
        t.start()

    def _catch_up(self) -> list[tuple[str, int]]:
        """Replace every copy of this node's that is marked stale with a
        current owner's (one that is not marked stale for the shard and
        was heard within lease_s), every field and view of the
        shard, and merge the index's attr stores (a mark on the attr
        stores alone, ``ATTRS_SHARD``, merges them from any current
        node); then record the marks read before the copy as covered and
        tell every peer, which stop routing around the copy. A union
        would keep the bits a missed Clear removed. Before the first
        copy of an index, every peer that may write has drained the
        writes it began without the marks (``_drain_peers``, C14). A
        shard that no current owner gave, whatever the failure, stays
        stale.
        → the (index, shard) pairs caught up."""
        with self._catch_up_lock:
            mine = self._stale_keys_of_mine()
            if not mine:
                return []
            t0 = time.monotonic()
            inventories: dict[tuple[str, str], list[dict]] = {}
            schema_from: set[str] = set()
            done: list[tuple[str, int]] = []
            drained: dict[str, bool] = {}
            for index, shard in sorted(mine):
                if index not in drained:
                    drained[index] = self._drain_peers(index, [
                        [self.me.uri, i, s, stamps]
                        for (i, s), stamps in mine.items() if i == index
                    ])
                if not drained[index]:
                    continue
                sources = (
                    self._peers(alive_only=False)
                    if shard == ATTRS_SHARD
                    else self.shard_nodes(index, shard)
                )
                for src in sources:
                    if (
                        src.id == self.me.id
                        or src.uri in self._stale_uris(index, shard)
                        or not self._heard_within_lease(src)
                    ):
                        continue
                    try:
                        if src.uri not in schema_from:
                            self.server.api.apply_schema(
                                self.client._json("GET", src.uri, "/schema"),
                                validate=False,
                            )
                            schema_from.add(src.uri)
                        if shard == ATTRS_SHARD:
                            idx = self.server.holder.index(index)
                            if idx is not None:
                                self._merge_attr_stores(src, index, idx)
                        else:
                            if (src.uri, index) not in inventories:
                                inventories[(src.uri, index)] = (
                                    self.client.fragment_inventory(src.uri, index)
                                )
                            self._replace_shard(
                                src, index, shard, inventories[(src.uri, index)]
                            )
                    except Exception as e:  # noqa: BLE001 — the shard stays stale
                        self.server.logger.log(
                            f"catch-up of {index}/{shard} from {src.id}: "
                            + (str(e) if isinstance(e, PeerError)
                               else traceback.format_exc())
                        )
                        continue
                    done.append((index, shard))
                    break
            if not done:
                return []
            for index in sorted({i for i, _ in done}):
                idx = self.server.holder.index(index)
                if idx is not None:
                    self._sync_attr_stores(index, idx)
                self.server.api._invalidate_results(index)
            covered = [
                [self.me.uri, index, shard, mine[(index, shard)]]
                for index, shard in done
            ]
            self._merge_marks({"caught": covered})
            by_index: dict[str, list] = {}
            for rec in covered:
                by_index.setdefault(rec[1], []).append(rec)
            # best effort: a peer this misses keeps routing around the
            # copy until its heartbeat reads the record on our /status
            for n in self._peers(alive_only=False):
                for index, recs in by_index.items():
                    try:
                        self.client._json(
                            "POST", n.uri, "/internal/shards/announce",
                            {"index": index, "entries": {}, "caught": recs},
                            timeout=RELAY_TIMEOUT_S,
                        )
                    except PeerError:
                        break
            self.last_catch_up = {
                "shards": len(done),
                "seconds": round(time.monotonic() - t0, 3),
            }
            return done

    def _replace_shard(
        self, src: Node, index: str, shard: int, inventory: list[dict]
    ) -> None:
        """Make every fragment of ``shard`` here equal ``src``'s, plus
        the writes this node applies meanwhile (C12): each fragment's
        capture is armed before the first fetch, so a write that lands
        here while ``src``'s copies are fetched is replayed on them by
        ``Fragment.replace``, whether or not ``src`` had it when it
        answered. A write this node took before the capture was armed
        is in ``src``'s copy already: a coordinator writes a stale owner
        only after every current owner took the write
        (``_write_waves``), and every write planned before its
        coordinator knew the marks has ended (``_drain_peers``). Every
        fragment either side holds is fetched (one ``src`` lacks comes
        back empty)."""
        idx = self.server.holder.index(index)
        if idx is None:
            return
        theirs = {
            (f["field"], f["view"]) for f in inventory if f["shard"] == shard
        }
        mine = {
            (f_name, v_name)
            for f_name, f in list(idx.fields.items())
            for v_name, view in list(f.views.items())
            if view.fragment(shard) is not None
        }
        frags = []
        try:
            for field, view in sorted(theirs | mine):
                f = (
                    idx.existence_field()
                    if field == EXISTENCE_FIELD
                    else idx.field(field)
                )
                if f is None:
                    continue  # a field of the source's schema we cannot make
                frag = f.create_view_if_not_exists(
                    view
                ).create_fragment_if_not_exists(shard)
                frag.capture_ops()
                frags.append((f, field, view, frag))
            for f, field, view, frag in frags:
                with self.movement.transfer(
                    "pull", index, field, view, shard, peer=src.uri
                ) as row:
                    data = self._retrieve_with_backoff(
                        src, index, field, view, shard
                    )
                    row["bytes"] = len(data)
                    self.movement.throttle(len(data))
                    self.movement.account("pull", len(data))
                frag.replace(data)
                if view == VIEW_BSI:
                    f.fit_depth(frag)
        finally:
            for *_, frag in frags:
                frag.end_capture()  # a no-op once replaced

    # -------------------------------------------------------------- queries
    def query(self, index: str, pql: str, shards: list[int] | None) -> dict:
        self._check_ready()
        calls = parse(pql)
        api = self.server.api
        api.check_write_limit(api.count_query_writes(calls), "query")
        # coordinator-side result-cache consult BEFORE the fan-out: a
        # hit spends zero RPCs and zero remote device waves.  The key's
        # mutation stamp is THIS node's — remote writes that bypassed
        # this coordinator are covered by the write-path invalidation
        # broadcast (every coordinator write path calls
        # _broadcast_cache_invalidate before its ack returns).
        cache = getattr(api, "result_cache", None)
        key = None
        gen = 0
        t0 = 0.0
        has_write = any(
            unwrap_options(c).name in WRITE_CALLS for c in calls
        )
        if cache is not None and cache.enabled:
            # teach the event-loop fast path this text's identity (the
            # loop itself never parses — docs/result-cache.md)
            cache.memoize_pql(pql, None if has_write else calls)
        if cache is not None and cache.enabled and not has_write:
            key = api._result_cache_key(index, calls, shards)
            if key is not None:
                hit = cache.get(key)
                if hit is not None:
                    return hit.resp
                gen = cache.generation(index)
                t0 = time.perf_counter()
        results = []
        wrote = False
        for call in calls:
            # classify on the innermost call: Options(Set(...)) — however
            # deeply wrapped — must take the write path (replica
            # fan-out), not the read scatter
            inner = unwrap_options(call)
            if inner.name in WRITE_CALLS:
                wrote = True
                results.append(self._route_write(index, inner))
            else:
                results.append(self._route_read(index, call, shards))
        if wrote:
            # the coordinator-local write legs (and any translate-key
            # allocations the routing did) dirtied WALs on THIS node:
            # group-fsync them before the acknowledgement leaves, same
            # contract as the single-node api.query (docs/durability.md)
            durable.ack_barrier()
            api._invalidate_results(index)
            self._broadcast_cache_invalidate(index)
        resp = self.server.api.build_response(results)
        qctx = resilience.current_query_context()
        if qctx is not None and qctx.partial_shards:
            # ?allow-partial=true and at least one shard had no
            # surviving replica: label the degradation on the response
            # (and in metrics) — a silently partial answer is the one
            # thing this path must never produce
            resp["partialShards"] = sorted(set(qctx.partial_shards))
            self.server.stats.count("queries_partial")
            # a degraded answer must never be served to later full-
            # replica requests from cache
            key = None
        if key is not None:
            cache.offer(key, resp, time.perf_counter() - t0, gen=gen)
        return resp

    def _broadcast_cache_invalidate(self, index: str) -> None:
        """A write acknowledged by THIS node must not leave a bystander
        peer serving its pre-write cached results: a non-owner's
        mutation stamp never moves on a remote write, so its result-
        cache keys still verify against stale entries.  Synchronous
        best-effort POST to every alive peer before the write's ack
        returns; an unreachable peer's staleness window is bounded by
        the cache's revalidate-every-N countdown (docs/result-cache.md)."""
        cache = getattr(self.server.api, "result_cache", None)
        if cache is None or not cache.enabled:
            return
        for n in self._peers():
            try:
                self.client._json(
                    "POST",
                    n.uri,
                    "/internal/cache/invalidate",
                    {"index": index},
                )
            except PeerError:
                pass

    def _h_cache_invalidate(self, handler) -> None:
        """Receiver half of the write-path invalidation broadcast: a
        remote write doesn't move this node's mutation stamp, so the
        stamp check alone cannot retire entries it dirtied."""
        body = handler._json_body()
        self.server.api._invalidate_results(body["index"])
        handler._json({"success": True})

    def _route_read(self, index: str, call: Call, shards: list[int] | None) -> Any:
        # scatter only the inner call of an Options() wrapper: result
        # shaping (columnAttrs/exclude*) is re-derived at the coordinator
        # after the merge, so running it on every node is pure waste
        wrapper: Call | None = None
        if call.name == "Options":
            if len(call.children) != 1:
                raise ValueError("Options() takes exactly one call")
            wrapper = call
            opt_shards = wrapper.arg("shards")
            if opt_shards is not None:
                shards = list(opt_shards)
            call = call.children[0]
        call = self._translate_read_keys(index, call)
        if call.name == "IncludesColumn":
            # only the column's own shard can answer — one RPC, not a fan-out
            col = call.arg("column")
            if isinstance(col, (int, np.integer)):
                col = int(col)
                if col < 0:
                    return False  # unknown column key
                shard = col // SHARD_WIDTH
                if shards is not None and shard not in shards:
                    return False
                shards = [shard]
        all_shards = shards if shards is not None else self.global_shards(index)
        if not all_shards:
            all_shards = [0]
        by_node: dict[str, list[int]] = {}
        node_by_id = {n.id: n for n in self.nodes}
        holdings = self._read_holdings(index)
        qctx = resilience.current_query_context()
        probed: set[str] = set()
        for s in all_shards:
            primary = self._pick_read_node(index, s, holdings)
            if primary is None and self._revive_owners(index, s, probed):
                primary = self._pick_read_node(index, s, holdings)
            if primary is None:
                # ?allow-partial=true opts into serving what survives:
                # the skipped shard is recorded and surfaces on the
                # response as the partialShards annotation — silence is
                # never an option, degradation must be labeled
                if qctx is not None and qctx.allow_partial:
                    qctx.partial_shards.append(s)
                    continue
                stale = self._stale_uris(index, s)
                if stale:
                    raise ShardUnavailableError(
                        f"no current owner for shard {s}: the copies of "
                        f"{sorted(stale)} {STALE_COPY} and have not caught "
                        "up, and no other owner is alive"
                    )
                raise ShardUnavailableError(f"no alive owner for shard {s}")
            by_node.setdefault(primary.id, []).append(s)
        if not by_node:
            # every shard skipped (partial mode with no survivors):
            # nothing to scatter — reduce over an empty partial set
            return reduce_results(call, [])

        send = call
        # A scatter with ANY remote leg can SPLIT mid-query: in-query
        # failover re-plans a failed leg's shards across surviving
        # replicas, so len(by_node) == 1 only proves a single-node
        # merge when that node is THIS one (local legs cannot fail
        # over). The exact multi-node merge transforms (GroupBy limit
        # pinning, TopN two-phase/n-strip) must therefore be chosen
        # whenever a remote leg exists — otherwise a failover during
        # the degraded window would merge limit-truncated per-node
        # partials and under-count.
        multi = len(by_node) > 1 or any(
            nid != self.me.id for nid in by_node
        )
        if call.name == "GroupBy" and multi:
            # Per-node truncation before a cross-node merge under-counts:
            # a group cut by `limit` on node A but not node B merges with
            # only B's partial count. Strip the GroupBy limit (re-applied
            # after the full merge) and pin every child Rows(limit=) to
            # the GLOBAL first-L rows — resolved by fanning out the child
            # Rows call itself, whose sorted-union merge is exact — so
            # each node expands exactly the globally-limited row set,
            # including rows that yield zero local groups (single-node
            # semantics: the limit cuts the row universe, not the group
            # list). Reference: executor.go executeGroupBy reduces FULL
            # per-shard group lists before applying limit.
            send = self._pin_groupby_rows(index, call, shards)
        if (
            call.name == "TopN"
            and call.arg("n") is not None
            and call.arg("ids") is None
            and multi
        ):
            partials = self._topn_two_phase(index, call, by_node, node_by_id)
        else:
            if (
                call.name == "TopN"
                and call.arg("ids") is not None
                and call.arg("n") is not None
                and multi
            ):
                # ids= recounts are exact per node, but a local n cut
                # would truncate them back to partial lists — strip n for
                # the fan-out; reduce_results re-applies it post-merge.
                send = Call(
                    "TopN",
                    {k: v for k, v in call.args.items() if k != "n"},
                    list(call.children),
                    list(call.pos_args),
                )
            partials = self._fanout(index, send, by_node, node_by_id)
        result = reduce_results(call, partials)
        if call.name in ("Rows", "TopN"):
            # per-node partials resolve keys from each node's LOCAL
            # translate cache — a node lagging the primary's tail emits
            # the id as a string. Re-derive at the coordinator, tailing
            # the primary for gaps (same discipline as column keys).
            self._reattach_row_keys(index, call, result)
        if isinstance(result, RowResult):
            self._attach_column_keys(index, result)
            # attrs/options don't survive the segment wire format; attr
            # stores replicate cluster-wide, so re-derive at the
            # coordinator (reference: executor reduce attaches attrs)
            idx = self.server.holder.index(index)
            if idx is not None and self.me.uri in self._stale_uris(index, ATTRS_SHARD):
                self._attach_current_attrs(index, idx, call, wrapper, result)
            elif idx is not None:
                self.server.api.executor._attach_row_attrs(idx, call, result)
                if wrapper is not None:
                    apply_options(idx, wrapper, result)
        return result

    def _attach_current_attrs(
        self, index: str, idx, call: Call, wrapper: Call | None, result: RowResult
    ) -> None:
        """A coordinator whose attr stores of the index are marked stale
        missed an attribute write (C13): a read's row attributes and,
        under ``columnAttrs``, its column attributes come from a current
        node instead of its own stores (no RPC when the read wants
        neither)."""
        row = self.server.api.executor._attr_row(idx, call)
        cols = (
            result.columns()
            if wrapper is not None and wrapper.arg("columnAttrs")
            else None
        )
        col_attrs = None
        if row is not None or cols is not None:
            row_attrs, col_attrs = self._current_attrs(index, row, cols)
            if row is not None:
                result.attrs = row_attrs
        if wrapper is not None:
            apply_options(idx, wrapper, result, column_attrs=col_attrs)

    def _current_attrs(
        self, index: str, row: tuple[str, int] | None, cols
    ) -> tuple[dict, dict[int, dict]]:
        """The attributes of ``row`` (field, id) and of the columns
        ``cols`` from a peer whose attr stores are not marked stale and
        that this node heard within lease_s; → (row attrs, {column:
        attrs}). None answers: a 503 naming STALE_COPY."""
        body = {
            "index": index,
            "field": row[0] if row else None,
            "row": row[1] if row else None,
            "columns": [] if cols is None else [int(c) for c in cols],
        }
        stale = self._stale_uris(index, ATTRS_SHARD)
        errors = []
        for n in self._peers(alive_only=False):
            if n.uri in stale or not self._heard_within_lease(n):
                continue
            try:
                got = self.client._json("POST", n.uri, "/internal/attrs/get", body)
            except PeerError as e:
                errors.append(f"{n.id}: {e}")
                continue
            return got.get("rowAttrs") or {}, {
                int(c): a for c, a in (got.get("columnAttrs") or {}).items()
            }
        raise ShardUnavailableError(
            f"this node's copies of {index!r} {STALE_COPY}, and no current "
            f"node it heard gave the read's attributes: {errors or 'none heard'}"
        )

    def _read_holdings(self, index: str) -> dict[str, Any]:
        """Per-node shard holdings resolved ONCE per read (the local
        available_shards set is a union over all fragments; peers come
        from the announced-inventory cache — zero RPCs)."""
        idx_obj = self.server.holder.index(index)
        local_avail = idx_obj.available_shards() if idx_obj else set()
        return {
            n.id: (
                local_avail
                if n.id == self.me.id
                else self._peer_shards.get((n.id, index), ())
            )
            for n in self.nodes
        }

    def _pick_read_node(
        self,
        index: str,
        s: int,
        holdings: dict[str, Any],
        exclude: frozenset[str] | set[str] = frozenset(),
    ) -> Node | None:
        """The node that should execute shard ``s`` for a read, or None
        when no candidate survives (``exclude`` names peers that already
        failed this query — in-query failover re-plans around them).

        PREFER an owner that actually HOLDS the fragment: mid-resize a
        shard's new owner may still be pulling, and routing there would
        silently count zeros. The previous holder keeps its copy until
        the anti-entropy handoff completes, so falling back to ANY alive
        node reporting the shard serves exact data through the window
        (reference: ResizeJob serves from the old assignment until the
        job completes). Last resort — nobody reports the shard at all —
        is the first alive owner, which may still be pulling.

        Never a node whose copy of ``s`` is marked stale (missed an
        acknowledged write; ``_mark_left_out``), this node included: a
        lookup in memory, like the holdings, so a read adds no RPC."""
        stale = self._stale_uris(index, s)
        alive_owners = [
            n
            for n in self.shard_nodes(index, s)
            if self._alive_for_read(n) and n.id not in exclude and n.uri not in stale
        ]
        if not alive_owners:
            return None
        holders = [n for n in alive_owners if s in holdings[n.id]]
        if holders:
            # Replica read load-balancing (reference: cluster.go
            # shardNodes — any replica serves a read). Serve locally
            # when this node is a holder (a local partial costs no
            # RPC at all — what makes full replication scale reads
            # linearly with nodes); otherwise pick a holder by a
            # PER-SHARD-stable hash: different shards land on
            # different replicas (aggregate load spreads), while one
            # shard's reads stay pinned to one replica, whose stacks
            # stay warm. A replica that missed a write (it was down
            # when the write was acknowledged) is not among the
            # holders: it is marked stale and gets no read of the shard
            # until it has replaced its copy (_catch_up).
            local = next((n for n in holders if n.id == self.me.id), None)
            return (
                local
                if local is not None
                else holders[(s ^ (s >> 7)) % len(holders)]
            )
        read_alive = [
            n
            for n in self.nodes
            if self._alive_for_read(n) and n.id not in exclude and n.uri not in stale
        ]
        return next(
            (n for n in read_alive if s in holdings[n.id]),
            alive_owners[0],
        )

    def _revive_owners(self, index: str, s: int, probed: set[str]) -> bool:
        """Re-probe the dead-marked owners of shard ``s`` that this read
        has not probed yet (``probed``, updated); True when one answered,
        which marks it alive. Unlike the reference, which fails the read
        at once when no owner is marked alive: a dead mark may be stale
        by up to a heartbeat period (a peer that refused its probe while
        it started, a leg that failed under load) while every owner
        serves. A read pays this only where it would otherwise fail, one
        probe a node (a refusal returns at once)."""
        revived = False
        for n in self.shard_nodes(index, s):
            if n.id == self.me.id or n.alive or n.id in probed:
                continue
            probed.add(n.id)
            try:
                self._probe(n)
            except PeerError:
                continue
            n.alive = True
            revived = True
        return revived

    def _timed_query_node(
        self,
        span_name: str,
        node: "Node",
        index: str,
        pql: str,
        shards: list[int] | None,
        write: bool = False,
    ) -> tuple[list[Any], float]:
        """One fan-out RPC leg with the observability contract applied
        in ONE place: a tracing span + the ``fanout_rpc_seconds``
        histogram.  The RPC itself goes through the per-peer leg
        coalescer (``_NodeLegBatcher``) so concurrent legs to the same
        node share one multi-query /internal RPC; this span therefore
        covers queue wait + the (possibly shared) round trip — per-leg
        latency as the CALLER experienced it.  Returns (decoded results,
        elapsed seconds); a failed leg raises before the histogram
        records, same as before extraction.

        ``write=True`` legs (the replica write fan-out) take the
        single-shot RPC instead: OUTSIDE the leg coalescer (a write must
        not ride an envelope whose transport retry would replay it) and
        OUTSIDE the retry scope (``query_node_once``) — a replayed
        Set/Clear is a duplicated write, so writes fail loudly and leave
        the retry decision to the client."""
        t0 = time.perf_counter()
        with GLOBAL_TRACER.span(
            span_name, node=node.id, shards=len(shards) if shards else 0
        ):
            if write:
                result = self.client.query_node_once(
                    node.uri, index, pql, shards
                )
            else:
                result = self._legs.call(node, index, pql, shards)
        elapsed = time.perf_counter() - t0
        if self.server.stats is not None:
            self.server.stats.timing(
                "fanout_rpc_seconds", elapsed, tags={"node": node.id}
            )
        return result, elapsed

    def _fanout(
        self,
        index: str,
        call: Call,
        by_node: dict[str, list[int]],
        node_by_id: dict[str, "Node"],
    ) -> list[Any]:
        """Scatter one call to its shard owners, gather decoded partials.
        Every leg records fan-out latency (histogram + span + profile
        shard-group entry) so tail latency is attributable to the node —
        and therefore the shards — that caused it.

        In-query replica FAILOVER (docs/fault-tolerance.md): a leg that
        fails with a retryable error — transport drop, 5xx, breaker
        fast-fail — after the client wrapper's own same-peer retries no
        longer errors the query.  The peer is marked dead (so concurrent
        queries stop routing to it), the leg's shards re-plan onto the
        next surviving replica owner, and the scatter continues.  Each
        failure permanently excludes that peer for THIS query, so the
        loop is bounded by the node count.  A shard with no surviving
        owner fails the query — unless the client opted into
        ?allow-partial=true, in which case it joins the response's
        partialShards annotation.  Permanent errors (4xx: the peer
        answered and refused) are not failed over — every replica would
        refuse identically."""
        partials: list[Any] = []
        prof = tracing.current_profile()
        stats = self.server.stats
        pending: list[tuple[str, list[int]]] = list(by_node.items())
        failed: set[str] = set()
        probed: set[str] = set()
        holdings: dict[str, Any] | None = None
        while pending:
            node_id, node_shards = pending.pop()
            t0 = time.perf_counter()
            if node_id == self.me.id:
                # this node serves its own shard group — counts toward
                # the per-node replica read spread (see _h_query). Via
                # the wave scheduler: concurrent coordinator threads'
                # local legs coalesce into shared device waves.
                if stats is not None:
                    stats.count("queries_served", tags={"path": "local"})
                with GLOBAL_TRACER.span(
                    "cluster.local", node=node_id, shards=len(node_shards)
                ):
                    partials.extend(
                        self.server.api.scheduler.execute(
                            index, [call], shards=node_shards
                        )
                    )
                if prof is not None:
                    prof.add_fanout(
                        call.name,
                        node_id,
                        node_shards,
                        time.perf_counter() - t0,
                        0,
                    )
                continue
            node = node_by_id[node_id]
            try:
                remote, elapsed = self._timed_query_node(
                    "cluster.fanout",
                    node,
                    index,
                    call.to_pql(),
                    node_shards,
                )
            except PeerError as e:
                gated = any(text in str(e) for text in NOT_SERVING)
                if not e.retryable and not gated:
                    # the peer ANSWERED with a permanent refusal (4xx):
                    # no replica would answer differently — fail loudly,
                    # and don't dead-mark a peer that is demonstrably up
                    raise ShardUnavailableError(
                        f"shard owner {node_id} failed mid-query: {e}"
                    ) from e
                # a probe-gate 503 means the peer is ALIVE and serving
                # (its heartbeats succeed) but its card is not: the
                # verdict is pending, or the card failed its probe —
                # marking it dead would route reads around a live sole
                # holder for the whole probe window, and a failed card
                # is named in the error below when no replica survives;
                # still fail THIS query's legs over to a surviving
                # replica. The same for the peer's other NOT_SERVING
                # answers: it is up, but its copy missed writes (this
                # node learns the mark at its next heartbeat), a peer has
                # not heard it, or it is still joining. Any other
                # retryable failure: heartbeat state was stale — mark
                # dead NOW so concurrent queries reroute.
                if not gated:
                    node.alive = False
                failed.add(node_id)
                if stats is not None:
                    stats.count("legs_failed_over")
                if holdings is None:
                    holdings = self._read_holdings(index)
                lost: list[int] = []
                replan: dict[str, list[int]] = {}
                probed |= failed
                for s in node_shards:
                    target = self._pick_read_node(
                        index, s, holdings, exclude=failed
                    )
                    if target is None and self._revive_owners(index, s, probed):
                        target = self._pick_read_node(
                            index, s, holdings, exclude=failed
                        )
                    if target is None:
                        lost.append(s)
                    else:
                        replan.setdefault(target.id, []).append(s)
                        node_by_id.setdefault(target.id, target)
                if prof is not None:
                    # per-query failover attribution: the evidence the
                    # flight recorder retains names the failed peer and
                    # where each shard group went (docs/fault-tolerance.md)
                    for to_id, moved in replan.items():
                        prof.note_failover(node_id, to_id, moved)
                if lost:
                    qctx = resilience.current_query_context()
                    if qctx is not None and qctx.allow_partial:
                        qctx.partial_shards.extend(lost)
                    else:
                        raise ShardUnavailableError(
                            f"shard owner {node_id} failed mid-query and "
                            f"no replica survives for shards {lost}: {e}"
                        ) from e
                pending.extend(replan.items())
                continue
            if prof is not None:
                prof.add_fanout(
                    call.name,
                    node_id,
                    node_shards,
                    elapsed,
                    prof.take_rpc_bytes(),
                )
            partials.extend(remote)  # query_node returns decoded results
        return partials

    def _pin_groupby_rows(self, index: str, call: Call, shards) -> Call:
        """GroupBy rewritten for an exact multi-node fan-out: the group
        `limit` is stripped (reduce re-cuts after the full merge) and each
        child Rows(limit=L) becomes Rows(ids=[global first-L rows]) via a
        cluster Rows() round — the allowed set must come from the field's
        row UNIVERSE, not from surviving groups, because a limited-in row
        with zero nonzero groups still consumes a limit slot."""
        children = []
        for ch in call.children:
            if ch.arg("limit") is None:
                children.append(ch)
                continue
            rows_res = self._route_read(index, ch, shards)
            args = {k: v for k, v in ch.args.items() if k != "limit"}
            args["ids"] = list(rows_res.get("rows", []))
            children.append(Call(ch.name, args, list(ch.children), list(ch.pos_args)))
        args = {k: v for k, v in call.args.items() if k != "limit"}
        return Call(call.name, args, children, list(call.pos_args))

    def _topn_two_phase(
        self,
        index: str,
        call: Call,
        by_node: dict[str, list[int]],
        node_by_id: dict[str, "Node"],
    ) -> list[Any]:
        """Exact distributed TopN (reference: executor.go executeTopN's
        two-phase candidate recount — hardened to PROVABLY
        exact membership).

        Phase 1 fans out with headroom n' = 2n+10: each node returns its
        local top-n'. A row in one node's cut but not another's would
        single-phase merge with a partial count, so phase 2 broadcasts the
        candidate UNION as TopN(ids=...) and every node recounts exactly
        those ids — counts for every candidate are then exact.

        Membership proof: a row NO node returned has, on node i, a local
        count ≤ that node's truncation cutoff (its smallest returned count
        if it truncated at n', else 0 — the local path is a full scan, so
        an untruncated list is complete). Its global count is therefore ≤
        Σ cutoffs. If the merged n-th count beats that bound, no unseen
        row can reach the top n; otherwise fall back to one exhaustive
        pass (n stripped — nodes return ALL nonzero rows; counts add over
        disjoint shards, so that is exact by construction, the reference's
        cache-miss behavior being approximate instead)."""
        n = int(call.arg("n"))

        def topn_call(args: dict) -> Call:
            return Call("TopN", args, list(call.children), list(call.pos_args))

        # iterative deepening: on a skewed (Zipfian) distribution the
        # cutoff drops fast with n', so widening usually proves exactness
        # in one or two rounds. Flat distributions terminate through the
        # TIE-BREAK argument below instead of an exhaustive pass.
        headroom_n = 2 * n + 10
        cnt_n = id_n = None
        for _ in range(self.TOPN_DEEPEN_ROUNDS):
            headroom = {**call.args, "n": headroom_n}
            phase1 = self._fanout(
                index, topn_call(headroom), by_node, node_by_id
            )
            trunc = [p for p in phase1 if p and len(p) >= headroom_n]
            bound = sum(p[-1]["count"] for p in trunc)
            # frontier: every truncated node's list ends at (cutoff, fid)
            # in (count desc, id asc) order. An unseen row reaching the
            # bound must sit AT the cutoff on every truncated node, i.e.
            # AFTER each frontier — so its id exceeds every fid.
            max_fid = max((int(p[-1]["id"]) for p in trunc), default=-1)
            cand = sorted({int(pr["id"]) for p in phase1 for pr in p})
            # bound == 0 ⇒ no node truncated ⇒ each list already carries
            # that node's complete nonzero rows; the merge sums full local
            # counts, so phase 1 alone is exact — skip the recount.
            if not cand or bound == 0:
                return phase1
            args = {k: v for k, v in call.args.items() if k != "n"}
            args["ids"] = cand
            phase2 = self._fanout(
                index, topn_call(args), by_node, node_by_id
            )
            merged: dict[int, int] = {}
            for p in phase2:
                for pr in p:
                    merged[pr["id"]] = merged.get(pr["id"], 0) + pr["count"]
            exact = sorted(merged.items(), key=lambda rc: (-rc[1], rc[0]))
            if len(exact) >= n:
                id_n, cnt_n = exact[n - 1]
                # an unseen row displaces the n-th candidate only by
                # (count desc, id asc) order: impossible when its count
                # ceiling is below cnt_n, and impossible on a TIE when
                # its id (> max_fid, frontier argument above) cannot
                # undercut id_n. This is what lets a perfectly flat
                # distribution — where counts alone never separate —
                # terminate in one round with bounded transfer.
                if cnt_n > bound or (
                    cnt_n == bound and id_n <= max_fid + 1
                ):
                    return phase2
            headroom_n *= 4
        # Bounded final pass (never every nonzero row): a row that could
        # still displace the current n-th candidate (cnt_n, id_n) needs a
        # global count ≥ cnt_n, hence a LOCAL count ≥ ceil(cnt_n / P) on
        # at least one of the P fanned-out nodes. Ask each node for
        # exactly those rows (minCount floor), recount the union for
        # exact global counts, and the result is provably complete:
        # anything never returned has global ≤ P·(ceil(cnt_n/P) − 1)
        # < cnt_n — strictly below the n-th, no tie possible.
        if cnt_n is None:
            # < n distinct rows exist cluster-wide even after deepening:
            # with every per-node list truncation-free this returns at
            # bound == 0 above; a populated truncated list at headroom_n
            # ≥ n implies ≥ n candidates. Unreachable, but fail exact.
            args = {k: v for k, v in call.args.items() if k != "n"}
            return self._fanout(index, topn_call(args), by_node, node_by_id)
        floor = max(1, -(-cnt_n // max(1, len(by_node))))
        args = {k: v for k, v in call.args.items() if k != "n"}
        args["minCount"] = floor
        sweep = self._fanout(index, topn_call(args), by_node, node_by_id)
        cand = sorted(
            {int(pr["id"]) for p in sweep for pr in p}
            | {int(pr["id"]) for p in phase2 for pr in p}
        )
        args = {k: v for k, v in call.args.items() if k != "n"}
        args["ids"] = cand
        return self._fanout(index, topn_call(args), by_node, node_by_id)

    def wait_rebalanced(self, timeout: float | None = None) -> None:
        """Block until the background join-rebalance pull (if any) has
        finished — test/ops hook for deterministic growth sequencing.
        Raises a labeled ``TimeoutError`` when the pull is STILL RUNNING
        at the deadline: the old silent return let callers proceed
        against a half-populated node (reads routed there count zeros,
        node-remove races the pull) with nothing to grep for."""
        t = self._rebalance_thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"rebalance pull still running after {timeout}s "
                    f"({t.name}); transfer progress: GET /debug/cluster"
                )

    def _translate_read_keys(self, index: str, call: Call) -> Call:
        """Rewrite string row keys to IDs before fan-out, consulting the
        translate primary for keys this node hasn't seen. Unknown keys
        become -1 (reads as an empty row)."""
        idx = self.server.holder.index(index)
        if idx is None:
            return call
        new_args = dict(call.args)
        for k, v in call.args.items():
            f = idx.field(k)
            if isinstance(v, str) and f is not None and f.options.keys:
                rid = self._row_key_lookup(index, k, v)
                new_args[k] = rid if rid is not None else -1
            elif k == "column" and isinstance(v, str) and idx.options.keys:
                cid = self._col_key_lookup(index, v)
                new_args[k] = cid if cid is not None else -1
        children = [self._translate_read_keys(index, ch) for ch in call.children]
        return Call(call.name, new_args, children, list(call.pos_args))

    def _col_key_lookup(self, index: str, key: str) -> int | None:
        """Non-creating column-key → id lookup: local store first, then the
        translate primary (reads must not allocate new ids)."""
        idx = self.server.holder.index(index)
        cid = idx.column_keys.translate_key(key, create=False)
        if cid is not None:
            return cid
        primary = self._translate_primary()
        if primary.id == self.me.id:
            return None
        try:
            resp = self.client._json(
                "POST",
                primary.uri,
                "/internal/translate/create",
                {"index": index, "keys": [key], "create": False},
            )
        except PeerError:
            return None
        cid = resp["ids"][0]
        if cid is not None:
            idx.column_keys.apply_entries([(key, cid)])
        return cid

    def _row_key_lookup(self, index: str, field: str, key: str) -> int | None:
        f = self.server.holder.index(index).field(field)
        rid = f.row_keys.translate_key(key, create=False)
        if rid is not None:
            return rid
        primary = self._translate_primary()
        if primary.id == self.me.id:
            return None
        try:
            resp = self.client._json(
                "POST",
                primary.uri,
                "/internal/translate/create",
                {"index": index, "field": field, "keys": [key], "create": False},
            )
        except PeerError:
            return None
        rid = resp["ids"][0]
        if rid is not None:
            f.row_keys.apply_entries([(key, rid)])
        return rid

    def _reattach_row_keys(self, index: str, call: Call, result: Any) -> None:
        """Coordinator-authoritative row keys for Rows()/TopN() results
        (reference: executor.go translates RowIdentifiers/Pairs at reduce
        time, not per node)."""
        idx = self.server.holder.index(index)
        if idx is None:
            return
        try:
            fname = self.server.api.executor._call_field_name(call)
        except ExecutionError:
            # call carries no field argument — nothing to re-key
            return
        f = idx.field(fname)
        if f is None or not f.options.keys:
            return
        if isinstance(result, dict) and "rows" in result:
            ids = list(result["rows"])
        elif isinstance(result, list):
            ids = [p["id"] for p in result if isinstance(p, dict) and "id" in p]
        else:
            return
        missing = [i for i in ids if f.row_keys.translate_id(i) is None]
        if missing:
            primary = self._translate_primary()
            if primary.id != self.me.id:
                try:
                    # tail only from below the smallest unresolved id —
                    # never the primary's whole log (ids allocate
                    # monotonically, so every gap is ≥ min(missing))
                    entries = self.client.translate_entries(
                        primary.uri, index, fname, min(missing) - 1
                    )
                    f.row_keys.apply_entries(entries)
                except PeerError:
                    pass
        # fill gaps only: a node-supplied key (reduce keymap) beats the
        # str(id) fallback — never degrade a key already in hand
        if isinstance(result, dict):
            existing: dict[int, str] = {}
            if "keys" in result:
                existing = {
                    i: k
                    for i, k in zip(result["rows"], result["keys"])
                    if k != str(i)
                }
            result["keys"] = [
                f.row_keys.translate_id(i) or existing.get(i) or str(i)
                for i in ids
            ]
        else:
            for p in result:
                if isinstance(p, dict) and "id" in p:
                    have = p.get("key")
                    p["key"] = (
                        f.row_keys.translate_id(p["id"])
                        or (have if have != str(p["id"]) else None)
                        or str(p["id"])
                    )

    def _attach_column_keys(self, index: str, res: RowResult) -> None:
        idx = self.server.holder.index(index)
        if idx is None or not idx.options.keys:
            return
        cols = res.columns().tolist()
        missing = [c for c in cols if idx.column_keys.translate_id(c) is None]
        if missing:
            # tail the primary's log from below the smallest gap only
            primary = self._translate_primary()
            if primary.id != self.me.id:
                try:
                    entries = self.client.translate_entries(
                        primary.uri, index, None, min(missing) - 1
                    )
                    idx.column_keys.apply_entries(entries)
                except PeerError:
                    pass
        res.keys = [idx.column_keys.translate_id(c) or str(c) for c in cols]

    def _route_write(self, index: str, call: Call) -> Any:
        # single-column writes go to every owner of the column's shard;
        # row-wide / attr writes broadcast to every node
        if call.name in ("SetRowAttrs", "SetColumnAttrs"):
            return self._route_attr_write(index, call)
        if call.name in ("Set", "Clear") and call.pos_args:
            col = call.pos_args[0]
            if isinstance(col, str):
                col_id = self.translate_column_key(index, col)
                call = Call(call.name, dict(call.args), list(call.children),
                            [col_id] + list(call.pos_args[1:]))
            else:
                col_id = col
            # row keys also need cluster-consistent translation
            fa = call.field_arg()
            if fa is not None and isinstance(fa[1], str):
                fname, key = fa
                row_id = self.translate_row_key(index, fname, key)
                new_args = dict(call.args)
                new_args[fname] = row_id
                call = Call(call.name, new_args, list(call.children), list(call.pos_args))
            shard = col_id // SHARD_WIDTH
            with self._planning(index):
                result = None
                took_write: list[str] = []
                left_out: list[Node] = []
                current, stale = self._write_waves(
                    index, shard, self.shard_nodes(index, shard)
                )
                for owner in current + stale:
                    self._check_lease()
                    if not self._probe_alive(owner):
                        left_out.append(owner)
                        continue
                    if owner.id == self.me.id:
                        r = self.server.api.executor.execute(index, [call])[0]
                    else:
                        remote, _ = self._timed_query_node(
                            "cluster.write_fanout",
                            owner,
                            index,
                            call.to_pql(),
                            [shard],
                            write=True,
                        )
                        r = remote[0]
                    took_write.append(owner.uri)
                    result = r if result is None else result
                if result is None:
                    raise ShardUnavailableError(f"no alive owner for shard {shard}")
                # known/announced only after the write landed, and only
                # naming owners that actually took it; the owners it left
                # out are marked stale before the ack
                with self._shard_cache_lock:
                    self._known_shards[index] = (
                        self._known_shards.get(index, set()) | {shard}
                    )
                self._tell_peers(index, {shard: took_write}, {shard: left_out})
                return result
        # broadcast writes: a node left out misses the write in every
        # shard it owns
        with self._planning(index):
            result: Any = None
            left_out = {}
            current, stale = self._write_waves(index, None, self.nodes)
            for n in current + stale:
                self._check_lease()
                if not self._probe_alive(n):
                    for s, nodes in self._owned_shards(index, n).items():
                        left_out.setdefault(s, []).extend(nodes)
                    continue
                if n.id == self.me.id:
                    r = self.server.api.executor.execute(index, [call])[0]
                else:
                    remote, _ = self._timed_query_node(
                        "cluster.write_fanout", n, index, call.to_pql(), None,
                        write=True,
                    )
                    r = remote[0]
                if isinstance(r, bool):
                    result = bool(result) | r
                else:
                    result = r if result is None else result
            self._tell_peers(index, {}, left_out)
            return result

    def _route_attr_write(self, index: str, call: Call) -> None:
        """Attr writes broadcast with ONE coordinator-assigned timestamp
        so every replica stores an identical LWW cell — unsynchronized
        node clocks never decide a merge, and block checksums agree
        immediately after a healthy broadcast."""
        idx = self.server.holder.index(index)
        if idx is None:
            raise ValueError(f"index {index!r} not found")
        if call.name == "SetRowAttrs":
            if len(call.pos_args) < 2:
                raise ValueError("SetRowAttrs(field, row, attrs...) needs 2 args")
            fname = call.pos_args[0]
            row = call.pos_args[1]
            f = idx.field(fname)
            if f is None:
                raise ValueError(f"field {fname!r} not found")
            id_ = (
                self.translate_row_key(index, fname, row)
                if isinstance(row, str)
                else row
            )
            payload = {"index": index, "field": fname, "id": id_}
        else:
            col = call.pos_args[0] if call.pos_args else None
            if col is None:
                raise ValueError("SetColumnAttrs(col, attrs...) needs a column")
            id_ = (
                self.translate_column_key(index, col)
                if isinstance(col, str)
                else col
            )
            payload = {"index": index, "id": id_}
        payload["attrs"] = dict(call.args)
        payload["ts"] = time.time()
        with self._planning(index):
            left_out: dict[int, list[Node]] = {}
            for n in self.nodes:
                self._check_lease()
                if not self._probe_alive(n):
                    # its attr stores and its shards are marked: it reads
                    # attributes from a current node (_current_attrs) and
                    # serves no leg of the index until its catch-up merged
                    # the stores it missed (_catch_up)
                    left_out.setdefault(ATTRS_SHARD, []).append(n)
                    for s, nodes in self._owned_shards(index, n).items():
                        left_out.setdefault(s, []).extend(nodes)
                    continue
                if n.id == self.me.id:
                    self._apply_attr_write(payload)
                else:
                    self.client.set_attrs(n.uri, payload)
            self._tell_peers(index, {}, left_out)
        return None

    def _apply_attr_write(self, payload: dict) -> None:
        idx = self.server.holder.index(payload["index"])
        if idx is None:
            return
        if payload.get("field"):
            f = idx.field(payload["field"])
            if f is None:
                return
            store = f.row_attrs
        else:
            store = idx.column_attrs
        store.set_attrs(int(payload["id"]), payload["attrs"], ts=payload["ts"])
        # replica-side durability barrier: the RPC ack this write rides
        # back on is an acknowledgement too (docs/durability.md)
        durable.ack_barrier()
        # attr writes never move the mutation stamp — this hook is the
        # ONLY thing keeping this replica's cached results honest
        self.server.api._invalidate_results(payload["index"])

    # -------------------------------------------------------------- imports
    def import_router(self, index: str, field: str, payload: dict, values: bool) -> None:
        self._check_ready()
        api = self.server.api
        idx = self.server.holder.index(index)
        if idx is None:
            raise ValueError(f"index {index!r} not found")
        # whole-request size check BEFORE key translation or the per-shard
        # split — per-node slices passing their own check must not let an
        # oversized request through piecemeal
        api.check_write_limit(api._payload_size(payload), "import")
        if values and not payload.get("clear") and payload.get("values"):
            # whole-request range check BEFORE the fan-out: per-shard
            # sub-batches validate independently, so one out-of-range
            # value mid-request would otherwise leave the earlier shards'
            # writes committed behind a "rejected" error
            f = api._field(api._index(index), field)
            vals = payload["values"]
            f._check_range(int(min(vals)), int(max(vals)))
        # cluster-consistent key translation through the primary
        if payload.get("columnKeys"):
            payload = dict(payload)
            payload["columnIDs"] = self.translate_column_keys(
                index, payload.pop("columnKeys")
            )
        if payload.get("rowKeys"):
            payload = dict(payload)
            payload["rowIDs"] = self.translate_row_keys(
                index, field, payload.pop("rowKeys")
            )
        cols = np.asarray(payload.get("columnIDs", []), dtype=np.uint64)
        shards = cols // np.uint64(SHARD_WIDTH)
        uniq_shards = [int(s) for s in np.unique(shards).tolist()]
        with self._planning(index):
            # two waves (_write_waves), each (local slices, remote slices):
            # the owners whose copy is marked stale take their slices after
            # every current owner took its own (C12)
            waves: list[tuple[list, list]] = [([], []), ([], [])]
            delivered: dict[int, int] = {}
            took_write: dict[int, list[str]] = {}  # shard → owner URIs that got it
            left_out: dict[int, list[Node]] = {}  # shard → owners it skipped
            for shard in uniq_shards:
                m = shards == shard
                sub = dict(payload)
                sub["columnIDs"] = cols[m].tolist()
                if values:
                    if payload.get("clear"):
                        # value-clear carries no values list (api.import_values
                        # clears the listed columns and returns)
                        sub.pop("values", None)
                    else:
                        vals = payload.get("values", [])
                        sub["values"] = [vals[i] for i in np.flatnonzero(m).tolist()]
                else:
                    rows = payload.get("rowIDs", [])
                    sub["rowIDs"] = [rows[i] for i in np.flatnonzero(m).tolist()]
                    ts = payload.get("timestamps")
                    if ts:
                        sub["timestamps"] = [ts[i] for i in np.flatnonzero(m).tolist()]
                sh = int(shard)
                delivered[sh] = 0
                groups = self._write_waves(index, sh, self.shard_nodes(index, sh))
                for (local, remote), group in zip(waves, groups):
                    for owner in group:
                        if not self._probe_alive(owner):
                            left_out.setdefault(sh, []).append(owner)
                        elif owner.id == self.me.id:
                            local.append((sh, sub))
                        else:
                            remote.append((sh, owner, sub))
            for local, remote in waves:
                self._check_lease()
                # remote shard slices fan out CONCURRENTLY (each delivery is
                # an HTTP RPC; a sequential loop would make wide imports pay
                # the sum of RTTs) and overlap the local applies; failures
                # propagate exactly like the sequential path (fut.result
                # re-raises)
                futs = []
                if remote:
                    pool = self._import_pool()
                    futs = [
                        (sh, pool.submit(
                            self.client.import_node, o.uri, index, field, sub, values
                        ))
                        for sh, o, sub in remote
                    ]
                for sh, sub in local:
                    if values:
                        api.import_values(index, field, sub)
                    else:
                        api.import_bits(index, field, sub)
                    delivered[sh] += 1
                    took_write.setdefault(sh, []).append(self.me.uri)
                for sh, fut in futs:
                    # the receiver reports who actually APPLIED the slice —
                    # it may have re-forwarded to the current owners if our
                    # topology was stale, and the announce below must name
                    # the real holders
                    took_write.setdefault(sh, []).extend(fut.result())
                    delivered[sh] += 1
            for sh, d in delivered.items():
                if d == 0:
                    raise ShardUnavailableError(
                        f"no alive owner for shard {sh}; import rejected"
                    )
            with self._shard_cache_lock:
                self._known_shards[index] = (
                    self._known_shards.get(index, set()) | set(uniq_shards)
                )
            # synchronous announce BEFORE acking the import: a client may
            # import through this node and immediately read through any other
            # (and must not read a skipped owner's copy without it)
            self._tell_peers(index, took_write, left_out)
        # the local applies invalidated through api.import_*'s own hook,
        # but a coordinator that owns NONE of the shards never moved its
        # own stamp — and neither did any bystander peer
        api._invalidate_results(index)
        self._broadcast_cache_invalidate(index)

    def import_roaring_router(
        self, index: str, field: str, shard: int, data: bytes, view: str
    ) -> int:
        """Clustered bulk-lane import (docs/ingest.md): the incoming
        serialized roaring frame is streamed VERBATIM to every alive
        owner of the shard — the frame the client built is the frame
        every replica adopts; no per-replica re-serialization, no
        per-bit path anywhere. Remote legs go concurrently through the
        single-shot (never-retried) write RPC and each replica answers
        only after its own WAL append + ack barrier, so the client's
        acknowledgement is covered by every replica's durability barrier
        (replicate before ack). Returns the adopted delta bit count
        when this node applied locally (ingest metering)."""
        self._check_ready()
        api = self.server.api
        if self.server.holder.index(index) is None:
            raise ValueError(f"index {index!r} not found")
        sh = int(shard)
        with self._planning(index):
            left_out: list[Node] = []
            # two waves (_write_waves), each (local or not, remote owners):
            # the owners whose copy is marked stale take the frame after
            # every current owner took it (C12)
            waves: list[tuple[bool, list[Node]]] = []
            for group in self._write_waves(index, sh, self.shard_nodes(index, sh)):
                remote: list[Node] = []
                for o in group:
                    if o.id != self.me.id:
                        (remote if self._probe_alive(o) else left_out).append(o)
                waves.append((any(o.id == self.me.id for o in group), remote))

            def push(node):
                t0 = time.perf_counter()
                with GLOBAL_TRACER.span(
                    "cluster.import_roaring", node=node.id, shards=1
                ):
                    self.client.import_roaring(
                        node.uri, index, field, view, sh, data
                    )
                if self.server.stats is not None:
                    self.server.stats.timing(
                        "fanout_rpc_seconds",
                        time.perf_counter() - t0,
                        tags={"node": node.id},
                    )

            bits = 0
            applied = 0
            took_write: list[str] = []
            for local, remote in waves:
                self._check_lease()
                futs = []
                if remote:
                    pool = self._import_pool()
                    futs = [(o, pool.submit(push, o)) for o in remote]
                if local:
                    bits = api.import_roaring(index, field, sh, data, view=view)
                    applied += 1
                    took_write.append(self.me.uri)
                for node, fut in futs:
                    fut.result()  # a failed replica leg fails the import loudly
                    applied += 1
                    took_write.append(node.uri)
            if applied == 0:
                raise ShardUnavailableError(
                    f"no alive owner for shard {sh}; import rejected"
                )
            with self._shard_cache_lock:
                self._known_shards[index] = (
                    self._known_shards.get(index, set()) | {sh}
                )
            # synchronous announce BEFORE the ack, naming only the owners
            # that actually took the frame (same rule as import_router)
            self._tell_peers(index, {sh: took_write}, {sh: left_out})
        # same rule as import_router: a non-owner coordinator's stamp
        # (and every bystander's) never moved — invalidate explicitly
        api._invalidate_results(index)
        self._broadcast_cache_invalidate(index)
        return bits

    # ---------------------------------------------------------- translation
    def _route_translate_keys(
        self, index: str, field: str | None, keys: list[str], create: bool
    ) -> list[int | None]:
        """Cluster-safe /internal/translate/keys: ID allocation happens
        ONLY on the translate primary — a non-primary node allocating
        from its local counter would hand out IDs the primary also hands
        out for different keys, forking the key space. Non-primary nodes
        forward and cache the primary's entries locally (same discipline
        as _col_key_lookup)."""
        self._check_ready()  # 503 while STARTING — a stale local counter
        # allocating here is exactly the key-space fork this router exists
        # to prevent
        api = self.server.api
        store = api._translate_store(index, field)  # validates keys option
        primary = self._translate_primary()
        if primary.id == self.me.id:
            if create:
                api.check_write_limit(len(keys), "translate")
            return self._primary_allocate(index, field, store, keys, create)
        if create:
            api.check_write_limit(len(keys), "translate")
        # local-cache-first (same discipline as _col_key_lookup): entries
        # tailed from the primary serve hits without a round trip; only
        # misses travel
        local = store.translate_keys(keys, create=False)
        miss = [k for k, i in zip(keys, local) if i is None]
        if miss:
            payload: dict = {"index": index, "keys": miss, "create": create}
            if field:
                payload["field"] = field
            try:
                got = self.client._json(
                    "POST", primary.uri, "/internal/translate/create", payload
                )["ids"]
            except PeerError as e:
                raise ShardUnavailableError(
                    f"translate primary unavailable: {e}"
                ) from e
            store.apply_entries([(k, i) for k, i in zip(miss, got) if i])
            by_key = dict(zip(miss, got))
            local = [
                i if i is not None else by_key.get(k)
                for k, i in zip(keys, local)
            ]
        return local

    def _translate_primary(self) -> Node:
        """The sorted-first alive node owns key allocation (reference:
        translate.go primary/replica design)."""
        for n in self.nodes:
            if n.alive:
                return n
        raise ShardUnavailableError("no alive nodes for key translation")

    def _primary_allocate(
        self, index: str, field: str | None, store, keys: list[str], create: bool
    ) -> list[int | None]:
        """Every key→id ALLOCATION on this node funnels through here.
        Two duties beyond the raw store call (reference: translate.go has
        a fixed primary so needs neither; failover makes both mandatory):

        1. Fence-on-promotion: before the FIRST allocation of a primacy
           term, catch the local counter up past every allocation the
           deposed primary managed to replicate (else a stale _next_id
           re-issues live ids for new keys — a silent keyspace fork).
        2. Replicate-before-ack: push freshly created entries to every
           alive peer synchronously, so a subsequent failover to ANY of
           them finds the allocation and the fence in (1) can see it.
        """
        if not create:
            return store.translate_keys(keys, create=False)
        self._ensure_translate_primacy()
        pre = store.translate_keys(keys, create=False)
        miss = {k for k, i in zip(keys, pre) if i is None}
        ids = store.translate_keys(keys, create=True)
        new = {
            k: i for k, i in zip(keys, ids) if k in miss and i is not None
        }
        # fold in any binding whose earlier push failed (the client was
        # refused, but the local store kept it): a retry's keys are
        # already bound, so without this the push would be skipped and
        # the ack would cover an allocation no peer holds
        skey = (index, field)
        with self._unpushed_lock:
            pending = dict(self._unpushed_translate.get(skey, {}))
        if pending:
            # drop entries the store no longer backs: a binding recorded
            # here before a demotion may have been DISPLACED by the
            # surviving chain during reconcile — re-pushing it after a
            # re-promotion would overwrite the chain's legitimate binding
            # on every peer (apply is incoming-wins)
            stale = [
                k for k, i in pending.items()
                if store.translate_key(k, create=False) != i
            ]
            if stale:
                with self._unpushed_lock:
                    cur = self._unpushed_translate.get(skey)
                    for k in stale:
                        pending.pop(k, None)
                        if cur:
                            cur.pop(k, None)
                    if cur is not None and not cur:
                        self._unpushed_translate.pop(skey, None)
        pending.update(new)
        if pending:
            try:
                self._push_translate_entries(index, field, sorted(pending.items()))
            except Exception:
                # any failure means the ack must not go out AND the
                # bindings must be remembered for the retry's re-push
                with self._unpushed_lock:
                    self._unpushed_translate.setdefault(skey, {}).update(pending)
                raise
            with self._unpushed_lock:
                cur = self._unpushed_translate.get(skey)
                if cur:
                    for k in pending:
                        cur.pop(k, None)
                    if not cur:
                        self._unpushed_translate.pop(skey, None)
            # TOCTOU corrective: a concurrent reconcile pull can displace
            # a binding BETWEEN the stale filter and the push — the push
            # then re-spread a binding the chain had already superseded.
            # Re-check afterwards and push the store's CURRENT bindings
            # for anything that moved, so peers converge on the chain's
            # side within this same ack.
            corrected = sorted(
                (k, now)
                for k, i in pending.items()
                if (now := store.translate_key(k, create=False)) is not None
                and now != i
            )
            if corrected:
                try:
                    self._push_translate_entries(index, field, corrected)
                except Exception as e:  # noqa: BLE001
                    # best-effort within this ack (the allocation itself
                    # replicated fine): remember the chain bindings for
                    # the next allocation's re-push instead of failing a
                    # complete allocation — AE tailing also heals them
                    with self._unpushed_lock:
                        self._unpushed_translate.setdefault(skey, {}).update(
                            dict(corrected)
                        )
                    self.server.logger.log(
                        f"translate corrective push deferred ({e}); "
                        "entries queued for the next allocation's re-push"
                    )
        return ids

    def _push_translate_entries(
        self, index: str, field: str | None, entries: list[tuple[str, int]]
    ) -> None:
        """Synchronous fan-out of new allocations to alive peers, BEFORE
        the client ack. The fence's safety argument REQUIRES that every
        currently-alive peer — the only failover candidates — holds the
        entry when the ack goes out, so a push failure to a peer that is
        still alive (probe confirms) REFUSES the allocation ack; the
        client retries and the already-bound keys re-push idempotently.
        A peer the probe confirms dead is tolerated: it re-learns by
        reconcile-tailing on rejoin. Residual window (documented, not
        closable without quorum consensus): primary + every pushed peer
        die together after an ack — rejoin reconcile then resolves any
        resulting fork toward the surviving chain, displacing one side.
        """
        if not entries:
            return
        payload: dict = {"index": index, "entries": [[k, i] for k, i in entries]}
        if field:
            payload["field"] = field

        def push(peer: Node) -> str | None:
            try:
                resp = self.client._json(
                    "POST", peer.uri, "/internal/translate/apply", payload
                )
                if resp.get("applied") is not True:
                    # the receiver doesn't know the index/field yet (the
                    # schema broadcast raced the push): it did NOT store
                    # the entries, so counting this as replicated would
                    # ack an allocation no peer holds — refuse; the
                    # client retries once the schema lands
                    return f"{peer.uri}: schema not applied on receiver yet"
                return None
            except PeerError as e:
                # a REAL probe, not the cached flag: only a peer that is
                # verifiably down may miss the push without failing the
                # ack (it reconcile-tails on rejoin)
                try:
                    self.client.status(peer.uri, timeout=5.0)
                except PeerError:
                    peer.alive = False
                    self.server.logger.log(
                        f"translate push skipped dead peer {peer.uri} "
                        f"({e}); it will reconcile-tail on rejoin"
                    )
                    return None
                return f"{peer.uri}: {e}"

        peers = self._peers()
        if len(peers) == 1:
            failures = [f for f in [push(peers[0])] if f]
        elif peers:
            # concurrent fan-out: the ack waits on the SLOWEST peer, not
            # the sum of peers
            failures = [f for f in self._import_pool().map(push, peers) if f]
        else:
            failures = []
        if failures:
            raise ShardUnavailableError(
                "translate replication incomplete (alive peer unreachable: "
                f"{'; '.join(failures)}); allocation not acked — retry"
            )

    def _ensure_translate_primacy(self) -> None:
        """Run the promotion fence before this term's first allocation.
        Raises ShardUnavailableError — REFUSING the allocation — when the
        fence could not pull from every alive peer: allocating behind an
        incomplete fence is exactly the stale-counter fork it prevents.
        The refusal is transient: the unreachable peer is either marked
        dead by the next heartbeat (and leaves the fence set) or becomes
        pullable. The pull itself runs outside the lock; a primacy
        transition observed mid-fence (generation bump) invalidates the
        attempt rather than stamping a fence that straddled two terms."""
        for _ in range(3):
            with self._translate_fence_lock:
                if self._translate_fence_ok:
                    return
                gen0 = self._primacy_gen
            # pull order decides conflict winners (apply_entries is
            # incoming-wins): peers whose own chain is UNVERIFIED — a
            # rejoined ex-primary still awaiting reconcile — are pulled
            # FIRST, verified peers last, so a forked binding a pending
            # peer still carries is displaced by the verified chain
            # instead of peer iteration order silently deciding
            peers: list[tuple[bool, Node]] = []
            ok = True
            for peer in self._peers():
                try:
                    st = self.client.status(peer.uri, timeout=5.0)
                except PeerError:
                    ok = False
                    continue
                peers.append((bool(st.get("translatePending")), peer))
            peers.sort(key=lambda p: not p[0])  # pending=True first
            ok = ok and all(
                self._pull_translations_from(peer, full=True)
                for _pending, peer in peers
            )
            if not ok:
                raise ShardUnavailableError(
                    "translate fence incomplete (an alive peer was "
                    "unpullable); allocation refused — retry"
                )
            with self._translate_fence_lock:
                if self._primacy_gen == gen0:
                    # the gen guard catches transitions the heartbeat
                    # OBSERVED; re-derive primacy from current liveness
                    # too — a demotion seen by liveness flags but whose
                    # gen bump raced this attempt must not stamp a fence
                    # for a node that is no longer primary
                    if self._translate_primary().id != self.me.id:
                        raise ShardUnavailableError(
                            "translate primacy lost mid-fence; "
                            "allocation refused — retry"
                        )
                    self._translate_fence_ok = True
                    self._observed_primary_id = self.me.id
                    return
        raise ShardUnavailableError(
            "translate primacy flapping; allocation refused — retry"
        )

    def _pull_translations_from(self, node: Node, full: bool) -> bool:
        """Pull key translations for every keyed store from ``node``.
        ``full`` pulls from offset 0 (fencing/reconcile); otherwise from
        the store's dense watermark — NOT max id, so a hole left by a
        missed push is re-covered. Returns True when every store pulled
        without a peer error."""
        ok = True
        for idx_name, idx in list(self.server.holder.indexes.items()):
            stores: list[tuple[str | None, Any]] = []
            if idx.options.keys:
                stores.append((None, idx.column_keys))
            for f_name, f in list(idx.fields.items()):
                if f.options.keys:
                    stores.append((f_name, f.row_keys))
            for f_name, store in stores:
                try:
                    entries, sender_holes = self.client.translate_tail(
                        node.uri, idx_name, f_name,
                        0 if full else store.dense_through,
                        holes=None if full else store.holes_for_pull(),
                    )
                except PeerError:
                    ok = False
                    continue
                dropped = store.apply_entries(entries)
                # adopt the sender's known fork vacancies so this node's
                # watermark can cross cluster-wide holes it never saw
                # displaced locally (else every later incremental pull
                # re-ships the whole tail above the hole)
                if sender_holes:
                    store.adopt_holes(sender_holes)
                if dropped:
                    self.server.logger.log(
                        f"translate {idx_name}/{f_name or '<columns>'}: "
                        f"dropped {len(dropped)} forked binding(s) "
                        f"displaced by {node.uri}'s chain: "
                        f"{dropped[:5]}{'…' if len(dropped) > 5 else ''}"
                    )
        return ok

    def _maybe_reconcile_translations(self, primary: Node) -> None:
        """Off-heartbeat-thread full reconcile against the current
        primary. Armed at boot (a restarted ex-primary may hold
        never-replicated allocations that conflict with the surviving
        chain) and on demotion; cleared only after a clean full pull."""
        t = self._reconcile_thread
        if t is not None and t.is_alive():
            return
        with self._translate_fence_lock:
            gen0 = self._primacy_gen

        def clear_pending_if_current() -> None:
            # a primacy transition mid-pull re-arms pending for the NEW
            # term; a stale thread must not wipe that re-arm
            with self._translate_fence_lock:
                if self._primacy_gen == gen0:
                    self._translate_reconcile_pending = False

        def run() -> None:
            if primary.id == self.me.id:
                # we rejoined straight back into primacy (still sorted
                # first): the fence IS the reconcile — it full-pulls from
                # every alive peer, displacing any forked local binding
                try:
                    self._ensure_translate_primacy()
                except ShardUnavailableError:
                    return  # pending stays set; retried next heartbeat
                clear_pending_if_current()
            elif self._pull_translations_from(primary, full=True):
                clear_pending_if_current()

        t = threading.Thread(
            target=run, daemon=True, name="translate-reconcile"
        )
        self._reconcile_thread = t
        t.start()

    def translate_column_keys(self, index: str, keys: list[str]) -> list[int]:
        """Batch column-key allocation: ONE hop to the primary (or one
        local allocate + one pooled push wave) regardless of batch size —
        a keyed import must never pay per-key RPCs."""
        primary = self._translate_primary()
        if primary.id == self.me.id:
            idx = self.server.holder.index(index)
            return self._primary_allocate(index, None, idx.column_keys, keys, True)
        resp = self.client._json(
            "POST",
            primary.uri,
            "/internal/translate/create",
            {"index": index, "keys": keys},
        )
        return resp["ids"]

    def translate_row_keys(
        self, index: str, field: str, keys: list[str]
    ) -> list[int]:
        primary = self._translate_primary()
        if primary.id == self.me.id:
            f = self.server.holder.index(index).field(field)
            return self._primary_allocate(index, field, f.row_keys, keys, True)
        resp = self.client._json(
            "POST",
            primary.uri,
            "/internal/translate/create",
            {"index": index, "field": field, "keys": keys},
        )
        return resp["ids"]

    def translate_column_key(self, index: str, key: str) -> int:
        return self.translate_column_keys(index, [key])[0]

    def translate_row_key(self, index: str, field: str, key: str) -> int:
        return self.translate_row_keys(index, field, [key])[0]

    # --------------------------------------------------------- anti-entropy
    def sync_holder(self) -> None:
        """Block-checksum diff + union merge against replica peers
        (reference: holderSyncer.SyncHolder), then tail key translations
        from the primary. Union is the merge between two CURRENT copies
        only (C10): a copy here marked stale is first replaced from a
        current owner (``_catch_up``) and never merged while stale, and
        no block is pulled from an owner whose copy is marked stale —
        the reference's pass unions such a copy in, which brings back
        on every owner the bits an acknowledged Clear removed."""
        holder = self.server.holder
        dropped_indexes: set[str] = set()
        self._catch_up()
        for idx_name, idx in list(holder.indexes.items()):
            for f_name, f in list(idx.fields.items()):
                for v_name, view in list(f.views.items()):
                    for shard, frag in list(view.fragments.items()):
                        stale = self._stale_uris(idx_name, shard)
                        if self.me.uri in stale:
                            continue  # no current owner gave a copy yet
                        owners = self.shard_nodes(idx_name, shard)
                        if not any(o.id == self.me.id for o in owners):
                            # resize handoff: a fragment this node no
                            # longer owns is push-merged to every current
                            # owner, then dropped — writes that raced the
                            # topology change onto the old owner are
                            # preserved by the union merge
                            if self._handoff_fragment(
                                idx_name, f_name, v_name, shard, frag, view, owners
                            ):
                                dropped_indexes.add(idx_name)
                            continue
                        for owner in owners:
                            if (
                                owner.id == self.me.id
                                or not owner.alive
                                or owner.uri in stale
                            ):
                                continue
                            try:
                                self._sync_fragment(
                                    idx_name, f_name, v_name, shard, frag, owner
                                )
                            except PeerError:
                                continue
            self._sync_attr_stores(idx_name, idx)
        for idx_name in dropped_indexes:
            # relinquished fragments left this node: re-publish the
            # shrunken inventory so cached routing stops pointing here
            idx = holder.index(idx_name)
            self._announce_shards(
                idx_name,
                {self.me.uri: sorted(idx.available_shards()) if idx else []},
                replace=True,
            )
        self._tail_translations()

    def _handoff_fragment(
        self, index, field, view_name, shard, frag, view, owners: list[Node]
    ) -> bool:
        """Relinquish a no-longer-owned fragment (the drop half of the
        reference's ResizeJob): union-merge its bits into EVERY current
        owner, and delete the local copy only when all owners took the
        push — a dead owner keeps the copy alive for the next pass.
        Returns True when the local copy was dropped."""
        if not owners:
            return False  # no current owners (shouldn't happen); keep the data
        v0 = frag.version
        data = serialize(frag.bitmap)
        # the push is movement too: same admission lane as rebalance
        # pulls — one slot for the whole owner fan-out (the frame is
        # shared), the byte throttle paid once per owner leg
        with self.movement.transfer(
            "push", index, field, view_name, shard
        ) as mrow:
            mrow["bytes"] = len(data)
            for owner in owners:
                if not self._probe_alive(owner):
                    return False
                self.movement.throttle(len(data))
                try:
                    self._import_roaring_with_backoff(
                        owner.uri, index, field, view_name, shard, data
                    )
                except PeerError:
                    return False
                self.movement.account("push", len(data))
        # the re-check and the removal must be ONE atomic step under the
        # fragment write lock: a write (e.g. a re-forwarded import, which
        # applies locally on the old owner by design) landing between
        # them would be deleted with the fragment — silent loss. Every
        # mutation path takes frag._lock, so holding it here closes the
        # window; RLock keeps remove_fragment→frag.close() reentrant.
        with frag._lock:
            if frag.version != v0:
                # a write raced in after the serialize — its bits aren't
                # in what we pushed, so keep the copy; the next
                # anti-entropy pass re-pushes and retires it
                return False
            return view.remove_fragment(shard)

    def _sync_attr_stores(self, idx_name: str, idx) -> None:
        """Block-checksum diff of the column/row attr stores against all
        peers (reference: holderSyncer attr block sync). Attr writes
        broadcast cluster-wide with one coordinator timestamp, so this
        only repairs nodes that missed a broadcast while down; the merge
        is key-wise last-writer-wins with tombstones (AttrStore
        .merge_block), so missed deletes propagate instead of being
        resurrected."""
        for peer in self._peers():
            try:
                self._merge_attr_stores(peer, idx_name, idx)
            except PeerError:
                continue  # peer unreachable; skip its remaining stores

    def _merge_attr_stores(self, peer: Node, idx_name: str, idx) -> None:
        """Merge ``peer``'s column and row attr stores of the index into
        this node's, block by block (raises ``PeerError``)."""
        stores: list[tuple[str | None, Any]] = [(None, idx.column_attrs)]
        stores += [(f_name, f.row_attrs) for f_name, f in list(idx.fields.items())]
        for field_name, store in stores:
            theirs = self.client.attr_blocks(peer.uri, idx_name, field_name)
            mine = {b: c.hex() for b, c in store.block_checksums()}
            for block, checksum in theirs.items():
                if mine.get(block) == checksum:
                    continue
                data = self.client.attr_block_data(
                    peer.uri, idx_name, field_name, block
                )
                if data:
                    store.merge_block(data)

    def _sync_fragment(self, index, field, view, shard, frag, peer: Node) -> None:
        theirs = self.client.fragment_blocks(peer.uri, index, field, view, shard)
        mine = {b: c.hex() for b, c in frag.block_checksums()}
        for block in set(theirs) | set(mine):
            if theirs.get(block) == mine.get(block):
                continue
            if block not in theirs:
                continue  # peer missing data; its own AE pass will pull ours
            rows, cols = self.client.block_data(
                peer.uri, index, field, view, shard, block
            )
            local_rows, local_cols = frag.block_data(block)
            merged = set(zip(local_rows.tolist(), local_cols.tolist())) | set(
                zip(
                    np.asarray(rows, dtype=np.uint64).tolist(),
                    np.asarray(cols, dtype=np.uint64).tolist(),
                )
            )
            if merged:
                mr, mc = zip(*sorted(merged))
            else:
                mr, mc = (), ()
            frag.merge_block(
                block,
                np.asarray(mr, dtype=np.uint64),
                np.asarray(mc, dtype=np.uint64),
            )

    def _tail_translations(self) -> None:
        primary = self._translate_primary()
        if primary.id == self.me.id:
            return
        # a pending reconcile (armed at boot / on demotion) upgrades the
        # incremental tail to a full pull — AE runs off the heartbeat
        # thread, so doing it inline here is fine. The clear is
        # generation-guarded like _maybe_reconcile_translations': a
        # demotion that re-arms pending mid-pull must not be wiped by
        # this (older) pull's completion.
        with self._translate_fence_lock:
            full = self._translate_reconcile_pending
            gen0 = self._primacy_gen
        if self._pull_translations_from(primary, full=full) and full:
            with self._translate_fence_lock:
                if self._primacy_gen == gen0:
                    self._translate_reconcile_pending = False

    # ------------------------------------------------------ internal routes
    def _mount_internal_routes(self) -> None:
        import re

        http = self.server.http
        routes = {
            ("POST", re.compile(r"^/internal/query$")): self._h_query,
            ("POST", re.compile(r"^/internal/query/batch$")): self._h_query_batch,
            ("GET", re.compile(r"^/internal/shards$")): self._h_shards,
            ("GET", re.compile(r"^/internal/fragment/blocks$")): self._h_blocks,
            ("GET", re.compile(r"^/internal/fragment/block/data$")): self._h_block_data,
            ("GET", re.compile(r"^/internal/fragment/data$")): self._h_fragment_data,
            ("GET", re.compile(r"^/internal/fragment/inventory$")): self._h_inventory,
            ("GET", re.compile(r"^/internal/status$")): self._h_internal_status,
            (
                "POST",
                re.compile(r"^/internal/import/([^/]+)/([^/]+)$"),
            ): self._h_import_bits,
            (
                "POST",
                re.compile(r"^/internal/import-value/([^/]+)/([^/]+)$"),
            ): self._h_import_values,
            (
                "POST",
                re.compile(
                    r"^/internal/import-roaring/([^/]+)/([^/]+)/(\d+)$"
                ),
            ): self._h_import_roaring,
            ("POST", re.compile(r"^/internal/attrs/set$")): self._h_attr_set,
            ("GET", re.compile(r"^/internal/attrs/blocks$")): self._h_attr_blocks,
            ("POST", re.compile(r"^/internal/attrs/get$")): self._h_attrs_get,
            (
                "GET",
                re.compile(r"^/internal/attrs/block/data$"),
            ): self._h_attr_block_data,
            ("GET", re.compile(r"^/internal/trace$")): self._h_trace,
            ("GET", re.compile(r"^/internal/translate/data$")): self._h_translate_data,
            (
                "POST",
                re.compile(r"^/internal/translate/create$"),
            ): self._h_translate_create,
            (
                "POST",
                re.compile(r"^/internal/translate/apply$"),
            ): self._h_translate_apply,
            ("POST", re.compile(r"^/internal/sync$")): self._h_sync,
            (
                "POST",
                re.compile(r"^/internal/schema/apply$"),
            ): self._h_schema_apply,
            (
                "POST",
                re.compile(r"^/internal/schema/delete$"),
            ): self._h_schema_delete,
            (
                "POST",
                re.compile(r"^/internal/cluster/resize/remove-node$"),
            ): self._h_remove_node,
            (
                "POST",
                re.compile(r"^/internal/cluster/join$"),
            ): self._h_join,
            (
                "POST",
                re.compile(r"^/internal/shards/announce$"),
            ): self._h_shards_announce,
            (
                "POST",
                re.compile(r"^/internal/marks/drain$"),
            ): self._h_marks_drain,
            (
                "POST",
                re.compile(r"^/internal/cache/invalidate$"),
            ): self._h_cache_invalidate,
        }
        http.extra_routes.update(routes)

    @staticmethod
    def _hop_query_context(handler):
        """Context manager installing the fan-out hop's share of the
        caller's deadline budget: ``X-Pilosa-Deadline-Ms`` carries the
        REMAINING milliseconds at send time, so this hop's retries and
        wave waits are bounded by what the original client was promised
        (decrement-per-hop by construction — each hop re-forwards only
        what is left on its own clock)."""
        import contextlib

        deadline = resilience.deadline_from_header(
            handler.headers.get(resilience.DEADLINE_HEADER)
        )
        if deadline is None:
            return contextlib.nullcontext()
        return resilience.use_query_context(
            resilience.QueryContext(deadline=deadline)
        )

    # each handler receives the live request Handler object
    def _h_query(self, handler) -> None:
        # body FIRST, gate second: the 503 must not leave unread body
        # bytes on a keep-alive connection (the next request would parse
        # from the stale body). Same device-probe gate as the client-
        # facing query route: a coordinator's fan-out must not be the
        # first CUDA call on a node whose probe is still running, nor
        # reach a card that failed it. wait=False — the coordinator's
        # RPC timeout (30s) is shorter than the gate wait, so blocking
        # here would turn the probe window into a client-visible RPC
        # timeout; failing fast maps to ShardUnavailableError (503, the
        # server's reason) at the coordinator, which fails the leg over.
        body = handler._json_body()
        if not self.server._query_gate(wait=False):
            raise ShardUnavailableError(self.server._gate_reason())
        # per-node served-query counter: every read leg THIS
        # node executes — whether taken from a coordinator (here) or
        # served locally (the _fanout local branch) — counts once, so
        # the cluster-wide distribution shows the replica read spread
        self.server.stats.count("queries_served", tags={"path": "remote"})
        # through the wave scheduler: concurrent remote legs from
        # different coordinators (or wave-mates) share this node's
        # device dispatch/readback waves exactly like client queries
        calls = (
            parse(body["query"])
            if isinstance(body["query"], str)
            else body["query"]
        )
        writes = self.server.api.count_query_writes(calls)
        if not writes:
            # a write leg still lands on a stale copy (the catch-up
            # keeps writes that land meanwhile); a read leg does not
            # read one
            self._check_leg(body["index"], body.get("shards"))
        with self._hop_query_context(handler):
            results = self.server.api.scheduler.execute(
                body["index"], calls, shards=body.get("shards")
            )
        if writes:
            # replica-side durability barrier: the RPC ack a write leg
            # rides back on IS the coordinator's acknowledgement — its
            # ops-log appends must be on disk first (docs/durability.md)
            durable.ack_barrier()
            self.server.api._invalidate_results(body["index"])
        # framed response: JSON control + raw packed-word blobs — a wide
        # Row() partial crosses the wire at 4 bytes/word instead of
        # base64's 5.33 plus JSON string parse (reference: internal
        # QueryResponse protobuf)
        blobs: list[bytes] = []
        control = {"results": [encode_result(r, blobs) for r in results]}
        handler._bytes(frame.encode_frame(control, blobs), frame.CONTENT_TYPE)

    def _h_query_batch(self, handler) -> None:
        """Multi-query /internal RPC: several coordinator fan-out legs
        coalesced into one POST (``_NodeLegBatcher``).  Per-entry trace
        context rides in the body — one HTTP request cannot carry N
        header contexts — and each entry's execution joins its own
        propagated trace via the scheduler's detached per-query spans.
        The whole batch goes to the wave scheduler as ONE enqueue
        (``execute_many``), so the legs also share this node's device
        readback wave.  Per-entry error isolation: a failing query
        yields an ``error`` entry; its RPC-mates answer normally."""
        body = handler._json_body()
        if not self.server._query_gate(wait=False):
            raise ShardUnavailableError(self.server._gate_reason())
        entries = body.get("queries", [])
        stats = self.server.stats
        api = self.server.api
        reqs = []
        wrote_indexes: set[str] = set()
        refused: dict[int, ShardUnavailableError] = {}  # entry → _check_leg
        for i, q in enumerate(entries):
            stats.count("queries_served", tags={"path": "remote"})
            q_calls = q["query"]
            if isinstance(q_calls, str):
                try:
                    q_calls = parse(q_calls)
                except Exception:  # noqa: BLE001 — per-entry isolation:
                    # execute_many re-parses and makes the parse error
                    # this slot's answer; its batch-mates still execute
                    pass
            if not isinstance(q_calls, str) and api.count_query_writes(
                q_calls
            ):
                wrote_indexes.add(q["index"])
            else:
                try:
                    self._check_leg(q["index"], q.get("shards"))
                except ShardUnavailableError as e:
                    refused[i] = e  # this entry's answer; no execution
                    continue
            reqs.append(
                (
                    q["index"],
                    q_calls,
                    q.get("shards"),
                    (q.get("traceId"), q.get("parentSpanId")),
                )
            )
        with GLOBAL_TRACER.span("cluster.query_batch", queries=len(entries)):
            with stats.timer("internal_query_batch_seconds"):
                with self._hop_query_context(handler):
                    ran = iter(
                        self.server.api.scheduler.execute_many(reqs)
                        if reqs
                        else ()
                    )
                    results = [
                        refused[i] if i in refused else next(ran)
                        for i in range(len(entries))
                    ]
        if wrote_indexes:
            # the batcher coalesces read fan-out legs, but the RPC shape
            # doesn't FORBID writes — hold them to the same ack-barrier
            # and cache-invalidation contract as _h_query
            durable.ack_barrier()
            for name in sorted(wrote_indexes):
                api._invalidate_results(name)
        blobs: list[bytes] = []
        out: list[dict] = []
        for r in results:
            if isinstance(r, BaseException):
                out.append({"error": str(r)})
            else:
                out.append({"results": [encode_result(x, blobs) for x in r]})
        handler._bytes(
            frame.encode_frame({"queries": out}, blobs), frame.CONTENT_TYPE
        )

    def _h_trace(self, handler) -> None:
        """One trace's locally buffered spans (the stitch half of
        cross-node tracing: the coordinator pulls these from every peer
        and merges them under its own HTTP span for chrome export)."""
        trace_id = handler.query_params.get("trace_id", [""])[0]
        if not trace_id:
            raise ValueError("trace_id= required")
        handler._json({"spans": GLOBAL_TRACER.spans_for_trace(trace_id)})

    def _fetch_cluster_trace(self, trace_id: str) -> dict[str, list[dict]]:
        """node id → span dicts for one trace, local buffer + every
        reachable peer (unreachable peers just drop out of the view)."""
        by_node = {self.me.id: GLOBAL_TRACER.spans_for_trace(trace_id)}
        for n in self._peers():
            try:
                by_node[n.id] = self.client.fetch_trace(n.uri, trace_id)
            except PeerError:
                continue
        return by_node

    def _h_shards_announce(self, handler) -> None:
        body = handler._json_body()
        self._apply_shard_entries(body)
        self._merge_marks(body)
        if body.get("marks") and not body.get("relayed"):
            # before the answer: the writer acknowledges only once every
            # node that may serve has the marks (a failure here is a 503)
            self._relay_marks(body)
        handler._json({"success": True})

    def _h_marks_drain(self, handler) -> None:
        body = handler._json_body()
        self._drain_writes(body["index"], body.get("marks") or [])
        handler._json({"success": True})

    def _h_shards(self, handler) -> None:
        index = handler.query_params["index"][0]
        idx = self.server.holder.index(index)
        handler._json(
            {"shards": sorted(idx.available_shards()) if idx else []}
        )

    def _frag_from_params(self, handler):
        p = handler.query_params
        return self._local_fragment(
            p["index"][0], p["field"][0], p.get("view", ["standard"])[0],
            int(p["shard"][0]),
        )

    def _h_blocks(self, handler) -> None:
        frag = self._frag_from_params(handler)
        blocks = frag.block_checksums() if frag else []
        handler._json(
            {"blocks": [{"block": b, "checksum": c.hex()} for b, c in blocks]}
        )

    def _h_block_data(self, handler) -> None:
        frag = self._frag_from_params(handler)
        block = int(handler.query_params["block"][0])
        if frag is None:
            handler._bytes(
                frame.encode_frame({"n": 0}, []), frame.CONTENT_TYPE
            )
            return
        rows, cols = frag.block_data(block)
        # framed: anti-entropy block repair ships raw u64 pairs, not JSON
        # int text (reference: internal BlockDataResponse protobuf)
        handler._bytes(
            frame.encode_frame(
                {"n": int(len(rows))},
                [frame.pack_u64(rows), frame.pack_u64(cols)],
            ),
            frame.CONTENT_TYPE,
        )

    def _h_fragment_data(self, handler) -> None:
        frag = self._frag_from_params(handler)
        data = serialize(frag.bitmap) if frag else serialize_empty()
        handler.send_response(200)
        handler.send_header("Content-Type", "application/octet-stream")
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    def _h_schema_apply(self, handler) -> None:
        self.server.api.apply_schema(handler._json_body(), validate=False)
        handler._json({"success": True})

    def _h_schema_delete(self, handler) -> None:
        body = handler._json_body()
        index, field = body.get("index"), body.get("field")
        from pilosa_tpu_torch.executor import ExecutionError

        try:
            if field:
                self.server.api.delete_field(index, field)
            else:
                self._purge_shard_caches(index)
                self.server.api.delete_index(index)
        except (KeyError, ExecutionError):
            pass  # already gone — deletion is idempotent cluster-wide
        handler._json({"success": True})

    def _h_sync(self, handler) -> None:
        """Manual anti-entropy pass (reference: the AE ticker, triggerable)."""
        self.sync_holder()
        handler._json({"success": True})

    def _h_remove_node(self, handler) -> None:
        body = handler._json_body()
        node_id = body.get("id")
        if not node_id:
            raise ValueError("remove-node requires an 'id'")
        try:
            removed = self.remove_node(
                node_id, broadcast=body.get("broadcast", True), uri=body.get("uri")
            )
        except RebalanceInFlightError as e:
            # 409, not 500: the cluster is healthy — the admin request
            # lost a conflict with in-flight data movement and is safe
            # to retry once the pull drains
            handler._json({"error": str(e)}, code=409)
            return
        handler._json({"success": removed, "state": self.state})

    def _h_join(self, handler) -> None:
        body = handler._json_body()
        node_id, uri = body.get("id"), body.get("uri")
        if not node_id or not uri:
            raise ValueError("join requires 'id' and 'uri'")
        added = self.add_node(
            node_id, uri, forward=not body.get("forwarded", False)
        )
        handler._json(
            {"success": added, "topologyEpoch": self.topology.epoch}
        )

    def _h_inventory(self, handler) -> None:
        index = handler.query_params["index"][0]
        want_sums = handler.query_params.get("checksums", ["0"])[0] in (
            "1", "true",
        )
        idx = self.server.holder.index(index)
        frags = []
        if idx is not None:
            for f_name, f in idx.fields.items():
                for v_name, view in f.views.items():
                    for shard, frag in list(view.fragments.items()):
                        row = {"field": f_name, "view": v_name, "shard": shard}
                        if want_sums:
                            # content digest over the serialized frame:
                            # serialize run-compacts on the way out, so
                            # equal logical content ⇒ equal digest — the
                            # puller skips in-sync fragments without a
                            # block-by-block diff (docs/resize.md)
                            row["checksum"] = fragment_checksum(
                                serialize(frag.bitmap)
                            )
                        frags.append(row)
        handler._json({"fragments": frags})

    def fragment_checksums(self, index: str | None = None) -> dict:
        """{index: {"field/view/shard": digest}} over every local
        fragment — the convergence witness anti-entropy and the resize
        bench compare across owners (served on /internal/status)."""
        out: dict[str, dict[str, str]] = {}
        for idx_name, idx in list(self.server.holder.indexes.items()):
            if index is not None and idx_name != index:
                continue
            sums: dict[str, str] = {}
            for f_name, f in list(idx.fields.items()):
                for v_name, view in list(f.views.items()):
                    for shard, frag in list(view.fragments.items()):
                        sums[f"{f_name}/{v_name}/{shard}"] = fragment_checksum(
                            serialize(frag.bitmap)
                        )
            out[idx_name] = sums
        return out

    def _h_internal_status(self, handler) -> None:
        """Data-plane status: state + per-fragment content checksums.
        Separate from the public /status heartbeat payload — computing
        digests per heartbeat would tax every liveness probe."""
        handler._json({
            "state": self.state,
            "localID": self.me.id,
            "topologyEpoch": self.topology.epoch,
            "checksums": self.fragment_checksums(),
            "movement": self.movement.snapshot(),
        })

    @staticmethod
    def _import_body(handler) -> dict:
        """Internal import payload: framed (raw u64/i64 id and value
        blobs — the node↔node fast path) or plain JSON (external callers
        hitting the internal route directly)."""
        body = handler._body()
        if not frame.is_frame(body):
            import json as _json

            if not body:
                return {}
            try:
                return _json.loads(body)
            except _json.JSONDecodeError as e:
                raise ValueError(f"bad JSON body: {e}") from e
        control, blobs = frame.decode_frame(body)
        # keep the vectors as ndarrays: boxing millions of u64s into
        # Python ints would re-pay the per-element cost the frame format
        # exists to avoid; every consumer (np.asarray in the API resolve
        # path, fancy-indexed shard splits, re-framed forwards) takes
        # arrays directly
        for key in ("columnIDs", "rowIDs"):
            idx = control.pop(f"{key}Bin", None)
            if idx is not None:
                control[key] = frame.unpack_u64(blobs[idx])
        idx = control.pop("valuesBin", None)
        if idx is not None:
            control["values"] = np.frombuffer(blobs[idx], np.int64).copy()
        return control

    def _h_import_bits(self, handler, index: str, field: str) -> None:
        # deliberately NOT behind the device-probe gate: the import apply
        # path is numpy/roaring only (torch and the card are first
        # touched at query time), so no CUDA call runs here — and
        # gating would refuse replica writes for the whole probe window
        applied_by = self._apply_or_reforward_import(
            index, field, self._import_body(handler), values=False
        )
        handler._json({"success": True, "appliedBy": applied_by})

    def _h_import_values(self, handler, index: str, field: str) -> None:
        applied_by = self._apply_or_reforward_import(
            index, field, self._import_body(handler), values=True
        )
        handler._json({"success": True, "appliedBy": applied_by})

    def _h_import_roaring(
        self, handler, index: str, field: str, shard: str
    ) -> None:
        # node-local bulk-lane apply (no re-fan-out — the coordinator's
        # roaring_router already addressed every owner): adopt the frame
        # via one WAL append, barrier inside api.import_roaring, THEN
        # ack — the coordinator's client acknowledgement is backed by
        # this replica's durability barrier. Not device-probe gated for
        # the same reason as _h_import_bits (numpy/roaring only).
        data = handler._body()
        view = handler.query_params.get("view", ["standard"])[0] or "standard"
        bits = self.server.api.import_roaring(
            index, field, int(shard), data, view=view
        )
        meter = getattr(self.server.http, "ingest_meter", None)
        if meter is not None:
            meter.record(len(data), bits)
        handler._json({"success": True, "bits": bits})

    def _apply_or_reforward_import(
        self, index: str, field: str, payload: dict, values: bool
    ) -> list[str]:
        """Authoritative-receiver import: a node whose topology is stale
        (e.g. mid-join) fans out to OLD owners; if this node no longer
        owns the payload's shard, re-forward to the current owners so the
        bits land where reads route — otherwise they'd sit invisible in a
        relinquished fragment until the anti-entropy handoff. The
        `reforwarded` flag stops ping-pong when two nodes disagree about
        ownership: the second hop applies locally and lets AE reconcile.
        Returns the URIs that actually APPLIED the payload, so the
        router's shard announce names real holders, not this node."""
        cols = payload.get("columnIDs", [])
        span = (
            set(np.unique(np.asarray(cols, np.uint64) // SHARD_WIDTH).tolist())
            if len(cols)
            else set()
        )
        if len(span) > 1:
            # the node↔node import contract is single-shard (the router
            # splits before fan-out). Forwarding/applying a multi-shard
            # payload wholesale under ONE shard's ownership decision
            # would park other shards' bits on a non-owner, invisible to
            # reads until anti-entropy — enforce, don't assume.
            raise ValueError(
                f"internal import spans shards {sorted(span)}; "
                "single-shard payloads required"
            )
        shard = span.pop() if span else 0
        if (
            not payload.get("reforwarded")
            and len(cols)
            and not self.topology.owns(self.me.id, index, shard)
        ):
            fwd = dict(payload)
            fwd["reforwarded"] = True
            applied_by: list[str] = []
            for owner in self.shard_nodes(index, shard):
                if not self._probe_alive(owner):
                    continue
                try:
                    applied_by.extend(
                        self.client.import_node(
                            owner.uri, index, field, fwd, values
                        )
                    )
                except PeerError:
                    continue
            if applied_by:
                return applied_by
            # every current owner unreachable: apply locally — the bits
            # survive here and hand off at the next anti-entropy pass
        if values:
            self.server.api.import_values(index, field, payload)
        else:
            self.server.api.import_bits(index, field, payload)
        return [self.me.uri]

    def _attr_store_from_params(self, handler):
        """Resolve the attr store named by index= [+ field=] params:
        the index's column-attr store, or a field's row-attr store."""
        p = handler.query_params
        idx = self.server.holder.index(p["index"][0])
        if idx is None:
            return None
        field = p.get("field", [None])[0]
        if field is None:
            return idx.column_attrs
        f = idx.field(field)
        return f.row_attrs if f else None

    def _h_attr_set(self, handler) -> None:
        self._apply_attr_write(handler._json_body())
        handler._json({"success": True})

    def _h_attr_blocks(self, handler) -> None:
        store = self._attr_store_from_params(handler)
        blocks = store.block_checksums() if store else []
        handler._json(
            {"blocks": [{"block": b, "checksum": c.hex()} for b, c in blocks]}
        )

    def _h_attrs_get(self, handler) -> None:
        """The attributes of one row and of a list of columns
        (``_current_attrs``); a 503 while this node's own attr stores
        are marked stale."""
        body = handler._json_body()
        index = body["index"]
        if self.me.uri in self._stale_uris(index, ATTRS_SHARD):
            raise ShardUnavailableError(
                f"this node's attributes of {index!r} {STALE_COPY}"
            )
        idx = self.server.holder.index(index)
        row_attrs: dict = {}
        col_attrs: dict[str, dict] = {}
        if idx is not None:
            f = idx.field(body["field"]) if body.get("field") else None
            if f is not None:
                row_attrs = f.row_attrs.attrs(int(body["row"]))
            for c in body.get("columns") or ():
                attrs = idx.column_attrs.attrs(int(c))
                if attrs:
                    col_attrs[str(c)] = attrs
        handler._json({"rowAttrs": row_attrs, "columnAttrs": col_attrs})

    def _h_attr_block_data(self, handler) -> None:
        store = self._attr_store_from_params(handler)
        block = int(handler.query_params["block"][0])
        data = store.block_data(block) if store else {}
        handler._json({"attrs": {str(k): v for k, v in data.items()}})

    def _h_translate_data(self, handler) -> None:
        p = handler.query_params
        index = p["index"][0]
        offset = int(p.get("offset", ["0"])[0])
        idx = self.server.holder.index(index)
        store = None
        if idx is not None:
            if "field" in p:
                f = idx.field(p["field"][0])
                store = f.row_keys if f is not None else None
            else:
                store = idx.column_keys
        if store is None:
            # unknown index OR field (schema broadcast raced the pull):
            # empty answer, same as the index-missing case — a 500 here
            # fails the caller's fence for a transient race
            handler._json({"entries": [], "senderHoles": []})
            return
        holes = [
            int(x) for x in p.get("holes", [""])[0].split(",") if x
        ]
        entries, own_holes = store.tail_for(offset, holes)
        handler._json({
            "entries": [{"k": k, "id": i} for k, i in entries],
            # the sender's known vacancies: the puller adopts the ones it
            # lacks so its watermark can cross cluster-wide fork holes
            "senderHoles": own_holes,
        })

    def _h_translate_create(self, handler) -> None:
        """Batch key→ID translation on the primary. JSON body or a
        protobuf TranslateKeysRequest (returns TranslateKeysResponse)."""
        from pilosa_tpu_torch import encoding

        proto = handler._proto_body()
        if proto:
            body = encoding.protoser.translate_keys_request_from_bytes(
                handler._body()
            )
        else:
            body = handler._json_body()
        idx = self.server.holder.index(body["index"])
        store = (
            idx.field(body["field"]).row_keys if body.get("field") else idx.column_keys
        )
        create = body.get("create", True)
        primary = self._translate_primary()
        if create and primary.id != self.me.id:
            # a sender with a stale liveness view posted its create here:
            # allocating from this node's counter would fork the keyspace.
            # Forward ONE hop to the primary we see; a forwarded request
            # landing on another non-primary (liveness views still
            # settling) refuses instead of looping.
            if body.get("fwd"):
                handler._json(
                    {"error": "not translate primary"}, code=503
                )
                return
            try:
                resp = self.client._json(
                    "POST",
                    primary.uri,
                    "/internal/translate/create",
                    dict(body, fwd=True),
                )
            except PeerError as e:
                handler._json(
                    {"error": f"translate primary unavailable: {e}"}, code=503
                )
                return
            ids = resp["ids"]
            store.apply_entries(
                [(k, i) for k, i in zip(body["keys"], ids) if i]
            )
        else:
            ids = self._primary_allocate(
                body["index"], body.get("field"), store, body["keys"], create
            )
        if create:
            # allocations appended to the translate WAL (locally, or via
            # the forwarded primary's apply_entries above): durable
            # before the RPC ack leaves (docs/durability.md)
            durable.ack_barrier()
        if proto:
            handler._proto(encoding.protoser.translate_keys_response_to_bytes(ids))
        else:
            handler._json({"ids": ids})

    def _h_translate_apply(self, handler) -> None:
        """Receiver for the primary's replicate-before-ack entry push.
        Unknown index/field (schema broadcast raced the push) is not an
        error — the entries arrive again via tailing."""
        body = handler._json_body()
        idx = self.server.holder.index(body["index"])
        store = None
        if idx is not None:
            if body.get("field"):
                f = idx.field(body["field"])
                store = f.row_keys if f is not None else None
            else:
                store = idx.column_keys
        if store is None:
            handler._json({"applied": False})
            return
        dropped = store.apply_entries([(k, i) for k, i in body["entries"]])
        if dropped:
            self.server.logger.log(
                f"translate apply {body['index']}/{body.get('field') or '<columns>'}: "
                f"primary push displaced {len(dropped)} local binding(s)"
            )
        # replicate-before-ack only holds if the replica's copy is ON
        # DISK when the primary's push returns (docs/durability.md)
        durable.ack_barrier()
        # adopted bindings can change how cached results keyed under the
        # old (stamp-blind) translate state would decode — retire them
        self.server.api._invalidate_results(body["index"])
        handler._json({"applied": True})


def serialize_empty() -> bytes:
    from pilosa_tpu_torch.roaring import Bitmap

    return serialize(Bitmap())


def reduce_results(call: Call, partials: list[Any]) -> Any:
    """Merge per-node partial results (reference: executor.go per-call
    reducers)."""
    if not partials:
        return None
    first = partials[0]
    if isinstance(first, RowResult):
        merged = RowResult({})
        for p in partials:
            merged.segments.update(p.segments)  # shards are disjoint
        return merged
    if isinstance(first, bool):
        return any(partials)
    if isinstance(first, int):
        return sum(partials)
    if isinstance(first, dict) and "value" in first and "count" in first:
        if call.name == "Sum":
            return {
                "value": sum(p["value"] for p in partials),
                "count": sum(p["count"] for p in partials),
            }
        # Min/Max merge
        want_max = call.name == "Max"
        best = None
        for p in partials:
            if p["count"] == 0:
                continue
            if best is None or (
                p["value"] > best["value"] if want_max else p["value"] < best["value"]
            ):
                best = dict(p)
            elif p["value"] == best["value"]:
                best["count"] += p["count"]
        return best or {"value": 0, "count": 0}
    if isinstance(first, dict) and "rows" in first:
        rows = sorted(set().union(*(set(p["rows"]) for p in partials)))
        # keyed fields: each partial carries rows∥keys aligned — rebuild
        # the merged mapping so the cluster path returns keys too
        # (reference: executor.go executeRows returns RowIdentifiers)
        keymap: dict[int, str] = {}
        for p in partials:
            if "keys" in p:
                # skip str(id) placeholders a translate-lagging node
                # emits — never let one overwrite a real key in hand
                keymap.update(
                    (r, k)
                    for r, k in zip(p["rows"], p["keys"])
                    if k != str(r)
                )
        limit = call.arg("limit")
        if limit is not None:
            rows = rows[:limit]
        out: dict[str, Any] = {"rows": rows}
        if keymap:
            out["keys"] = [keymap.get(r, str(r)) for r in rows]
        return out
    if isinstance(first, list):
        sample = next((p[0] for p in partials if p), None)
        if sample is not None and isinstance(sample, dict) and "group" in sample:
            merged: dict[tuple, dict] = {}
            for p in partials:
                for g in p:
                    key = tuple(
                        (e["field"], e["rowID"]) for e in g["group"]
                    )
                    if key in merged:
                        merged[key]["count"] += g["count"]
                        if "sum" in g:
                            merged[key]["sum"] = merged[key].get("sum", 0) + g["sum"]
                    else:
                        merged[key] = dict(g)
            out = list(merged.values())
            # nested ascending row-id order — matches the single-node
            # expand order, and makes the limit cut below deterministic
            # (child Rows limits were already pinned to the global row cut
            # at fan-out time — see _pin_groupby_rows)
            out.sort(key=lambda g: tuple(e["rowID"] for e in g["group"]))
            limit = call.arg("limit")
            if limit is not None:
                out = out[:limit]
            return out
        # TopN pairs: counts add across nodes (each node counted disjoint shards)
        counts: dict[int, dict] = {}
        for p in partials:
            for pair in p:
                if pair["id"] in counts:
                    c = counts[pair["id"]]
                    c["count"] += pair["count"]
                    k = pair.get("key")
                    # a later partial's real key beats an earlier
                    # placeholder from a translate-lagging node
                    if (
                        k is not None
                        and k != str(pair["id"])
                        and c.get("key") == str(pair["id"])
                    ):
                        c["key"] = k
                else:
                    counts[pair["id"]] = dict(pair)
        pairs = sorted(counts.values(), key=lambda pr: (-pr["count"], pr["id"]))
        n = call.arg("n")
        if n is not None:
            pairs = pairs[:n]
        return pairs
    return first
