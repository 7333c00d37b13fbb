"""Mutation-stamped cross-request result cache (docs/result-cache.md).

The wave scheduler (executor/scheduler.py) already established the
identity law this cache rides: two queries may share one answer exactly
when their single-flight dedup key — ``(index, canonical calls, shard
scope, view-version mutation stamp)`` — is equal, because every data
write bumps a view version through the globally monotone counter, so a
post-write query computes a DIFFERENT key and can never observe a
pre-write result.  Single-flight applies that law for the lifetime of
one in-flight execution and then throws the answer away; this cache
retains SETTLED results under the same key, turning the workload
plane's measured unchanged-stamp repeat traffic (docs/workload.md
cachability estimate) into serves that skip the admission lane, the
worker pool, and the engines entirely.

Two mechanisms close the gaps the stamp alone leaves:

* **Explicit invalidation** (``invalidate``): attribute writes
  (SetRowAttrs/SetColumnAttrs) mutate attribute stores WITHOUT bumping
  any view version, so a stamp-keyed entry would serve stale attrs
  forever.  Every API write path must therefore reach the invalidation
  hook (``API._invalidate_results`` — enforced by the ``cacheinvariant``
  analyzer rule), which also reclaims the unreachable old-stamp
  generations instead of waiting for LRU pressure to find them.
* **Fill generations** (``generation``/``offer(gen=...)``): a fill whose
  execution overlapped an invalidation must not resurrect a pre-write
  result — the caller snapshots the index's generation before
  executing, and the offer is refused if it moved.

Admission is cost-aware: results cheaper than ``result-cache-min-cost-
ms`` are not worth a ledger slot (the 0.2ms Count), results larger than
the per-entry byte cap would evict half the working set for one giant
answer, and an index whose stamp churns on every consecutive fill is
write-dominated — its entries would rotate out before a single hit.
Everything admitted is charged against the ``result-cache-bytes``
budget with LRU eviction, and each entry carries the route cache's
bounded revalidate-every-N countdown (executor/executor.py): after
``REVALIDATE_HITS`` serves the entry steps aside for one real
execution, so no answer — however hot — serves unverified forever.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any

from pilosa_tpu_torch.utils import sanitize

# after this many hits an entry is deliberately served as a miss and
# dropped, so the settle path re-executes and re-fills it — the route
# cache's bounded revalidate-every-N idiom (executor/executor.py),
# sized larger because a result hit saves milliseconds where a route
# revalidation saves microseconds
REVALIDATE_HITS = 1024

# one entry may take at most budget/_ENTRY_BUDGET_FRACTION bytes: a
# single giant GroupBy must not evict the whole hot working set.  This
# cap is also the workload estimator's byte cutoff — repeats whose
# results exceed it are NOT counted as servable (docs/workload.md)
_ENTRY_BUDGET_FRACTION = 8

# consecutive offers under a CHANGED stamp before an index is treated
# as write-dominated and admission pauses until a stamp repeats
_CHURN_STREAK = 16

_SKIP_OFF = "cache-off"
_SKIP_COST = "cost-below-threshold"
_SKIP_BYTES = "over-byte-cap"
_SKIP_CHURN = "stamp-churn"
_SKIP_STALE = "invalidated-during-execution"


class _Entry:
    __slots__ = (
        "key", "index", "resp", "body", "nbytes", "cost_s", "hits",
        "countdown",
    )

    def __init__(self, key: tuple, resp: dict, body: bytes, cost_s: float):
        self.key = key
        self.index = key[0]
        self.resp = resp  # JSON-ready response dict — treated immutable
        self.body = body  # pre-serialized JSON bytes (the loop fast path)
        self.nbytes = len(body)
        self.cost_s = cost_s
        self.hits = 0
        self.countdown = REVALIDATE_HITS


class _PqlKeyer:
    """Raw pql text → canonical call-repr tuple, memoized.  The
    event-loop fast path CONSULTS only (``cached``) — it never parses:
    charging every first-seen query a parse on the serving thread is
    exactly the miss-path overhead the bench gate bounds at 3%.
    Instead the worker/coordinator paths, which parse anyway, record
    the identity (``memoize``) at settle time, so the SECOND arrival
    of a hot query is served from the loop.  Write-bearing queries
    memoize as ``None`` — the fast path steps aside permanently.
    Bounded LRU so hostile distinct queries cannot grow the memo
    without bound."""

    MISSING = object()  # "never seen": distinct from memoized None

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self._lock = sanitize.make_lock("_PqlKeyer._lock", loop_safe=True)
        self._memo: OrderedDict[str, tuple | None] = OrderedDict()

    def cached(self, pql: str):
        """The memoized canonical tuple, ``None`` (a write), or
        ``MISSING`` — never parses, safe on the event loop."""
        # loop_safe: O(1) LRU memo peek, nothing blocking under the
        # lock; registered loop_safe with the sanitizer (make_lock)
        with self._lock:  # pilosa: allow(loop-purity)
            if pql in self._memo:
                self._memo.move_to_end(pql)
                return self._memo[pql]
        return self.MISSING

    def memoize(self, pql: str, canon: tuple | None) -> None:
        with self._lock:
            self._memo[pql] = canon
            self._memo.move_to_end(pql)
            while len(self._memo) > self.capacity:
                self._memo.popitem(last=False)


class ResultCache:
    """Bounded, byte-ledgered result cache keyed on the scheduler's
    single-flight dedup identity.  Thread-safe; all counters and the
    ledger live under one lock (lookups are dict hits — the lock is
    never held across parsing, execution, or serialization)."""

    def __init__(
        self,
        max_bytes: int = 64_000_000,
        min_cost_ms: float = 1.0,
        mode: str = "on",
        stats=None,
    ):
        if mode not in ("on", "off"):
            raise ValueError(
                f"result-cache-mode must be 'on' or 'off', got {mode!r}"
            )
        self.max_bytes = max(0, int(max_bytes))
        self.min_cost_ms = float(min_cost_ms)
        self.mode = mode
        self.stats = stats
        self._lock = sanitize.make_lock("ResultCache._lock", loop_safe=True)
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self._by_index: dict[str, set] = {}
        self._gen: dict[str, int] = {}
        # per-index (last fill stamp, consecutive-changed streak) for
        # the write-churn admission guard
        self._stamp_seen: dict[str, tuple[Any, int]] = {}
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.invalidated_entries = 0
        self.fills = 0
        self.revalidations = 0
        self.skips: dict[str, int] = {}
        self._keyer = _PqlKeyer()
        self._tl = threading.local()

    # ------------------------------------------------------------ config
    @property
    def enabled(self) -> bool:
        return self.mode == "on" and self.max_bytes > 0

    @property
    def entry_byte_cap(self) -> int:
        return self.max_bytes // _ENTRY_BUDGET_FRACTION

    # ------------------------------------------------------------ lookup
    def get(self, key: tuple) -> _Entry | None:
        """The settled entry for this dedup key, or None.  Counts the
        hit/miss and stamps the thread-local outcome the HTTP layer
        tags flightrec/EXPLAIN with (``consume_outcome``)."""
        if not self.enabled:
            self._set_outcome("skip", _SKIP_OFF)
            return None
        if getattr(self._tl, "bypass", 0):
            # ?profile / EXPLAIN ANALYZE: measured actuals must reflect
            # a real execution, never a cached serve
            self._set_outcome("skip", "bypass")
            return None
        # loop_safe: bounded LRU probe + counter bumps, nothing
        # blocking under the lock; registered loop_safe (make_lock)
        with self._lock:  # pilosa: allow(loop-purity)
            e = self._entries.get(key)
            if e is not None:
                e.countdown -= 1
                if e.countdown <= 0:
                    # bounded revalidate: step aside for one real
                    # execution; the settle path re-fills the key
                    self._drop_locked(e)
                    self.revalidations += 1
                    e = None
            if e is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                e.hits += 1
                self.hits += 1
        if e is None:
            if self.stats is not None:
                self.stats.count("result_cache_misses_total")
            self._set_outcome("miss")
            return None
        if self.stats is not None:
            self.stats.count("result_cache_hits_total")
        self._set_outcome("hit")
        return e

    def lookup_pql(
        self, api, index: str, pql: str, shards: list[int] | None
    ) -> _Entry | None:
        """Loop-thread fast path (server/eventloop.py): raw request →
        settled entry, or None when the worker path must run.  Pure
        CPU — two dict lookups plus the stack-token walk, NO parsing
        (the worker path's ``memoize_pql`` populated the keyer) — so it
        is legal inside the event loop's coroutine (the asyncpurity
        rule bans blocking calls, not dict lookups)."""
        if not self.enabled:
            return None
        canon = self._keyer.cached(pql)
        if canon is None or canon is _PqlKeyer.MISSING:
            # a write, or text the worker path has not settled yet —
            # either way the worker path owns this arrival
            return None
        idx = api.holder.index(index)
        if idx is None:
            return None  # unknown index: the worker path owns the 4xx
        from pilosa_tpu_torch.executor.scheduler import stack_token

        key = (
            index,
            canon,
            tuple(shards) if shards is not None else None,
            stack_token(idx),
        )
        return self.get(key)

    def memoize_pql(self, pql: str, calls: list | None) -> None:
        """Record raw query text → canonical identity for the event-loop
        fast path.  Called from the paths that parsed the text anyway
        (API.query, Cluster.query) so the loop itself never parses;
        pass ``calls=None`` for write-bearing queries — the loop then
        steps aside for that text permanently."""
        if not self.enabled:
            return
        if calls is None:
            self._keyer.memoize(pql, None)
            return
        from pilosa_tpu_torch.executor.scheduler import canonical_calls

        # per-call-object repr cache: the fill leg's dedup_key and the
        # scheduler's single-flight key reuse this render
        self._keyer.memoize(pql, canonical_calls(calls))

    def contains(self, key: tuple) -> bool:
        """Non-mutating peek for EXPLAIN — no counters, no LRU touch."""
        with self._lock:
            return key in self._entries

    # ------------------------------------------------------------ fill
    def generation(self, index: str) -> int:
        """The index's invalidation generation: snapshot BEFORE
        executing, hand to ``offer`` — a fill that overlapped an
        invalidation is refused instead of resurrecting a pre-write
        result under a still-current key (attr writes don't move the
        stamp, so the key alone cannot catch this race)."""
        with self._lock:
            return self._gen.get(index, 0)

    def offer(
        self, key: tuple, resp: dict, cost_s: float, gen: int | None = None
    ) -> bool:
        """Offer one settled response for admission.  ``cost_s`` is the
        measured execution cost (the admission signal); ``gen`` the
        pre-execution generation from ``generation()``."""
        if not self.enabled:
            self._set_fill(_SKIP_OFF)
            return False
        if cost_s * 1e3 < self.min_cost_ms:
            self._skip(_SKIP_COST)
            return False
        index = key[0]
        stamp = key[3] if len(key) > 3 else None
        body = json.dumps(resp, separators=(",", ":")).encode()
        if len(body) > self.entry_byte_cap:
            self._skip(_SKIP_BYTES)
            return False
        e = _Entry(key, resp, body, cost_s)
        evicted = 0
        with self._lock:
            if gen is not None and self._gen.get(index, 0) != gen:
                self._skip_locked(_SKIP_STALE)
                return False
            prev, streak = self._stamp_seen.get(index, (None, 0))
            streak = 0 if stamp == prev else streak + 1
            self._stamp_seen[index] = (stamp, streak)
            if streak >= _CHURN_STREAK:
                # write-dominated index: every recent fill arrived under
                # a fresh stamp, so admitted entries rotate out before a
                # single hit — pause admission until a stamp repeats
                self._skip_locked(_SKIP_CHURN)
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._drop_locked(old, pop=False)
            while (
                self.used_bytes + e.nbytes > self.max_bytes and self._entries
            ):
                _, victim = self._entries.popitem(last=False)
                self._drop_locked(victim, pop=False)
                self.evictions += 1
                evicted += 1
            self._entries[key] = e
            self._by_index.setdefault(index, set()).add(key)
            self.used_bytes += e.nbytes
            self.fills += 1
        if evicted and self.stats is not None:
            self.stats.count("result_cache_evictions_total", evicted)
        self._set_fill("filled")
        return True

    def _drop_locked(self, e: _Entry, pop: bool = True) -> None:
        if pop:
            self._entries.pop(e.key, None)
        keys = self._by_index.get(e.index)
        if keys is not None:
            keys.discard(e.key)
            if not keys:
                self._by_index.pop(e.index, None)
        self.used_bytes -= e.nbytes

    # ------------------------------------------------------- invalidation
    def invalidate(self, index: str) -> int:
        """Drop every entry for ``index`` and bump its fill generation.
        The write-path hook (API._invalidate_results) — correctness for
        stamp-blind attr writes, byte reclamation for everything else."""
        with self._lock:
            self._gen[index] = self._gen.get(index, 0) + 1
            self._stamp_seen.pop(index, None)
            keys = self._by_index.pop(index, set())
            dropped = 0
            for k in keys:
                e = self._entries.pop(k, None)
                if e is not None:
                    self.used_bytes -= e.nbytes
                    dropped += 1
            self.invalidations += 1
            self.invalidated_entries += dropped
        if self.stats is not None:
            self.stats.count("result_cache_invalidations_total")
        return dropped

    def clear(self) -> None:
        """Drop everything (cluster attach: single-node entries are not
        merged-topology entries, even under an unchanged local stamp)."""
        with self._lock:
            for index in list(self._by_index):
                self._gen[index] = self._gen.get(index, 0) + 1
            self._entries.clear()
            self._by_index.clear()
            self._stamp_seen.clear()
            self.used_bytes = 0

    # ------------------------------------------------------------ outcome
    @contextmanager
    def bypass(self):
        """Thread-local lookup bypass: real execution required (profile
        / EXPLAIN ANALYZE).  Fills are still allowed — a profiled run
        produces a perfectly valid settled result."""
        prev = getattr(self._tl, "bypass", 0)
        self._tl.bypass = prev + 1
        try:
            yield
        finally:
            self._tl.bypass = prev

    def _set_outcome(self, kind: str, reason: str | None = None) -> None:
        self._tl.outcome = (kind, reason)

    def _set_fill(self, what: str) -> None:
        self._tl.fill = what

    def _skip(self, reason: str) -> None:
        with self._lock:
            self._skip_locked(reason)

    def _skip_locked(self, reason: str) -> None:
        self.skips[reason] = self.skips.get(reason, 0) + 1
        self._set_fill(reason)

    def consume_outcome(self) -> dict | None:
        """This thread's last lookup/fill verdict, cleared on read — the
        HTTP settle path tags flightrec entries and the slow-query log
        with it."""
        out = getattr(self._tl, "outcome", None)
        fill = getattr(self._tl, "fill", None)
        self._tl.outcome = None
        self._tl.fill = None
        if out is None and fill is None:
            return None
        d: dict = {}
        if out is not None:
            d["outcome"] = out[0]
            if out[1]:
                d["reason"] = out[1]
        if fill is not None:
            d["fill"] = fill
        return d

    # ------------------------------------------------------------ surface
    def candidacy(self, index: str, has_write: bool) -> dict:
        """The structural half of the EXPLAIN verdict (docs/result-
        cache.md): would a settled result for this query be admitted?
        The HTTP layer adds the measured half (per-fingerprint cost and
        bytes from the workload plane) next to these."""
        if self.mode == "off":
            return {"admitted": False, "reason": "result-cache-mode is off"}
        if self.max_bytes <= 0:
            return {
                "admitted": False,
                "reason": "result-cache-bytes budget is zero",
            }
        if has_write:
            return {
                "admitted": False,
                "reason": "query contains writes (never cached)",
            }
        with self._lock:
            _, streak = self._stamp_seen.get(index, (None, 0))
        if streak >= _CHURN_STREAK:
            return {
                "admitted": False,
                "reason": (
                    f"stamp churn: {streak} consecutive fills under a "
                    "changed mutation stamp — write-dominated index"
                ),
            }
        return {
            "admitted": True,
            "reason": (
                f"read query; admitted when measured cost ≥ "
                f"{self.min_cost_ms}ms and result ≤ "
                f"{self.entry_byte_cap} bytes"
            ),
        }

    def snapshot(self) -> dict:
        """The /debug/vars ``resultCache`` section and the
        /debug/resources ledger row's source."""
        with self._lock:
            return {
                "mode": self.mode,
                "enabled": self.enabled,
                "maxBytes": self.max_bytes,
                "usedBytes": self.used_bytes,
                "entryByteCap": self.entry_byte_cap,
                "minCostMs": self.min_cost_ms,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "hitFraction": round(
                    self.hits / max(1, self.hits + self.misses), 4
                ),
                "fills": self.fills,
                "evictions": self.evictions,
                "revalidations": self.revalidations,
                "invalidations": self.invalidations,
                "invalidatedEntries": self.invalidated_entries,
                "admissionSkips": dict(self.skips),
            }
