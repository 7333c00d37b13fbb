"""Deterministic fault injection for the node→node data plane.

Every behavior in docs/fault-tolerance.md — retry-then-succeed, replica
failover, breaker trips, deadline exhaustion — is testable without real
network chaos: a ``FaultInjector`` holds seeded, rule-based faults, which
the reference's ``FaultInjectingClient`` (an ``InternalClient`` subclass,
ported with the cluster: ROADMAP.md A10) consults at the single transport
chokepoint before any bytes move.
Faults therefore surface to callers exactly like real failures do (as
``PeerError`` with a status, or as added latency), underneath the retry
and breaker layers in ``parallel/resilience.py``.

Rules are JSON objects:

    {"peer": "127.0.0.1:9101",      # substring match on the peer URI ("" = all)
     "path": "/internal/query",     # prefix match on the request path ("" = all)
     "method": "POST",              # exact match ("" = all)
     "action": "http",              # drop | delay | http | blackhole
     "status": 503,                 # http action: injected status code
     "times": 2,                    # fire for the first N matches, then inert
                                    # (0/absent = every match; the
                                    #  "first-N-then-ok" shape)
     "delay_ms": 100, "jitter_ms": 50}   # delay action; also honored as a
                                         # pre-fault latency on drop/blackhole

Actions: ``drop`` raises a connection-reset-shaped transport error;
``delay`` sleeps ``delay_ms`` + U(0, jitter_ms) (seeded RNG) then lets
the request proceed; ``http`` fails with the given 5xx/4xx status;
``blackhole`` fails EVERY match until the rule set is cleared (the
unreachable-peer shape — ``times`` is ignored).

Configured three ways: the ``fault-rules`` config key (JSON list) /
``PILOSA_TPU_FAULT_RULES`` env var, seeded by ``fault-seed``; or at
runtime through the debug route (GET/POST/DELETE ``/debug/faults``) so
an operator can rehearse a failure on a live cluster and clear it
without a restart.
"""

from __future__ import annotations

import errno
import json
import os
import random
import signal
import threading
import time

from pilosa_tpu_torch.parallel.client import PeerError

_ACTIONS = ("drop", "delay", "http", "blackhole")


class FaultRule:
    __slots__ = (
        "peer", "path", "method", "action", "status", "times",
        "delay_ms", "jitter_ms", "fires",
    )

    def __init__(self, spec: dict):
        self.peer = spec.get("peer", "")
        self.path = spec.get("path", "")
        self.method = spec.get("method", "")
        self.action = spec.get("action", "drop")
        if self.action not in _ACTIONS:
            raise ValueError(
                f"fault action must be one of {_ACTIONS}, got {self.action!r}"
            )
        self.status = int(spec.get("status", 503))
        self.times = int(spec.get("times", 0))
        self.delay_ms = float(spec.get("delay_ms", 0.0))
        self.jitter_ms = float(spec.get("jitter_ms", 0.0))
        self.fires = 0

    def matches(self, method: str, uri: str, path: str) -> bool:
        if self.method and self.method != method:
            return False
        if self.peer and self.peer not in uri:
            return False
        if self.path and not path.startswith(self.path):
            return False
        # blackhole ignores `times`: it fails until cleared
        if self.action != "blackhole" and self.times > 0 and self.fires >= self.times:
            return False
        return True

    def to_json(self) -> dict:
        return {
            "peer": self.peer,
            "path": self.path,
            "method": self.method,
            "action": self.action,
            "status": self.status,
            "times": self.times,
            "delay_ms": self.delay_ms,
            "jitter_ms": self.jitter_ms,
            "fires": self.fires,
        }


class FaultInjector:
    """Seeded rule set shared by one node's outgoing client chain and
    its /debug/faults route.  Thread-safe; the no-rules fast path is one
    attribute read, so an always-installed injector costs nothing in
    production."""

    def __init__(self, rules: list[dict] | None = None, seed: int = 0,
                 sleep=time.sleep):
        self._lock = threading.Lock()
        self._rules: list[FaultRule] = []
        self._rng = random.Random(seed)
        self.seed = seed
        self._sleep = sleep
        # concurrency high-water mark across delayed requests — the
        # heartbeat-fan-out test reads this to prove probes overlap
        self._active = 0
        self.max_concurrent = 0
        if rules:
            self.set_rules(rules, seed)

    @classmethod
    def from_config(cls, config) -> "FaultInjector":
        rules: list[dict] = []
        raw = getattr(config, "fault_rules", "") or ""
        if raw:
            parsed = json.loads(raw)
            if not isinstance(parsed, list):
                raise ValueError("fault-rules must be a JSON list of rules")
            rules = parsed
        return cls(rules, seed=getattr(config, "fault_seed", 0))

    @property
    def armed(self) -> bool:
        return bool(self._rules)

    def set_rules(self, rules: list[dict], seed: int | None = None) -> None:
        parsed = [FaultRule(r) for r in rules]
        with self._lock:
            if seed is not None:
                self.seed = seed
                self._rng = random.Random(seed)
            self._rules = parsed

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [r.to_json() for r in self._rules],
                "maxConcurrent": self.max_concurrent,
            }

    def before_request(self, method: str, uri: str, path: str) -> None:
        """Apply the first matching rule (rule order is the tiebreak —
        deterministic given the same arrival order).  Raises PeerError
        for failure actions; returns after sleeping for delay actions."""
        if not self._rules:
            return
        with self._lock:
            rule = next(
                (r for r in self._rules if r.matches(method, uri, path)), None
            )
            if rule is None:
                return
            rule.fires += 1
            delay_s = 0.0
            if rule.delay_ms > 0 or rule.jitter_ms > 0:
                delay_s = (
                    rule.delay_ms + self._rng.uniform(0.0, rule.jitter_ms)
                ) / 1e3
            action, status = rule.action, rule.status
            if delay_s > 0:
                self._active += 1
                self.max_concurrent = max(self.max_concurrent, self._active)
        try:
            if delay_s > 0:
                self._sleep(delay_s)
        finally:
            if delay_s > 0:
                with self._lock:
                    self._active -= 1
        if action == "delay":
            return
        if action == "http":
            raise PeerError(
                uri, f"HTTP {status}: injected fault", status=status
            )
        if action == "blackhole":
            raise PeerError(uri, "injected blackhole: peer unreachable")
        raise PeerError(uri, "injected connection drop: connection reset")


# --------------------------------------------------------------- FS faults
#
# The durable write protocol (utils/durable.py) consults an installed
# hook before every filesystem primitive it performs.  FSFaultInjector is
# that hook: seeded, rule-armed disk faults — EIO, ENOSPC, torn
# (partial) writes, and process death at an exact protocol point — so
# the chaos suite reaches the write path exactly where real faults
# would (docs/durability.md crash matrix).
#
# Rules are JSON objects:
#
#     {"op": "snapshot-write",  # durable.py hook op: wal-append |
#                               # snapshot-write | fsync | rename |
#                               # dirfsync | truncate ("" = all ops)
#      "path": "fragments/0",   # substring match on the file path ("" = all)
#      "action": "crash",       # eio | enospc | torn | crash | kill | delay
#      "after": 2,              # skip the first N matches (arm the fault at
#                               # a precise occurrence), then
#      "times": 1,              # fire for the next N matches (0 = forever)
#      "cap_bytes": 7,          # torn action: bytes actually written before
#                               # the cut (default: half the buffer)
#      "delay_ms": 50, "jitter_ms": 10}  # delay action (seeded jitter)
#
# Actions: ``eio``/``enospc`` raise the corresponding OSError (the disk
# said no; recovery must keep the old state authoritative); ``torn``
# caps the write at cap_bytes then dies — the kill-9-mid-write shape;
# ``crash`` raises durable.SimulatedCrash (in-process chaos: tears
# through recovery code like a process death, caught only by the test
# harness / compaction worker); ``kill`` SIGKILLs the process — the
# real thing, for the subprocess crash-recovery suite; ``delay`` sleeps
# (stretches a protocol window so a concurrent writer can be observed
# not blocking).
#
# Armed via config ``fs-fault-rules`` (JSON list) + the shared
# ``fault-seed``; Server.open installs the injector process-wide with
# ``durable.install_fs_hook``.

_FS_ACTIONS = ("eio", "enospc", "torn", "crash", "kill", "delay")


class FSFaultRule:
    __slots__ = (
        "op", "path", "action", "then", "after", "times", "cap_bytes",
        "delay_ms", "jitter_ms", "matched", "fires",
    )

    def __init__(self, spec: dict):
        self.op = spec.get("op", "")
        self.path = spec.get("path", "")
        self.action = spec.get("action", "eio")
        # torn rules: how the process dies after the capped write —
        # "crash" (SimulatedCrash, in-process suites) or "kill" (SIGKILL,
        # the subprocess crash-recovery suite)
        self.then = spec.get("then", "crash")
        if self.action not in _FS_ACTIONS:
            raise ValueError(
                f"fs fault action must be one of {_FS_ACTIONS}, "
                f"got {self.action!r}"
            )
        if self.then not in ("crash", "kill"):
            # a typo'd death mode would silently degrade SIGKILL to an
            # in-process SimulatedCrash — the operator's kill-9
            # rehearsal would exercise the weaker mode with no error
            raise ValueError(
                f"fs fault 'then' must be 'crash' or 'kill', "
                f"got {self.then!r}"
            )
        self.after = int(spec.get("after", 0))
        self.times = int(spec.get("times", 1))
        self.cap_bytes = int(spec.get("cap_bytes", -1))
        self.delay_ms = float(spec.get("delay_ms", 0.0))
        self.jitter_ms = float(spec.get("jitter_ms", 0.0))
        self.matched = 0  # occurrences seen (drives `after`)
        self.fires = 0

    def observe(self, op: str, path: str) -> bool:
        """Count a match and decide whether the fault WOULD fire on it —
        without consuming the firing (the injector consumes `fires` only
        on the one rule it selects). Deterministic: the `after`/`times`
        counters make the Nth occurrence of an op the crash point, every
        run — and every overlapping rule counts every occurrence, so an
        earlier rule firing can never skew a later rule's `after`."""
        if self.op and self.op != op:
            return False
        if self.path and self.path not in path:
            return False
        self.matched += 1
        if self.matched <= self.after:
            return False
        if self.times > 0 and self.fires >= self.times:
            return False
        return True

    def try_fire(self, op: str, path: str) -> bool:
        if self.observe(op, path):
            self.fires += 1
            return True
        return False

    def to_json(self) -> dict:
        return {
            "op": self.op,
            "path": self.path,
            "action": self.action,
            "then": self.then,
            "after": self.after,
            "times": self.times,
            "capBytes": self.cap_bytes,
            "delay_ms": self.delay_ms,
            "matched": self.matched,
            "fires": self.fires,
        }


class FSFaultInjector:
    """The ``durable.install_fs_hook`` protocol: ``check`` may raise or
    kill before a primitive touches the filesystem; ``write_cap`` caps a
    write's length for torn-write faults; ``torn`` performs the death
    that must follow a capped write.  Thread-safe; unarmed cost is one
    attribute read per primitive."""

    def __init__(self, rules: list[dict] | None = None, seed: int = 0,
                 sleep=time.sleep):
        self._lock = threading.Lock()
        self._rules: list[FSFaultRule] = []
        self._rng = random.Random(seed)
        self.seed = seed
        self._sleep = sleep
        # the rule whose capped write this thread just performed —
        # thread-local because write_cap() and the torn() death that
        # follows it happen on the SAME thread (durable._write), while
        # OTHER threads may be tearing through different rules
        # concurrently; one shared slot would fire the wrong `then`
        self._torn_local = threading.local()
        if rules:
            self.set_rules(rules, seed)

    @classmethod
    def from_config(cls, config) -> "FSFaultInjector":
        rules: list[dict] = []
        raw = getattr(config, "fs_fault_rules", "") or ""
        if raw:
            parsed = json.loads(raw)
            if not isinstance(parsed, list):
                raise ValueError("fs-fault-rules must be a JSON list of rules")
            rules = parsed
        return cls(rules, seed=getattr(config, "fault_seed", 0))

    @property
    def armed(self) -> bool:
        return bool(self._rules)

    def set_rules(self, rules: list[dict], seed: int | None = None) -> None:
        parsed = [FSFaultRule(r) for r in rules]
        with self._lock:
            if seed is not None:
                self.seed = seed
                self._rng = random.Random(seed)
            self._rules = parsed

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [r.to_json() for r in self._rules],
            }

    def _die(self, action: str, op: str, path: str) -> None:
        from pilosa_tpu_torch.utils.durable import SimulatedCrash

        if action == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise SimulatedCrash(f"injected crash at {op} on {path}")

    # --------------------------------------------- durable.py hook protocol
    def check(self, op: str, path: str) -> None:
        if not self._rules:
            return
        with self._lock:
            # every non-torn rule observes (counts) the occurrence; only
            # the FIRST eligible rule fires — a firing rule must not
            # hide occurrences from the rules behind it
            rule = None
            for r in self._rules:
                if r.action == "torn":
                    continue  # torn rules count write_cap occurrences
                if r.observe(op, path) and rule is None:
                    r.fires += 1
                    rule = r
            if rule is None:
                return
            action = rule.action
            delay_s = (
                rule.delay_ms + self._rng.uniform(0.0, rule.jitter_ms)
            ) / 1e3 if action == "delay" else 0.0
        if action == "delay":
            self._sleep(delay_s)
            return
        if action == "eio":
            raise OSError(errno.EIO, f"injected EIO at {op}", path)
        if action == "enospc":
            raise OSError(
                errno.ENOSPC, f"injected ENOSPC at {op}", path
            )
        self._die(action, op, path)

    def write_cap(self, op: str, path: str, nbytes: int) -> int | None:
        if not self._rules:
            return None
        with self._lock:
            rule = None
            cap = None
            for r in self._rules:
                if r.action != "torn":
                    continue  # non-torn rules count check occurrences
                eligible = r.observe(op, path)
                if not eligible or rule is not None:
                    continue
                c = r.cap_bytes if r.cap_bytes >= 0 else nbytes // 2
                if c >= nbytes:
                    # this write is smaller than the cap — nothing would
                    # tear. Don't consume the firing: a burnt `fires`
                    # with no injected fault makes the chaos scenario
                    # silently vacuous; the rule stays armed for a write
                    # it can actually truncate.
                    continue
                r.fires += 1
                rule = r
                cap = c
            if rule is None:
                return None
            self._torn_local.rule = rule
            return cap

    def torn(self, op: str, path: str) -> None:
        """The death that follows a capped write (durable._write calls
        this right after flushing the partial buffer — the bytes ARE on
        the file, exactly like a kill mid-write leaves them)."""
        rule = getattr(self._torn_local, "rule", None)
        self._die(rule.then if rule is not None else "crash", op, path)
