"""Runtime concurrency sanitizer — the dynamic half of the lock rules.

The static analyzer predicts the holds-A-while-acquiring-B graph from
source (``tools/analysis/rules/locks.py``); this module OBSERVES it.
Behind ``PILOSA_TPU_SANITIZE=1``, ``make_lock`` returns an instrumented
wrapper that records, per thread, the stack of sanitized locks held and
derives:

- the observed lock-order graph (every held→acquiring pair, counted);
- hold times per lock (total/max — a lock held for milliseconds on a
  hot path is a latency bug even without a deadlock);
- event-loop-thread findings: any BLOCKING acquire of a lock not
  registered ``loop_safe`` on the thread ``mark_loop_thread()`` marked
  (the deterministic runtime form of the ``loop-purity`` rule);
- cycles in the observed graph (AB/BA deadlocks that merely have not
  fired yet);
- observed edges the static analysis never predicted, when
  ``PILOSA_TPU_SANITIZE_STATIC`` points at the JSON from
  ``python -m tools.analysis --emit-lock-graph`` (inline JSON works
  too) — a mismatch means the call-graph under-approximated and the
  static rules have a blind spot worth closing.

With the env var unset, ``make_lock`` returns the raw lock (or the
``inner`` shim passed in, e.g. a ``saturation.ContendedLock``): the
production fast path pays ZERO overhead — not even an ``if``.

Reports surface three ways: ``report()`` (served at
``/debug/sanitize``), an atexit line to stderr when there are
findings, and the pytest gate (``tests/conftest.py`` fails the run
under ``make sanitize`` if ``findings()`` is non-empty).  See
docs/concurrency.md.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time

__all__ = [
    "enabled",
    "make_lock",
    "mark_loop_thread",
    "unmark_loop_thread",
    "loop_thread_marked",
    "report",
    "findings",
    "reset",
]

_ENV = "PILOSA_TPU_SANITIZE"
_ENV_STATIC = "PILOSA_TPU_SANITIZE_STATIC"

_data_lock = threading.Lock()  # guards every structure below
_locks: dict[str, "SanitizedLock"] = {}
_edges: dict[tuple[str, str], int] = {}
_loop_violations: dict[str, int] = {}
_loop_thread: int | None = None
_tl = threading.local()
_atexit_registered = False


def enabled() -> bool:
    return os.environ.get(_ENV, "") not in ("", "0")


def _stack() -> list:
    st = getattr(_tl, "stack", None)
    if st is None:
        st = _tl.stack = []
    return st


def mark_loop_thread(ident: int | None = None) -> None:
    """Declare the current (or given) thread as THE event-loop thread.
    Safe to call when the sanitizer is off (no-op)."""
    global _loop_thread
    if not enabled():
        return
    _loop_thread = ident if ident is not None else threading.get_ident()


def unmark_loop_thread(ident: int | None = None) -> None:
    """Clear the mark when the loop exits.  The OS REUSES thread
    idents: a mark outliving its loop would flag an unrelated worker
    thread that later receives the same ident.  Only the marked
    thread's own exit clears it, so a second live loop's mark is never
    clobbered by the first one shutting down."""
    global _loop_thread
    if ident is None:
        ident = threading.get_ident()
    if _loop_thread == ident:
        _loop_thread = None


def loop_thread_marked() -> bool:
    return _loop_thread is not None


class SanitizedLock:
    """Lock wrapper recording held-stack edges, hold times, and
    loop-thread acquires.  Exposes ``acquire``/``release`` and the
    context protocol, so ``threading.Condition`` wraps it unmodified
    (Condition's default ``_is_owned`` probes via ``acquire(False)``,
    which records nothing — only SUCCESSFUL acquires enter the held
    stack, and self-edges are never recorded)."""

    __slots__ = (
        "name", "loop_safe", "reentrant", "_inner",
        "acquisitions", "hold_total_s", "hold_max_s",
    )

    def __init__(self, name: str, inner, *, reentrant: bool, loop_safe: bool):
        self.name = name
        self._inner = inner
        self.reentrant = reentrant
        self.loop_safe = loop_safe
        self.acquisitions = 0
        self.hold_total_s = 0.0
        self.hold_max_s = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        st = _stack()
        if blocking:
            # record the HAZARD at attempt time — if this acquire
            # deadlocks, the edge that explains it must already be in
            # the graph
            held = [e for e in st if e[0] is not self]
            if held or (
                _loop_thread is not None
                and not self.loop_safe
                and threading.get_ident() == _loop_thread
            ):
                with _data_lock:
                    for lk, _t0 in held:
                        key = (lk.name, self.name)
                        _edges[key] = _edges.get(key, 0) + 1
                    if (
                        _loop_thread is not None
                        and not self.loop_safe
                        and threading.get_ident() == _loop_thread
                    ):
                        _loop_violations[self.name] = (
                            _loop_violations.get(self.name, 0) + 1
                        )
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self.acquisitions += 1
            st.append((self, time.monotonic()))
        return ok

    def release(self) -> None:
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is self:
                _lk, t0 = st.pop(i)
                held_s = time.monotonic() - t0
                self.hold_total_s += held_s
                if held_s > self.hold_max_s:
                    self.hold_max_s = held_s
                break
        self._inner.release()

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        return inner_locked() if inner_locked is not None else False

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


def make_lock(
    name: str,
    *,
    reentrant: bool = False,
    loop_safe: bool = False,
    inner=None,
):
    """THE lock constructor for instrumented subsystems.

    ``name`` uses the static analyzer's lexical identity
    (``ClassName.attr`` — e.g. ``"ResultCache._lock"``) so the observed
    graph lines up with the predicted one.  ``inner`` composes with an
    existing shim (``saturation.ContendedLock``); otherwise a plain
    ``Lock``/``RLock`` is built.  ``loop_safe=True`` asserts the lock is
    bounded and safe to take on the event-loop thread — the claim every
    loop-purity allow pragma makes, now checked at runtime."""
    if inner is None:
        inner = threading.RLock() if reentrant else threading.Lock()
    if not enabled():
        return inner
    lk = SanitizedLock(name, inner, reentrant=reentrant, loop_safe=loop_safe)
    global _atexit_registered
    with _data_lock:
        _locks[name] = lk
        if not _atexit_registered:
            _atexit_registered = True
            atexit.register(_atexit_report)
    return lk


# ------------------------------------------------------------- reporting
def _cycles(edges: dict[tuple[str, str], int]) -> list[list[str]]:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    out: list[list[str]] = []
    reported: set[frozenset] = set()

    def dfs(start: str, node: str, path: list[str], visiting: set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start and len(path) > 1:
                key = frozenset(path)
                if key not in reported:
                    reported.add(key)
                    out.append(path + [start])
            elif nxt not in visiting:
                visiting.add(nxt)
                dfs(start, nxt, path + [nxt], visiting)
                visiting.discard(nxt)

    for n in sorted(graph):
        dfs(n, n, [n], {n})
    return out


def _load_static() -> dict | None:
    raw = os.environ.get(_ENV_STATIC, "").strip()
    if not raw:
        return None
    try:
        if raw.startswith("{"):
            return json.loads(raw)
        with open(raw, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _names_match(static_name: str, observed: str) -> bool:
    """`*.attr` static nodes (receiver not lexically resolvable) match
    any observed lock with that attribute."""
    if static_name == observed:
        return True
    if static_name.startswith("*.") and observed.endswith(static_name[1:]):
        return True
    return False


def _unexplained(
    observed: dict[tuple[str, str], int], static: dict
) -> list[dict]:
    """Observed edges with no static explanation.  An edge A→B is
    explained when the static graph has a PATH from a node matching A
    to a node matching B — the static closure may know the edge only
    through an intermediate lock the dynamic run never contended on."""
    sedges = [tuple(e[:2]) for e in static.get("edges", [])]
    adj: dict[str, set[str]] = {}
    for a, b in sedges:
        adj.setdefault(a, set()).add(b)
    nodes = set(adj) | {b for _a, bs in adj.items() for b in bs}

    def explained(a: str, b: str) -> bool:
        frontier = [n for n in nodes if _names_match(n, a)]
        seen = set(frontier)
        while frontier:
            cur = frontier.pop()
            if _names_match(cur, b) or any(
                _names_match(t, b) for t in adj.get(cur, ())
            ):
                return True
            for t in adj.get(cur, ()):
                if t not in seen:
                    seen.add(t)
                    frontier.append(t)
        return False

    out = []
    for (a, b), count in sorted(observed.items()):
        if not explained(a, b):
            out.append({"held": a, "acquiring": b, "count": count})
    return out


def report() -> dict:
    """The full sanitizer report — served at ``/debug/sanitize`` and
    consumed by the conftest gate."""
    if not enabled():
        return {"enabled": False}
    with _data_lock:
        locks = {
            name: {
                "acquisitions": lk.acquisitions,
                "loopSafe": lk.loop_safe,
                "holdSecondsTotal": round(lk.hold_total_s, 6),
                "holdSecondsMax": round(lk.hold_max_s, 6),
            }
            for name, lk in sorted(_locks.items())
        }
        observed = dict(_edges)
        loop_v = dict(_loop_violations)
    rep: dict = {
        "enabled": True,
        "loopThreadMarked": _loop_thread is not None,
        "locks": locks,
        "edges": [
            {"held": a, "acquiring": b, "count": c}
            for (a, b), c in sorted(observed.items())
        ],
        "cycles": _cycles(observed),
        "loopThreadViolations": loop_v,
    }
    static = _load_static()
    if static is not None:
        rep["staticComparison"] = {
            "staticEdges": len(static.get("edges", [])),
            "unexplainedEdges": _unexplained(observed, static),
        }
    return rep


def findings(rep: dict | None = None) -> list[str]:
    """Human-readable gate findings: empty list == clean run."""
    rep = rep if rep is not None else report()
    if not rep.get("enabled"):
        return []
    out = []
    for cyc in rep.get("cycles", []):
        out.append("lock-order cycle observed: " + " -> ".join(cyc))
    for name, count in sorted(rep.get("loopThreadViolations", {}).items()):
        out.append(
            f"non-loop_safe lock {name} blocking-acquired on the "
            f"event-loop thread ({count}x)"
        )
    for e in rep.get("staticComparison", {}).get("unexplainedEdges", []):
        out.append(
            f"observed edge {e['held']} -> {e['acquiring']} "
            f"({e['count']}x) absent from the static lock graph"
        )
    return out


def reset() -> None:
    """Drop all recorded state (test isolation)."""
    global _loop_thread
    with _data_lock:
        _locks.clear()
        _edges.clear()
        _loop_violations.clear()
    _loop_thread = None


def _atexit_report() -> None:
    found = findings()
    if found:
        sys.stderr.write(
            "[pilosa-tpu sanitize] %d finding(s):\n" % len(found)
        )
        for line in found:
            sys.stderr.write(f"[pilosa-tpu sanitize]   {line}\n")
