"""Movement admission lane (docs/resize.md). Reference:
pilosa_tpu/parallel/movement.py. The cluster (parallel/cluster.py) moves
fragments through the lane; ``fragment_checksum`` also serves the CLI's
``backup`` and ``restore``.

Every bulk data-movement path — rebalance pulls, anti-entropy handoff
pushes, restore adopts — moves whole fragments as serialized roaring
frames through the SAME admission lane, so movement can never starve
serving: transfers hold a bounded concurrency slot and pay a byte-rate
token bucket (``movement-max-concurrent`` / ``movement-max-mbit``)
before their bytes touch the wire, and every transfer is visible while
in flight (`GET /debug/cluster`) and accounted after
(`rebalance_bytes_total{direction}` / `fragments_moved_total` /
`movement_throttle_waits`, plus the ``movement`` row in
`GET /debug/resources`).

The lane deliberately owns NO transport: callers bring their own
resilient-client RPCs (the `resilience` analyzer rule pins movement to
that chain) and merely bracket them with :meth:`MovementLane.transfer`
+ :meth:`MovementLane.throttle`.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from collections import deque
from contextlib import contextmanager

from pilosa_tpu_torch.utils import sanitize


def fragment_checksum(data: bytes) -> str:
    """Content hash of one serialized fragment frame. ``serialize``
    run-compacts containers on the way out, so identical logical
    content yields identical bytes — the digest is a convergence
    witness, not just a transfer integrity check."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


class MovementMeter:
    """Rolling movement-throughput accounting: lifetime totals tagged
    by direction (pull / push / restore) plus a sliding-window rate,
    read by the /debug/resources "movement" row. Window math is
    monotonic throughout (mirrors stats.IngestMeter)."""

    WINDOW_S = 60.0

    def __init__(self) -> None:
        self._lock = sanitize.make_lock("MovementMeter._lock")
        self.bytes_by_direction: dict[str, int] = {}
        self.fragments_total = 0
        self.throttle_waits = 0
        self._events: list[tuple[float, int]] = []

    def record(self, direction: str, nbytes: int) -> None:
        now = time.monotonic()
        with self._lock:
            self.bytes_by_direction[direction] = (
                self.bytes_by_direction.get(direction, 0) + nbytes
            )
            self.fragments_total += 1
            self._events.append((now, nbytes))
            self._trim(now)

    def note_throttle_wait(self) -> None:
        with self._lock:
            self.throttle_waits += 1

    def _trim(self, now: float) -> None:
        cut = now - self.WINDOW_S
        i = bisect.bisect_right(self._events, (cut, 1 << 62))
        if i:
            del self._events[:i]

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            if self._events:
                span = max(now - self._events[0][0], 1e-9)
                wb = sum(e[1] for e in self._events)
            else:
                span, wb = 0.0, 0
            return {
                "bytesByDirection": dict(self.bytes_by_direction),
                "bytesTotal": sum(self.bytes_by_direction.values()),
                "fragmentsTotal": self.fragments_total,
                "throttleWaits": self.throttle_waits,
                "windowSeconds": round(min(span, self.WINDOW_S), 3),
                "recentBytesPerS": round(wb / span, 1) if span else 0.0,
                "recentMbitPerS": (
                    round(wb * 8 / span / 1e6, 3) if span else 0.0
                ),
            }


class MovementLane:
    """Bounded admission for whole-fragment transfers.

    - ``max_concurrent`` transfers hold a slot at once; excess callers
      block (movement threads, never the serving loop).
    - ``max_mbit`` > 0 paces aggregate payload bytes with a token
      bucket (1 s of burst); :meth:`throttle` sleeps off any deficit
      BEFORE the caller ships/adopts the frame, so a resize drains at a
      configured ceiling instead of line rate.

    Per-transfer progress rows live here (in-flight dict + a bounded
    history deque) for `GET /debug/cluster`.
    """

    HISTORY = 64

    def __init__(
        self,
        max_concurrent: int = 4,
        max_mbit: float = 0.0,
        stats=None,
    ) -> None:
        self.max_concurrent = max(1, int(max_concurrent))
        self.max_mbit = float(max_mbit)
        self.stats = stats
        self.meter = MovementMeter()
        self._sem = threading.BoundedSemaphore(self.max_concurrent)
        self._lock = sanitize.make_lock("MovementLane._lock")
        self._active: dict[int, dict] = {}
        self._done: deque[dict] = deque(maxlen=self.HISTORY)
        self._next_id = 0
        self._bytes_per_s = self.max_mbit * 1e6 / 8.0
        # 1 s of burst, floored so tiny test rates still admit one frame
        self._burst = max(self._bytes_per_s, 65536.0)
        self._allowance = self._burst
        self._last = time.monotonic()

    # ------------------------------------------------------------ admission
    @contextmanager
    def transfer(
        self,
        direction: str,
        index: str,
        field: str = "",
        view: str = "",
        shard: int = -1,
        peer: str = "",
    ):
        """Hold one movement slot for the duration of a transfer and
        publish its progress row. Yields the row dict — the caller
        stamps ``bytes`` on it once the payload size is known."""
        row = {
            "id": 0,
            "direction": direction,
            "index": index,
            "field": field,
            "view": view,
            "shard": shard,
            "peer": peer,
            "bytes": 0,
            "state": "queued",
            "startedMonotonicS": time.monotonic(),
        }
        queued = not self._sem.acquire(blocking=False)
        if queued:
            # slot wait is admission backpressure too — visible in the
            # same counter as rate sleeps
            self.meter.note_throttle_wait()
            if self.stats is not None:
                self.stats.count("movement_throttle_waits")
            self._sem.acquire()
        with self._lock:
            self._next_id += 1
            row["id"] = self._next_id
            row["state"] = "active"
            self._active[row["id"]] = row
        try:
            yield row
            row["state"] = "done"
        except BaseException:
            row["state"] = "failed"
            raise
        finally:
            self._sem.release()
            with self._lock:
                self._active.pop(row["id"], None)
                row["seconds"] = round(
                    time.monotonic() - row.pop("startedMonotonicS"), 3
                )
                self._done.append(row)

    def throttle(self, nbytes: int) -> float:
        """Pay ``nbytes`` into the token bucket; sleep off any deficit.
        Returns the seconds slept (0.0 when unthrottled)."""
        if self._bytes_per_s <= 0 or nbytes <= 0:
            return 0.0
        with self._lock:
            now = time.monotonic()
            self._allowance = min(
                self._burst,
                self._allowance + (now - self._last) * self._bytes_per_s,
            )
            self._last = now
            self._allowance -= nbytes
            deficit = -self._allowance
        if deficit <= 0:
            return 0.0
        wait = deficit / self._bytes_per_s
        self.meter.note_throttle_wait()
        if self.stats is not None:
            self.stats.count("movement_throttle_waits")
        time.sleep(wait)
        return wait

    # ----------------------------------------------------------- accounting
    def account(self, direction: str, nbytes: int) -> None:
        """Record one completed fragment transfer of ``nbytes``."""
        self.meter.record(direction, nbytes)
        if self.stats is not None:
            self.stats.count(
                "rebalance_bytes_total", nbytes, tags={"direction": direction}
            )
            self.stats.count("fragments_moved_total")

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        with self._lock:
            active = [dict(r) for r in self._active.values()]
            recent = [dict(r) for r in self._done]
        now = time.monotonic()
        for r in active:
            r["ageS"] = round(now - r.pop("startedMonotonicS"), 3)
        return {
            "maxConcurrent": self.max_concurrent,
            "maxMbit": self.max_mbit,
            "active": sorted(active, key=lambda r: r["id"]),
            "recent": recent,
            "meter": self.meter.snapshot(),
        }
