"""Persisted device-probe verdicts.

A card that cannot initialize may present as a HANG inside the first
CUDA call, so every probe against it costs the full watchdog timeout
(300 s by default).  The verdict is a property of the HOST's transport,
not of one process — so it is persisted host-side with a short TTL:
within the TTL, the next boot (server or bench) decides in <1 s by
reading the file instead of re-paying the probe.

Callers honor only NEGATIVE verdicts across boots (a healthy probe is
cheap to re-run; a stale positive would skip the watchdog on a
transport that wedged in between) — positive verdicts are stored for
observability and freshness bookkeeping.

Location: ``$PILOSA_TPU_TORCH_PROBE_CACHE`` if set (tests point it at a
tmp dir), else ``$XDG_CACHE_HOME/pilosa_tpu_torch/device_probe.json``,
else ``~/.cache/pilosa_tpu_torch/device_probe.json``: a file of the
port's own, so a verdict left by the reference's JAX server never
decides the port's.  Verdicts key on the device probed (``"cuda"``).
All I/O is best-effort: an unwritable cache degrades to probing every
boot, never to an error.
"""

from __future__ import annotations

import json
import os
import time


def cache_path() -> str:
    env = os.environ.get("PILOSA_TPU_TORCH_PROBE_CACHE")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(base, "pilosa_tpu_torch", "device_probe.json")


def load(ttl_s: float, pin: str = "") -> dict | None:
    """The cached verdict dict ({"ok": bool, "platform": str, ...}) if
    one exists for this device and is younger than ``ttl_s``;
    None otherwise (including ttl_s <= 0 — TTL 0 disables the cache)."""
    if ttl_s <= 0:
        return None
    try:
        with open(cache_path(), "r", encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            return None
        if data.get("pin", "") != (pin or ""):
            return None
        # wall clock on purpose: the verdict timestamp persists across
        # process boots, where no monotonic clock is comparable
        if time.time() - float(data.get("time", 0)) > ttl_s:  # pilosa: allow(wall-clock)
            return None
        if not isinstance(data.get("ok"), bool):
            return None
        return data
    except Exception:  # noqa: BLE001 — missing/corrupt cache = no verdict
        return None


def store(ok: bool, pin: str = "", platform: str = "") -> None:
    path = cache_path()
    try:
        from pilosa_tpu_torch.utils import durable

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # durable=False: atomic replace without the fsyncs — a probe
        # verdict lost to a crash just costs one fresh probe
        durable.atomic_write_file(
            path,
            json.dumps(
                {
                    "ok": bool(ok),
                    "pin": pin or "",
                    "platform": platform,
                    "time": time.time(),
                }
            ),
            tmp_suffix=f".tmp.{os.getpid()}",
            durable=False,
        )
    except Exception:  # noqa: BLE001 — persistence is best-effort
        pass
