"""Diagnostics: periodic runtime snapshots of the node.

Reference: diagnostics.go (diagnosticsCollector — hourly phone-home of
anonymized usage info). This environment has zero egress, so the
collector writes each snapshot to ``<data_dir>/diagnostics.json`` (and
keeps the latest in memory for the ``/info`` surface) instead of POSTing
it; the payload fields mirror the reference's (version, uptime, schema
shape, runtime gauges).
"""

from __future__ import annotations

import json
import os
import platform
import threading
import time


class DiagnosticsCollector:
    def __init__(self, server):
        self.server = server
        self.start_time = time.time()  # boot wall timestamp (started_at)
        # uptime measures on the monotonic clock: wall time steps under
        # NTP and a negative uptime has shipped in real diagnostics
        self._start_mono = time.monotonic()
        self._timer: threading.Timer | None = None
        self._closed = False
        self.last: dict = {}
        self._backend_cache: str | None = None

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        from pilosa_tpu_torch import __version__

        holder = self.server.holder
        n_fields = 0
        n_fragments = 0
        field_types: dict[str, int] = {}
        # list() copies: schema writes race this timer thread
        for idx in list(holder.indexes.values()):
            for f in list(idx.fields.values()):
                n_fields += 1
                field_types[f.options.field_type] = (
                    field_types.get(f.options.field_type, 0) + 1
                )
                for view in list(f.views.values()):
                    n_fragments += len(view.fragments)
        snap = {
            "version": __version__,
            "time": time.time(),
            "uptime_seconds": round(time.monotonic() - self._start_mono, 1),
            "started_at": self.start_time,
            "node_id": self.server.config.node_id,
            "num_indexes": len(holder.indexes),
            "num_fields": n_fields,
            "num_fragments": n_fragments,
            "field_types": field_types,
            "os": platform.system(),
            "arch": platform.machine(),
            "python": platform.python_version(),
            "backend": self._backend(),
            "cluster_size": (
                len(self.server.cluster.nodes) if self.server.cluster else 1
            ),
        }
        self.last = snap
        return snap

    def _backend(self) -> str:
        """The torch device queries run on and, on a card that passed
        its probe, its name. Computed once the probe verdict has landed:
        asking for the name makes a CUDA context in this process."""
        if self._backend_cache is not None:
            return self._backend_cache
        dev = self.server.api.executor.compiler.device
        verdict = getattr(self.server, "device_verdict", None)
        if verdict is None:
            return str(dev)  # probe pending
        name = str(dev)
        if dev.type == "cuda":
            if not verdict[0]:
                name = f"{dev} (unavailable: {verdict[1]})"
            else:
                try:
                    import torch

                    name = f"{dev} ({torch.cuda.get_device_name(dev)})"
                except Exception:  # pilosa: allow(broad-except) —
                    # diagnostics must never raise
                    name = f"{dev} (unavailable)"
        self._backend_cache = name
        return name

    # ------------------------------------------------------------ lifecycle
    def flush(self) -> None:
        """Take a snapshot and persist it (the phone-home analogue)."""
        snap = self.snapshot()
        data_dir = os.path.expanduser(self.server.config.data_dir)
        try:
            from pilosa_tpu_torch.utils import durable

            os.makedirs(data_dir, exist_ok=True)
            # durable=False: best-effort snapshot — atomic replace so a
            # reader never sees a torn file, no fsyncs (losing one
            # diagnostics flush to a crash costs nothing)
            durable.atomic_write_file(
                os.path.join(data_dir, "diagnostics.json"),
                json.dumps(snap, indent=1),
                tmp_suffix=".tmp",
                durable=False,
            )
        except OSError:
            pass

    def open(self) -> None:
        interval = self.server.config.diagnostics_interval
        if interval <= 0:
            return
        # first flush off the startup path — and AFTER the probe
        # verdict: _backend() asks CUDA for the card's name, which must
        # not be the process's first CUDA call
        def first():
            self._gate_on_device_verdict()
            self.flush()

        self._first_flush = threading.Thread(
            target=first, daemon=True, name="diagnostics-first-flush"
        )
        self._first_flush.start()
        self._schedule(interval)

    def _gate_on_device_verdict(self) -> None:
        wait = getattr(self.server, "wait_mesh", None)
        if wait is not None:
            wait(None)

    def _schedule(self, interval: float) -> None:
        if self._closed:
            return

        def tick():
            try:
                # same gate as the first flush: a periodic flush must
                # not make the first CUDA call before the probe verdict
                self._gate_on_device_verdict()
                self.flush()
            finally:
                self._schedule(interval)

        self._timer = threading.Timer(interval, tick)
        self._timer.daemon = True
        self._timer.name = "diagnostics-flush"
        self._timer.start()

    def close(self) -> None:
        self._closed = True
        if self._timer is not None:
            self._timer.cancel()
