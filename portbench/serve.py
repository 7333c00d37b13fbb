"""The system under test: ``pilosa_tpu_torch``'s HTTP ``Server`` in this
process, filled with a configuration's data and warmed on the cell's
own query shapes.

Loading uses the program's bench-only shortcut: a fragment whose
``_np_matrix`` holds its packed rows is stacked from them as from its
storage. One shard per set field (the last) is written through the
fragment's roaring storage instead, since row listings (``Rows()``,
GroupBy's levels) read storage; every block holds every row (the
configurations' ``cover``), so that shard lists every row there is.
"""

from __future__ import annotations

import http.client
import json
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# fragments are created on threads of their own: each writes an empty
# snapshot with its fsyncs, which overlap on the disk
CREATE_THREADS = 64


class System:
    """The server, opened first so that its device probe (a subprocess
    of several seconds) runs while the data is made and loaded."""

    def __init__(self, index: str, device: str = "cuda"):
        from pilosa_tpu_torch.server import Server
        from pilosa_tpu_torch.utils.config import Config

        self.index = index
        self.device = device
        self.data = None
        self.times: dict = {}
        # a data dir of this run under the system's temp dir (TMPDIR)
        self.data_dir = tempfile.mkdtemp(prefix="portbench-data-")
        t0 = time.perf_counter()
        self.srv = Server(Config(bind="127.0.0.1:0", data_dir=self.data_dir, result_cache_mode="off"), device=device)
        self.srv.open()  # the device probe runs off this thread meanwhile
        self.times["open_s"] = time.perf_counter() - t0
        self.conn = http.client.HTTPConnection("127.0.0.1", self.srv.port, timeout=600)

    @property
    def port(self) -> int:
        return self.srv.port

    @property
    def path(self) -> str:
        return f"/index/{self.index}/query"

    def post(self, path: str, body) -> dict:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        self.conn.request("POST", path, body=data)
        resp = self.conn.getresponse()
        out = json.loads(resp.read() or b"{}")
        if resp.status != 200:
            raise RuntimeError(f"POST {path}: {resp.status} {json.dumps(out)[:300]}")
        return out

    def load(self, data) -> None:
        """The schema over HTTP, then every shard's fragments."""
        from pilosa_tpu_torch.core import VIEW_BSI
        from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

        if SHARD_WIDTH != data.width:
            raise RuntimeError(f"the program's shard width {SHARD_WIDTH} is not the configuration's {data.width}")
        self.data = d = data
        t0 = time.perf_counter()
        self.post(f"/index/{d.index}", {"options": {"trackExistence": bool(d.config.get("track_existence", False))}})
        for f in d.fields.values():
            opts = {"type": "int", "min": f.min, "max": f.max} if f.kind == "int" else {}
            self.post(f"/index/{d.index}/field/{f.name}", {"options": opts})
        idx = self.srv.holder.index(d.index)
        last = d.shards - 1
        with ThreadPoolExecutor(CREATE_THREADS) as pool:
            for f in d.fields.values():
                field = idx.field(f.name)
                if f.kind == "int" and field.bit_depth != f.depth:
                    raise RuntimeError(f"{f.name}: the program's depth {field.bit_depth} != {f.depth}")
                view = field.create_view_if_not_exists(VIEW_BSI if f.kind == "int" else "standard")
                packed = [f.packed(g) for g in range(d.blocks)]
                frags = list(pool.map(view.create_fragment_if_not_exists, range(d.shards)))
                for s, frag in enumerate(frags):
                    if f.kind != "int" and s == last:
                        frag.union_positions(f.positions(s % d.blocks))
                        continue
                    frag._np_matrix = packed[s % d.blocks]
                    frag._all_dirty = False
        self.times["load_s"] = time.perf_counter() - t0
        # the front end closes a keep-alive connection idle past its limit
        self.conn.close()
        self.conn = http.client.HTTPConnection("127.0.0.1", self.srv.port, timeout=600)

    def ready(self, timeout: float = 600.0) -> None:
        t0 = time.perf_counter()
        if not self.srv.wait_mesh(timeout) or not self.srv.device_verdict[0]:
            raise RuntimeError(f"the server's device probe failed: {self.srv.device_verdict}")
        self.times["probe_s"] = self.srv.probe_seconds
        self.times["probe_wait_s"] = time.perf_counter() - t0

    def stack(self) -> None:
        """Fill the program's device cache before the first query: build
        the kernels (only a checkout's first run compiles) and stack
        every field onto the card, as a first query of each would. A
        first query that paid for them would hand the router a dispatch
        time of seconds, and it routes the next queries to the host for
        it, where each stacks the field again in host memory."""
        from pilosa_tpu_torch.core import VIEW_BSI

        t0 = time.perf_counter()
        if self.device == "cuda":
            import torch

            from pilosa_tpu_torch.ops import _cuda

            _cuda.build(_cuda.SOURCES)
        self.times["build_s"] = time.perf_counter() - t0
        comp = self.srv.api.executor.compiler
        idx = self.srv.holder.index(self.data.index)
        shards = list(range(self.data.shards))
        for f in self.data.fields.values():
            comp.stacks.matrix(idx, idx.field(f.name), VIEW_BSI if f.kind == "int" else "standard", shards)
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.times["stack_s"] = time.perf_counter() - t0 - self.times["build_s"]

    def query(self, pql: str):
        return self.post(self.path, pql.encode())["results"]

    def counters(self) -> dict:
        """The program's own counters this benchmark reads."""
        from pilosa_tpu_torch.ops import _cuda

        api = self.srv.api
        stacks = api.executor.compiler.stacks
        return {
            "decisions": dict(api.executor.router.decisions),
            "scheduler": api.scheduler.snapshot(),
            "launches": {n: k.launches for n, k in _cuda.KERNELS.items()},
            "stacks": {"full_restacks": stacks.full_restacks, "delta_updates": stacks.delta_updates},
        }

    def close(self) -> None:
        try:
            self.conn.close()
            self.srv.close()
        finally:
            shutil.rmtree(self.data_dir, ignore_errors=True)


def query_timer(api, sink: list):
    """Wrap ``api.query`` (what the HTTP front end calls) so each call's
    seconds land in ``sink``; returns the undo."""
    inner = api.query

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            sink.append(time.perf_counter() - t0)

    api.query = timed
    return lambda: api.__dict__.pop("query", None)
