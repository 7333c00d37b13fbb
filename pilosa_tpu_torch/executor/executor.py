"""Query executor: PQL AST → kernel launches over sharded fragments.

Reference: pilosa_tpu/executor/executor.py (itself a redesign of the Go
executor.go). Every device-routed read call is one launch of the
hand-written kernels over stacked ``int32[R, S, W]`` field arrays — a
filtered TopN, Sum, Min or Max included: its filter's call tree runs
inside the aggregate's kernel (K2, K4 and K5's fused modes), as the
reference fuses ``_filter_plan`` into the aggregate's program; GroupBy
builds its base mask first, as the reference does — and only scalars or
small count vectors cross back to the host, all of a query's results in
one readback wave.

Ported here: Count, the bitmap calls (Row, Range, Union, Intersect,
Difference, Xor, Not, All, Shift, and BSI conditions), TopN (with and
without a filter, and the ids= form), Sum, Min, Max, GroupBy (fused and
level-synchronous, with filter=, limit= and aggregate=Sum), Rows,
IncludesColumn, Options and the write calls. A field over the device
budget serves through residency (compile.StackCache): its rows as tiered
or hot-slot leaves, its BSI block assembled from tiered slices, and its
TopN and GroupBy levels streamed in host-packed chunks through K2 and
K6.

With a mesh context (parallel/mesh.py) the router has a third route,
``mesh``: the same read calls as blocked programs, one kernel launch per
block of the placed stacks and a reduction tree onto the lead device
(B16). Shift, trees that touch a tiered field and shapes that only
replicate fall back to the device route, which gathers each leaf row's
blocks into a whole plane on the lead device; each fallback is counted.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from datetime import datetime
from typing import Any, Callable

import numpy as np
import torch

from pilosa_tpu_torch import ops
from pilosa_tpu_torch.core import BSI_OFFSET, FIELD_INT, VIEW_BSI, VIEW_STANDARD, Field, Holder, Index
from pilosa_tpu_torch.executor.compile import PlanError, QueryCompiler, StackOverBudget
from pilosa_tpu_torch.executor.hostpath import HostPlanError
from pilosa_tpu_torch.executor.router import QueryRouter, estimate_words
from pilosa_tpu_torch.executor.row import RowResult
from pilosa_tpu_torch.pql import Call, coerce_timestamp, parse
from pilosa_tpu_torch.roaring import unpack_words
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.utils import tracing
from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER


def apply_options(
    idx: "Index", call: "Call", res: Any, column_attrs: dict | None = None
) -> Any:
    """Apply an Options() wrapper's result-shaping args (reference:
    QueryRequest ColumnAttrs/ExcludeColumns/ExcludeRowAttrs); the column
    attributes come from ``column_attrs`` ({column: attrs}) when given,
    else from the index's store."""
    if isinstance(res, RowResult):
        if call.arg("excludeColumns"):
            res.exclude_columns = True
        if call.arg("excludeRowAttrs"):
            res.exclude_row_attrs = True
        if call.arg("columnAttrs"):
            sets = []
            attrs_of = (
                idx.column_attrs.attrs if column_attrs is None else column_attrs.get
            )
            for col in res.columns().tolist():
                attrs = attrs_of(int(col))
                if attrs:
                    entry: dict = {"id": int(col), "attrs": attrs}
                    if idx.options.keys:
                        key = idx.column_keys.translate_id(int(col))
                        if key is not None:
                            entry["key"] = key
                    sets.append(entry)
            res.column_attr_sets = sets
    return res


BITMAP_CALLS = {
    "Row",
    "Range",
    "Union",
    "Intersect",
    "Difference",
    "Xor",
    "Not",
    "All",
    "Shift",
}
WRITE_CALLS = {
    "Set",
    "Clear",
    "ClearRow",
    "Store",
    "SetRowAttrs",
    "SetColumnAttrs",
}
def unwrap_options(call: Call) -> Call:
    """Innermost call of an Options() wrapper chain — THE write/read
    classification rule."""
    while call.name == "Options" and len(call.children) == 1:
        call = call.children[0]
    return call


class ExecutionError(ValueError):
    pass


def finalize(results: list) -> list:
    """Dispatched results → client-facing values."""
    return [r.value if isinstance(r, _Pending) else r for r in results]


class _Pending:
    """Deferred on-device aggregate values. Every pending result of a
    query (or of a whole scheduler wave) is raveled to int64,
    concatenated and copied to the host in ONE transfer
    (scheduler.fetch_wave); ``finish`` turns the fetched host arrays
    (original shapes) into the final result."""

    __slots__ = ("arrays", "finish", "value", "fetched", "route", "audit")

    def __init__(
        self,
        arrays: list,
        finish: "Callable[[list], Any]",
        route: str = "device",
    ) -> None:
        self.arrays = list(arrays)
        self.finish = finish
        self.value = None
        self.fetched: list | None = None
        self.route = route
        # settle-time router-audit record, completed when the readback
        # wave lands; popped on first use
        self.audit: dict | None = None

    def resolve_now(self) -> Any:
        self.value = self.finish([a.cpu().numpy() for a in self.arrays])
        return self.value

    def resolve_fetched(self) -> Any:
        """Finish from host arrays a prior fetch_wave stored."""
        if self.fetched is None:
            raise RuntimeError("resolve_fetched before fetch")
        self.value = self.finish(self.fetched)
        return self.value


class SumCount(dict):
    """Sum/Min/Max result: {"value": v, "count": n} (reference: ValCount)."""

    def __init__(self, value: int, count: int):
        super().__init__(value=int(value), count=int(count))


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _pad_row_ids(rows: list[int], k_pad: int) -> list[int]:
    """Row ids padded to k_pad with -1: K6 reads a -1 row as zeros, so
    padded slots count 0 and prune."""
    return list(rows) + [-1] * (k_pad - len(rows))


class _PackCache:
    """LRU of host-packed [S, W] rows keyed by (level, row), bounded in
    rows (GroupBy's streamed levels)."""

    def __init__(self, cap: int):
        self.cap = cap
        self._rows: "OrderedDict[tuple[int, int], np.ndarray]" = OrderedDict()

    def get(self, key: tuple[int, int]) -> "np.ndarray | None":
        got = self._rows.get(key)
        if got is not None:
            self._rows.move_to_end(key)
        return got

    def put(self, key: tuple[int, int], plane: np.ndarray) -> None:
        self._rows[key] = plane
        while len(self._rows) > self.cap:
            self._rows.popitem(last=False)


class Executor:
    # device-memory cap for GroupBy's [G, S, W] group-mask tensor; levels
    # surviving more groups than fit are processed in chunks (see
    # _execute_group_by). None ⇒ resolved lazily in _gb_budget(); tests
    # pin an int (class or instance) to force paths.
    GROUPBY_MASK_BUDGET = None

    def _gb_budget(self) -> int:
        """GroupBy transient-mask budget: a pinned GROUPBY_MASK_BUDGET
        wins; else PILOSA_TPU_GROUPBY_BUDGET; else 1/8 of the stack
        budget (70 % of the card's memory), floored at 256 MiB — sized so
        a realistic two-level GroupBy folds through the fused
        one-readback path."""
        if self.GROUPBY_MASK_BUDGET is not None:
            return self.GROUPBY_MASK_BUDGET
        env = os.environ.get("PILOSA_TPU_GROUPBY_BUDGET")
        if env:
            return int(env)
        return max(256 << 20, self.compiler.stacks.STACK_BYTES_BUDGET // 8)

    def __init__(
        self,
        holder: Holder,
        device: "str | torch.device | None" = None,
        stats=None,
        route_mode: str | None = None,
        router: QueryRouter | None = None,
        mesh_ctx=None,
    ):
        """``device`` defaults to the card ("cuda"), or to the lead device
        of ``mesh_ctx`` (a parallel.mesh.MeshContext) when one is given."""
        self.holder = holder
        self.stats = stats
        if device is None:
            device = mesh_ctx.lead if mesh_ctx is not None else "cuda"
        self.compiler = QueryCompiler(device, stats=stats, mesh_ctx=mesh_ctx)
        self.device = self.compiler.device
        self.router = (
            router if router is not None else QueryRouter(mode=route_mode, stats=stats)
        )
        # the router's mesh path exists only while a multi-position mesh
        # is attached; a rebuild without one resets it
        self.router.mesh_devices = (
            self.compiler.mesh_engine.n_devices if self.compiler.mesh_engine is not None else 1
        )
        # per-query-string route cache (see _routes_for)
        self._route_cache: "OrderedDict[tuple, list]" = OrderedDict()
        self._route_cache_lock = threading.Lock()

    _ROUTE_CACHE_HITS = 64
    _ROUTE_CACHE_MAX = 512

    def _routes_for(
        self,
        idx: Index,
        index_name: str,
        query,
        calls: "list[Call]",
        shards: list[int] | None,
    ) -> "list[tuple[str | None, int, bool, int]]":
        """One ``(route, work, mesh_ok, cold_words)`` spec per call, via a cache that
        revalidates every _ROUTE_CACHE_HITS hits when the query arrived
        as a raw string (the serving hot path)."""
        if not isinstance(query, str):
            return [self._route(idx, c, shards) for c in calls]
        key = (
            index_name,
            query,
            tuple(shards) if shards is not None else None,
            self.router.mode,
        )
        with self._route_cache_lock:
            ent = self._route_cache.get(key)
            if ent is not None and ent[0] > 0 and len(ent[1]) == len(calls):
                ent[0] -= 1
                self._route_cache.move_to_end(key)
                return ent[1]
        routes = [self._route(idx, c, shards) for c in calls]
        with self._route_cache_lock:
            self._route_cache[key] = [self._ROUTE_CACHE_HITS, routes]
            self._route_cache.move_to_end(key)
            while len(self._route_cache) > self._ROUTE_CACHE_MAX:
                self._route_cache.popitem(last=False)
        return routes

    # ------------------------------------------------------------ entry
    def execute(
        self,
        index_name: str,
        query: str | list[Call],
        shards: list[int] | None = None,
        routes: "list[tuple[str | None, int, bool, int]] | None" = None,
    ) -> list[Any]:
        results = self.dispatch(index_name, query, shards, routes=routes)
        pending = [r for r in results if isinstance(r, _Pending)]
        if pending:
            elapsed = self.settle(pending)
            prof = tracing.current_profile()
            if prof is not None:
                prof.add_call("_readback", elapsed, None)
        return finalize(results)

    def dispatch(
        self,
        index_name: str,
        query: str | list[Call],
        shards: list[int] | None = None,
        routes: "list[tuple[str | None, int, bool, int]] | None" = None,
    ) -> list[Any]:
        """Issue every call WITHOUT the readback wave — aggregates come
        back as unresolved ``_Pending``s, launched in program order on
        one stream, so an aggregate before a write still reads pre-write
        state. ``routes`` optionally carries the per-call specs a caller
        (the wave scheduler) already computed."""
        idx = self.holder.index(index_name)
        if idx is None:
            raise ExecutionError(f"index {index_name!r} not found")
        calls = parse(query) if isinstance(query, str) else query
        prof = tracing.current_profile()
        prof_shards: list[int] | None = None
        if routes is None:
            routes = self._routes_for(idx, index_name, query, calls, shards)
        results = []
        for i, c in enumerate(calls):
            t0 = time.perf_counter()
            route, work = routes[i][0], routes[i][1]
            with GLOBAL_TRACER.span(f"executor.{c.name}", index=index_name):
                results.append(
                    self._execute_call(idx, c, shards, lazy=True, route=route)
                )
            elapsed = time.perf_counter() - t0
            if route in ("host", "device", "mesh"):
                self.router.record(route)
                if work > 0:
                    self.router.observe(route, work, elapsed)
                if work > 0 and self.router.audit.enabled:
                    est = self._candidate_costs(route, work, routes[i][2], routes[i][3])
                    res = results[-1]
                    if isinstance(res, _Pending):
                        res.audit = {
                            "route": route,
                            "estimates": est,
                            "dispatch_s": elapsed,
                        }
                    else:
                        self.router.audit.record(route, est, elapsed)
                if self.stats is not None:
                    self.stats.count("queries_routed", tags={"path": route})
                if route == "mesh" and prof is not None:
                    # ?profile=true: the mesh geometry, once per query
                    prof.mesh = self.compiler.mesh_snapshot()
            if self.stats is not None:
                self.stats.timing(
                    "executor_call_seconds", elapsed, tags={"call": c.name}
                )
            if prof is not None:
                if prof_shards is None:
                    prof_shards = self._shards(idx, shards)
                prof.add_call(c.name, elapsed, prof_shards, route=route)
        if prof is not None and self.compiler.stacks._tiered:
            # which container tiers served this query's over-budget
            # fields, and the promotion counters when it ran
            prof.residency = self.compiler.stacks.residency_snapshot()
        return results

    def fetch(self, pending: "list[_Pending]") -> float:
        """One device→host transfer for every pending's arrays
        (scheduler.fetch_wave); leaves the host arrays on ``p.fetched``
        and records the readback calibration."""
        if not pending:
            return 0.0
        from pilosa_tpu_torch.executor.scheduler import fetch_wave

        t0 = time.perf_counter()
        fetch_wave(pending)
        elapsed = time.perf_counter() - t0
        for path in {p.route for p in pending}:
            self.router.observe_readback(elapsed, path=path)
        share = elapsed / len(pending)
        for p in pending:
            rec = p.audit
            if rec is not None:
                p.audit = None
                self.router.audit.record(
                    rec["route"], rec["estimates"], rec["dispatch_s"] + share
                )
        if self.stats is not None:
            self.stats.timing("executor_readback_seconds", elapsed)
        return elapsed

    def settle(self, pending: "list[_Pending]") -> float:
        """Fetch + resolve a pending set."""
        elapsed = self.fetch(pending)
        for p in pending:
            p.resolve_fetched()
        return elapsed

    def _shards(self, idx: Index, shards: list[int] | None) -> list[int]:
        if shards is not None:
            return sorted(shards)
        avail = idx.available_shards()
        return sorted(avail) if avail else [0]

    # ------------------------------------------------------------ routing
    def _route(self, idx: Index, call: Call, shards: list[int] | None):
        """(route, estimated_work_words, mesh_ok, cold_upload_words) for
        one top-level call. Writes route None; Rows is metadata-only and
        serves host-side. Under ``auto`` the router charges the device
        route the upload of every cold row of a tiered field, and picks
        the mesh route when a mesh engine is attached and the call tree
        has blocked programs. A pinned ``mesh`` falls back to the device
        route, counted, where it has none."""
        c, sh = call, shards
        while c.name == "Options" and len(c.children) == 1:
            sh = c.arg("shards", sh)
            c = c.children[0]
        if c.name in WRITE_CALLS:
            return None, 0, False, 0
        if c.name == "Rows":
            return "host", 0, False, 0
        n = len(sh) if sh is not None else max(1, len(idx.available_shards()))
        work = estimate_words(idx, c, n)
        if self.router.mode in ("host", "device"):
            # pinned modes skip the residency and mesh walks on their hot path
            return self.router.mode, work, False, 0
        tiered, cold_words = self._residency_info(idx, c, sh)
        # container stores hold payloads in global plane positions, which
        # no block can decode: trees touching a tiered field stay on the
        # device route
        mesh_ok = self._mesh_ok(c, n) and not tiered
        if self.router.mode == "mesh":
            if mesh_ok:
                return "mesh", work, True, cold_words
            if self.compiler.mesh_engine is not None:
                self.compiler.mesh_engine.note_fallback()
            return "device", work, False, cold_words
        route = self.router.decide(
            (idx.name, n, repr(c)), work, mesh_ok=mesh_ok, device_extra_words=cold_words,
        )
        return route, work, mesh_ok, cold_words

    def _mesh_ok(self, call: Call, n_shards: int) -> bool:
        """Can this call run as blocked mesh programs: a mesh engine is
        attached, the shard and word shapes place as blocks, and every
        call of the tree has a blocked program?"""
        if self.compiler.mesh_mode(n_shards) is None:
            return False
        from pilosa_tpu_torch.parallel.mesh import mesh_supported

        return mesh_supported(call)

    def _candidate_costs(self, route: str, work: int, mesh_ok: bool, cold_words: int) -> dict:
        """Modeled cost in seconds of each candidate path of one call;
        the device path also pays its cold-row uploads at host speed.
        Mesh appears when it was a real candidate or was chosen."""
        r = self.router
        extra_s = cold_words / r._host_wps() if cold_words else 0.0
        costs = {"host": r.host_cost(work), "device": r.device_cost(work) + extra_s}
        if (mesh_ok and r.mesh_devices > 1) or route == "mesh":
            costs["mesh"] = r.mesh_cost(work) + extra_s
        return costs

    def _residency_info(
        self, idx: Index, call: Call, shards: list[int] | None, detail: list | None = None,
    ) -> tuple[bool, int]:
        """(touches_tiered_field, cold_upload_words) for one call tree.

        Every COLD row of a tiered (over-budget) field costs the device
        path about one host-packed [S, W] plane upload. The probe never
        creates residency entries or bumps touch counts; ``detail``
        collects a classification per touched row range (explain)."""
        stacks = self.compiler.stacks
        if stacks.residency_mode() == "slots":
            return False, 0
        shard_list = self._shards(idx, shards)
        unit = len(shard_list) * WORDS_PER_SHARD
        over_budget: dict[tuple, bool] = {}

        def over(field: Field, view_name: str) -> bool:
            k = (field.name, view_name)
            got = over_budget.get(k)
            if got is None:
                got = stacks.is_over_budget(idx, field, view_name, shard_list)
                over_budget[k] = got
            return got

        tiered = False
        cold = 0

        def leaf(field: Field, view_name: str, row_id) -> None:
            nonlocal tiered, cold
            if not over(field, view_name):
                if detail is not None:
                    detail.append({"field": field.name, "view": view_name, "row": row_id, "class": "in-budget"})
                return
            tiered = True
            resident = stacks.tiered_resident(idx, field, view_name, shard_list, row_id)
            if not resident:
                cold += unit
            if detail is not None:
                detail.append({
                    "field": field.name, "view": view_name, "row": row_id,
                    "class": "resident" if resident else "cold",
                })

        def bsi_block(f: Field) -> None:
            nonlocal tiered, cold
            tiered = True
            need = BSI_OFFSET + f.bit_depth
            cold_slices = 0
            for d in range(need):
                if not stacks.tiered_resident(idx, f, VIEW_BSI, shard_list, d):
                    cold += unit
                    cold_slices += 1
            if detail is not None:
                detail.append({
                    "field": f.name, "view": VIEW_BSI, "slices": need, "coldSlices": cold_slices,
                    "class": "cold" if cold_slices else "resident",
                })

        def walk(c: Call) -> None:
            if c.name in ("Row", "Range"):
                cond = c.condition()
                if cond is not None:
                    f = idx.field(cond[0])
                    if f is not None and over(f, VIEW_BSI):
                        bsi_block(f)
                    return
                fa = c.field_arg()
                if fa is not None:
                    f = idx.field(fa[0])
                    if f is not None:
                        row = fa[1]
                        if isinstance(row, bool):
                            row = int(row)
                        if isinstance(row, int):
                            leaf(f, VIEW_STANDARD, row)
                return
            if c.name in ("Sum", "Min", "Max"):
                # the aggregate's own BSI block is read too
                fname = c.arg("field") or (c.pos_args[0] if c.pos_args else None)
                f = idx.field(fname) if isinstance(fname, str) else None
                if f is not None and f.options.field_type == FIELD_INT and over(f, VIEW_BSI):
                    bsi_block(f)
            for ch in c.children:
                walk(ch)
            for sub in (c.arg("filter"), c.arg("aggregate")):
                if isinstance(sub, Call):
                    walk(sub)

        walk(call)
        return tiered, cold

    def route_for(self, index_name: str, query: "str | Call | list[Call]", shards: list[int] | None = None) -> str:
        """The route a query's first call would take now ("host",
        "device", "mesh", or "write"), executing nothing: what a
        benchmark stamps beside its rows."""
        idx = self.holder.index(index_name)
        if idx is None:
            raise ExecutionError(f"index {index_name!r} not found")
        calls = parse(query) if isinstance(query, str) else query
        first = calls[0] if isinstance(calls, list) else calls
        return self._route(idx, first, shards)[0] or "write"

    def explain_call(self, idx: Index, call: Call, shards: list[int] | None) -> dict:
        """The plan of one top-level call, executing nothing: the route
        the router takes now, each candidate's modeled cost and the
        residency class of every row range the call touches."""
        c, sh = call, shards
        while c.name == "Options" and len(c.children) == 1:
            sh = c.arg("shards", sh)
            c = c.children[0]
        if c.name in WRITE_CALLS:
            return {"call": c.name, "route": "write"}
        if c.name == "Rows":
            return {"call": c.name, "route": "host", "note": "metadata-only call; always served host-side"}
        n = len(sh) if sh is not None else max(1, len(idx.available_shards()))
        work = estimate_words(idx, c, n)
        res_detail: list = []
        tiered, cold_words = self._residency_info(idx, c, sh, detail=res_detail)
        # mesh supportability, verdict and reason
        mesh_attached = self.compiler.mesh_engine is not None
        geometry_ok = mesh_attached and self.compiler.mesh_mode(n) is not None
        programs_ok = False
        if geometry_ok:
            from pilosa_tpu_torch.parallel.mesh import mesh_supported

            programs_ok = mesh_supported(c)
        multi_device = self.router.mesh_devices > 1
        mesh_ok = geometry_ok and programs_ok and not tiered and multi_device
        if not mesh_attached:
            mesh_reason = "no mesh engine attached"
        elif not multi_device:
            mesh_reason = "single device — mesh path disabled"
        elif not geometry_ok:
            mesh_reason = "shard/word geometry does not place onto the mesh"
        elif not programs_ok:
            mesh_reason = "call tree contains mesh-fallback calls"
        elif tiered:
            mesh_reason = "tiered residency pins to the device route"
        else:
            mesh_reason = "supported"
        # the route taken now, without _route's fallback count (that
        # counts served fallbacks only)
        if self.router.mode != "auto":
            route = self.router.mode
            if route == "mesh" and not mesh_ok:
                route = "device"
        else:
            route = self.router.decide(
                (idx.name, n, repr(c)), work, mesh_ok=mesh_ok, device_extra_words=cold_words,
            )
        costs = self._candidate_costs(route, work, mesh_ok, cold_words)
        return {
            "call": c.name,
            "route": route,
            "routeMode": self.router.mode,
            "estimatedWorkWords": work,
            "crossoverWords": self.router.crossover_words(),
            "candidates": {
                path: {"estimatedSeconds": t, "chosen": path == route} for path, t in sorted(costs.items())
            },
            "residency": {
                "mode": self.compiler.stacks.residency_mode(),
                "tiered": tiered,
                "coldUploadWords": cold_words,
                "rowRanges": res_detail,
            },
            "mesh": {
                "supported": mesh_ok,
                "reason": mesh_reason,
                "meshDevices": self.router.mesh_devices,
            },
        }

    def _execute_call(
        self,
        idx: Index,
        call: Call,
        shards: list[int] | None,
        lazy: bool = False,
        route: str | None = "device",
    ) -> Any:
        name = call.name
        if name == "Options":
            if len(call.children) != 1:
                raise ExecutionError("Options() takes exactly one call")
            opt_shards = call.arg("shards", shards)
            res = self._execute_call(
                idx, call.children[0], opt_shards, lazy=lazy, route=route
            )
            if isinstance(res, _Pending):
                # shape at resolve time so Options() args still apply
                inner = res.finish
                res.finish = lambda a: apply_options(idx, call, inner(a))
                return res
            return apply_options(idx, call, res)
        if name in WRITE_CALLS:
            return self._execute_write(idx, call)
        shard_list = self._shards(idx, shards)
        host = route == "host"
        # a direct caller may pass route="mesh" without a mesh engine
        mesh = route == "mesh" and self.compiler.mesh_engine is not None
        try:
            if name in BITMAP_CALLS:
                if host:
                    # np.array: the host engine may hand back views of
                    # live stack memory
                    words = np.array(
                        self.compiler.host.bitmap_words(idx, call, shard_list)
                    )
                elif mesh:
                    words = self.compiler.mesh_bitmap_words(idx, call, shard_list)
                else:
                    words = self.compiler.bitmap_words(idx, call, shard_list)
                res = RowResult({s: words[i] for i, s in enumerate(shard_list)})
                self._attach_keys(idx, res)
                self._attach_row_attrs(idx, call, res)
                return res
            if name == "Count":
                if len(call.children) != 1:
                    raise ExecutionError("Count() takes exactly one call")
                if host:
                    return self.compiler.host.count(idx, call.children[0], shard_list)
                if mesh:
                    pend = _Pending(
                        [self.compiler.mesh_count_async(idx, call.children[0], shard_list)],
                        lambda a: int(a[0]),
                        route="mesh",
                    )
                else:
                    pend = _Pending(
                        [self.compiler.count_async(idx, call.children[0], shard_list)],
                        lambda a: int(a[0]),
                    )
                return pend if lazy else pend.resolve_now()
            if name == "Sum":
                return self._execute_sum(idx, call, shard_list, lazy=lazy, host=host, mesh=mesh)
            if name in ("Min", "Max"):
                return self._execute_min_max(
                    idx, call, shard_list, name == "Max", lazy=lazy, host=host, mesh=mesh
                )
            if name == "TopN":
                return self._execute_topn(idx, call, shard_list, lazy=lazy, host=host, mesh=mesh)
            if name == "Rows":
                return self._execute_rows(idx, call, shard_list)
            if name == "GroupBy":
                return self._execute_group_by(
                    idx, call, shard_list, lazy=lazy, host=host, mesh=mesh
                )
            if name == "IncludesColumn":
                return self._execute_includes_column(idx, call, shard_list, host=host)
        except (PlanError, StackOverBudget, HostPlanError) as e:
            raise ExecutionError(str(e)) from e
        raise ExecutionError(f"unknown call {name!r}")

    # ----------------------------------------------------------- helpers
    def _bitmap_words(self, idx: Index, call: Call, shards: list[int]) -> np.ndarray:
        try:
            return self.compiler.bitmap_words(idx, call, shards)
        except (PlanError, StackOverBudget) as e:
            raise ExecutionError(str(e)) from e

    def _field(self, idx: Index, name: str) -> Field:
        f = idx.field(name)
        if f is None:
            raise ExecutionError(f"field {name!r} not found")
        return f

    def _row_id(self, field: Field, row: Any, create: bool = False) -> int | None:
        if isinstance(row, bool):
            return int(row)
        if isinstance(row, int):
            return row
        if isinstance(row, str):
            if not field.options.keys:
                raise ExecutionError(f"field {field.name!r} does not use string keys")
            return field.row_keys.translate_key(row, create=create)
        raise ExecutionError(f"bad row value {row!r}")

    def _col_id(self, idx: Index, col: Any, create: bool = False) -> int | None:
        if isinstance(col, int) and not isinstance(col, bool):
            return col
        if isinstance(col, str):
            if not idx.options.keys:
                raise ExecutionError(f"index {idx.name!r} does not use string keys")
            return idx.column_keys.translate_key(col, create=create)
        raise ExecutionError(f"bad column value {col!r}")

    def _attach_row_attrs(self, idx: Index, call: Call, res: RowResult) -> None:
        """Direct Row(field=row) results carry the row's attributes
        (reference: QueryResult Row.Attrs)."""
        row = self._attr_row(idx, call)
        if row is not None:
            res.attrs = idx.field(row[0]).row_attrs.attrs(row[1])

    def _attr_row(self, idx: Index, call: Call) -> tuple[str, int] | None:
        """(field, row id) whose attributes a direct Row(field=row)
        result carries, or None."""
        if call.name != "Row" or call.condition() is not None:
            return None
        fa = call.field_arg()
        if fa is None:
            return None
        field = idx.field(fa[0])
        if field is None:
            return None
        row_id = fa[1]
        if isinstance(row_id, str):
            if not field.options.keys:
                return None
            row_id = field.row_keys.translate_key(row_id, create=False)
            if row_id is None:
                return None
        if isinstance(row_id, bool):
            row_id = int(row_id)
        if isinstance(row_id, int):
            return field.name, row_id
        return None

    def _attach_keys(self, idx: Index, res: RowResult) -> None:
        if idx.options.keys:
            cols = res.columns().tolist()
            res.keys = [idx.column_keys.translate_id(c) or str(c) for c in cols]

    def _call_field_name(self, call: Call) -> str:
        fname = call.arg("field")
        if fname is None and call.pos_args:
            fname = call.pos_args[0]
        if fname is None:
            raise ExecutionError(f"{call.name}() needs a field argument")
        return fname

    def _agg_field(self, idx: Index, call: Call) -> Field:
        field = self._field(idx, self._call_field_name(call))
        if field.options.field_type != FIELD_INT:
            raise ExecutionError(f"field {field.name!r} is not an int field")
        return field

    def _filter_device(self, idx: Index, call: Call, shards: list[int]):
        """The child-call filter as device int32[S, W] (K1's words mode),
        or None without one: the streamed TopN's, built once for all its
        chunks, as the reference's (executor.py:1263-1273)."""
        if not call.children:
            return None
        return self.compiler.bitmap_device(idx, call.children[0], shards)

    def _filter_tree(self, idx: Index, call: Call, shards: list[int]):
        """The child-call filter as a planned call tree (``PlannedFilter``)
        that K2, K4 or K5 evaluates inside its own launch, as the
        reference's ``_filter_plan`` (executor.py:1019) runs inside the
        aggregate's program; None without one (all columns)."""
        if not call.children:
            return None
        return self.compiler.planned_filter(idx, call.children[0], shards)

    def _filter_plan(self, idx: Index, call: Call, shards: list[int], mode: str):
        """The child-call filter of a mesh aggregate as (BlockPlan, placed
        arrays): each block's plan is evaluated inside the aggregate's
        kernel on that block. None without one."""
        if not call.children:
            return None
        return self.compiler.mesh_plan(idx, call.children[0], shards, mode)

    def _bsi_stacked(self, idx: Index, field: Field, shards: list[int], mesh: bool = False):
        """(int32[P, S, W] BSI stack on the device, depth D). The kernels
        read a plane at or past P as zeros, so the stack is never padded
        to 2 + D. An over-budget stack assembles from tiered slice rows
        in tiered mode; slots mode raises, as the reference's does. With
        ``mesh`` the stack is the placed MeshArray; on the device route
        under a mesh it is gathered onto the lead device."""
        try:
            if mesh:
                return self.compiler.stacks.matrix(idx, field, VIEW_BSI, shards)[0], field.bit_depth
            m, _rows = self.compiler.stacks.dense(idx, field, VIEW_BSI, shards)
        except StackOverBudget as e:
            if self.compiler.stacks.residency_mode() == "slots":
                raise ExecutionError(str(e)) from e
            m = self.compiler.tiered_bsi_block(idx, field, shards)
        return m, field.bit_depth

    # ------------------------------------------------------- aggregates
    def _execute_sum(
        self, idx: Index, call: Call, shards: list[int], lazy: bool = False,
        host: bool = False, mesh: bool = False,
    ):
        field = self._agg_field(idx, call)
        if host:
            value, n = self.compiler.host.sum(idx, field, call, shards)
            return SumCount(value, n)
        stack, depth = self._bsi_stacked(idx, field, shards, mesh=mesh)
        if mesh:
            mode = self.compiler.mesh_mode(len(shards))
            eng = self.compiler.mesh_engine
            run = eng.sum_tree(mode, fplan=self._filter_plan(idx, call, shards, mode))
            pos, neg, n = eng.dispatch("sum", run, stack, depth)
        else:
            pos, neg, n = ops.bsi_sum(stack, depth, self._filter_tree(idx, call, shards))
        pend = _Pending(
            [pos, neg, n],
            lambda a: SumCount(ops.bsi.weigh_sum(a[0][0], a[1][0]), int(a[2][0])),
            route="mesh" if mesh else "device",
        )
        return pend if lazy else pend.resolve_now()

    def _execute_min_max(
        self, idx: Index, call: Call, shards: list[int], want_max: bool,
        lazy: bool = False, host: bool = False, mesh: bool = False,
    ):
        field = self._agg_field(idx, call)
        if host:
            value, n = self.compiler.host.min_max(
                idx, field, call, shards, want_max
            )
            return SumCount(value, n)
        stack, depth = self._bsi_stacked(idx, field, shards, mesh=mesh)
        if mesh:
            # every block's per-shard extremes, gathered: finish merges
            # them as it merges per-shard partials
            mode = self.compiler.mesh_mode(len(shards))
            eng = self.compiler.mesh_engine
            run = eng.minmax_tree(want_max, mode, fplan=self._filter_plan(idx, call, shards, mode))
            values, counts = eng.dispatch("minmax", run, stack, depth)
        else:
            values, counts = ops.bsi_min_max(stack, depth, self._filter_tree(idx, call, shards), want_max)

        def finish(a):
            # per-shard (or per-block) extremes merge exactly: min/max
            # with its count is associative over disjoint column blocks
            best, best_count = None, 0
            for v, n in zip(a[0].tolist(), a[1].tolist()):
                if n == 0:
                    continue
                if best is None or (v > best if want_max else v < best):
                    best, best_count = v, n
                elif v == best:
                    best_count += n
            return SumCount(best if best is not None else 0, best_count)

        pend = _Pending([values, counts], finish, route="mesh" if mesh else "device")
        return pend if lazy else pend.resolve_now()

    def _execute_topn(
        self, idx: Index, call: Call, shards: list[int], lazy: bool = False,
        host: bool = False, mesh: bool = False,
    ):
        field = self._field(idx, self._call_field_name(call))
        n = call.arg("n")
        ids = call.arg("ids")
        # internal (cluster fan-out) arg: only rows whose LOCAL count
        # reaches the floor
        min_count = call.arg("minCount")
        attr_name = call.arg("attrName")
        attr_values = call.arg("attrValues")
        if attr_name is not None and not attr_values:
            raise ExecutionError("TopN() attrName requires attrValues")

        if host:
            pairs = self.compiler.host.topn_pairs(
                idx, field, call, shards,
                list(ids) if ids is not None else None,
            )
            return self._topn_finish(
                field, pairs, n, attr_name, attr_values, min_count
            )
        try:
            matrix, _n_rows = self.compiler.stacks.matrix(idx, field, VIEW_STANDARD, shards)
        except StackOverBudget:
            # streamed: chunk readbacks are the streaming discipline, so
            # this path is synchronous; the filter is built once (under a
            # mesh too: the stream is the fallback, counted)
            if mesh:
                self.compiler.mesh_engine.note_fallback()
            filt = self._filter_device(idx, call, shards)
            pairs = self._topn_chunked(field, shards, filt, ids=ids)
            return self._topn_finish(field, pairs, n, attr_name, attr_values, min_count)
        if mesh:
            mode = self.compiler.mesh_mode(len(shards))
            eng = self.compiler.mesh_engine
            fplan = self._filter_plan(idx, call, shards, mode)
            run = eng.topn_tree(mode, fplan is not None, ids is not None, fplan=fplan)
            row_ids = self.compiler.mesh_scalars(list(ids)) if ids is not None else None
            counts = eng.dispatch("topn", run, matrix, row_ids)
        else:
            if not isinstance(matrix, torch.Tensor):
                matrix = matrix.gather()
            row_ids = self.compiler.device_scalars(list(ids)) if ids is not None else None
            counts = ops.row_counts(matrix, self._filter_tree(idx, call, shards), row_ids)
        if ids is not None:

            def finish(a):
                pairs = [
                    (int(r), int(c)) for r, c in zip(ids, a[0].tolist()) if c > 0
                ]
                return self._topn_finish(
                    field, pairs, n, attr_name, attr_values, min_count
                )

        else:

            def finish(a):
                nz = np.flatnonzero(a[0])
                pairs = [(int(r), int(a[0][r])) for r in nz.tolist()]
                return self._topn_finish(
                    field, pairs, n, attr_name, attr_values, min_count
                )

        pend = _Pending([counts], finish, route="mesh" if mesh else "device")
        return pend if lazy else pend.resolve_now()

    @staticmethod
    def _topn_finish(
        field: Field, pairs: list, n, attr_name, attr_values, min_count=None
    ) -> list[dict]:
        if min_count is not None:
            pairs = [(r, c) for r, c in pairs if c >= min_count]
        if attr_name is not None:
            allowed = set(attr_values)
            pairs = [
                (r, c)
                for r, c in pairs
                if field.row_attrs.attrs(r).get(attr_name) in allowed
            ]
        pairs.sort(key=lambda rc: (-rc[1], rc[0]))
        if n is not None:
            pairs = pairs[:n]
        out = []
        for rid, c in pairs:
            entry = {"id": rid, "count": c}
            if field.options.keys:
                entry["key"] = field.row_keys.translate_id(rid) or str(rid)
            out.append(entry)
        return out

    def _topn_chunked(self, field: Field, shards: list[int], filt, ids=None) -> list:
        """TopN over an over-budget field: row chunks of ``hot_capacity``
        packed on the host, uploaded, counted by K2 and dropped — device
        memory stays within the hot budget and every row is counted
        exactly."""
        rows = list(ids) if ids is not None else self._rows_of_field(field, shards)
        if not rows:
            return []
        view = field.view(VIEW_STANDARD)
        frags = [view.fragment(s) if view else None for s in shards]
        chunk = self.compiler.stacks.hot_capacity(len(shards))
        pairs: list = []
        for lo in range(0, len(rows), chunk):
            sub = rows[lo : lo + chunk]
            counts = ops.row_counts(self._pack_rows(frags, sub, len(sub)), filt).cpu().numpy()
            pairs += [(int(r), int(c)) for r, c in zip(sub, counts.tolist()) if c > 0]
        return pairs

    def _pack_rows(
        self, frags: list, rows: list[int], k_pad: int,
        cache: "_PackCache | None" = None, level: int = 0,
    ) -> torch.Tensor:
        """Host-packed int32 [k_pad, S, W] of ``rows`` (row-major, like a
        resident stack) on the device; padding rows and shards without a
        fragment stay zero. ``cache`` keeps packed rows by (level, row)."""
        host = np.zeros((k_pad, len(frags), WORDS_PER_SHARD), dtype=np.uint32)
        for j, r in enumerate(rows):
            got = cache.get((level, r)) if cache is not None else None
            if got is None:
                got = host[j]
                if r >= 0:
                    for i, frag in enumerate(frags):
                        if frag is not None:
                            got[i] = frag.row_packed(r)
                if cache is not None:
                    cache.put((level, r), got.copy())
            else:
                host[j] = got
        return torch.from_numpy(host.view(np.int32)).to(self.device)

    def _rows_of_field(self, field: Field, shards: list[int]) -> list[int]:
        rows: set[int] = set()
        view = field.view(VIEW_STANDARD)
        if view is None:
            return []
        for s in shards:
            frag = view.fragment(s)
            if frag is not None:
                rows.update(frag.row_ids())
        return sorted(rows)

    def _execute_rows(self, idx: Index, call: Call, shards: list[int]) -> dict:
        field = self._field(idx, self._call_field_name(call))
        rows = self._rows_of_field(field, shards)
        rids = call.arg("ids")
        if rids is not None:
            want = set(rids)
            rows = [r for r in rows if r in want]
        col = call.arg("column")
        if col is not None:
            col_id = self._col_id(idx, col)
            shard = col_id // SHARD_WIDTH
            view = field.view(VIEW_STANDARD)
            frag = view.fragment(shard) if view else None
            rows = [r for r in rows if frag is not None and frag.contains(r, col_id)]
        previous = call.arg("previous")
        if previous is not None:
            prev_id = self._row_id(field, previous)
            rows = [r for r in rows if r > (prev_id if prev_id is not None else -1)]
        limit = call.arg("limit")
        if limit is not None:
            rows = rows[:limit]
        if field.options.keys:
            return {
                "rows": rows,
                "keys": [field.row_keys.translate_id(r) or str(r) for r in rows],
            }
        return {"rows": rows}

    def _gb_programs(self, mesh_mode: str | None):
        """(gb_counts, gb_masks, grouped Sum, row-id placement) for one
        GroupBy execution: the kernels on the device, or the mesh
        engine's blocked programs with their reduction trees, so the
        call sites below stay engine-agnostic."""
        if mesh_mode is None:
            return ops.gb_counts, ops.gb_masks, ops.bsi_sum, self.compiler.device_scalars
        eng = self.compiler.mesh_engine
        counts = eng.groupby_counts_tree(mesh_mode)
        masks = eng.groupby_masks_tree(mesh_mode)
        sums = eng.grouped_sum_tree(mesh_mode)
        return (
            lambda m, mat, rows: eng.dispatch("groupby", counts, m, mat, rows),
            lambda m, mat, g_idx, row_sel: eng.dispatch("groupby", masks, m, mat, g_idx, row_sel),
            lambda st, depth, m: eng.dispatch("groupby", sums, st, depth, m),
            self.compiler.mesh_scalars,
        )

    def _execute_group_by(
        self, idx: Index, call: Call, shards: list[int], lazy: bool = False,
        host: bool = False, mesh: bool = False,
    ):
        """GroupBy with the reference's row universes and emission order
        on either engine. On the device: the fused path (one deferred
        [G, K] readback) when no aggregate is asked for and the folded
        masks fit ``_gb_budget``, else the level-synchronous path, two
        K6 launches per level and K4 for aggregate=Sum. On the mesh the
        same launches run per block; a level over the stack budget falls
        back to the device route, counted."""
        if not call.children or any(ch.name != "Rows" for ch in call.children):
            raise ExecutionError("GroupBy() takes Rows() calls")
        limit = call.arg("limit")
        filter_call = call.arg("filter")
        if filter_call is not None and not isinstance(filter_call, Call):
            raise ExecutionError("GroupBy filter must be a call")
        aggregate = call.arg("aggregate")
        if aggregate is not None and not (
            isinstance(aggregate, Call) and aggregate.name == "Sum"
        ):
            raise ExecutionError("GroupBy aggregate must be Sum(field=...)")
        agg_field = self._agg_field(idx, aggregate) if aggregate is not None else None
        fields: list[Field] = []
        row_lists: list[list[int]] = []
        for ch in call.children:
            f = self._field(idx, self._call_field_name(ch))
            fields.append(f)
            rows = self._rows_of_field(f, shards)
            rids = ch.arg("ids")
            if rids is not None:
                want = set(rids)
                rows = [r for r in rows if r in want]
            prev = ch.arg("previous")
            if prev is not None:
                prev_id = self._row_id(f, prev)
                rows = [r for r in rows if r > (prev_id if prev_id is not None else -1)]
            rlimit = ch.arg("limit")
            if rlimit is not None:
                rows = rows[:rlimit]
            row_lists.append(rows)
        if host:
            return self.compiler.host.group_by(
                idx, fields, row_lists, filter_call, agg_field, limit, shards
            )

        stacks = self.compiler.stacks
        if mesh and any(stacks.is_over_budget(idx, f, VIEW_STANDARD, shards) for f in fields):
            # a streamed level has no placed stack to block
            self.compiler.mesh_engine.note_fallback()
            mesh = False
        agg = self._bsi_stacked(idx, agg_field, shards, mesh=mesh) if agg_field is not None else None
        matrices = []
        for f in fields:
            try:
                if mesh:
                    matrices.append(stacks.matrix(idx, f, VIEW_STANDARD, shards)[0])
                else:
                    matrices.append(stacks.dense(idx, f, VIEW_STANDARD, shards)[0])
            except StackOverBudget:
                # an over-budget level has no resident stack: its counts
                # and masks stream host-packed row chunks instead
                matrices.append(None)
        n_shards = len(shards)
        mesh_mode = self.compiler.mesh_mode(n_shards) if mesh else None
        gb_counts, gb_masks, grouped_sum, dev_ids = self._gb_programs(mesh_mode)
        if mesh:
            if filter_call is not None:
                base_mask = self.compiler.mesh_bitmap_device(idx, filter_call, shards)
            else:
                base_mask = self.compiler.mesh_ones(n_shards)
        elif filter_call is not None:
            base_mask = self.compiler.bitmap_device(idx, filter_call, shards)
        else:
            base_mask = self.compiler.ones(n_shards)
        if aggregate is None and all(m is not None for m in matrices) and all(row_lists):
            fused = self._groupby_fused(
                fields, row_lists, matrices, base_mask, limit, n_shards,
                gb_counts, gb_masks, dev_ids, route="mesh" if mesh else "device",
            )
            if fused is not None:
                return fused if lazy else fused.resolve_now()

        # Level-synchronous: a nesting level is two launches, (1) the
        # counts of every (surviving group × candidate row) pair, (2) the
        # surviving groups' masks, chunked to the mask budget depth-first
        # so that the emission order — and `limit` — is the reference's.
        chunk_cap = max(1, self._gb_budget() // (n_shards * WORDS_PER_SHARD * 4))
        chunk_cap = 1 << (chunk_cap.bit_length() - 1)
        results: list[dict] = []

        def emit(groups: list[tuple], counts: np.ndarray, masks) -> None:
            start = len(results)
            for grp, c in zip(groups, counts.tolist()):
                results.append(
                    {
                        "group": [{"field": f.name, "rowID": rid} for f, rid in grp],
                        "count": int(c),
                    }
                )
            if agg is not None:
                pos, neg, _n = (
                    x.cpu().numpy() for x in grouped_sum(agg[0], agg[1], masks[: len(groups)])
                )
                for i in range(len(groups)):
                    results[start + i]["sum"] = ops.bsi.weigh_sum(pos[i], neg[i])

        # a streamed level's host-packed rows, per execution: the counts
        # pass and the mask pass both need them, and a row recurs across
        # pair chunks; bounded to chunk_cap rows like the mask tensor
        pack_cache = _PackCache(chunk_cap)

        def level_frags(level: int) -> list:
            view = fields[level].view(VIEW_STANDARD)
            return [view.fragment(s) if view else None for s in shards]

        def level_counts(level: int, masks, n_groups: int) -> np.ndarray:
            """int64[n_groups, len(rows)]: the resident stack when the
            level fits the budget, else host-packed chunks of
            ``hot_capacity`` rows counted by K6 with arange row ids."""
            rows_l = row_lists[level]
            m = matrices[level]
            if m is not None:
                rows_arr = dev_ids(_pad_row_ids(rows_l, _pow2(len(rows_l))))
                return gb_counts(masks, m, rows_arr).cpu().numpy()[:n_groups, : len(rows_l)]
            frags = level_frags(level)
            hot = self.compiler.stacks.hot_capacity(n_shards)
            parts = []
            for lo in range(0, len(rows_l), hot):
                sub = rows_l[lo : lo + hot]
                k_pad = _pow2(len(sub))
                packed = self._pack_rows(frags, sub, k_pad, pack_cache, level)
                counts = ops.gb_counts(masks, packed, dev_ids(list(range(k_pad))))
                parts.append(counts.cpu().numpy()[:n_groups, : len(sub)])
            return np.concatenate(parts, axis=1)

        def pair_masks(level: int, masks, chunk: np.ndarray):
            # p_pad-padded: padding pairs (group 0, row -1) are zero masks
            rows_l = row_lists[level]
            m = matrices[level]
            p_pad = _pow2(chunk.shape[0])
            g_idx = chunk[:, 0].tolist() + [0] * (p_pad - chunk.shape[0])
            if m is None:
                # a streamed level packs only the chunk's distinct rows
                # and selects them by local index
                uniq_k = np.unique(chunk[:, 1])
                m = self._pack_rows(
                    level_frags(level), [rows_l[k] for k in uniq_k.tolist()], _pow2(uniq_k.size),
                    pack_cache, level,
                )
                local = np.searchsorted(uniq_k, chunk[:, 1]).tolist()
                row_sel = _pad_row_ids(local, p_pad)
            else:
                row_sel = _pad_row_ids([rows_l[k] for k in chunk[:, 1].tolist()], p_pad)
            return gb_masks(masks, m, dev_ids(g_idx), dev_ids(row_sel))

        def expand(level: int, masks, groups: list[tuple]) -> None:
            if limit is not None and len(results) >= limit:
                return
            rows_l = row_lists[level]
            cnp = level_counts(level, masks, len(groups))
            pairs = np.argwhere(cnp > 0)  # (g-major, k-minor) = lexicographic
            last = level == len(fields) - 1
            if last and limit is not None:
                pairs = pairs[: limit - len(results)]
            for lo in range(0, pairs.shape[0], chunk_cap):
                chunk = pairs[lo : lo + chunk_cap]
                sub_groups = [
                    groups[g] + ((fields[level], rows_l[k]),) for g, k in chunk.tolist()
                ]
                if last and agg is None:
                    # counts suffice: no final masks
                    emit(sub_groups, cnp[chunk[:, 0], chunk[:, 1]], None)
                else:
                    sub_masks = pair_masks(level, masks, chunk)
                    if last:
                        emit(sub_groups, cnp[chunk[:, 0], chunk[:, 1]], sub_masks)
                    else:
                        expand(level + 1, sub_masks, sub_groups)
                if limit is not None and len(results) >= limit:
                    return

        if all(row_lists):
            expand(0, base_mask[None], [()])
        return results

    def _groupby_fused(
        self, fields, row_lists, matrices, base_mask, limit, n_shards,
        gb_counts, gb_masks, dev_ids, route: str = "device",
    ):
        """All-pairs GroupBy: fold every level but the last into one
        [G, S, W] pair-mask tensor (K6 gb_masks) with no readback, count
        the last level's rows against it (K6 gb_counts) and read the
        [G, K] counts back once, deferred. A padding row (-1) or an empty
        parent gives an all-zero mask, so every empty combination counts 0
        and the finish drops it; argwhere's row-major order is the nested
        ascending row order, so ``limit`` cuts as the level path does.
        None when the folded masks would exceed ``_gb_budget``."""
        kp = [_pow2(len(r)) for r in row_lists]
        n_groups = 1
        masks = base_mask[None]
        for lvl in range(len(fields) - 1):
            g_new = n_groups * kp[lvl]
            if g_new * n_shards * WORDS_PER_SHARD * 4 > self._gb_budget():
                return None
            rows_arr = _pad_row_ids(row_lists[lvl], kp[lvl])
            g_idx = [g for g in range(n_groups) for _ in range(kp[lvl])]
            masks = gb_masks(
                masks, matrices[lvl], dev_ids(g_idx), dev_ids(rows_arr * n_groups)
            )
            n_groups = g_new
        last = len(fields) - 1
        counts = gb_counts(
            masks, matrices[last], dev_ids(_pad_row_ids(row_lists[last], kp[last]))
        )

        def finish(a):
            cnt = a[0]  # [G, kp[last]]
            results: list[dict] = []
            for flat, k in np.argwhere(cnt > 0).tolist():
                if limit is not None and len(results) >= limit:
                    break
                idxs = [k]
                rem = flat
                for lvl in range(last - 1, -1, -1):
                    idxs.append(rem % kp[lvl])
                    rem //= kp[lvl]
                idxs.reverse()
                results.append(
                    {
                        "group": [
                            {"field": fields[lvl].name, "rowID": row_lists[lvl][j]}
                            for lvl, j in enumerate(idxs)
                        ],
                        "count": int(cnt[flat, k]),
                    }
                )
            return results

        return _Pending([counts], finish, route=route)

    def _execute_includes_column(
        self, idx: Index, call: Call, shards: list[int], host: bool = False
    ) -> bool:
        """IncludesColumn(bitmap, column=N) → bool. Only the column's own
        shard is evaluated."""
        if len(call.children) != 1:
            raise ExecutionError("IncludesColumn() takes exactly one call")
        col = call.arg("column")
        if col is None:
            raise ExecutionError("IncludesColumn() requires a column argument")
        col_id = self._col_id(idx, col, create=False)
        if col_id is None:
            return False
        shard = col_id // SHARD_WIDTH
        if shard not in shards:
            return False
        offset = col_id % SHARD_WIDTH
        if host:
            return self.compiler.host.includes_column(idx, call, shard, offset)
        words = self._bitmap_words(idx, call.children[0], [shard])[0]
        return bool((int(words[offset // 32]) >> (offset % 32)) & 1)

    # ------------------------------------------------------------ writes
    def _execute_write(self, idx: Index, call: Call) -> Any:
        name = call.name
        if name == "Set":
            return self._execute_set(idx, call)
        if name == "Clear":
            return self._execute_clear(idx, call)
        if name == "ClearRow":
            return self._execute_clear_row(idx, call)
        if name == "Store":
            return self._execute_store(idx, call)
        if name == "SetRowAttrs":
            return self._execute_set_row_attrs(idx, call)
        if name == "SetColumnAttrs":
            return self._execute_set_column_attrs(idx, call)
        raise ExecutionError(f"unknown write call {name!r}")

    def _set_args(self, idx: Index, call: Call) -> tuple[int, Field, Any, datetime | None]:
        if not call.pos_args:
            raise ExecutionError(f"{call.name}() needs a column argument")
        col = self._col_id(idx, call.pos_args[0], create=call.name == "Set")
        ts = None
        for extra in call.pos_args[1:]:
            coerced = coerce_timestamp(extra)
            if coerced is not None:
                ts = coerced
            else:
                raise ExecutionError(f"unexpected argument {extra!r}")
        fa = call.field_arg()
        if fa is None:
            raise ExecutionError(f"{call.name}() needs a field=row argument")
        fname, row = fa
        return col, self._field(idx, fname), row, ts

    def _execute_set(self, idx: Index, call: Call) -> bool:
        col, field, row, ts = self._set_args(idx, call)
        if field.options.field_type == FIELD_INT:
            if not isinstance(row, int) or isinstance(row, bool):
                raise ExecutionError("int field Set() needs an integer value")
            changed = field.set_value(col, row)
        else:
            row_id = self._row_id(field, row, create=True)
            changed = field.set_bit(row_id, col, timestamp=ts)
        idx.mark_columns_exist(np.array([col], dtype=np.uint64))
        return changed

    def _execute_clear(self, idx: Index, call: Call) -> bool:
        col, field, row, _ts = self._set_args(idx, call)
        if field.options.field_type == FIELD_INT:
            return field.clear_value(col)
        row_id = self._row_id(field, row)
        if row_id is None:
            return False
        return field.clear_bit(row_id, col)

    def _execute_clear_row(self, idx: Index, call: Call) -> bool:
        fa = call.field_arg()
        if fa is None:
            raise ExecutionError("ClearRow() needs a field=row argument")
        fname, row = fa
        field = self._field(idx, fname)
        if field.options.field_type in (FIELD_INT,):
            raise ExecutionError("ClearRow() is not supported on int fields")
        row_id = self._row_id(field, row)
        if row_id is None:
            return False
        changed = False
        for view in field.views.values():
            for frag in view.fragments.values():
                changed |= frag.clear_row(row_id)
        return changed

    def _execute_store(self, idx: Index, call: Call) -> bool:
        if len(call.children) != 1:
            raise ExecutionError("Store() takes exactly one row call")
        fa = call.field_arg()
        if fa is None:
            raise ExecutionError("Store() needs a field=row argument")
        fname, row = fa
        field = self._field(idx, fname)
        row_id = self._row_id(field, row, create=True)
        shards = self._shards(idx, None)
        words = self._bitmap_words(idx, call.children[0], shards)
        for i, s in enumerate(shards):
            positions = unpack_words(words[i])
            frag = field.create_view_if_not_exists(
                VIEW_STANDARD
            ).create_fragment_if_not_exists(s)
            frag.set_row(row_id, positions.astype(np.uint64))
        return True

    def _execute_set_row_attrs(self, idx: Index, call: Call) -> None:
        if len(call.pos_args) < 2:
            raise ExecutionError("SetRowAttrs(field, row, attrs...) needs 2 args")
        field = self._field(idx, call.pos_args[0])
        row_id = self._row_id(field, call.pos_args[1], create=True)
        field.row_attrs.set_attrs(row_id, dict(call.args))
        return None

    def _execute_set_column_attrs(self, idx: Index, call: Call) -> None:
        if len(call.pos_args) < 1:
            raise ExecutionError("SetColumnAttrs(col, attrs...) needs a column")
        col = self._col_id(idx, call.pos_args[0], create=True)
        idx.column_attrs.set_attrs(col, dict(call.args))
        return None
