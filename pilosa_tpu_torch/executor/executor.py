"""Query executor: PQL AST → kernel launches over sharded fragments.

Reference: pilosa_tpu/executor/executor.py (itself a redesign of the Go
executor.go). Every device-routed read call is one launch of the
hand-written kernels over stacked ``int32[R, S, W]`` field arrays — or
two where a filter child runs first as K1's words (a filtered TopN, Sum,
Min, Max or GroupBy; the reference fuses the filter into one program,
ROADMAP.md A8) — and only scalars or small count vectors cross back to
the host, all of a query's results in one readback wave.

Ported here: Count, the bitmap calls (Row, Range, Union, Intersect,
Difference, Xor, Not, All, Shift, and BSI conditions), TopN (with and
without a filter, and the ids= form), Sum, Min, Max, GroupBy (fused and
level-synchronous, with filter=, limit= and aggregate=Sum), Rows,
IncludesColumn, Options and the write calls. A field over the device
budget serves through residency (compile.StackCache): its rows as tiered
or hot-slot leaves, its BSI block assembled from tiered slices, and its
TopN and GroupBy levels streamed in host-packed chunks through K2 and
K6. Not ported: the mesh paths (ROADMAP.md A13).
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


def apply_options(idx: "Index", call: "Call", res: Any) -> Any:
    """Apply an Options() wrapper's result-shaping args (reference:
    QueryRequest ColumnAttrs/ExcludeColumns/ExcludeRowAttrs)."""
    if isinstance(res, RowResult):
        if call.arg("excludeColumns"):
            res.exclude_columns = True
        if call.arg("excludeRowAttrs"):
            res.exclude_row_attrs = True
        if call.arg("columnAttrs"):
            sets = []
            for col in res.columns().tolist():
                attrs = idx.column_attrs.attrs(int(col))
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
        device: "str | torch.device" = "cuda",
        stats=None,
        route_mode: str | None = None,
        router: QueryRouter | None = None,
    ):
        self.holder = holder
        self.stats = stats
        self.compiler = QueryCompiler(device, stats=stats)
        self.device = self.compiler.device
        self.router = (
            router if router is not None else QueryRouter(mode=route_mode, stats=stats)
        )
        if self.router.mode == "mesh":
            raise ValueError("mesh routing is not ported yet (ROADMAP.md A13)")
        self.router.mesh_devices = 1
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
    ) -> "list[tuple[str | None, int]]":
        """One ``(route, work)`` spec per call, via a cache that
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
        routes: "list[tuple[str | None, int]] | None" = None,
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
        routes: "list[tuple[str | None, int]] | None" = None,
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
            if route in ("host", "device"):
                self.router.record(route)
                if work > 0:
                    self.router.observe(route, work, elapsed)
                if work > 0 and self.router.audit.enabled:
                    est = self._candidate_costs(work, routes[i][2])
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
        """(route, estimated_work_words, cold_upload_words) for one
        top-level call. Writes route None; Rows is metadata-only and
        serves host-side. Under ``auto`` the router charges the device
        route the upload of every cold row of a tiered field."""
        c, sh = call, shards
        while c.name == "Options" and len(c.children) == 1:
            sh = c.arg("shards", sh)
            c = c.children[0]
        if c.name in WRITE_CALLS:
            return None, 0, 0
        if c.name == "Rows":
            return "host", 0, 0
        n = len(sh) if sh is not None else max(1, len(idx.available_shards()))
        work = estimate_words(idx, c, n)
        if self.router.mode != "auto":
            # pinned modes skip the residency walk on their hot path
            return self.router.mode, work, 0
        _tiered, cold_words = self._residency_info(idx, c, sh)
        route = self.router.decide((idx.name, n, repr(c)), work, device_extra_words=cold_words)
        return route, work, cold_words

    def _candidate_costs(self, work: int, cold_words: int) -> dict:
        """Modeled cost in seconds of each candidate path of one call;
        the device path also pays its cold-row uploads at host speed."""
        r = self.router
        extra_s = cold_words / r._host_wps() if cold_words else 0.0
        return {"host": r.host_cost(work), "device": r.device_cost(work) + extra_s}

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
        if self.router.mode != "auto":
            route = self.router.mode
        else:
            route = self.router.decide((idx.name, n, repr(c)), work, device_extra_words=cold_words)
        costs = self._candidate_costs(work, cold_words)
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
        try:
            if name in BITMAP_CALLS:
                if host:
                    # np.array: the host engine may hand back views of
                    # live stack memory
                    words = np.array(
                        self.compiler.host.bitmap_words(idx, call, shard_list)
                    )
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
                pend = _Pending(
                    [self.compiler.count_async(idx, call.children[0], shard_list)],
                    lambda a: int(a[0]),
                )
                return pend if lazy else pend.resolve_now()
            if name == "Sum":
                return self._execute_sum(idx, call, shard_list, lazy=lazy, host=host)
            if name in ("Min", "Max"):
                return self._execute_min_max(
                    idx, call, shard_list, name == "Max", lazy=lazy, host=host
                )
            if name == "TopN":
                return self._execute_topn(idx, call, shard_list, lazy=lazy, host=host)
            if name == "Rows":
                return self._execute_rows(idx, call, shard_list)
            if name == "GroupBy":
                return self._execute_group_by(
                    idx, call, shard_list, lazy=lazy, host=host
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
        if call.name != "Row" or call.condition() is not None:
            return
        fa = call.field_arg()
        if fa is None:
            return
        field = idx.field(fa[0])
        if field is None:
            return
        row_id = fa[1]
        if isinstance(row_id, str):
            if not field.options.keys:
                return
            row_id = field.row_keys.translate_key(row_id, create=False)
            if row_id is None:
                return
        if isinstance(row_id, bool):
            row_id = int(row_id)
        if isinstance(row_id, int):
            res.attrs = field.row_attrs.attrs(row_id)

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
        or None without one (the kernels read None as all ones). The
        aggregate then reads it back: two launches where the reference
        fuses the filter into the aggregate's program (``_filter_plan``,
        executor.py:1019; ROADMAP.md A8)."""
        if not call.children:
            return None
        return self.compiler.bitmap_device(idx, call.children[0], shards)

    def _bsi_stacked(self, idx: Index, field: Field, shards: list[int]):
        """(int32[P, S, W] BSI stack on the device, depth D). The kernels
        read a plane at or past P as zeros, so the stack is never padded
        to 2 + D. An over-budget stack assembles from tiered slice rows
        in tiered mode; slots mode raises, as the reference's does."""
        try:
            m, _rows = self.compiler.stacks.matrix(idx, field, VIEW_BSI, shards)
        except StackOverBudget as e:
            if self.compiler.stacks.residency_mode() == "slots":
                raise ExecutionError(str(e)) from e
            m = self.compiler.tiered_bsi_block(idx, field, shards)
        return m, field.bit_depth

    # ------------------------------------------------------- aggregates
    def _execute_sum(
        self, idx: Index, call: Call, shards: list[int], lazy: bool = False,
        host: bool = False,
    ):
        field = self._agg_field(idx, call)
        if host:
            value, n = self.compiler.host.sum(idx, field, call, shards)
            return SumCount(value, n)
        stack, depth = self._bsi_stacked(idx, field, shards)
        filt = self._filter_device(idx, call, shards)
        pos, neg, n = ops.bsi_sum(stack, depth, None if filt is None else filt[None])
        pend = _Pending(
            [pos, neg, n],
            lambda a: SumCount(ops.bsi.weigh_sum(a[0][0], a[1][0]), int(a[2][0])),
        )
        return pend if lazy else pend.resolve_now()

    def _execute_min_max(
        self, idx: Index, call: Call, shards: list[int], want_max: bool,
        lazy: bool = False, host: bool = False,
    ):
        field = self._agg_field(idx, call)
        if host:
            value, n = self.compiler.host.min_max(
                idx, field, call, shards, want_max
            )
            return SumCount(value, n)
        stack, depth = self._bsi_stacked(idx, field, shards)
        filt = self._filter_device(idx, call, shards)
        values, counts = ops.bsi_min_max(stack, depth, filt, want_max)

        def finish(a):
            # per-shard extremes merge exactly: min/max with its count is
            # associative over disjoint shards
            best, best_count = None, 0
            for v, n in zip(a[0].tolist(), a[1].tolist()):
                if n == 0:
                    continue
                if best is None or (v > best if want_max else v < best):
                    best, best_count = v, n
                elif v == best:
                    best_count += n
            return SumCount(best if best is not None else 0, best_count)

        pend = _Pending([values, counts], finish)
        return pend if lazy else pend.resolve_now()

    def _execute_topn(
        self, idx: Index, call: Call, shards: list[int], lazy: bool = False,
        host: bool = False,
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
        # the filter is K1's words output, then K2 reads it: two launches
        # where the reference fuses the filter into the TopN program
        try:
            matrix, _n_rows = self.compiler.stacks.matrix(idx, field, VIEW_STANDARD, shards)
        except StackOverBudget:
            # streamed: chunk readbacks are the streaming discipline, so
            # this path is synchronous; the filter is built once
            filt = self._filter_device(idx, call, shards)
            pairs = self._topn_chunked(field, shards, filt, ids=ids)
            return self._topn_finish(field, pairs, n, attr_name, attr_values, min_count)
        filt = self._filter_device(idx, call, shards)
        if ids is not None:
            counts = ops.row_counts(
                matrix, filt, self.compiler.device_scalars(list(ids))
            )

            def finish(a):
                pairs = [
                    (int(r), int(c)) for r, c in zip(ids, a[0].tolist()) if c > 0
                ]
                return self._topn_finish(
                    field, pairs, n, attr_name, attr_values, min_count
                )

        else:
            counts = ops.row_counts(matrix, filt)

            def finish(a):
                nz = np.flatnonzero(a[0])
                pairs = [(int(r), int(a[0][r])) for r in nz.tolist()]
                return self._topn_finish(
                    field, pairs, n, attr_name, attr_values, min_count
                )

        pend = _Pending([counts], finish)
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

    def _execute_group_by(
        self, idx: Index, call: Call, shards: list[int], lazy: bool = False,
        host: bool = False,
    ):
        """GroupBy with the reference's row universes and emission order
        on either engine. On the device: the fused path (one deferred
        [G, K] readback) when no aggregate is asked for and the folded
        masks fit ``_gb_budget``, else the level-synchronous path, two
        K6 launches per level and K4 for aggregate=Sum."""
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

        agg = self._bsi_stacked(idx, agg_field, shards) if agg_field is not None else None
        matrices = []
        for f in fields:
            try:
                matrices.append(self.compiler.stacks.matrix(idx, f, VIEW_STANDARD, shards)[0])
            except StackOverBudget:
                # an over-budget level has no resident stack: its counts
                # and masks stream host-packed row chunks instead
                matrices.append(None)
        n_shards = len(shards)
        if filter_call is not None:
            base_mask = self.compiler.bitmap_device(idx, filter_call, shards)
        else:
            base_mask = self.compiler.ones(n_shards)
        if aggregate is None and all(m is not None for m in matrices) and all(row_lists):
            fused = self._groupby_fused(
                fields, row_lists, matrices, base_mask, limit, n_shards
            )
            if fused is not None:
                return fused if lazy else fused.resolve_now()

        # Level-synchronous: a nesting level is two launches, (1) the
        # counts of every (surviving group × candidate row) pair, (2) the
        # surviving groups' masks, chunked to the mask budget depth-first
        # so that the emission order — and `limit` — is the reference's.
        chunk_cap = max(1, self._gb_budget() // (n_shards * WORDS_PER_SHARD * 4))
        chunk_cap = 1 << (chunk_cap.bit_length() - 1)
        dev_ids = self.compiler.device_scalars
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
                    x.cpu().numpy() for x in ops.bsi_sum(agg[0], agg[1], masks[: len(groups)])
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
                return ops.gb_counts(masks, m, rows_arr).cpu().numpy()[:n_groups, : len(rows_l)]
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
            return ops.gb_masks(masks, m, dev_ids(g_idx), dev_ids(row_sel))

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

    def _groupby_fused(self, fields, row_lists, matrices, base_mask, limit, n_shards):
        """All-pairs GroupBy: fold every level but the last into one
        [G, S, W] pair-mask tensor (K6 gb_masks) with no readback, count
        the last level's rows against it (K6 gb_counts) and read the
        [G, K] counts back once, deferred. A padding row (-1) or an empty
        parent gives an all-zero mask, so every empty combination counts 0
        and the finish drops it; argwhere's row-major order is the nested
        ascending row order, so ``limit`` cuts as the level path does.
        None when the folded masks would exceed ``_gb_budget``."""
        kp = [_pow2(len(r)) for r in row_lists]
        dev_ids = self.compiler.device_scalars
        n_groups = 1
        masks = base_mask[None]
        for lvl in range(len(fields) - 1):
            g_new = n_groups * kp[lvl]
            if g_new * n_shards * WORDS_PER_SHARD * 4 > self._gb_budget():
                return None
            rows_arr = _pad_row_ids(row_lists[lvl], kp[lvl])
            g_idx = [g for g in range(n_groups) for _ in range(kp[lvl])]
            masks = ops.gb_masks(
                masks, matrices[lvl], dev_ids(g_idx), dev_ids(rows_arr * n_groups)
            )
            n_groups = g_new
        last = len(fields) - 1
        counts = ops.gb_counts(
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

        return _Pending([counts], finish)

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
