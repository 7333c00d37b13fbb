"""Query executor: PQL AST → kernel launches over sharded fragments.

Reference: pilosa_tpu/executor/executor.py (itself a redesign of the Go
executor.go). Every device-routed read call is one launch — or two, for a
filtered TopN — of the hand-written kernels over stacked ``int32[R, S, W]``
field arrays, and only scalars (or a [rows] count vector for TopN) cross
back to the host, all of a query's results in one readback wave.

Ported here: Count, the bitmap calls (Row, Range, Union, Intersect,
Difference, Xor, Not, All), TopN (with and without a filter, and the ids=
form), Rows, IncludesColumn, Options and the write calls. Sum, Min, Max
and GroupBy run on the host engine; routed to the device they raise
ExecutionError until their kernels land (ROADMAP.md A7, A9).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from datetime import datetime
from typing import Any, Callable

import numpy as np
import torch

from pilosa_tpu_torch import ops
from pilosa_tpu_torch.core import FIELD_INT, VIEW_STANDARD, Field, Holder, Index
from pilosa_tpu_torch.executor.compile import PlanError, QueryCompiler, StackOverBudget
from pilosa_tpu_torch.executor.hostpath import HostPlanError
from pilosa_tpu_torch.executor.router import QueryRouter, estimate_words
from pilosa_tpu_torch.executor.row import RowResult
from pilosa_tpu_torch.pql import Call, coerce_timestamp, parse
from pilosa_tpu_torch.roaring import unpack_words
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
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
# calls whose device programs are not ported yet, and the ROADMAP item
# that ports them; the auto router serves them host-side
_HOST_ONLY = {"Sum": "A7", "Min": "A7", "Max": "A7", "GroupBy": "A9"}


def unwrap_options(call: Call) -> Call:
    """Innermost call of an Options() wrapper chain — THE write/read
    classification rule."""
    while call.name == "Options" and len(call.children) == 1:
        call = call.children[0]
    return call


def _device_ported(call: Call) -> bool:
    """Whether every node of the tree has a CUDA path in this port."""
    if call.name in _HOST_ONLY or call.name == "Shift":
        return False
    if call.name in ("Row", "Range") and call.condition() is not None:
        return False
    sub = [call.arg("filter"), call.arg("aggregate")]
    return all(
        _device_ported(c) for c in list(call.children) + sub if isinstance(c, Call)
    )


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


class Executor:
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
                if route == "host" and self.router.mode == "auto" and not _device_ported(c):
                    # auto routing had no choice: the call has no CUDA
                    # path yet, so its host decision is counted apart
                    self.router.record("host_unported")
                if work > 0:
                    self.router.observe(route, work, elapsed)
                if work > 0 and self.router.audit.enabled:
                    est = self._candidate_costs(work)
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
        """(route, estimated_work_words) for one top-level call. Writes
        route None; Rows is metadata-only and serves host-side, and so
        do calls without a CUDA path yet under ``auto``."""
        c, sh = call, shards
        while c.name == "Options" and len(c.children) == 1:
            sh = c.arg("shards", sh)
            c = c.children[0]
        if c.name in WRITE_CALLS:
            return None, 0
        if c.name == "Rows":
            return "host", 0
        n = len(sh) if sh is not None else max(1, len(idx.available_shards()))
        work = estimate_words(idx, c, n)
        if self.router.mode != "auto":
            return self.router.mode, work
        if not _device_ported(c):
            return "host", work
        return self.router.decide((idx.name, n, repr(c)), work), work

    def _candidate_costs(self, work: int) -> dict:
        """Modeled cost in seconds of each candidate path of one call."""
        r = self.router
        return {"host": r.host_cost(work), "device": r.device_cost(work)}

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
        if not host and name in _HOST_ONLY:
            raise ExecutionError(
                f"{name}() is not yet ported to the CUDA path (ROADMAP.md "
                f"{_HOST_ONLY[name]}); route it to the host engine"
            )
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
                field = self._agg_field(idx, call)
                value, n = self.compiler.host.sum(idx, field, call, shard_list)
                return SumCount(value, n)
            if name in ("Min", "Max"):
                field = self._agg_field(idx, call)
                value, n = self.compiler.host.min_max(
                    idx, field, call, shard_list, name == "Max"
                )
                return SumCount(value, n)
            if name == "TopN":
                return self._execute_topn(idx, call, shard_list, lazy=lazy, host=host)
            if name == "Rows":
                return self._execute_rows(idx, call, shard_list)
            if name == "GroupBy":
                return self._execute_group_by(idx, call, shard_list)
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

    # ------------------------------------------------------- aggregates
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
        matrix, _n_rows = self.compiler.stacks.matrix(idx, field, VIEW_STANDARD, shards)
        # the filter is K1's words output, then K2 reads it: two launches
        # where the reference fuses the filter into the TopN program
        filt = (
            self.compiler.bitmap_device(idx, call.children[0], shards)
            if call.children
            else None
        )
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

    def _execute_group_by(self, idx: Index, call: Call, shards: list[int]):
        """GroupBy on the host engine (its device programs are ROADMAP
        A9): the same row universes and emission order as the reference."""
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
        return self.compiler.host.group_by(
            idx, fields, row_lists, filter_call, agg_field, limit, shards
        )

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
