"""Programmatic API façade — the surface the HTTP layer and tests call.

Reference: pilosa_tpu/server/api.py (after api.go: Query, CreateIndex/
Field, DeleteIndex/Field, Import, ImportValue, ImportRoaring, Schema).
Serialization of results to JSON lives here so transport layers stay
thin. Ported so far: schema, query (on a device mesh too, ``mesh_ctx``),
the bit/value/roaring imports and the response builder. Cluster,
EXPLAIN, export and translation wait for the slices that port the HTTP
front end (ROADMAP.md A5).
"""

from __future__ import annotations

import re
import time
from datetime import datetime
from typing import Any

import numpy as np

from pilosa_tpu_torch.core import (
    EXISTENCE_FIELD,
    VIEW_STANDARD,
    Field,
    FieldOptions,
    Holder,
    Index,
    IndexOptions,
)
from pilosa_tpu_torch.executor import ExecutionError, Executor, RowResult
from pilosa_tpu_torch.executor.executor import WRITE_CALLS, unwrap_options
from pilosa_tpu_torch.executor.scheduler import WaveScheduler, dedup_key
from pilosa_tpu_torch.pql import parse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils import durable


# index/field naming rule (reference: validateName in pilosa.go — lowercase
# start, then lowercase/digit/underscore/dash, max 64 chars)
_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")


class RequestTooLargeError(ExecutionError):
    """A single request carries more writes than max_writes_per_request
    allows (reference: server/config.go max-writes-per-request). The HTTP
    layer maps this to 413."""


def validate_name(name: str, what: str = "name") -> str:
    if not _NAME_RE.fullmatch(name):
        raise ExecutionError(
            f"invalid {what} {name!r}: must match [a-z][a-z0-9_-]* "
            "and be at most 64 characters"
        )
    return name


def field_options_from_json(opts: dict, explicit_create: bool = False) -> FieldOptions:
    """Map the reference's JSON field-options wire names onto FieldOptions
    (reference: http/handler.go postFieldRequest).

    Range tracking: an explicit ``hasRange`` always wins. Without it, the
    CREATE route treats a present min/max key as a declared range (so an
    operator's explicit [0, 0] is enforced), but schema RESTORES/sync use
    the nonzero rule — pre-hasRange /schema dumps serialize min:0/max:0
    unconditionally for unbounded fields, and reading those as an
    enforced [0, 0] would brick every restored int field."""
    if "hasRange" in opts:
        has_range = bool(opts["hasRange"])
    elif explicit_create:
        has_range = "min" in opts or "max" in opts
    else:
        has_range = bool(opts.get("min", 0) or opts.get("max", 0))
    return FieldOptions(
        field_type=opts.get("type", "set"),
        cache_type=opts.get("cacheType", "ranked"),
        cache_size=opts.get("cacheSize", 50_000),
        time_quantum=opts.get("timeQuantum", ""),
        keys=opts.get("keys", False),
        min=opts.get("min", 0),
        max=opts.get("max", 0),
        has_range=has_range,
        no_standard_view=opts.get("noStandardView", False),
    )


class API:
    def __init__(
        self,
        holder: Holder,
        device=None,
        stats=None,
        mesh_ctx=None,
        max_writes: int = 5000,
        route_mode: str | None = None,
        router=None,
        batch_mode: str | None = None,
        batch_window_us: float | None = None,
        batch_max_queries: int | None = None,
    ):
        """``device`` is where queries run: ``"cuda"`` (the default;
        raises without a card) or ``"cpu"`` for the plain torch
        versions. ``mesh_ctx`` serves reads over a device mesh
        (parallel.mesh.MeshContext, or ``"auto"`` for every card when
        there are two or more); the device is then the mesh's lead.
        ``route_mode`` pins the router (auto/host/device/mesh)."""
        self.holder = holder
        self.max_writes = max_writes
        self.stats = stats
        if mesh_ctx == "auto":
            from pilosa_tpu_torch.parallel.mesh import MeshContext

            mesh_ctx = MeshContext.auto()
        self.mesh_ctx = mesh_ctx
        self.executor = Executor(
            holder, device=device, stats=stats, route_mode=route_mode, router=router,
            mesh_ctx=mesh_ctx,
        )
        # cross-query wave scheduler (executor/scheduler.py): sync
        # queries submitted concurrently share dispatch/readback waves
        self.scheduler = WaveScheduler(
            lambda: self.executor,
            stats=stats,
            mode=batch_mode,
            window_us=batch_window_us,
            max_queries=batch_max_queries,
        )
        # mutation-stamped cross-request result cache; a bare API has
        # none (the serving front ends install one when they are ported)
        self.result_cache = None

    # ------------------------------------------------------------- schema
    def create_index(self, name: str, options: dict | None = None) -> Index:
        validate_name(name, "index name")
        opts = options or {}
        idx = self.holder.create_index(
            name,
            IndexOptions(
                keys=opts.get("keys", False),
                track_existence=opts.get("trackExistence", True),
            ),
        )
        return idx

    def delete_index(self, name: str) -> None:
        self.holder.delete_index(name)
        self._invalidate_results(name)

    def create_field(self, index: str, name: str, options: dict | None = None) -> Field:
        validate_name(name, "field name")
        idx = self._index(index)
        f = idx.create_field(
            name, field_options_from_json(options or {}, explicit_create=True)
        )
        self._invalidate_results(index)
        return f

    def delete_field(self, index: str, name: str) -> None:
        self._index(index).delete_field(name)
        self._invalidate_results(index)

    def schema(self) -> dict:
        return {"indexes": self.holder.schema()}

    # -------------------------------------------------------------- query
    def check_write_limit(self, n: int, what: str) -> None:
        if self.max_writes > 0 and n > self.max_writes:
            raise RequestTooLargeError(
                f"{what} carries {n} writes; max_writes_per_request is "
                f"{self.max_writes}"
            )

    def count_query_writes(self, calls: list) -> int:
        """Write calls in a parsed query — same classification rule the
        cluster router uses (executor.unwrap_options)."""
        return sum(1 for c in calls if unwrap_options(c).name in WRITE_CALLS)

    def query(
        self, index: str, pql: str, shards: list[int] | None = None
    ) -> dict:
        calls = parse(pql) if isinstance(pql, str) else pql
        n_writes = self.count_query_writes(calls)
        self.check_write_limit(n_writes, "query")
        if self.stats is not None:
            self.stats.count("queries_served", tags={"path": "local"})
        # read queries consult the result cache BEFORE execution: the
        # key embeds the index's current mutation stamp, so a hit is a
        # settled answer computed under this exact data generation
        # (docs/result-cache.md); key + invalidation generation are
        # snapshotted pre-execution so a result computed before a
        # concurrent write can never be stored under post-write state
        cache = self.result_cache
        key = gen = None
        if cache is not None and cache.enabled and isinstance(pql, str):
            # teach the event-loop fast path this text's identity (the
            # loop itself never parses — docs/result-cache.md)
            cache.memoize_pql(pql, None if n_writes else calls)
        if n_writes == 0 and cache is not None and cache.enabled:
            key = self._result_cache_key(index, calls, shards)
            if key is not None:
                hit = cache.get(key)
                if hit is not None:
                    return hit.resp
                gen = cache.generation(index)
        t0 = time.perf_counter()
        # sync queries go to the wave scheduler, not straight to
        # execute: concurrent device-routed requests coalesce into
        # shared dispatch/readback waves (writes and host-routed reads
        # pass through direct — see executor/scheduler.py)
        results = self.scheduler.execute(index, calls, shards=shards)
        elapsed = time.perf_counter() - t0
        if n_writes:
            # durability barrier BEFORE the acknowledgement leaves: in
            # batch WAL mode this group-fsyncs every ops log the query
            # dirtied (docs/durability.md)
            durable.ack_barrier()
            self._invalidate_results(index)
        resp = self.build_response(results)
        if key is not None:
            cache.offer(key, resp, elapsed, gen=gen)
        return resp

    def _result_cache_key(self, index: str, calls: list, shards) -> tuple | None:
        """This query's single-flight dedup identity (executor/
        scheduler.py dedup_key) — the result cache's key.  None when
        the index is gone (the caller's execution will raise the
        canonical error)."""
        idx = self.holder.index(index)
        if idx is None:
            return None
        return dedup_key(index, calls, shards, idx)

    def _invalidate_results(self, index: str) -> None:
        """The write-path invalidation hook: EVERY API write path must
        reach this (enforced by the cacheinvariant analyzer rule).
        Correctness for stamp-blind attribute writes, byte reclamation
        for stamp-bumping ones (docs/result-cache.md)."""
        cache = self.result_cache
        if cache is not None:
            cache.invalidate(index)

    def build_response(self, results: list[Any]) -> dict:
        """Assemble the QueryResponse dict; Options(columnAttrs=true)
        results contribute response-level columnAttrs sets (reference:
        QueryResponse.ColumnAttrSets)."""
        resp: dict = {"results": [self._result_json(r) for r in results]}
        col_sets = [
            s
            for r in results
            if isinstance(r, RowResult) and r.column_attr_sets
            for s in r.column_attr_sets
        ]
        if col_sets:
            resp["columnAttrs"] = col_sets
        return resp

    def _result_json(self, r: Any) -> Any:
        if isinstance(r, RowResult):
            return r.to_json()
        if r is None:
            return None
        return r

    # ------------------------------------------------------------- import
    def import_bits(self, index: str, field: str, payload: dict) -> None:
        """Bulk bit import (reference: api.Import / ImportRequest).

        payload keys: rowIDs|rowKeys, columnIDs|columnKeys, timestamps
        (epoch seconds or ISO strings, optional), clear (optional).
        """
        idx = self._index(index)
        f = self._field(idx, field)
        # size-check the raw payload BEFORE key translation so an
        # oversized keyed import doesn't allocate new IDs first
        self.check_write_limit(self._payload_size(payload), "import")
        rows = self._resolve_rows(f, payload)
        cols = self._resolve_cols(idx, payload)
        if rows.size != cols.size:
            raise ExecutionError("rowIDs and columnIDs length mismatch")
        timestamps = None
        raw_ts = payload.get("timestamps")
        if raw_ts:
            timestamps = [self._parse_ts(t) for t in raw_ts]
        f.import_bulk(rows, cols, timestamps=timestamps, clear=payload.get("clear", False))
        idx.mark_columns_exist(cols)
        durable.ack_barrier()  # acknowledged ⇒ on disk (docs/durability.md)
        self._invalidate_results(index)

    def import_values(self, index: str, field: str, payload: dict) -> None:
        """Bulk BSI import (reference: api.ImportValue).

        payload keys: columnIDs|columnKeys, values, clear (optional: the
        columns' values are cleared and ``values`` is not read).
        """
        idx = self._index(index)
        f = self._field(idx, field)
        self.check_write_limit(self._payload_size(payload), "import")
        cols = self._resolve_cols(idx, payload)
        if payload.get("clear"):
            f.clear_values(cols)
            durable.ack_barrier()
            self._invalidate_results(index)
            return
        values = np.asarray(payload.get("values", []), dtype=np.int64)
        if cols.size != values.size:
            raise ExecutionError("columnIDs and values length mismatch")
        f.import_values(cols, values)
        idx.mark_columns_exist(cols)
        durable.ack_barrier()  # acknowledged ⇒ on disk (docs/durability.md)
        self._invalidate_results(index)

    def import_roaring(self, index: str, field: str, shard: int, data: bytes, view: str = VIEW_STANDARD) -> int:
        """Direct roaring-bitmap union into a fragment (reference:
        api.ImportRoaring fast path). The wire-speed bulk lane
        (docs/ingest.md): the fragment adopts the incoming frame with
        ONE crc32-framed WAL append, and the single ``ack_barrier``
        below group-fsyncs it together with the existence-field appends
        — fsyncs amortize across concurrent importers instead of a full
        durable snapshot per post."""
        idx = self._index(index)
        if field == EXISTENCE_FIELD:
            # whole-fragment movement (rebalance pull, handoff push,
            # restore) ships the internal existence field too, and the
            # adopter may not have lazily created it yet — materialize
            # it instead of failing the transfer (docs/resize.md)
            f = idx.existence_field()
            if f is None:
                raise ExecutionError(
                    f"index {index!r} does not track existence"
                )
        else:
            f = self._field(idx, field)
        frag = f.create_view_if_not_exists(view).create_fragment_if_not_exists(shard)
        delta = frag.import_roaring(data)
        # existence marking from the DELTA (incoming positions), not the
        # merged fragment — a whole-fragment values() pass per import
        # made repeated bulk loads O(fragment) each. Folded CONTAINER-
        # wise (fold_to_columns: key arithmetic + OR chain), never a
        # value-vector sort: the per-import existence sort was the next
        # bottleneck once the adopt itself went to one WAL append.
        # Under the fragment lock: on the fresh-adopt path ``delta`` IS
        # live storage, and a concurrent writer mutating its containers
        # mid-fold would tear it.
        from pilosa_tpu_torch.roaring.build import fold_to_columns

        with frag._lock:
            bits = delta.count()
            delta_cols = fold_to_columns(delta, SHARD_WIDTH)
        idx.mark_shard_columns(shard, delta_cols)
        # acknowledged ⇒ on disk: the barrier group-fsyncs the
        # fragment's union-frame append AND the existence-field appends
        # in one pass (docs/durability.md, docs/ingest.md)
        durable.ack_barrier()
        self._invalidate_results(index)
        # adopted bit count (the delta, deduplicated) — ingest metering
        return int(bits)

    @staticmethod
    def _payload_size(payload: dict) -> int:
        # `v is not None` (not truthiness): framed internal imports carry
        # these as ndarrays, whose truth value is ambiguous
        return max(
            (
                len(v) if (v := payload.get(k)) is not None else 0
                for k in ("rowIDs", "rowKeys", "columnIDs", "columnKeys", "values")
            ),
            default=0,
        )

    def _resolve_rows(self, f: Field, payload: dict) -> np.ndarray:
        if "rowKeys" in payload and payload["rowKeys"]:
            if not f.options.keys:
                raise ExecutionError(f"field {f.name!r} does not use string keys")
            ids = f.row_keys.translate_keys(payload["rowKeys"], create=True)
            return np.asarray(ids, dtype=np.uint64)
        return np.asarray(payload.get("rowIDs", []), dtype=np.uint64)

    def _resolve_cols(self, idx: Index, payload: dict) -> np.ndarray:
        if "columnKeys" in payload and payload["columnKeys"]:
            if not idx.options.keys:
                raise ExecutionError(f"index {idx.name!r} does not use string keys")
            ids = idx.column_keys.translate_keys(payload["columnKeys"], create=True)
            return np.asarray(ids, dtype=np.uint64)
        return np.asarray(payload.get("columnIDs", []), dtype=np.uint64)

    @staticmethod
    def _parse_ts(t: Any) -> datetime | None:
        if t in (None, 0, ""):
            return None
        if isinstance(t, (int, float)):
            return datetime.utcfromtimestamp(t)
        return datetime.fromisoformat(t)

    # ------------------------------------------------------------ helpers
    def _index(self, name: str) -> Index:
        idx = self.holder.index(name)
        if idx is None:
            raise ExecutionError(f"index {name!r} not found")
        return idx

    @staticmethod
    def _field(idx: Index, name: str) -> Field:
        f = idx.field(name)
        if f is None:
            raise ExecutionError(f"field {name!r} not found")
        return f
