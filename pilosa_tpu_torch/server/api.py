"""Programmatic API façade — the surface the HTTP layer and tests call.

Reference: pilosa_tpu/server/api.py (after api.go: Query, CreateIndex/
Field, DeleteIndex/Field, Import, ImportValue, ImportRoaring, Schema,
ApplySchema, ExportCSV, ShardNodes, Hosts, State, Info). Serialization
of results to JSON lives here so transport layers stay thin. The port
serves one node: the cluster layer is not ported (ROADMAP.md A10), so
the cluster surfaces answer for a single node.
"""

from __future__ import annotations

import io
import re
import time
from datetime import datetime
from typing import Any

import numpy as np

from pilosa_tpu_torch import __version__, roaring
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
from pilosa_tpu_torch.executor.scheduler import WaveScheduler, dedup_key, stack_token
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
        self.diagnostics = None  # set by Server.open
        # mutation-stamped cross-request result cache (utils/
        # resultcache.py, docs/result-cache.md).  None ⇒ uncached:
        # the serving front ends install one (_ServerCore default,
        # Server.open config-sized) — a bare API façade in tests keeps
        # its exact pre-cache semantics.
        self.result_cache = None

    def attach_mesh(self, mesh_ctx) -> None:
        """Late mesh attachment (Server.open does this after the HTTP
        listener is up, when ``MeshContext.auto()`` finds two or more
        cards). The query router carries over: its calibration must
        survive the executor swap."""
        self.mesh_ctx = mesh_ctx
        self.executor = Executor(
            self.holder, mesh_ctx=mesh_ctx, stats=self.stats, router=self.executor.router,
        )

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

    def apply_schema(self, schema: dict, validate: bool = True) -> None:
        """Idempotently create everything in a schema dump (reference:
        api.ApplySchema). ``validate=False`` is for cluster schema sync:
        replication must accept names that predate (or bypass) the
        create-time validation rule, or a node could fail to join against
        existing data."""
        for idx_def in schema.get("indexes", []):
            if validate:
                validate_name(idx_def["name"], "index name")
            opts = idx_def.get("options", {})
            idx = self.holder.create_index_if_not_exists(
                idx_def["name"],
                IndexOptions(
                    keys=opts.get("keys", False),
                    track_existence=opts.get("trackExistence", True),
                ),
            )
            for f_def in idx_def.get("fields", []):
                if validate:
                    validate_name(f_def["name"], "field name")
                if idx.field(f_def["name"]) is None:
                    idx.create_field(
                        f_def["name"], field_options_from_json(f_def.get("options", {}))
                    )
        for idx_def in schema.get("indexes", []):
            # schema application changes what keys/fields resolve —
            # every named index's cached results are stale generations
            self._invalidate_results(idx_def["name"])

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

    def explain(self, index: str, pql: str, shards: list[int] | None = None) -> dict:
        """EXPLAIN (plan only — docs/observability.md): the decisions
        the serving path would make for this query, without executing
        it — per-call router cost tables over every candidate path,
        residency classification of touched row ranges, mesh
        supportability verdicts, and the wave scheduler's batchability
        prediction.  ``?explain=analyze`` runs the query too and the
        HTTP layer merges measured actuals next to these estimates."""
        calls = parse(pql) if isinstance(pql, str) else pql
        idx = self.executor.holder.index(index)
        if idx is None:
            raise ExecutionError(f"index {index!r} not found")
        plans = [self.executor.explain_call(idx, c, shards) for c in calls]
        has_write = any(unwrap_options(c).name in WRITE_CALLS for c in calls)
        any_device = any(p.get("route") in ("device", "mesh") for p in plans)
        if self.scheduler.mode == "off":
            batchable, why = False, "batch-mode is off"
        elif has_write:
            batchable, why = False, "query contains writes (never coalesced)"
        elif not any_device:
            batchable, why = False, (
                "no device/mesh-routed call — host-routed queries bypass "
                "the wave window"
            )
        else:
            batchable, why = True, (
                "device-routed reads ride shared dispatch/readback waves"
            )
        router = self.executor.router
        return {
            "index": index,
            "query": pql if isinstance(pql, str) else repr(pql),
            "routeMode": router.mode,
            "crossoverWords": router.crossover_words(),
            "waveScheduler": {
                "mode": self.scheduler.mode,
                "batchable": batchable,
                "reason": why,
                "occupancyEwma": router.wave_occupancy.value,
            },
            "resultCache": self._explain_result_cache(
                index, calls, shards, has_write
            ),
            "calls": plans,
        }

    def _explain_result_cache(
        self, index: str, calls: list, shards, has_write: bool
    ) -> dict:
        """EXPLAIN's cache verdict (docs/result-cache.md): whether this
        exact key is cached RIGHT NOW, and the structural admission
        candidacy.  The HTTP layer enriches the verdict with the
        workload plane's measured per-fingerprint cost/bytes."""
        cache = self.result_cache
        if cache is None:
            return {"enabled": False, "reason": "no result cache wired"}
        out = {"enabled": cache.enabled, "mode": cache.mode}
        key = (
            self._result_cache_key(index, calls, shards)
            if not has_write
            else None
        )
        out["cachedNow"] = key is not None and cache.contains(key)
        out.update(cache.candidacy(index, has_write))
        return out

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

    def mutation_stamp(self, index: str) -> tuple | None:
        """The index's current view-version mutation stamp — the SAME
        stack token single-flight dedup keys on (executor/scheduler.py),
        read here for the workload plane's cachability estimate
        (docs/workload.md): a repeated fingerprint whose stamp is
        unchanged between repeats is exactly a query a mutation-stamped
        result cache would have served from cache.  None when the index
        is gone (the settle races a delete).  Cost: the same
        O(fields × views) walk stack_token documents — microseconds on
        realistic schemas; if schemas grow to thousands of fields, take
        the per-index max-stamp O(1) upgrade described there and both
        callers get it."""
        idx = self.holder.index(index)
        if idx is None:
            return None
        return stack_token(idx)

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

    # -------------------------------------------------------- translation
    def _translate_store(self, index: str, field: str | None):
        """The keyed index's column store or keyed field's row store;
        validates the keys option (shared by the local path and the
        cluster's primary-forwarding router)."""
        idx = self._index(index)
        if field:
            f = self._field(idx, field)
            if not f.options.keys:
                raise ExecutionError(f"field {field!r} does not use string keys")
            return f.row_keys
        if not idx.options.keys:
            raise ExecutionError(f"index {index!r} does not use string keys")
        return idx.column_keys

    def translate_keys(
        self, index: str, field: str | None, keys: list[str], create: bool = True
    ) -> list[int | None]:
        """String keys → IDs for a keyed index (column keys) or field
        (row keys). ``create=False`` (lookup-only) leaves unknown keys as
        None — the wire layer maps them to 0, IDs start at 1. Creation is
        a write: the max_writes_per_request limit applies. Reference:
        api.TranslateKeys via POST /internal/translate/keys."""
        store = self._translate_store(index, field)
        if create:
            self.check_write_limit(len(keys), "translate")
        ids = store.translate_keys(keys, create=create)
        if create:
            # new key→id assignments are acknowledged state: a client
            # that writes bits under a returned id after a crash must
            # find the same mapping on replay
            durable.ack_barrier()
            # a fresh mapping changes what keyed queries resolve to
            # without touching any view version — stamp-blind, so the
            # explicit hook is the only correctness mechanism here
            self._invalidate_results(index)
        return ids

    # ------------------------------------------------------------- export
    def fragment_data(
        self,
        index: str,
        field: str,
        shard: int,
        view: str = VIEW_STANDARD,
        fmt: str = "pilosa",
    ) -> bytes:
        """One fragment's bitmap, serialized. ``fmt``: "pilosa" (the
        cookie-12348 fragment file layout) or "official" (32-bit
        RoaringFormatSpec — what stock CRoaring/RoaringBitmap clients
        parse; only representable when every row id < 2^32/SHARD_WIDTH,
        since the interchange format is 32-bit)."""
        if fmt not in ("pilosa", "official"):
            raise ExecutionError(f"unknown roaring format {fmt!r}")
        idx = self._index(index)
        f = self._field(idx, field)
        v = f.view(view)
        frag = v.fragment(shard) if v is not None else None
        bm = frag.bitmap if frag is not None else roaring.Bitmap()
        if fmt == "official":
            return roaring.serialize_official(bm)
        return roaring.serialize(bm)

    def export_csv(self, index: str, field: str, shard: int | None = None) -> str:
        """CSV rows of (rowID/key, columnID/key) pairs (reference:
        api.ExportCSV)."""
        idx = self._index(index)
        f = self._field(idx, field)
        view = f.view(VIEW_STANDARD)
        out = io.StringIO()
        if view is None:
            return ""
        shards = sorted(view.available_shards())
        if shard is not None:
            shards = [s for s in shards if s == shard]
        for s in shards:
            frag = view.fragment(s)
            for row in frag.row_ids():
                row_repr = (
                    f.row_keys.translate_id(row) or str(row)
                    if f.options.keys
                    else str(row)
                )
                for col in frag.row_columns(row).tolist():
                    col_repr = (
                        idx.column_keys.translate_id(col) or str(col)
                        if idx.options.keys
                        else str(col)
                    )
                    out.write(f"{row_repr},{col_repr}\n")
        return out.getvalue()

    # -------------------------------------------------------------- info
    def info(self) -> dict:
        out = {
            "shardWidth": SHARD_WIDTH,
            "version": __version__,
        }
        if self.diagnostics is not None:
            out["diagnostics"] = self.diagnostics.snapshot()
        return out

    # The port serves one node (ROADMAP.md A10 ports the cluster): the
    # cluster surfaces answer as the reference's do without a cluster.
    def state(self) -> str:
        return "NORMAL"

    def hosts(self) -> list[dict]:
        return [{"id": "local", "uri": "", "isCoordinator": True}]

    def topology_epoch(self) -> int:
        return 0

    def translate_pending(self) -> bool:
        return False

    def node_inventories(self) -> dict:
        return {
            name: sorted(idx.available_shards())
            for name, idx in self.holder.indexes.items()
        }

    def shard_nodes(self, index: str, shard: int) -> list[dict]:
        return self.hosts()

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
