"""Query compilation: PQL call tree → one postfix program, run by K1.

Reference: pilosa_tpu/executor/compile.py, which turns a call tree into
one jitted XLA program. Here the same planner emits a small postfix
program instead — leaf loads plus AND, OR, XOR and ANDNOT (PQL Not is
existence ANDNOT x), and CMP for a BSI condition — that the fused
call-tree kernel (``ops.tree_eval``, csrc/tree_eval.cu) interprets word
by word:

- each (field, view) keeps a device-resident stacked matrix
  ``int32[R, S, W]`` (row-major, so a row is one contiguous [S, W]
  plane) rebuilt only when a fragment version changes, and point writes
  patch it through the delta scatter (K3);
- row ids are launch arguments, not part of the program, so one program
  serves every row of the same query shape. There is no program cache:
  the walk that would compute the reference's structure key costs as
  much as the one that builds the program, and it runs anyway to
  collect the leaves;
- a count reduces inside the same launch to one int64, so a Count query
  is one launch and one scalar readback.

- a BSI condition (``Row(v > 5)``, ``-10 < v < 300``, ``v == null``)
  is evaluated inside the same launch as the rest of the tree, as the
  reference vmaps ``compare``/``between`` into its program: CMP reads
  the field's BSI stack through a small condition table.

Not ported yet (each raises): the hot-row, tiered and over-budget
residency paths (``StackOverBudget`` → ExecutionError, ROADMAP.md A11,
as the reference's slots mode surfaces it) and ``Shift`` (``PlanError``,
A6).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from pilosa_tpu_torch import ops
from pilosa_tpu_torch.core import (
    EXISTENCE_FIELD,
    FIELD_INT,
    FIELD_TIME,
    VIEW_BSI,
    VIEW_STANDARD,
    Field,
    Index,
)
from pilosa_tpu_torch.core.timequantum import views_by_time_range
from pilosa_tpu_torch.ops.bitwise import (
    OP_AND,
    OP_ANDNOT,
    OP_CMP,
    OP_LOAD,
    OP_OR,
    OP_XOR,
    OP_ZERO,
    TREE_MAX_CONDS,
    TREE_MAX_LEAVES,
    TREE_MAX_OPS,
    TREE_MAX_STACK,
    program_depth,
)
from pilosa_tpu_torch.pql import Call, Condition, coerce_timestamp
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD
from pilosa_tpu_torch.utils import saturation


class PlanError(ValueError):
    pass


class StackOverBudget(Exception):
    """A field's dense [R, S, W] stack would exceed the device budget.

    Raised EXPLICITLY instead of letting the allocation fail. The
    reference serves such fields through hot-row and tiered residency;
    the port does not have those yet, so the executor surfaces this as
    an ExecutionError."""

    def __init__(self, field: str, rows: int, bytes_needed: int, budget: int):
        self.field, self.rows = field, rows
        self.bytes_needed, self.budget = bytes_needed, budget
        super().__init__(
            f"field {field!r}: dense stack of {rows} rows needs "
            f"{bytes_needed / 2**20:.0f} MiB on device (budget "
            f"{budget / 2**20:.0f} MiB); over-budget residency is not yet "
            "ported to the CUDA path (ROADMAP.md A11)"
        )


def _not_ported(what: str, item: str) -> PlanError:
    return PlanError(f"{what} is not yet ported to the CUDA path (ROADMAP.md {item})")


# --------------------------------------------------------------- stacking
def stack_view_matrices(
    view, shards: list[int], rows: int | None = None
) -> tuple[np.ndarray, int]:
    """Stack a view's fragment host matrices → (np uint32[R, S, W], R).

    ``rows`` pins the stack height (a chunk of a larger stack); by
    default it is the tallest fragment's padded height. Shared by the
    device StackCache and the host engine (executor/hostpath.py).
    Row-major, so a row is one contiguous [S, W] plane and a query reads
    only the rows it touches."""
    mats, max_rows = [], 1
    for s in shards:
        frag = view.fragment(s) if view else None
        if frag is None:
            mats.append(None)
        else:
            m, _n = frag.host_matrix()
            mats.append(m)
            max_rows = max(max_rows, m.shape[0])
    if rows is not None:
        max_rows = rows
    stacked = np.zeros((max_rows, len(shards), WORDS_PER_SHARD), dtype=np.uint32)
    from pilosa_tpu_torch import native

    mats = [m[:max_rows] if m is not None else None for m in mats]
    if not native.stack_fill(mats, stacked):
        # rows outer, shards inner: destination writes land contiguously
        # in each [S, W] row plane
        for r in range(max_rows):
            plane = stacked[r]
            for i, m in enumerate(mats):
                if m is not None and r < m.shape[0]:
                    plane[i] = m[r]
    return stacked, max_rows


# host bytes per upload chunk: a 10 GiB stack crosses in pieces, so the
# host never holds a second full copy of it
_UPLOAD_CHUNK_BYTES = 256 << 20


def upload_stack(view, shards: list[int], device: torch.device) -> tuple[torch.Tensor, int]:
    """(int32[R, S, W] on ``device``, R) for a view's shard list."""
    heights = [1]
    for s in shards:
        frag = view.fragment(s) if view else None
        if frag is not None:
            heights.append(frag.host_matrix()[0].shape[0])
    rows = max(heights)
    if device.type == "cpu":
        stacked, _ = stack_view_matrices(view, shards, rows)
        return torch.from_numpy(stacked.view(np.int32)), rows
    dev = torch.empty((rows, len(shards), WORDS_PER_SHARD), dtype=torch.int32, device=device)
    step = max(1, _UPLOAD_CHUNK_BYTES // (rows * WORDS_PER_SHARD * 4))
    for lo in range(0, len(shards), step):
        chunk, _ = stack_view_matrices(view, shards[lo : lo + step], rows)
        dev[:, lo : lo + chunk.shape[1]].copy_(torch.from_numpy(chunk.view(np.int32)))
    return dev, rows


class StackCache:
    """Device-resident stacked (field, view) matrices.

    Entries key on the exact shard list and invalidate via per-fragment
    (uid, version) tokens — a deleted-and-recreated index gets fresh
    fragment uids, so stale data can never be served. An LRU cap and a
    byte ledger bound device memory.

    Point writes between queries take the DELTA path: the fragments'
    dirty-row history yields the changed (shard, row) set, only those
    packed rows cross host→device, and the delta scatter (K3) writes
    them into a copy of the resident stack in place of a full
    O(S·R·W) re-upload.
    """

    MAX_ENTRIES = 64
    MAX_DELTA_ROWS = 1024  # beyond this a full restack is cheaper

    # device-bytes cap for the resident stacks, aggregate. Resolution
    # order: PILOSA_TPU_STACK_BUDGET env → 70% of the card's memory
    # (torch.cuda.mem_get_info) → 2 GiB on the CPU. Tests monkeypatch
    # the class attribute with a plain int, which shadows the property.
    @property
    def STACK_BYTES_BUDGET(self) -> int:  # noqa: N802 — the reference's name
        if self._budget is None:
            env = os.environ.get("PILOSA_TPU_STACK_BUDGET")
            if env:
                self._budget = int(env)
            elif self.device.type == "cuda":
                self._budget = int(torch.cuda.mem_get_info(self.device)[1] * 0.7)
            else:
                self._budget = 2 << 30
        return self._budget

    def __init__(self, device: "str | torch.device" = "cuda", stats=None):
        self.device = ops.resolve_device(device)
        self.stats = stats
        self._budget: int | None = None
        self._cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        # contention-counted: every stack build/eviction and token check
        # serializes here
        self._lock = saturation.ContendedLock("stack-cache")
        # shared byte ledger: the budget is an AGGREGATE resident cap
        self._bytes: dict[tuple, int] = {}
        # projected bytes of builds in flight, keyed per build so two
        # concurrent builds of one key each hold a claim
        self._reserved: dict[object, int] = {}
        self.resident_bytes = 0
        # observability: tests assert the write path stays incremental
        self.full_restacks = 0
        self.delta_updates = 0
        self.delta_rows_uploaded = 0
        self.evictions = 0

    # ----------------------------------------------------- byte ledger
    # callers hold self._lock
    def _account(self, key: tuple, nbytes: int) -> None:
        self.resident_bytes += nbytes - self._bytes.get(key, 0)
        self._bytes[key] = nbytes

    def _forget(self, key: tuple) -> None:
        self.resident_bytes -= self._bytes.pop(key, 0)

    def _evict_for(self, need: int, keep: tuple | None = None) -> None:
        """Evict LRU stacks until ``need`` more bytes fit under the
        budget. The entry being (re)built is exempt; if nothing
        evictable remains the admit proceeds — the per-stack check
        already bounds any single entry."""
        budget = self.STACK_BYTES_BUDGET
        while self.resident_bytes + sum(self._reserved.values()) + need > budget:
            victim = next((k for k in self._cache if k != keep), None)
            if victim is None:
                break
            del self._cache[victim]
            self._forget(victim)
            self.evictions += 1
            if self.stats is not None:
                self.stats.count("stack_evictions_total", tags={"tier": "dense"})

    @staticmethod
    def _projected_rows(view, shards: list[int]) -> int:
        """Padded stack height WITHOUT materializing any host matrix —
        the over-budget check must not itself allocate O(R·W)."""
        from pilosa_tpu_torch.core.fragment import _pad_rows

        n = 1
        for s in shards:
            frag = view.fragment(s) if view else None
            if frag is not None:
                n = max(n, frag.n_rows())
        return _pad_rows(n)

    def matrix(self, idx: Index, field: Field, view_name: str, shards: list[int]):
        """(int32[R, S, W] on the device, n_rows) for the shard list.

        Raises StackOverBudget when the dense stack would exceed
        STACK_BYTES_BUDGET."""
        view = field.view(view_name)
        key = (idx.name, field.name, view_name, tuple(shards))
        # whole-view mutation stamp read BEFORE the per-fragment tokens:
        # a mutation racing this read advances view.version, so an entry
        # stamped with the earlier value just re-validates next query
        view_ver = view.version if view is not None else None
        with self._lock:
            cached = self._cache.get(key)
            if cached is not None and view_ver is not None and cached[3] == view_ver:
                # O(1) fast path: no mutation in the view since stamping
                self._cache.move_to_end(key)
                return cached[1], cached[2]
        r_pad = self._projected_rows(view, shards)
        need = len(shards) * r_pad * WORDS_PER_SHARD * 4
        if need > self.STACK_BYTES_BUDGET:
            raise StackOverBudget(field.name, r_pad, need, self.STACK_BYTES_BUDGET)
        with self._lock:
            # evict for the PROJECTED bytes BEFORE the build allocates
            self._evict_for(need - self._bytes.get(key, 0), keep=key)
            cached = self._cache.get(key)
            versions = tuple(self._frag_token(view, s) for s in shards)
            if cached is not None and cached[0] == versions:
                self._cache[key] = (versions, cached[1], cached[2], view_ver)
                self._cache.move_to_end(key)
                return cached[1], cached[2]
            build_token = object()
            self._reserved[build_token] = need
        # build OUTSIDE the lock: a slow restack/upload must not convoy
        # concurrent cache-hit readers; a racing write just means the
        # next query sees another version mismatch (delta application is
        # idempotent — rows carry full contents)
        try:
            entry = None
            if cached is not None:
                entry = self._try_delta(cached, view, shards, versions, view_ver)
            if entry is None:
                dev, max_rows = upload_stack(view, shards, self.device)
                with self._lock:
                    self.full_restacks += 1
                entry = (versions, dev, max_rows, view_ver)
        except BaseException:
            with self._lock:
                self._reserved.pop(build_token, None)
            raise
        with self._lock:
            self._reserved.pop(build_token, None)
            nbytes = entry[1].numel() * entry[1].element_size()
            self._evict_for(nbytes - self._bytes.get(key, 0), keep=key)
            self._cache[key] = entry
            self._account(key, nbytes)
            self._cache.move_to_end(key)
            while len(self._cache) > self.MAX_ENTRIES:
                victim, _ = self._cache.popitem(last=False)
                self._forget(victim)
            return entry[1], entry[2]

    def _try_delta(self, cached, view, shards: list[int], versions: tuple, view_ver):
        """Apply changed fragments' dirty rows to the cached stack; None
        ⇒ full restack (unknown history, fragment replaced, row growth
        past the stack height, or too many rows)."""
        old_versions, dev, max_rows = cached[0], cached[1], cached[2]
        updates: list[tuple[int, int, np.ndarray]] = []
        for i, s in enumerate(shards):
            old_uid, old_ver = old_versions[i]
            new_uid, _new_ver = versions[i]
            if (old_uid, old_ver) == versions[i]:
                continue
            if old_uid != new_uid:
                return None  # fragment created or replaced under the key
            frag = view.fragment(s)
            if frag is None:
                return None
            dirty = frag.dirty_rows_since(old_ver)
            if dirty is None:
                return None
            if len(updates) + len(dirty) > self.MAX_DELTA_ROWS:
                return None
            host_m, _n = frag.host_matrix()
            if host_m.shape[0] > max_rows:
                return None  # stack needs to grow — restack
            for r in sorted(dirty):
                if r >= max_rows:
                    return None
                words = (
                    host_m[r]
                    if r < host_m.shape[0]
                    else np.zeros(WORDS_PER_SHARD, dtype=np.uint32)
                )
                updates.append((i, r, words))
        if not updates:
            return (versions, dev, max_rows, view_ver)
        idx_arr = np.array([(r, i) for i, r, _w in updates], dtype=np.int32)
        row_arr = np.stack([w for _i, _r, w in updates]).view(np.int32)
        new_dev = ops.apply_stack_delta(
            dev,
            torch.from_numpy(idx_arr).to(self.device),
            torch.from_numpy(row_arr).to(self.device),
        )
        with self._lock:
            self.delta_updates += 1
            self.delta_rows_uploaded += len(updates)
        return (versions, new_dev, max_rows, view_ver)

    @staticmethod
    def _frag_token(view, shard: int) -> tuple:
        frag = view.fragment(shard) if view else None
        return (-1, -1) if frag is None else (frag.uid, frag.version)

    def stats_snapshot(self) -> dict:
        """Counter view (owns the field names so transport code never
        reads cache internals)."""
        with self._lock:
            return {
                "fullRestacks": self.full_restacks,
                "deltaUpdates": self.delta_updates,
                "deltaRowsUploaded": self.delta_rows_uploaded,
                "entries": len(self._cache),
                "evictions": self.evictions,
                "residentBytes": self.resident_bytes,
                "budgetBytes": self.STACK_BYTES_BUDGET,
            }

# ------------------------------------------------------------------ plans
class _Planner:
    """Builds the postfix ops of one call tree, plus the stacks and
    (stack, row id) leaves the program reads."""

    def __init__(self, idx: Index, shards: list[int], stacks: StackCache):
        self.idx = idx
        self.shards = shards
        self.stacks = stacks
        self._builders: list = []  # device-stack thunks
        self._array_keys: dict[tuple, int] = {}
        self.leaves: list[tuple[int, int]] = []  # (stack index, row id)
        # (stack index, depth, op, constant) per CMP
        self.conds: list[tuple[int, int, str, int]] = []

    def _add_array(self, key: tuple, build) -> int:
        i = self._array_keys.get(key)
        if i is None:
            i = len(self._builders)
            self._array_keys[key] = i
            self._builders.append(build)
        return i

    def materialize(self) -> list[torch.Tensor]:
        """Resolve the stacks AFTER planning finishes."""
        return [b() for b in self._builders]

    def _matrix_leaf(self, field: Field, view_name: str, row_id: int):
        # probing the budget up front raises StackOverBudget at plan time;
        # the check allocates nothing when the stack is cached
        self.stacks.matrix(self.idx, field, view_name, self.shards)
        ai = self._add_array(
            ("m", field.name, view_name),
            lambda: self.stacks.matrix(self.idx, field, view_name, self.shards)[0],
        )
        self.leaves.append((ai, row_id))
        return [(OP_LOAD, len(self.leaves) - 1)]

    @staticmethod
    def _zero():
        return [(OP_ZERO, 0)]

    def _existence(self):
        ef = self.idx.field(EXISTENCE_FIELD)
        if not self.idx.options.track_existence:
            raise PlanError(
                "query requires existence tracking (index created with "
                "track_existence=false)"
            )
        if ef is None:
            return self._zero()
        return self._matrix_leaf(ef, VIEW_STANDARD, 0)

    # ---------------------------------------------------------- call tree
    def plan(self, call: Call):
        """→ postfix ops evaluating to one [S, W] plane"""
        name = call.name
        if name in ("Row", "Range"):
            return self._plan_row(call)
        if name in ("Union", "Intersect", "Difference", "Xor"):
            subs = [self.plan(ch) for ch in call.children]
            if not subs:
                if name == "Intersect":
                    raise PlanError("Intersect() needs at least one child")
                return self._zero()
            op = {
                "Union": OP_OR,
                "Intersect": OP_AND,
                "Xor": OP_XOR,
                "Difference": OP_ANDNOT,
            }[name]
            out = list(subs[0])
            for sub_ops in subs[1:]:
                out += sub_ops + [(op, 0)]
            return out
        if name == "Not":
            if len(call.children) != 1:
                raise PlanError("Not() takes exactly one call")
            sub = self.plan(call.children[0])
            return self._existence() + sub + [(OP_ANDNOT, 0)]
        if name == "All":
            return self._existence()
        if name == "Shift":
            raise _not_ported("Shift()", "A6")
        raise PlanError(f"{name!r} is not a bitmap call")

    def _bsi(self, field: Field) -> int:
        """Index of the field's BSI stack among the planner's stacks (slots
        mode only: an over-budget stack raises StackOverBudget here)."""
        self.stacks.matrix(self.idx, field, VIEW_BSI, self.shards)
        return self._add_array(
            ("m", field.name, VIEW_BSI),
            lambda: self.stacks.matrix(self.idx, field, VIEW_BSI, self.shards)[0],
        )

    def _cmp(self, si: int, field: Field, op: str, value: int):
        self.conds.append((si, field.bit_depth, op, value))
        return [(OP_CMP, len(self.conds) - 1)]

    def _plan_condition(self, cond: tuple[str, Condition]):
        fname, condition = cond
        field = self.idx.field(fname)
        if field is None:
            raise PlanError(f"field {fname!r} not found")
        if field.options.field_type != FIELD_INT:
            raise PlanError(f"field {fname!r} is not an int field")
        value, op = condition.value, condition.op
        if value is None:
            if op == "!=":
                # columns with a value: the BSI existence plane
                return self._matrix_leaf(field, VIEW_BSI, 0)
            if op == "==":
                ex = self._existence()
                return ex + self._matrix_leaf(field, VIEW_BSI, 0) + [(OP_ANDNOT, 0)]
            raise PlanError(f"null only supports ==/!= comparisons, got {op!r}")
        si = self._bsi(field)
        if op == "between":
            lo, hi = int(value[0]), int(value[1])
            return self._cmp(si, field, ">=", lo) + self._cmp(si, field, "<=", hi) + [(OP_AND, 0)]
        return self._cmp(si, field, op, int(value))

    def _plan_row(self, call: Call):
        cond = call.condition()
        if cond is not None:
            return self._plan_condition(cond)
        fa = call.field_arg()
        if fa is None:
            raise PlanError(f"Row() needs a field argument: {call!r}")
        fname, row = fa
        field = self.idx.field(fname)
        if field is None:
            raise PlanError(f"field {fname!r} not found")
        row_id = self._row_id(field, row)

        ts_from, ts_to = call.arg("from"), call.arg("to")
        if ts_from is not None or ts_to is not None:
            if field.options.field_type != FIELD_TIME:
                raise PlanError(f"field {fname!r} is not a time field")
            raw_from, raw_to = ts_from, ts_to
            ts_from = coerce_timestamp(ts_from) if ts_from is not None else None
            ts_to = coerce_timestamp(ts_to) if ts_to is not None else None
            if raw_from is not None and ts_from is None:
                raise PlanError(f"bad from= timestamp {raw_from!r}")
            if raw_to is not None and ts_to is None:
                raise PlanError(f"bad to= timestamp {raw_to!r}")
            bounds = field.time_bounds()
            if bounds is None:
                return self._zero()
            ts_from = ts_from if ts_from is not None else bounds[0]
            ts_to = ts_to if ts_to is not None else bounds[1]
            view_names = [
                v
                for v in views_by_time_range(
                    VIEW_STANDARD, ts_from, ts_to, field.options.time_quantum
                )
                if field.view(v) is not None
            ]
            subs = [self._matrix_leaf(field, v, row_id) for v in view_names]
            if not subs:
                return self._zero()
            out = list(subs[0])
            for sub_ops in subs[1:]:
                out += sub_ops + [(OP_OR, 0)]
            return out
        return self._matrix_leaf(field, VIEW_STANDARD, row_id)

    def _row_id(self, field: Field, row) -> int:
        if isinstance(row, bool):
            return int(row)
        if isinstance(row, int):
            return row
        if isinstance(row, str):
            if not field.options.keys:
                raise PlanError(f"field {field.name!r} does not use string keys")
            rid = field.row_keys.translate_key(row, create=False)
            return rid if rid is not None else -1
        raise PlanError(f"bad row value {row!r}")


def check_program(ops_list: list, n_leaves: int, n_conds: int = 0) -> None:
    """PlanError when a program exceeds csrc/tree_eval.cu's fixed limits."""
    depth = program_depth(ops_list)
    for what, n, most in (
        ("operand stack depth", depth, TREE_MAX_STACK),
        ("program length", len(ops_list), TREE_MAX_OPS),
        ("leaf count", n_leaves, TREE_MAX_LEAVES),
        ("BSI condition count", n_conds, TREE_MAX_CONDS),
    ):
        if n > most:
            raise PlanError(
                f"call tree too large for the CUDA tree kernel: {what} {n} "
                f"exceeds its limit of {most}"
            )


# ----------------------------------------------------------- compiled API
class QueryCompiler:
    """Plans call trees into postfix programs and launches them; one
    program serves both the count and the words mode."""

    def __init__(self, device: "str | torch.device" = "cuda", stats=None):
        self.device = ops.resolve_device(device)
        self.stacks = StackCache(self.device, stats=stats)
        self._scalar_arrays: dict[tuple, torch.Tensor] = {}
        self._ones: dict[int, torch.Tensor] = {}
        # the HOST compilation layer: numpy plans over host-resident
        # stacks (executor/hostpath.py); the executor's router picks
        # which engine a call runs on
        from pilosa_tpu_torch.executor.hostpath import HostEngine

        self.host = HostEngine()

    def device_scalars(self, values: list[int]) -> torch.Tensor:
        """Device-resident int32 operand vector, cached by VALUE, so a
        repeated query uploads nothing."""
        key = tuple(values)
        cached = self._scalar_arrays.get(key)
        if cached is None:
            if len(self._scalar_arrays) >= 4096:
                # tiny entries; drop-all beats LRU bookkeeping here
                self._scalar_arrays.clear()
            cached = torch.tensor(key, dtype=torch.int32).to(self.device)
            self._scalar_arrays[key] = cached
        return cached

    def ones(self, n_shards: int) -> torch.Tensor:
        """All-ones int32[S, W] on the device (an absent filter, as the
        reference's ``compiler.ones``), cached per shard count."""
        plane = self._ones.get(n_shards)
        if plane is None:
            self._ones.clear()
            plane = torch.full(
                (n_shards, WORDS_PER_SHARD), -1, dtype=torch.int32, device=self.device
            )
            self._ones[n_shards] = plane
        return plane

    def _plan(self, idx: Index, call: Call, shards: list[int]):
        """(stacks, leaves, program, conditions) for one call tree,
        checked against the kernel's limits."""
        planner = _Planner(idx, shards, self.stacks)
        ops_list = planner.plan(call)
        check_program(ops_list, len(planner.leaves), len(planner.conds))
        return planner.materialize(), planner.leaves, ops_list, planner.conds

    def _run(self, idx: Index, call: Call, shards: list[int], count: bool):
        stacks, leaves, prog, conds = self._plan(idx, call, shards)
        return ops.tree_eval(
            stacks, leaves, prog, len(shards), count=count, device=self.device,
            conds=conds,
        )

    def bitmap_device(self, idx: Index, call: Call, shards: list[int]) -> torch.Tensor:
        """Evaluate a bitmap call for all shards in one launch → device
        int32[S, W]."""
        return self._run(idx, call, shards, count=False)

    def bitmap_words(self, idx: Index, call: Call, shards: list[int]) -> np.ndarray:
        return self.bitmap_device(idx, call, shards).cpu().numpy().view(np.uint32)

    def count_async(self, idx: Index, call: Call, shards: list[int]) -> torch.Tensor:
        """Device int64 scalar (not synced) — callers pipeline many
        queries before paying the device→host readback."""
        return self._run(idx, call, shards, count=True)
