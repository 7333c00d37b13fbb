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
- ``Shift(x, n)`` splits the program: K1 evaluates x into a temporary
  [S, W] plane, K7 shifts it, and the shifted plane enters the outer
  program as a leaf (the reference fuses all three into one program).
- a tree past K1's fixed limits (leaves, length, stack depth, BSI
  conditions) splits the same way: each subtree cut off is a
  sub-program that K1 evaluates in words mode into a temporary plane,
  read by the outer program as a one-row stack (``_Planner._fit``).

A field whose dense stack exceeds the budget serves through residency
(docs/device-residency.md), as the reference's: in the default
``tiered`` mode each row is a cold one-shot plane upload until its
touches promote it into a dense, sparse or run container store (K3 in
row mode), and K1 decodes sparse and run payloads in place; the legacy
``slots`` mode keeps an LRU [H, S, W] slot stack of hot rows.
"""

from __future__ import annotations

import os
import weakref
from collections import OrderedDict

import numpy as np
import torch

from pilosa_tpu_torch import ops
from pilosa_tpu_torch.core import (
    BSI_OFFSET,
    EXISTENCE_FIELD,
    FIELD_INT,
    FIELD_TIME,
    VIEW_BSI,
    VIEW_STANDARD,
    Field,
    Index,
)
from pilosa_tpu_torch.core.timequantum import views_by_time_range
from pilosa_tpu_torch.executor import residency
from pilosa_tpu_torch.executor.residency import RUN_MAX_INTERVALS, SPARSE_MAX_IDS, TieredEntry
from pilosa_tpu_torch.ops.bitwise import (
    OP_AND,
    OP_ANDNOT,
    OP_CMP,
    OP_LOAD,
    OP_LOAD_RUN,
    OP_LOAD_SPARSE,
    OP_OR,
    OP_XOR,
    OP_ZERO,
    TREE_MAX_CONDS,
    TREE_MAX_LEAVES,
    TREE_MAX_OPS,
    TREE_MAX_STACK,
    _LOADS,
    _PUSHES,
    program_depth,
)
from pilosa_tpu_torch.pql import Call, Condition, coerce_timestamp
from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD
from pilosa_tpu_torch.utils import saturation


class PlanError(ValueError):
    pass


class StackOverBudget(Exception):
    """A field's dense [R, S, W] stack, or one query's batch of resident
    rows, would exceed the device budget. Raised EXPLICITLY instead of
    letting the allocation fail: ``matrix`` raises it and the planner
    then serves the field through residency; ``hot_batch``,
    ``tiered_batch`` and ``_pack_payload`` raise it when one query needs
    more rows than a store holds."""

    def __init__(self, field: str, rows: int, bytes_needed: int, budget: int):
        self.field, self.rows = field, rows
        self.bytes_needed, self.budget = bytes_needed, budget
        super().__init__(
            f"field {field!r}: dense stack of {rows} rows needs "
            f"{bytes_needed / 2**20:.0f} MiB on device (budget "
            f"{budget / 2**20:.0f} MiB)"
        )


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


def upload_stack(view, shards: list[int], device: torch.device, mesh_ctx=None):
    """(int32[R, S, W] on ``device``, R) for a view's shard list; with a
    mesh context, a MeshArray placed by its rule (parallel/mesh.py), each
    block filled from host chunks of shards."""
    heights = [1]
    for s in shards:
        frag = view.fragment(s) if view else None
        if frag is not None:
            heights.append(frag.host_matrix()[0].shape[0])
    rows = max(heights)
    if mesh_ctx is not None:
        return _upload_placed(view, shards, rows, mesh_ctx), rows
    if device.type == "cpu":
        stacked, _ = stack_view_matrices(view, shards, rows)
        return torch.from_numpy(stacked.view(np.int32)), rows
    dev = torch.empty((rows, len(shards), WORDS_PER_SHARD), dtype=torch.int32, device=device)
    step = max(1, _UPLOAD_CHUNK_BYTES // (rows * WORDS_PER_SHARD * 4))
    for lo in range(0, len(shards), step):
        chunk, _ = stack_view_matrices(view, shards[lo : lo + step], rows)
        dev[:, lo : lo + chunk.shape[1]].copy_(torch.from_numpy(chunk.view(np.int32)))
    return dev, rows


def _upload_placed(view, shards: list[int], rows: int, mesh_ctx):
    """The [R, S, W] stack as a MeshArray: host chunks of shards, each
    copied into the blocks whose shard range it meets."""
    from pilosa_tpu_torch.parallel.mesh import MeshArray, empty_like_placement

    shape = (rows, len(shards), WORDS_PER_SHARD)
    mode = mesh_ctx.mode_for(len(shards), WORDS_PER_SHARD)
    if mode == "replicate":
        dev, _ = upload_stack(view, shards, mesh_ctx.lead)
        return MeshArray(mesh_ctx.mesh, shape, mode, [[dev]])
    out = empty_like_placement(mesh_ctx.mesh, shape, mode)
    step = max(1, _UPLOAD_CHUNK_BYTES // (rows * WORDS_PER_SHARD * 4))
    for lo in range(0, len(shards), step):
        chunk, _ = stack_view_matrices(view, shards[lo : lo + step], rows)
        src = torch.from_numpy(chunk.view(np.int32))
        hi = lo + chunk.shape[1]
        for i, j, blk in out.items():
            s_lo, s_hi, w_lo, w_hi = out.cover(i, j)
            a, b = max(lo, s_lo), min(hi, s_hi)
            if a < b:
                blk[:, a - s_lo : b - s_lo].copy_(src[:, a - lo : b - lo, w_lo:w_hi])
    return out


# explicit budget installed from config (device-stack-budget-bytes);
# wins over the env var and the card's memory
_budget_override: list[int] = []
# processes sharing this card (set_card_share): 1 outside a fleet
_card_share: list[int] = [1]


def set_stack_budget(n: int | None) -> None:
    """Install the configured device stack budget (Config field
    ``device-stack-budget-bytes``; the server wires it at boot) for the
    StackCaches made after it. None or 0 clears back to the env var and
    the card's memory."""
    _budget_override.clear()
    if n:
        _budget_override.append(int(n))


def set_card_share(n: int) -> None:
    """Divide the default budget (70% of the card) among ``n`` processes
    that share the card: the children of a supervised fleet (server/
    supervisor.py) each take 1/n. A configured or env budget is not
    divided."""
    _card_share[0] = max(1, int(n))


def card_budget(total_bytes: int) -> int:
    """The default budget on a card of ``total_bytes``: 70% of it,
    divided among the processes that share it (set_card_share)."""
    return int(total_bytes * 0.7) // _card_share[0]


def stack_budget_if_resolved() -> int | None:
    """The configured or env budget, or None where only the card's
    memory could answer: the /debug/resources ledger reads it without
    a CUDA call, since control-plane routes do not pass the probe gate."""
    if _budget_override:
        return _budget_override[0]
    env = os.environ.get("PILOSA_TPU_STACK_BUDGET")
    return int(env) if env else None


def _nbytes(stack) -> int:
    """Device bytes of a stack: a tensor, or a MeshArray's blocks once each."""
    return stack.nbytes if not isinstance(stack, torch.Tensor) else stack.numel() * stack.element_size()


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

    With a mesh context (parallel/mesh.py) a dense stack is a MeshArray
    of blocks over the mesh, and a delta runs K3 once per block it
    touches; residency stores and slot stacks sit whole on the lead
    device, ``self.device``.
    """

    MAX_ENTRIES = 64
    MAX_DELTA_ROWS = 1024  # beyond this a full restack is cheaper

    # device-bytes cap for the resident stacks, aggregate. Resolution
    # order: the configured budget (set_stack_budget) →
    # PILOSA_TPU_STACK_BUDGET env → 70% of the card's memory
    # (torch.cuda.mem_get_info), divided among the processes that share
    # the card (set_card_share) → 2 GiB on the CPU. Tests monkeypatch
    # the class attribute with a plain int, which shadows the property.
    @property
    def STACK_BYTES_BUDGET(self) -> int:  # noqa: N802 — the reference's name
        if self._budget is None:
            resolved = stack_budget_if_resolved()
            if resolved:
                self._budget = resolved
            elif self.device.type == "cuda":
                self._budget = card_budget(torch.cuda.mem_get_info(self.device)[1])
            else:
                self._budget = 2 << 30
        return self._budget

    def __init__(self, device: "str | torch.device" = "cuda", stats=None, mesh_ctx=None):
        self.device = ops.resolve_device(device)
        self.mesh_ctx = mesh_ctx
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
        # over-budget fields: legacy hot-row slot stacks, and tiered
        # compressed residency entries (executor/residency.py)
        self._hot: "OrderedDict[tuple, dict]" = OrderedDict()
        self._tiered: "OrderedDict[tuple, TieredEntry]" = OrderedDict()
        # observability: tests assert the write path stays incremental
        self.full_restacks = 0
        self.delta_updates = 0
        self.delta_rows_uploaded = 0
        self.hot_row_uploads = 0
        self.rows_promoted = 0
        self.rows_demoted = 0
        self.cold_uploads = 0
        self.evictions = {"dense": 0, "hot": 0, "tiered": 0}
        self._container_bytes = {"dense": 0, "sparse": 0, "run": 0}

    # ----------------------------------------------------- byte ledger
    # callers hold self._lock
    def _account(self, key: tuple, nbytes: int) -> None:
        self.resident_bytes += nbytes - self._bytes.get(key, 0)
        self._bytes[key] = nbytes

    def _forget(self, key: tuple) -> None:
        self.resident_bytes -= self._bytes.pop(key, 0)

    def _evict_for(self, need: int, keep: tuple | None = None) -> None:
        """Evict LRU entries (dense stacks first, then hot slot stacks,
        then tiered container entries) until ``need`` more bytes fit
        under the budget. The entry being (re)built is exempt; if nothing
        evictable remains the admit proceeds — the per-stack check
        already bounds any single entry."""
        budget = self.STACK_BYTES_BUDGET
        while self.resident_bytes + sum(self._reserved.values()) + need > budget:
            victim = next((k for k in self._cache if k != keep), None)
            if victim is not None:
                del self._cache[victim]
                self._forget(victim)
                self._note_eviction("dense")
                continue
            victim = next((k for k in self._hot if k != keep), None)
            if victim is not None:
                del self._hot[victim]
                self._forget(victim)
                self._note_eviction("hot")
                continue
            victim = next((k for k in self._tiered if k != keep), None)
            if victim is None:
                break
            self._forget_tiered(victim, self._tiered.pop(victim))
            self._note_eviction("tiered")

    def claim(self, nbytes: int) -> object:
        """Reserve ``nbytes`` of the budget for a query's temporary plane
        (a cut-off sub-program's or a Shift's), evicting LRU entries to
        make room → the token that ``release`` frees."""
        token = object()
        with self._lock:
            self._evict_for(nbytes)
            self._reserved[token] = nbytes
        return token

    def release(self, token: object) -> None:
        # no lock: the plane's finalizer calls this on whichever thread
        # drops the plane, perhaps one holding _lock; a dict pop is atomic
        self._reserved.pop(token, None)

    def _note_eviction(self, tier: str) -> None:
        # caller holds self._lock
        self.evictions[tier] += 1
        if self.stats is not None:
            self.stats.count("stack_evictions_total", tags={"tier": tier})

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
                dev, max_rows = upload_stack(view, shards, self.device, self.mesh_ctx)
                with self._lock:
                    self.full_restacks += 1
                entry = (versions, dev, max_rows, view_ver)
        except BaseException:
            with self._lock:
                self._reserved.pop(build_token, None)
            raise
        with self._lock:
            self._reserved.pop(build_token, None)
            nbytes = _nbytes(entry[1])
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
        if isinstance(dev, torch.Tensor):
            new_dev = ops.apply_stack_delta(
                dev,
                torch.from_numpy(idx_arr).to(self.device),
                torch.from_numpy(row_arr).to(self.device),
            )
        else:
            new_dev = self._delta_blocks(dev, idx_arr, row_arr)
        with self._lock:
            self.delta_updates += 1
            self.delta_rows_uploaded += len(updates)
        return (versions, new_dev, max_rows, view_ver)

    @staticmethod
    def _delta_blocks(placed, idx_arr: np.ndarray, row_arr: np.ndarray):
        """A delta on a MeshArray stack: K3 once per block that holds a
        changed (row, shard), on the block's slice of the changed rows
        (its shards, its words), into a new block; untouched blocks are
        shared with the old stack."""
        from pilosa_tpu_torch.parallel.mesh import MeshArray

        grid = []
        for i, row in enumerate(placed.blocks):
            out = []
            for j, blk in enumerate(row):
                s_lo, s_hi, w_lo, w_hi = placed.cover(i, j)
                mine = (idx_arr[:, 1] >= s_lo) & (idx_arr[:, 1] < s_hi)
                if not mine.any():
                    out.append(blk)
                    continue
                local = idx_arr[mine].copy()
                local[:, 1] -= s_lo
                rows = np.ascontiguousarray(row_arr[mine][:, w_lo:w_hi])
                out.append(ops.apply_stack_delta(
                    blk, torch.from_numpy(local).to(blk.device), torch.from_numpy(rows).to(blk.device),
                ))
            grid.append(out)
        return MeshArray(placed.mesh, placed.shape, placed.mode, grid)

    def dense(self, idx: Index, field: Field, view_name: str, shards: list[int]):
        """(int32[R, S, W] on the lead device, n_rows): the dense stack,
        gathered from its blocks when it is placed on a mesh (the device
        route under a mesh)."""
        stack, rows = self.matrix(idx, field, view_name, shards)
        return (stack if isinstance(stack, torch.Tensor) else stack.gather()), rows

    def gathered_row(self, idx: Index, field: Field, view_name: str, shards: list[int], row_id: int) -> torch.Tensor:
        """One row of a placed stack as int32[1, S, W] on the lead device
        (the device route's leaf under a mesh); [0, S, W], which K1 reads
        as zero words, for a row outside the stack."""
        stack, _rows = self.matrix(idx, field, view_name, shards)
        if not 0 <= row_id < stack.shape[0]:
            return torch.empty((0,) + tuple(stack.shape[1:]), dtype=torch.int32, device=self.device)
        if isinstance(stack, torch.Tensor):
            return stack[row_id : row_id + 1]
        return stack.gather_row(row_id)

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
                "hotRowUploads": self.hot_row_uploads,
                "entries": len(self._cache),
                "hotEntries": len(self._hot),
                "tieredEntries": len(self._tiered),
                "evictions": sum(self.evictions.values()),
                "residentBytes": self.resident_bytes,
                "budgetBytes": self.STACK_BYTES_BUDGET,
            }

    # ----------------------------------------------------- hot-row stacks
    # The legacy "slots" mode: an over-budget field keeps only an LRU
    # working set of rows on the device, an [H, S, W] slot stack plus a
    # row → slot map. Cold rows live in the host roaring bitmaps and are
    # promoted on first touch (K3, one batched scatter per query).

    def hot_capacity(self, n_shards: int) -> int:
        # HALF the aggregate budget: a full-budget slot stack would evict
        # every dense stack a hybrid query also needs, on every request
        h = (self.STACK_BYTES_BUDGET // 2) // max(1, n_shards * WORDS_PER_SHARD * 4)
        return max(8, 1 << (int(h).bit_length() - 1)) if h >= 8 else 8

    MAX_HOT_ENTRIES = 4  # count cap; the byte ledger is the real bound

    def _hot_entry(self, idx: Index, field: Field, view_name: str, shards):
        """(entry, view), resident rows reconciled with fragment writes.
        Caller holds _lock."""
        view = field.view(view_name)
        key = ("hot", idx.name, field.name, view_name, tuple(shards))
        # the O(1) whole-view fast path of matrix(): stamp read before tokens
        view_ver = view.version if view is not None else None
        entry = self._hot.get(key)
        h = self.hot_capacity(len(shards))
        if entry is not None and entry["h"] == h and view_ver is not None and entry["view_ver"] == view_ver:
            self._hot.move_to_end(key)
            return entry, view
        versions = tuple(self._frag_token(view, s) for s in shards)
        if entry is None or entry["h"] != h:
            nbytes = h * len(shards) * WORDS_PER_SHARD * 4
            self._evict_for(nbytes - self._bytes.get(key, 0), keep=key)
            dev = torch.zeros((h, len(shards), WORDS_PER_SHARD), dtype=torch.int32, device=self.device)
            entry = {"versions": versions, "dev": dev, "slots": OrderedDict(), "h": h, "view_ver": view_ver}
            self._hot[key] = entry
            self._account(key, nbytes)
            self._hot.move_to_end(key)
            while len(self._hot) > self.MAX_HOT_ENTRIES:
                victim, _ = self._hot.popitem(last=False)
                self._forget(victim)
            return entry, view
        self._hot.move_to_end(key)
        if entry["versions"] != versions:
            stale = self._stale_rows(view, shards, entry["versions"], versions)
            if stale is None:
                entry["slots"].clear()
            else:
                self._upload_hot_rows(
                    entry, view, shards,
                    [(r, entry["slots"][r]) for r in stale & set(entry["slots"])],
                )
            entry["versions"] = versions
        entry["view_ver"] = view_ver
        return entry, view

    @staticmethod
    def _stale_rows(view, shards, old_versions, versions) -> "set[int] | None":
        """Rows written between two token tuples, or None when unknowable
        (a fragment created or replaced, or its history trimmed)."""
        stale: set[int] = set()
        for i, s in enumerate(shards):
            old_uid, old_ver = old_versions[i]
            new_uid, _new_ver = versions[i]
            if (old_uid, old_ver) == versions[i]:
                continue
            frag = view.fragment(s) if view else None
            if frag is None or old_uid != new_uid:
                return None
            dirty = frag.dirty_rows_since(old_ver)
            if dirty is None:
                return None
            stale |= dirty
        return stale

    def _upload_hot_rows(self, entry, view, shards, pairs: list[tuple[int, int]]) -> None:
        """One K3 scatter for every (row_id, slot) pair — the slot stack
        is copied per scatter, so k rows must cost one copy, not k.
        Caller holds _lock."""
        if not pairs:
            return
        n_s = len(shards)
        data = np.zeros((len(pairs) * n_s, WORDS_PER_SHARD), dtype=np.uint32)
        idx_arr = np.empty((len(pairs) * n_s, 2), dtype=np.int32)
        for j, (row_id, slot) in enumerate(pairs):
            for i, s in enumerate(shards):
                frag = view.fragment(s) if view else None
                if frag is not None:
                    data[j * n_s + i] = frag.row_packed(row_id)
                idx_arr[j * n_s + i] = (slot, i)
        entry["dev"] = ops.apply_stack_delta(
            entry["dev"],
            torch.from_numpy(idx_arr).to(self.device),
            torch.from_numpy(data.view(np.int32)).to(self.device),
            mode="hot",
        )
        self.hot_row_uploads += len(pairs)

    def hot_batch(self, idx: Index, field: Field, view_name: str, shards: list[int], row_ids: list[int]):
        """Atomically ensure EVERY row in ``row_ids`` is resident and
        return ``(dev [H, S, W], {row_id: slot})`` captured in one
        critical section. The returned tensor is never written again —
        a later promotion scatters into a NEW tensor — so a program
        planned against this pair can never read a reassigned slot."""
        with self._lock:
            entry, view = self._hot_entry(idx, field, view_name, shards)
            slots = entry["slots"]
            need = [r for r in dict.fromkeys(row_ids) if r >= 0]
            if len(need) > entry["h"]:
                raise StackOverBudget(
                    field.name, len(need), len(need) * len(shards) * WORDS_PER_SHARD * 4,
                    self.STACK_BYTES_BUDGET,
                )
            # bump every needed resident row first so the LRU never
            # evicts one member of this batch to admit another
            for r in need:
                if r in slots:
                    slots.move_to_end(r)
            uploads: list[tuple[int, int]] = []
            for r in need:
                if r in slots:
                    continue
                if len(slots) < entry["h"]:
                    slot = len(slots)
                else:
                    _evicted, slot = slots.popitem(last=False)
                slots[r] = slot
                uploads.append((r, slot))
            self._upload_hot_rows(entry, view, shards, uploads)
            return entry["dev"], {r: slots[r] for r in need}

    # ------------------------------------------- tiered compressed residency
    # The default mode: an over-budget field keeps a hot working set of
    # rows resident in per-row containers — dense words, sparse ids or
    # run intervals (residency.choose_container). A cold row serves
    # through a one-shot host-packed plane upload; repeated touches
    # promote it; LRU slot reuse demotes the coldest resident row.

    RESIDENCY_MODE = "tiered"  # or "slots": the hot-row slot stacks above
    MAX_TIERED_ENTRIES = 4  # count cap; the byte ledger is the real bound

    def residency_mode(self) -> str:
        # a multi-host mesh serves over-budget fields through the slots:
        # container payloads are packed from this process's fragments,
        # which no other rank holds (MeshContext.place_block refuses
        # them), while the [H, S, W] slot stack places by shards like
        # every other stack (the reference's compile.py:673-683)
        if self.mesh_ctx is not None and getattr(self.mesh_ctx, "multihost", False):
            return "slots"
        return self.RESIDENCY_MODE

    def is_over_budget(self, idx: Index, field: Field, view_name: str, shards: list[int]) -> bool:
        """Would this field's dense stack exceed the budget? O(1) for a
        dense stack already resident and unchanged (``matrix`` serves it
        from its fast path), else O(S) metadata, no allocation — the
        router's residency probe."""
        view = field.view(view_name)
        if view is not None:
            with self._lock:
                cached = self._cache.get((idx.name, field.name, view_name, tuple(shards)))
            if cached is not None and cached[3] == view.version:
                return False
        r_pad = self._projected_rows(view, shards)
        return len(shards) * r_pad * WORDS_PER_SHARD * 4 > self.STACK_BYTES_BUDGET

    @staticmethod
    def _pack_plane(view, shards: list[int], row_id) -> np.ndarray:
        """Host-packed uint32 [S, W] plane of one row, from the fragments."""
        out = np.zeros((len(shards), WORDS_PER_SHARD), dtype=np.uint32)
        if view is None or row_id is None or row_id < 0:
            return out
        for i, s in enumerate(shards):
            frag = view.fragment(s)
            if frag is not None:
                out[i] = frag.row_packed(row_id)
        return out

    def _tiered_entry(self, idx: Index, field: Field, view_name: str, shards):
        """(key, entry, view), versions reconciled. Caller holds _lock.
        Stale resident rows are DROPPED, not re-uploaded: a write may
        change a row's container kind, so the next touch re-chooses and
        re-packs; touch counts survive, so a hot row re-promotes on its
        next query."""
        view = field.view(view_name)
        key = ("tier", idx.name, field.name, view_name, tuple(shards))
        view_ver = view.version if view is not None else None
        entry = self._tiered.get(key)
        if entry is None:
            entry = TieredEntry(len(shards), self.STACK_BYTES_BUDGET)
            self._tiered[key] = entry
            while len(self._tiered) > self.MAX_TIERED_ENTRIES:
                victim = next(k for k in self._tiered if k != key)
                self._forget_tiered(victim, self._tiered.pop(victim))
                self._note_eviction("tiered")
        # new stores size from the live budget
        entry.budget = self.STACK_BYTES_BUDGET
        self._tiered.move_to_end(key)
        if view_ver is not None and entry.view_ver == view_ver:
            return key, entry, view
        versions = tuple(self._frag_token(view, s) for s in shards)
        if entry.versions != versions:
            stale = (
                None if entry.versions is None
                else self._stale_rows(view, shards, entry.versions, versions)
            )
            if stale is None:
                entry.clear()
            else:
                self.rows_demoted += sum(
                    1 for r in stale if any(r in st["slots"] for st in entry.stores.values())
                )
                entry.drop_rows(stale)
            entry.versions = versions
        entry.view_ver = view_ver
        return key, entry, view

    def _tiered_store(self, entry, kind: str, key: tuple) -> dict:
        """Get-or-create one kind's fixed-capacity device store. Caller
        holds _lock; creation charges the byte ledger (evicting LRU
        entries first) and the per-container gauges."""
        st = entry.stores.get(kind)
        if st is not None:
            return st
        h, _k = entry.capacity(kind, entry.n_shards * WORDS_PER_SHARD)
        if kind == "dense":
            shape, fill = (h, entry.n_shards, WORDS_PER_SHARD), 0
        elif kind == "sparse":
            shape, fill = (h, SPARSE_MAX_IDS), -1
        elif kind == "run":
            shape, fill = (h, RUN_MAX_INTERVALS, 2), 0
        else:
            raise ValueError(f"unknown container kind {kind!r}")
        nbytes = int(np.prod(shape)) * 4
        self._evict_for(nbytes, keep=key)
        dev = torch.full(shape, fill, dtype=torch.int32, device=self.device)
        if self.mesh_ctx is not None:
            dev = self.mesh_ctx.place_block(dev)
        st = {"dev": dev, "slots": OrderedDict(), "free": [], "alloc": 0, "h": h, "nbytes": nbytes}
        entry.stores[kind] = st
        self._account(key, self._bytes.get(key, 0) + nbytes)
        self._container_bytes[kind] += nbytes
        self._push_residency_gauges()
        return st

    def _forget_tiered(self, key: tuple, entry) -> None:
        # caller holds self._lock
        for kind, st in entry.stores.items():
            self._container_bytes[kind] -= st["nbytes"]
        self._forget(key)
        self._push_residency_gauges()

    def _push_residency_gauges(self) -> None:
        if self.stats is None:
            return
        for kind, v in self._container_bytes.items():
            self.stats.gauge("residency_bytes", v, tags={"container": kind})

    def tiered_plan(self, idx: Index, field: Field, view_name: str, shards: list[int], row_id: int) -> tuple[str, str]:
        """Plan-time residency decision for one row leaf →
        ``(container kind, action)``, action one of "resident" (on the
        device already), "promote" (its touches reached the threshold:
        the batch packs and uploads it) or "cold" (a one-shot
        host-packed plane upload). The chooser memoizes per row; a miss
        costs one host row pack and an O(words) scan."""
        with self._lock:
            key, entry, view = self._tiered_entry(idx, field, view_name, shards)
            if row_id is None or row_id < 0:
                return "sparse", "cold"  # unknown key: an all-zero plane
            kind = entry.kinds.get(row_id)
            if kind is not None:
                # LRU, not FIFO: a constantly queried resident row's memo
                # must not age out behind one-shot cold rows
                entry.kinds.move_to_end(row_id)
            else:
                plane = self._pack_plane(view, shards, row_id)
                nbits, nruns = residency.analyze_plane(plane)
                kind = residency.choose_container(nbits, nruns, len(shards) * WORDS_PER_SHARD)
                entry.kinds[row_id] = kind
                while len(entry.kinds) > residency.MAX_TOUCH_ROWS:
                    entry.kinds.popitem(last=False)
            touches = entry.note_touch(row_id)
            if entry.resident(row_id, kind):
                return kind, "resident"
            if touches >= residency.PROMOTE_TOUCHES:
                return kind, "promote"
            return kind, "cold"

    def cold_plane(self, idx: Index, field: Field, view_name: str, shards, row_id: int) -> torch.Tensor:
        """One-shot device upload of a host-packed row plane, as a
        one-row int32 [1, S, W] stack — the pre-promotion cold service."""
        plane = self._pack_plane(field.view(view_name), shards, row_id)
        with self._lock:
            self.cold_uploads += 1
        return torch.from_numpy(plane.view(np.int32)[None]).to(self.device)

    def tiered_batch(self, idx: Index, field: Field, view_name: str, shards: list[int], needs: "list[tuple[int, str]]"):
        """Atomically ensure every (row, kind) pair is resident and
        return ``({kind: store}, {row: slot})`` captured in one critical
        section — hot_batch's immutable-snapshot contract: a promotion
        scatters into a NEW store tensor (K3's copy), so a planned query
        never reads a reassigned slot."""
        with self._lock:
            key, entry, view = self._tiered_entry(idx, field, view_name, shards)
            uniq = list(dict.fromkeys((r, k) for r, k in needs if r >= 0))
            by_kind: dict[str, list[int]] = {}
            for r, k in uniq:
                by_kind.setdefault(k, []).append(r)
            stores = {k: self._tiered_store(entry, k, key) for k in by_kind}
            for k, rows in by_kind.items():
                if len(rows) > stores[k]["h"]:
                    # a query needing more rows of one kind than its store
                    # holds fails EXPLICITLY, never with an evicted slot
                    raise StackOverBudget(
                        f"{field.name} ({k} container store, {stores[k]['h']} slots)",
                        len(rows), len(rows) * len(shards) * WORDS_PER_SHARD * 4,
                        self.STACK_BYTES_BUDGET,
                    )
            # bump resident batch members first so LRU reuse never
            # demotes one member of this batch to admit another
            for k, rows in by_kind.items():
                slots = stores[k]["slots"]
                for r in rows:
                    if r in slots:
                        slots.move_to_end(r)
            slot_map: dict[int, int] = {}
            for k, rows in by_kind.items():
                st = stores[k]
                missing = [r for r in rows if r not in st["slots"]]
                for r in rows:
                    if r in st["slots"]:
                        slot_map[r] = st["slots"][r]
                # pack and validate BEFORE any slot moves: a payload that
                # no longer fits its planned kind must fail with the slot
                # maps untouched
                payloads = {r: self._pack_payload(k, st, view, shards, r) for r in missing}
                uploads: list[tuple[int, int]] = []
                for r in missing:
                    if st["free"]:
                        slot = st["free"].pop()
                    elif st["alloc"] < st["h"]:
                        slot = st["alloc"]
                        st["alloc"] += 1
                    else:
                        demoted, slot = st["slots"].popitem(last=False)
                        entry.kinds.pop(demoted, None)
                        self.rows_demoted += 1
                        if self.stats is not None:
                            self.stats.count("rows_demoted")
                    st["slots"][r] = slot
                    slot_map[r] = slot
                    uploads.append((r, slot))
                if uploads:
                    self._upload_tiered_rows(st, k, payloads, uploads)
                    self.rows_promoted += len(uploads)
                    self.hot_row_uploads += len(uploads)
                    if self.stats is not None:
                        self.stats.count("rows_promoted", len(uploads))
            return {k: st["dev"] for k, st in stores.items()}, slot_map

    def _pack_payload(self, kind: str, st: dict, view, shards, row_id: int) -> np.ndarray:
        """Pack one row for its planned store, validating the fit
        (caller holds _lock and has not yet assigned a slot)."""
        payload = residency.pack_container(kind, self._pack_plane(view, shards, row_id))
        if kind != "dense" and payload.shape[0] > st["dev"].shape[1]:
            raise StackOverBudget(
                f"row {row_id} no longer fits its planned {kind!r} container (changed class mid-plan)",
                1, int(payload.nbytes), self.STACK_BYTES_BUDGET,
            )
        return payload

    def _upload_tiered_rows(self, st: dict, kind: str, payloads: dict, uploads) -> None:
        """Scatter pre-packed, pre-validated payloads into one kind's
        store: one K3 row scatter per batch, into a new store tensor.
        Caller holds _lock."""
        rows = np.full((len(uploads),) + tuple(st["dev"].shape[1:]), -1 if kind == "sparse" else 0, np.int32)
        for j, (row_id, _slot) in enumerate(uploads):
            payload = payloads[row_id]
            if kind == "dense":
                rows[j] = payload.view(np.int32)
            else:
                rows[j, : payload.shape[0]] = payload
        idx_arr = np.array([slot for _r, slot in uploads], dtype=np.int32)
        st["dev"] = ops.scatter_rows(
            st["dev"], torch.from_numpy(idx_arr).to(self.device), torch.from_numpy(rows).to(self.device)
        )

    def tiered_resident(self, idx: Index, field: Field, view_name: str, shards, row_id: int) -> bool:
        """Cheap residency probe (the router's cost model): never
        creates entries, packs planes or bumps touch counts."""
        key = ("tier", idx.name, field.name, view_name, tuple(shards))
        with self._lock:
            entry = self._tiered.get(key)
            if entry is None:
                return False
            kind = entry.kinds.get(row_id)
            return kind is not None and entry.resident(row_id, kind)

    def residency_snapshot(self) -> dict:
        """The ``?profile=true`` residency block (owns the field names,
        like stats_snapshot)."""
        with self._lock:
            return {
                "mode": self.RESIDENCY_MODE,
                "entries": len(self._tiered),
                "residentRows": sum(e.resident_rows() for e in self._tiered.values()),
                "rowsPromoted": self.rows_promoted,
                "rowsDemoted": self.rows_demoted,
                "coldUploads": self.cold_uploads,
                "evictions": dict(self.evictions),
                "bytesByContainer": dict(self._container_bytes),
                "budgetBytes": self.STACK_BYTES_BUDGET,
                "tiers": [
                    {
                        "field": key[2],
                        "view": key[3],
                        "shards": len(key[4]),
                        "rows": {k: len(st["slots"]) for k, st in entry.stores.items()},
                    }
                    for key, entry in self._tiered.items()
                ],
            }

# ------------------------------------------------------------------ plans
class _Planner:
    """Builds the postfix ops of one call tree, plus the arrays (stacks,
    residency stores, one-shot planes) and the (array, row) leaves the
    program reads.

    Over-budget fields resolve at ``materialize`` time as ONE atomic
    hot_batch / tiered_batch per field, so a leaf's slot is a thunk until
    then: plan-time slot binding could go stale if a concurrent query
    evicted a row between planning and the launch.

    The array builders and slot thunks take the planner as their
    argument and close over no planner: a closure over ``self`` would
    make a reference cycle that keeps a finished plan — and the store
    generation it read — alive until the cyclic collector runs.

    With a mesh attached to the stacks, a ``blocked`` plan reads the
    placed stacks themselves (MeshArrays, one K1 launch per block); the
    device route's plan reads each leaf row gathered into a whole plane
    on the lead device, and a BSI stack gathered whole.

    ``sub_words(planner, ops, leaves, conds)`` evaluates a sub-program
    that ``_fit`` cut off into a one-row [1, S, W] plane: K1 words on
    the device route, K1 words per block on the mesh route. Such a plane,
    like a Shift's, claims its bytes from the stack budget until it is
    freed, and is read by one program only: by the outer program, or by
    a later sub-program, which frees it once it has run (a Union planned
    as a left fold holds at most two such planes at a time)."""

    def __init__(
        self, idx: Index, shards: list[int], stacks: StackCache, blocked: bool = False, sub_words=None
    ):
        self.idx = idx
        self.shards = shards
        self.stacks = stacks
        self.blocked = blocked
        self.sub_words = sub_words or _device_words
        self._builders: list = []  # device-array builders, called with the planner
        self._temps: set[int] = set()  # arrays that are temporary planes
        self._array_keys: dict[tuple, int] = {}
        self.arrays: list[torch.Tensor] = []
        # (array index, row id or slot thunk called with the planner)
        self.leaves: list[tuple[int, object]] = []
        # (stack index, depth, op, constant) per CMP
        self.conds: list[tuple[int, int, str, int]] = []
        self._hot_needs: dict[tuple, tuple[Field, str, list[int]]] = {}
        self._hot_resolved: dict[tuple, tuple] = {}
        self._tiered_needs: dict[tuple, tuple[Field, str, list]] = {}
        self._tiered_resolved: dict[tuple, tuple] = {}

    def _add_array(self, key: tuple, build) -> int:
        i = self._array_keys.get(key)
        if i is None:
            i = len(self._builders)
            self._array_keys[key] = i
            self._builders.append(build)
        return i

    def materialize(self) -> list[torch.Tensor]:
        """Resolve the residency batches, then the arrays, in planning
        order (a later builder may read an earlier array)."""
        for fkey, (field, view_name, rows) in self._hot_needs.items():
            self._hot_resolved[fkey] = self.stacks.hot_batch(self.idx, field, view_name, self.shards, rows)
        for fkey, (field, view_name, needs) in self._tiered_needs.items():
            self._tiered_resolved[fkey] = self.stacks.tiered_batch(self.idx, field, view_name, self.shards, needs)
        self.arrays = []
        for b in self._builders:
            self.arrays.append(b(self))
        return self.arrays

    def resolved_leaves(self) -> list[tuple[int, int]]:
        """(array index, row) per leaf; call after materialize()."""
        return [(ai, row(self) if callable(row) else row) for ai, row in self.leaves]

    def _matrix_leaf(self, field: Field, view_name: str, row_id: int):
        op, ai, row = self._leaf(field, view_name, row_id)
        self.leaves.append((ai, row))
        return [(op, len(self.leaves) - 1)]

    def _leaf(self, field: Field, view_name: str, row_id: int):
        """(opcode, array index, row) of one stored row: a row of the
        dense stack; or, over budget, a slot of the hot slot stack
        ("slots" mode) or a tiered residency leaf."""
        try:
            # probing the budget up front raises StackOverBudget at plan
            # time; the check allocates nothing when the stack is cached
            self.stacks.matrix(self.idx, field, view_name, self.shards)
        except StackOverBudget:
            if self.blocked:
                raise  # the router sends trees with tiered leaves to the device route
            if self.stacks.residency_mode() != "slots":
                return self._tiered_leaf(field, view_name, row_id)
            fkey = (field.name, view_name)
            need = self._hot_needs.setdefault(fkey, (field, view_name, []))
            if row_id >= 0:
                need[2].append(row_id)
            ai = self._add_array(("hot",) + fkey, lambda p: p._hot_resolved[fkey][0])
            return OP_LOAD, ai, lambda p: p._hot_resolved[fkey][1].get(row_id, -1)
        if self.stacks.mesh_ctx is not None and not self.blocked:
            ai = self._add_array(
                ("g", field.name, view_name, row_id),
                lambda p: p.stacks.gathered_row(p.idx, field, view_name, p.shards, row_id),
            )
            return OP_LOAD, ai, 0
        ai = self._add_array(
            ("m", field.name, view_name),
            lambda p: p.stacks.matrix(p.idx, field, view_name, p.shards)[0],
        )
        return OP_LOAD, ai, row_id

    def _tiered_leaf(self, field: Field, view_name: str, row_id: int):
        """A row of an over-budget field in tiered mode: a cold row is a
        one-shot [1, S, W] plane (a plain LOAD); a resident one is a slot
        of its kind's store — LOAD of a dense [H, S, W] slot, or K1's
        LOAD_SPARSE / LOAD_RUN of a payload it decodes in place."""
        kind, action = self.stacks.tiered_plan(self.idx, field, view_name, self.shards, row_id)
        if action == "cold":
            ai = self._add_array(
                ("cold", field.name, view_name, row_id),
                lambda p: p.stacks.cold_plane(p.idx, field, view_name, p.shards, row_id),
            )
            return OP_LOAD, ai, 0
        fkey = (field.name, view_name)
        need = self._tiered_needs.setdefault(fkey, (field, view_name, []))
        need[2].append((row_id, kind))
        ai = self._add_array(("tier", kind) + fkey, lambda p: p._tiered_resolved[fkey][0][kind])
        op = {"dense": OP_LOAD, "sparse": OP_LOAD_SPARSE, "run": OP_LOAD_RUN}[kind]
        return op, ai, lambda p: p._tiered_resolved[fkey][1].get(row_id, -1)

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

    def _shift(self, child: Call, n: int):
        """Shift(child, n) as a leaf: a sub-program evaluates the child
        into a temporary [S, W] plane (K1 words), K7 shifts it, and the
        result enters this program as a one-row [1, S, W] stack."""
        sub = _Planner(self.idx, self.shards, self.stacks)
        prog = sub.program(child)

        def shifted() -> torch.Tensor:
            words = ops.tree_eval(
                sub.materialize(), sub.resolved_leaves(), prog, len(sub.shards), count=False,
                device=sub.stacks.device, conds=sub.conds,
            )
            sub.arrays = []  # the sub-program's own planes go now
            return ops.shift_words(words, n)[None]

        # a fresh key per Shift node: two shifts of one subtree are two planes
        ai = self._add_array(("shift", len(self._builders)), lambda p: p._temp_plane(shifted, ()))
        self._temps.add(ai)
        self.leaves.append((ai, 0))
        return [(OP_LOAD, len(self.leaves) - 1)]

    # ---------------------------------------------------------- call tree
    def program(self, call: Call):
        """→ postfix ops of ``call`` within K1's fixed limits, each
        sub-program cut off by ``_fit`` checked against them too."""
        prog = self._fit(self.plan(call))
        check_program(prog, len(self.leaves), len(self.conds))
        return prog

    def _fit(self, prog):
        """Split a program past K1's fixed limits (C4) into sub-programs.

        The reference's planner has no such limit: XLA fuses any tree.
        Here the postfix program is walked as a tree of fragments; where
        joining two operands would pass a limit, the heavier one (by its
        largest share of a limit) is cut off: a sub-program evaluating it
        into a temporary plane, which the outer program reads with one
        LOAD. A 300-leaf Union becomes a sub-program of 256 leaves whose
        plane the outer program ORs with the other 44, a stack 33 deep is
        cut where it reaches 32, and 17 conditions are cut into groups of
        at most 16. The planes are arrays of this plan
        and go with it when the query ends. Rebinds ``leaves`` and
        ``conds`` to the outer program's own."""
        if _fits((len(prog), len(self.leaves), len(self.conds), program_depth(prog))):
            return prog
        frags = []  # (ops over this planner's leaves and conds, n ops, n leaves, n conds, depth)
        for op, arg in prog:
            if op in _PUSHES:
                frags.append(([(op, arg)], 1, int(op in _LOADS), int(op == OP_CMP), 1))
                continue
            b, a = frags.pop(), frags.pop()
            while True:
                joined = (a[0] + b[0] + [(op, 0)], a[1] + b[1] + 1, a[2] + b[2], a[3] + b[3], max(a[4], b[4] + 1))
                if _fits(joined[1:]):
                    break
                if _weight(a) >= _weight(b):
                    a = self._spill(a)
                else:
                    b = self._spill(b)
            frags.append(joined)
        (top,) = frags
        out, self.leaves, self.conds = self._local(top[0])
        return out

    def _local(self, frag_ops):
        """A fragment's ops re-indexed onto its own leaf and condition
        lists → (ops, leaves, conds)."""
        leaves, conds, out = [], [], []
        for op, arg in frag_ops:
            if op in _LOADS:
                leaves.append(self.leaves[arg])
                arg = len(leaves) - 1
            elif op == OP_CMP:
                conds.append(self.conds[arg])
                arg = len(conds) - 1
            out.append((op, arg))
        return out, leaves, conds

    def _spill(self, frag):
        """Cut a fragment off as a sub-program → the one-LOAD fragment
        of the plane it writes."""
        prog, leaves, conds = self._local(frag[0])
        check_program(prog, len(leaves), len(conds))
        reads = {si for si, _r in leaves} & self._temps
        ai = self._add_array(
            ("split", len(self._builders)),
            lambda p: p._temp_plane(
                lambda: p.sub_words(p, prog, [(si, r(p) if callable(r) else r) for si, r in leaves], conds),
                reads,
            ),
        )
        self._temps.add(ai)
        self.leaves.append((ai, 0))
        return ([(OP_LOAD, len(self.leaves) - 1)], 1, 1, 0, 1)

    def _temp_plane(self, make, reads):
        """``make()``'s one-row plane, its bytes claimed from the stack
        budget until the plane is dropped; then the temporary planes
        ``reads``, which only the sub-program just run read, are freed."""
        token = self.stacks.claim(len(self.shards) * WORDS_PER_SHARD * 4)
        try:
            plane = make()
        except BaseException:
            self.stacks.release(token)
            raise
        anchor = plane.blocks[0][0] if hasattr(plane, "blocks") else plane  # a placed plane's first block
        weakref.finalize(anchor, self.stacks.release, token)
        for si in reads:
            self.arrays[si] = _emptied(self.arrays[si])
        return plane

    def plan(self, call: Call):
        """→ postfix ops evaluating to one [S, W] plane, before ``_fit``"""
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
            if len(call.children) != 1:
                raise PlanError("Shift() takes exactly one call")
            n = call.arg("n", 1)
            if not isinstance(n, int) or n < 0:
                raise PlanError(f"Shift() n must be a non-negative integer, got {n!r}")
            if n == 0:
                return self.plan(call.children[0])
            if self.blocked:
                raise PlanError("Shift has no blocked program (MESH_FALLBACK_CALLS)")
            return self._shift(call.children[0], n)
        raise PlanError(f"{name!r} is not a bitmap call")

    def _bsi(self, field: Field) -> int:
        """Index of the field's [P, S, W] BSI stack among the planner's
        arrays. Over budget, in tiered mode, each of its 2 + D slice rows
        is a residency leaf and the block is a [2 + D, S, W] tensor that
        K1 fills slice by slice in words mode (the reference stacks the
        decoded slices inside its program); slots mode raises
        StackOverBudget here, as the reference's does."""
        try:
            self.stacks.matrix(self.idx, field, VIEW_BSI, self.shards)
        except StackOverBudget:
            if self.blocked or self.stacks.residency_mode() == "slots":
                raise
            slices = [self._leaf(field, VIEW_BSI, d) for d in range(BSI_OFFSET + field.bit_depth)]
            return self._add_array(("bsitier", field.name), lambda p: p._bsi_block(slices))
        if self.stacks.mesh_ctx is not None and not self.blocked:
            return self._add_array(
                ("mg", field.name, VIEW_BSI),
                lambda p: p.stacks.dense(p.idx, field, VIEW_BSI, p.shards)[0],
            )
        return self._add_array(
            ("m", field.name, VIEW_BSI),
            lambda p: p.stacks.matrix(p.idx, field, VIEW_BSI, p.shards)[0],
        )

    def _bsi_block(self, slices) -> torch.Tensor:
        """[2 + D, S, W] from the slice leaves: one K1 words launch per
        slice, each writing its plane of the block."""
        n_s = len(self.shards)
        block = torch.empty((len(slices), n_s, WORDS_PER_SHARD), dtype=torch.int32, device=self.stacks.device)
        for d, (op, ai, row) in enumerate(slices):
            leaf = (0, row(self) if callable(row) else row)
            ops.tree_eval([self.arrays[ai]], [leaf], [(op, 0)], n_s, count=False, out=block[d])
        return block

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


def _device_words(p: _Planner, prog, leaves, conds) -> torch.Tensor:
    """A cut-off sub-program as K1 words over the arrays built so far →
    one-row [1, S, W] plane."""
    return ops.tree_eval(
        p.arrays, leaves, prog, len(p.shards), count=False, device=p.stacks.device, conds=conds,
    )[None]


def _emptied(a):
    """A freed plane's stand-in among a plan's arrays: no rows, and
    otherwise the plane's kind (tensor or placed), shape and device."""
    empty = lambda b: torch.empty((0,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)  # noqa: E731
    if hasattr(a, "blocks"):
        return type(a)(a.mesh, (0,) + a.shape[1:], a.mode, [[empty(b) for b in row] for row in a.blocks])
    return empty(a)


_LIMITS = (TREE_MAX_OPS, TREE_MAX_LEAVES, TREE_MAX_CONDS, TREE_MAX_STACK)


def _fits(sizes) -> bool:
    """(ops, leaves, conds, depth) within K1's fixed limits"""
    return all(n <= most for n, most in zip(sizes, _LIMITS))


def _weight(frag) -> float:
    """A fragment's largest share of one of K1's limits."""
    return max(n / most for n, most in zip(frag[1:], _LIMITS))


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
    program serves both the count and the words mode.

    With a mesh context spanning more than one position, a
    MeshQueryEngine (parallel/mesh.py) serves the mesh route: the same
    plans, run per block with a reduction tree. ``device`` is then the
    mesh's lead device."""

    def __init__(self, device: "str | torch.device" = "cuda", stats=None, mesh_ctx=None):
        self.device = ops.resolve_device(device)
        self.mesh_ctx = mesh_ctx
        if mesh_ctx is not None and mesh_ctx.lead != self.device:
            raise ValueError(f"the mesh's lead device {mesh_ctx.lead} is not the compiler's {self.device}")
        self.stacks = StackCache(self.device, stats=stats, mesh_ctx=mesh_ctx)
        self._scalar_arrays: dict[tuple, torch.Tensor] = {}
        self._mesh_scalars: dict[tuple, dict] = {}
        self._ones: dict[int, torch.Tensor] = {}
        self._mesh_ones: dict[int, object] = {}
        self.mesh_engine = None
        if mesh_ctx is not None and mesh_ctx.n_devices > 1:
            from pilosa_tpu_torch.parallel.mesh import MeshQueryEngine

            self.mesh_engine = MeshQueryEngine(mesh_ctx.mesh)
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

    def mesh_scalars(self, values: list[int]) -> dict:
        """``device_scalars`` placed for the mesh: one int32 copy on
        every device of the mesh, cached by value."""
        key = tuple(values)
        cached = self._mesh_scalars.get(key)
        if cached is None:
            if len(self._mesh_scalars) >= 4096:
                self._mesh_scalars.clear()
            cached = self.mesh_ctx.replicate(torch.tensor(key, dtype=torch.int32))
            self._mesh_scalars[key] = cached
        return cached

    def mesh_ones(self, n_shards: int):
        """``ones`` placed for the mesh (GroupBy's base mask), cached per
        shard count."""
        plane = self._mesh_ones.get(n_shards)
        if plane is None:
            self._mesh_ones.clear()
            plane = self.mesh_ctx.place_rows(np.full((n_shards, WORDS_PER_SHARD), -1, dtype=np.int32))
            self._mesh_ones[n_shards] = plane
        return plane

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
        """(arrays, leaves, program, conditions) for one call tree,
        checked against the kernel's limits."""
        planner = _Planner(idx, shards, self.stacks)
        ops_list = planner.program(call)
        arrays = planner.materialize()
        return arrays, planner.resolved_leaves(), ops_list, planner.conds

    def planned_filter(self, idx: Index, call: Call, shards: list[int]) -> "ops.PlannedFilter":
        """A filter's call tree planned against its materialized planes,
        launching nothing but the K1 words launches of its sub-programs
        (a Shift's, and those ``_Planner._fit`` cuts off a tree past K1's
        limits): what K2, K4 and K5 evaluate inside their own launch, as
        the reference's aggregates evaluate ``_filter_plan`` inside their
        program."""
        arrays, leaves, prog, conds = self._plan(idx, call, shards)
        return ops.PlannedFilter(arrays, leaves, prog, conds, len(shards), WORDS_PER_SHARD)

    def bitmap_device(self, idx: Index, call: Call, shards: list[int]) -> torch.Tensor:
        """Evaluate a bitmap call for all shards in one launch → device
        int32[S, W]."""
        arrays, leaves, prog, conds = self._plan(idx, call, shards)
        return ops.tree_eval(
            arrays, leaves, prog, len(shards), count=False, device=self.device, conds=conds,
        )

    def bitmap_words(self, idx: Index, call: Call, shards: list[int]) -> np.ndarray:
        return self.bitmap_device(idx, call, shards).cpu().numpy().view(np.uint32)

    def count_async(self, idx: Index, call: Call, shards: list[int]) -> torch.Tensor:
        """Device int64 scalar (not synced) — callers pipeline many
        queries before paying the device→host readback.

        When the whole tree is ONE sparse or run container leaf, K8
        counts the payload directly: no [S, W] plane, even in
        registers."""
        arrays, leaves, prog, conds = self._plan(idx, call, shards)
        if len(prog) == 1 and prog[0][0] in (OP_LOAD_SPARSE, OP_LOAD_RUN):
            si, slot = leaves[prog[0][1]]
            return ops.container_count(arrays[si], slot)
        return ops.tree_eval(
            arrays, leaves, prog, len(shards), count=True, device=self.device, conds=conds,
        )

    def tiered_bsi_block(self, idx: Index, field: Field, shards: list[int]) -> torch.Tensor:
        """The [P, S, W] BSI block of an int field for the aggregates
        (Sum, Min, Max, GroupBy's Sum): assembled from tiered slice rows
        when the dense stack is over budget (``_Planner._bsi``)."""
        planner = _Planner(idx, shards, self.stacks)
        si = planner._bsi(field)
        return planner.materialize()[si]

    # ------------------------------------------------------ mesh programs
    # The mesh route: the planner above, run blocked (its arrays are the
    # placed stacks), and the MeshQueryEngine's builders launching K1 per
    # block with the reduction tree.

    def mesh_mode(self, n_shards: int) -> str | None:
        """The placement mode serving this shard count, or None when no
        mesh engine is attached or the shape only replicates."""
        if self.mesh_engine is None:
            return None
        return self.mesh_engine.spec_mode(n_shards, WORDS_PER_SHARD)

    def mesh_plan(self, idx: Index, call: Call, shards: list[int], mode: str):
        """(BlockPlan, placed arrays) of a bitmap call tree for the mesh
        route; every array is placed in ``mode``."""
        from pilosa_tpu_torch.parallel.mesh import BlockPlan

        def sub_words(p: _Planner, prog, leaves, conds):
            plan = BlockPlan(prog, leaves, conds, len(shards), WORDS_PER_SHARD)
            return self.mesh_engine.bitmap_tree(plan, mode)(p.arrays)[None]

        planner = _Planner(idx, shards, self.stacks, blocked=True, sub_words=sub_words)
        ops_list = planner.program(call)
        arrays = planner.materialize()
        for a in arrays:
            if getattr(a, "mode", None) != mode:
                raise PlanError(f"a leaf array is not placed in {mode!r} mode")
        plan = BlockPlan(ops_list, planner.resolved_leaves(), planner.conds, len(shards), WORDS_PER_SHARD)
        return plan, arrays

    def mesh_bitmap_device(self, idx: Index, call: Call, shards: list[int]):
        """A bitmap call tree as K1 words per block → placed int32[S, W]."""
        mode = self.mesh_mode(len(shards))
        plan, arrays = self.mesh_plan(idx, call, shards, mode)
        run = self.mesh_engine.bitmap_tree(plan, mode)
        return self.mesh_engine.dispatch("bitmap", run, arrays)

    def mesh_bitmap_words(self, idx: Index, call: Call, shards: list[int]) -> np.ndarray:
        """Synchronous mesh bitmap: each block read back into its place
        of the host plane (spanned as ``mesh.collective``)."""
        from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER

        placed = self.mesh_bitmap_device(idx, call, shards)
        with GLOBAL_TRACER.span("mesh.collective", program="bitmap", devices=self.mesh_engine.n_devices):
            return placed.host().view(np.uint32)

    def mesh_count_async(self, idx: Index, call: Call, shards: list[int]) -> torch.Tensor:
        """Count as K1 counts per block and the reduction tree → int64 on
        the lead device (not synced); rides the readback wave."""
        mode = self.mesh_mode(len(shards))
        plan, arrays = self.mesh_plan(idx, call, shards, mode)
        run = self.mesh_engine.count_tree(plan, mode)
        return self.mesh_engine.dispatch("count", run, arrays)

    def mesh_snapshot(self) -> dict:
        """The mesh engine's counters (``meshExecution``)."""
        if self.mesh_engine is None:
            return {"attached": False}
        out = {"attached": True}
        out.update(self.mesh_engine.snapshot())
        return out
