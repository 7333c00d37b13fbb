"""Device-mesh query execution: PQL reads as blocked kernel launches.

Reference: pilosa_tpu/parallel/mesh.py (B16), where a mesh of TPU chips
holds the stacked field arrays under a ``NamedSharding`` and every read
call is one ``shard_map`` program whose reduction is a ``psum`` over ICI.
Here the mesh is a (shards × words) grid of ``torch.device`` positions:

- axis ``"shards"`` splits the column space (whole shards per position);
- axis ``"words"`` splits each shard's packed word axis, so one row is a
  distributed bit vector and only the aggregations communicate.

One device may stand for several positions (``cpu`` × 8 in the tests,
``cuda:0`` × 8 on a one-card machine): that checks the blocked programs,
their block shapes, the reduction trees and the readback order, but not
scaling across cards.

A placed array is a ``MeshArray``: the global shape, the placement mode
and a ``[shards][words]`` grid of contiguous int32 blocks, each on its
position's device. A program launches the existing hand-written kernels
(K1, K2, K4, K5, K6, K11) once per block on the block's device, and the
collective is explicit: the partials are copied onto the lead device
(``.to``, which orders the copy after the kernel on the source device's
stream) and summed, words axis first and then shards, as ``_psum_both``
orders the reference's reduction. K12 (csrc/mesh_finish.cu) finishes the
similarity programs on the reduced counts and K10 selects their top k.

The demo and bench programs of the reference (``count_and``, ``topn``,
``bsi_sum``, ``ingest_and_aggregate``, with ``place_matrix`` and
``place_row``) run the same way over grid-placed arrays: K2, K4 or K13
(csrc/ingest_counts.cu, the ingest step, in place) per block, the
reduction tree, and for ``topn`` the integer top-k (K12's count keys,
K10's int mode) on the lead device.

A mesh may span processes (B16m; ``parallel/multihost.py`` builds one
over a ``torch.distributed`` group). Each process then holds the blocks
of its own positions only, runs the kernels on them, and the reduction
tree ends in a cross-process sum: this rank's partials are summed words
first, then shards, and the result is all-reduced over the group, so
every rank gets the same reduced values and finishes the program (the
Min/Max merge, the integer and similarity top-k) identically. A program
over such a mesh is a collective: every rank calls the same programs in
the same order, or the group waits for the rank that did not (the
reference's lockstep contract, pilosa_tpu/server/server.py:485-494; the
serving mesh stays local for that reason).
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from pilosa_tpu_torch import ops
from pilosa_tpu_torch.ops import similarity
from pilosa_tpu_torch.ops.bsi import OFFSET_ROW, weigh_device
from pilosa_tpu_torch.ops._cuda import resolve_device
from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER

AXIS_SHARDS = "shards"
AXIS_WORDS = "words"

# ----------------------------------------------------- mesh read coverage
# The serving-path surface, as the reference's literals: every bitmap call
# type has a blocked program or a fallback annotation.
MESH_PROGRAMS = {
    "Row",
    "Range",
    "Union",
    "Intersect",
    "Difference",
    "Xor",
    "Not",
    "All",
}
# aggregates served as blocked programs with a reduction tree
MESH_AGGREGATES = {"Count", "Sum", "Min", "Max", "TopN", "GroupBy"}
# call types the mesh route hands back to the device route, which gathers
# each leaf row's blocks into a whole plane on the lead device. Shift's
# cross-word carry crosses block boundaries whenever the words axis is
# split.
MESH_FALLBACK_CALLS = {"Shift"}


def mesh_supported(call) -> bool:
    """Can this call tree execute as blocked mesh programs? A
    fallback-annotated call anywhere in the tree sends the whole query
    down the device route. GroupBy's Rows() children and its
    aggregate=Sum() are row universes and aggregate specs, not bitmap
    subtrees: only its filter matters."""
    name = call.name
    if name == "Options":
        return all(mesh_supported(ch) for ch in call.children)
    if name in MESH_FALLBACK_CALLS:
        return False
    if name == "GroupBy":
        filt = call.arg("filter")
        if filt is not None and hasattr(filt, "name") and not mesh_supported(filt):
            return False
        return all(ch.name == "Rows" or mesh_supported(ch) for ch in call.children)
    if name in MESH_PROGRAMS or name in MESH_AGGREGATES:
        return all(mesh_supported(ch) for ch in call.children)
    return False


# ------------------------------------------------------------------ mesh
class DeviceMesh:
    """A (shards × words) grid of devices; ``grid[i][j]`` is position
    (i, j). Positions run shards-major, the order of the reference's
    ``P(None, (shards, words))``. The lead device holds the reduced
    results: position (0, 0), or on a mesh that spans processes the first
    position of this rank.

    ``owners[i]`` is the rank of the process that holds shard row i (a
    words row never spans processes), and ``rank`` is this process's;
    None where one process holds every position."""

    def __init__(self, grid: "list[list[torch.device]]", owners: "list[int] | None" = None, rank: int = 0):
        self.grid = grid
        self.shape = {AXIS_SHARDS: len(grid), AXIS_WORDS: len(grid[0])}
        if owners is not None and len(owners) != len(grid):
            raise ValueError(f"{len(owners)} owners for {len(grid)} shard rows")
        self.owners = owners if owners is not None and len(set(owners)) > 1 else None
        self.rank = rank
        if self.owners is not None and rank not in self.owners:
            raise ValueError(f"rank {rank} holds no position of the mesh")
        self._lead = next(row[0] for i, row in enumerate(grid) if self.owns(i))

    @property
    def size(self) -> int:
        return self.shape[AXIS_SHARDS] * self.shape[AXIS_WORDS]

    @property
    def multiprocess(self) -> bool:
        """Do the positions span more than one process?"""
        return self.owners is not None

    @property
    def n_processes(self) -> int:
        return len(set(self.owners)) if self.owners is not None else 1

    def owns(self, i: int) -> bool:
        """Does this process hold shard row ``i``?"""
        return self.owners is None or self.owners[i] == self.rank

    @property
    def lead(self) -> torch.device:
        return self._lead


def make_mesh(devices=None, words_axis: int = 1) -> DeviceMesh:
    """2-D device mesh (shards × words) over ``devices`` (every CUDA card
    by default). A device may repeat; ``words_axis`` > 1 splits the packed
    word axis across positions."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device for a mesh; pass devices=['cpu'] * n for the CPU")
    devs = [resolve_device(d) for d in devices]
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh takes devices of one type, got {sorted({d.type for d in devs})}")
    n = len(devs)
    if words_axis < 1 or n % words_axis:
        raise ValueError(f"{n} devices not divisible by words_axis={words_axis}")
    return DeviceMesh([devs[i : i + words_axis] for i in range(0, n, words_axis)])


# ------------------------------------------------------------- placement
class MeshArray:
    """A global int32 (or f32) array placed over a mesh as contiguous
    blocks, ``blocks[i][j]`` on position (i, j)'s device. The modes, over
    the array's last two axes [.., S, W]:

    - ``grid``: S split over the shards axis, W over the words axis
      (``P(.., shards, words)``);
    - ``words``: W split over all positions in shards-major order
      (``P(.., None, (shards, words))``);
    - ``replicate``: one whole copy on the lead device, ``blocks[0][0]``
      (one process holds one copy: ``P()``);
    - ``rows``: S split over the shards axis, whole over the words axis,
      one block per shard row on its position (i, 0) (``P(shards, None)``);
    - ``cols``: W split over the words axis, the same slice in every
      shard row (``P(None, words)``).

    On a mesh that spans processes, a block of another rank's position
    is None here."""

    __slots__ = ("mesh", "shape", "mode", "blocks")

    def __init__(self, mesh: DeviceMesh, shape: tuple, mode: str, blocks: list):
        self.mesh, self.shape, self.mode, self.blocks = mesh, tuple(shape), mode, blocks

    @property
    def dtype(self) -> torch.dtype:
        return next(b for _i, _j, b in self.items()).dtype

    def cover(self, i: int, j: int) -> tuple[int, int, int, int]:
        """(s_lo, s_hi, w_lo, w_hi): the global range of the last two
        axes that block (i, j) holds."""
        return _cover(self.mesh, self.shape[-2], self.shape[-1], self.mode, i, j)

    def items(self):
        """(i, j, block) for every block this process holds,
        shards-major."""
        for i, row in enumerate(self.blocks):
            for j, blk in enumerate(row):
                if blk is not None:
                    yield i, j, blk

    def _addressable(self, what: str) -> None:
        if self.mesh.multiprocess:
            raise ValueError(
                f"{what}: this array spans {self.mesh.n_processes} processes and this one holds "
                "only its own blocks; reduce it with a mesh program (the reference's "
                "non-addressable global array cannot be fetched either)"
            )

    @property
    def nbytes(self) -> int:
        """Device bytes, each block counted once."""
        return sum(b.numel() * b.element_size() for _i, _j, b in self.items())

    def gather(self) -> torch.Tensor:
        """The whole array, assembled on the lead device in the
        placement's order."""
        self._addressable("gather")
        lead = self.mesh.lead
        if self.mode == "replicate":
            return self.blocks[0][0]
        if self.mode == "rows":
            return torch.cat([row[0].to(lead) for row in self.blocks], dim=-2)
        if self.mode == "cols":
            return torch.cat([b.to(lead) for b in self.blocks[0]], dim=-1)
        if self.mode == "words":
            return torch.cat([b.to(lead) for _i, _j, b in self.items()], dim=-1)
        return torch.cat([torch.cat([b.to(lead) for b in row], dim=-1) for row in self.blocks], dim=-2)

    def gather_row(self, r: int) -> torch.Tensor:
        """Row ``r`` of the leading axis as a [1, S, W] tensor on the lead
        device."""
        self._addressable("gather_row")
        if self.mode == "replicate":
            return self.blocks[0][0][r : r + 1]
        lead = self.mesh.lead
        out = torch.empty((1,) + self.shape[1:], dtype=self.dtype, device=lead)
        for i, j, b in self.items():
            s_lo, s_hi, w_lo, w_hi = self.cover(i, j)
            out[0, s_lo:s_hi, w_lo:w_hi].copy_(b[r])
        return out

    def host(self) -> np.ndarray:
        """The whole array as a host numpy array, each block copied into
        its place."""
        self._addressable("host")
        t = self.dtype
        np_dtype = np.float32 if t == torch.float32 else np.int64 if t == torch.int64 else np.int32
        out = np.empty(self.shape, dtype=np_dtype)
        seen = set()
        for i, j, b in self.items():
            cov = self.cover(i, j)
            if cov in seen:
                continue
            seen.add(cov)
            s_lo, s_hi, w_lo, w_hi = cov
            out[..., s_lo:s_hi, w_lo:w_hi] = b.cpu().numpy()
        return out

    def __getitem__(self, key) -> "MeshArray":
        """``a[None]`` (a new leading axis of 1) or ``a[lo:hi]`` (a slice
        of the leading axis), as views of the blocks."""
        if key is None:
            shape = (1,) + self.shape
        elif isinstance(key, slice):
            shape = (len(range(*key.indices(self.shape[0]))),) + self.shape[1:]
        else:
            raise TypeError(f"a MeshArray takes [None] or a leading slice, not {key!r}")
        return MeshArray(self.mesh, shape, self.mode, _map_blocks(self.blocks, lambda b: b[key]))

    def row(self, r: int) -> "MeshArray":
        """Row ``r`` of the leading axis as a placed [S, W] array (views
        of the blocks)."""
        return MeshArray(self.mesh, self.shape[1:], self.mode, _map_blocks(self.blocks, lambda b: b[r]))


def _map_blocks(blocks: list, fn) -> list:
    """``fn`` of every held block, None where another rank holds it."""
    return [[None if b is None else fn(b) for b in row] for row in blocks]


def _cover(mesh: DeviceMesh, n_s: int, n_w: int, mode: str, i: int, j: int) -> tuple[int, int, int, int]:
    ns, nw = mesh.shape[AXIS_SHARDS], mesh.shape[AXIS_WORDS]
    if mode == "grid":
        sl, wl = n_s // ns, n_w // nw
        return i * sl, (i + 1) * sl, j * wl, (j + 1) * wl
    if mode == "words":
        wl = n_w // (ns * nw)
        p = i * nw + j
        return 0, n_s, p * wl, (p + 1) * wl
    if mode == "rows":
        sl = n_s // ns
        return i * sl, (i + 1) * sl, 0, n_w
    if mode == "cols":
        wl = n_w // nw
        return 0, n_s, j * wl, (j + 1) * wl
    return 0, n_s, 0, n_w


def _block_positions(mesh: DeviceMesh, mode: str) -> "list[list[tuple[int, int]]]":
    """The positions that hold a block in ``mode``, as the blocks grid."""
    ns, nw = mesh.shape[AXIS_SHARDS], mesh.shape[AXIS_WORDS]
    if mode == "replicate":
        if mesh.multiprocess:
            raise ValueError("a mesh that spans processes places no replicated array: every rank would hold a copy")
        return [[(0, 0)]]
    if mode == "rows":
        return [[(i, 0)] for i in range(ns)]
    return [[(i, j) for j in range(nw)] for i in range(ns)]


def empty_like_placement(mesh: DeviceMesh, shape: tuple, mode: str, dtype=torch.int32) -> MeshArray:
    """Uninitialized blocks for a global ``shape`` in ``mode``, for this
    process's positions (None at another rank's)."""
    grid = []
    for row in _block_positions(mesh, mode):
        out = []
        for i, j in row:
            if not mesh.owns(i):
                out.append(None)
                continue
            s_lo, s_hi, w_lo, w_hi = _cover(mesh, shape[-2], shape[-1], mode, i, j)
            out.append(torch.empty(tuple(shape[:-2]) + (s_hi - s_lo, w_hi - w_lo), dtype=dtype, device=mesh.grid[i][j]))
        grid.append(out)
    return MeshArray(mesh, shape, mode, grid)


def _as_tensor(arr):
    if isinstance(arr, np.ndarray):
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return arr


def place(mesh: DeviceMesh, arr, mode: str) -> MeshArray:
    """A whole array (numpy uint32/int32/f32, or a tensor) placed in
    ``mode``: each block is a contiguous copy of its slice, on its
    position's device. On a mesh that spans processes every rank passes
    the whole array and places its own blocks of it
    (``MeshContext(mesh, multihost=True)`` places each rank's share
    instead)."""
    arr = _as_tensor(arr)
    out = empty_like_placement(mesh, tuple(arr.shape), mode, arr.dtype)
    for i, j, b in out.items():
        s_lo, s_hi, w_lo, w_hi = out.cover(i, j)
        b.copy_(arr[..., s_lo:s_hi, w_lo:w_hi])
    return out


class MeshContext:
    """Serving-path placement over a (shards × words) mesh: the stack
    cache places the executor's stacked field arrays through it, and
    QueryCompiler attaches a MeshQueryEngine when it spans more than one
    position. Processes with one card use no context (None).

    ``multihost``: the mesh spans processes, and each process places its
    own share of a global array: its local ``[.., S_local, W]`` is the
    slice of a global ``[.., S_local × processes, W]`` that its shard rows
    cover, in rank order. Every process must then place the same shapes
    in the same order (each placement is a collective)."""

    def __init__(self, mesh: DeviceMesh, multihost: bool = False):
        self.mesh = mesh
        self.multihost = multihost

    @classmethod
    def auto(cls, words_axis: int = 1, devices=None) -> "MeshContext | None":
        """A context over every CUDA card, or None with fewer than two
        (repeated positions are for explicit construction only)."""
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = list(devices)
        if len(devices) <= 1:
            return None
        return cls(make_mesh(devices, words_axis=words_axis))

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def lead(self) -> torch.device:
        return self.mesh.lead

    def mode_for(self, n_shards: int, n_words: int) -> str:
        """The placement rule of the reference's ``_spec``: ``grid`` when
        S divides the shards axis and W the words axis; else ``words``
        when W divides the position count; else ``replicate``."""
        if n_shards % self.mesh.shape[AXIS_SHARDS] == 0 and n_words % self.mesh.shape[AXIS_WORDS] == 0:
            return "grid"
        if n_words % self.n_devices == 0:
            return "words"
        return "replicate"

    def _check_uniform_s(self, shape: tuple) -> None:
        """The global shape is ``S_local × processes``, coherent only when
        every process places the same local shape: one all-gather of the
        local shapes, on every placement. Never cached: a placement is a
        collective, and a cache on one rank would skip the exchange the
        others enter."""
        import torch.distributed as dist

        shapes = [tuple(shape)]
        if dist.is_initialized():
            shapes = [None] * dist.get_world_size()
            dist.all_gather_object(shapes, tuple(shape))
        counts = [s[-2] for s in shapes]
        if len(set(counts)) != 1:
            raise ValueError(
                f"multi-host placement needs a uniform per-process shard count; got {counts} "
                "— pad every process to the same S (empty shards are all-zero rows)"
            )
        if len(set(shapes)) != 1:
            raise ValueError(f"multi-host placement needs one local shape on every process; got {shapes}")

    def _place_share(self, arr) -> MeshArray:
        """This process's share ``[.., S_local, W]`` → its blocks of the
        global ``[.., S_local × processes, W]``, grid mode only (the
        reference's ``_place``, pilosa_tpu/parallel/mesh.py:193-212)."""
        arr = _as_tensor(arr)
        self._check_uniform_s(tuple(arr.shape))
        s, w = arr.shape[-2], arr.shape[-1]
        s_global = s * self.mesh.n_processes
        if self.mode_for(s_global, w) != "grid":
            raise ValueError(
                f"multi-host placement needs the shards axis sharded: global S={s_global} not "
                f"divisible by mesh {self.mesh.shape[AXIS_SHARDS]} shard rows (or W={w} by "
                f"{self.mesh.shape[AXIS_WORDS]} words)"
            )
        shape = tuple(arr.shape[:-2]) + (s_global, w)
        out = empty_like_placement(self.mesh, shape, "grid", arr.dtype)
        covers = [out.cover(i, j) for i, j, _b in out.items()]
        lo, hi = min(c[0] for c in covers), max(c[1] for c in covers)
        if hi - lo != s:
            raise ValueError(
                f"rank {self.mesh.rank}'s shard rows cover {hi - lo} global shards, not its {s}: "
                "every process must offer the same number of devices"
            )
        for (i, j, b), (s_lo, s_hi, w_lo, w_hi) in zip(out.items(), covers):
            b.copy_(arr[..., s_lo - lo : s_hi - lo, w_lo:w_hi])
        return out

    def place_stack(self, stacked) -> MeshArray:
        """[R, S, W] (or a [P, S, W] BSI block) → placed; multi-host, S is
        this process's shard count."""
        if self.multihost:
            return self._place_share(stacked)
        return place(self.mesh, stacked, self.mode_for(stacked.shape[-2], stacked.shape[-1]))

    def place_rows(self, arr) -> MeshArray:
        """[S, W] → placed; multi-host, S is this process's shard count."""
        if self.multihost:
            return self._place_share(arr)
        return place(self.mesh, arr, self.mode_for(arr.shape[-2], arr.shape[-1]))

    def place_block(self, t: torch.Tensor) -> torch.Tensor:
        """Compressed container stores (tiered residency) stay whole on
        the lead device: their payloads hold global plane positions, so
        no block of them is a block of the plane."""
        if self.multihost:
            # the payloads are packed from this process's fragments: no
            # other rank holds them, so they are no array of the mesh. The
            # stack cache serves over-budget fields through the slots
            # there (StackCache.residency_mode), so reaching here is a bug
            raise ValueError(
                "compressed container stores cannot be placed on a multi-host mesh "
                "(process-local payloads are not replicable); over-budget fields use "
                "the slot path there"
            )
        return t.to(self.lead)

    def replicate(self, t: torch.Tensor) -> "dict[torch.device, torch.Tensor]":
        """One copy of a small tensor on every distinct device of this
        process's positions."""
        out: dict = {}
        for i, row in enumerate(self.mesh.grid):
            if not self.mesh.owns(i):
                continue
            for d in row:
                if d not in out:
                    out[d] = t.to(d)
        return out


def _pick(parts: list, k: int) -> list:
    """Output ``k`` of every block's tuple of partials, as a grid (None
    at another rank's positions)."""
    return [[None if p is None else p[k] for p in row] for row in parts]


# ---------------------------------------------------------------- engine
class BlockPlan(NamedTuple):
    """A planned call tree for K1 (executor/compile.py): postfix ops,
    (array, row) leaves, BSI conditions, and the global [S, W] it
    evaluates over."""

    ops: list
    leaves: list
    conds: list
    n_shards: int
    n_words: int


class MeshQueryEngine:
    """The serving-path program builders over a fixed mesh. Each builder
    returns a callable that launches a kernel once per block, on the
    block's device and that device's current stream, and reduces the
    partials onto the lead device. ``programsBuilt`` counts builder calls
    (the port keeps no program cache: a plan carries its row ids)."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self._stats_lock = threading.Lock()
        self.programs_built = 0
        self.calls: dict[str, int] = {}
        self.fallbacks = 0
        # cross-process collectives run and the host seconds spent in
        # them (from the partial on the host to the reduced value back)
        self.collectives = 0
        self.collective_s = 0.0

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    # ------------------------------------------------- placement algebra
    def spec_mode(self, n_shards: int, n_words: int) -> str | None:
        """``grid`` or ``words`` as MeshContext.mode_for places the
        stacks; None for a replicate-only shape (the device route serves
        it)."""
        mode = MeshContext(self.mesh).mode_for(n_shards, n_words)
        return None if mode == "replicate" else mode

    def block_shape(self, n_shards: int, n_words: int, mode: str) -> tuple[int, int]:
        """(S_local, W_local) of one block of an [S, W] plane."""
        s_lo, s_hi, w_lo, w_hi = _cover(self.mesh, n_shards, n_words, mode, 0, 0)
        return s_hi - s_lo, w_hi - w_lo

    def _psum_both(self, partials: "list[list[torch.Tensor]]") -> torch.Tensor:
        """The reduction tree: copy each partial this process holds onto
        the lead device, sum over the words axis first, then over the
        shards axis; on a mesh that spans processes, then all-reduce the
        sum over the group."""
        lead = self.mesh.lead
        rows = []
        for row in partials:
            if row[0] is None:
                continue  # another rank's shard row
            acc = row[0].to(lead)
            for p in row[1:]:
                acc = acc + p.to(lead)
            rows.append(acc)
        total = rows[0]
        for r in rows[1:]:
            total = total + r
        if self.mesh.multiprocess:
            total = self._all_reduce(total)
        return total

    def _gather_all(self, partials: "list[list[torch.Tensor]]") -> torch.Tensor:
        """All-gather of per-block vectors onto the lead device, words
        then shards: block (i, j)'s values land at position i * W + j.
        Across processes every block's vector has one length (grid mode),
        and the gather is an all-reduce of a zero-filled vector in which
        each rank writes its own positions' slots."""
        lead = self.mesh.lead
        if not self.mesh.multiprocess:
            return torch.cat([p.to(lead).reshape(-1) for row in partials for p in row])
        mine = [(i * len(row) + j, p) for i, row in enumerate(partials) for j, p in enumerate(row) if p is not None]
        n = mine[0][1].numel()
        out = torch.zeros(self.mesh.size * n, dtype=mine[0][1].dtype, device=lead)
        for pos, p in mine:
            out[pos * n : (pos + 1) * n] = p.to(lead).reshape(-1)
        return self._all_reduce(out)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group. gloo reduces on the host: the partial
        (counts, never planes) is copied to host memory, summed there and
        copied back to the lead device, for a CUDA and a CPU mesh alike.
        gloo also takes CUDA tensors (its all_reduce, all_gather and
        broadcast did on an H100 with torch 2.11 + CUDA 12.8), by the same
        copy inside; the explicit one keeps the collective's own time apart
        from the kernels'."""
        import torch.distributed as dist

        host = t.cpu()  # waits for the kernels that made the partial
        t0 = time.perf_counter()
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        out = host.to(self.mesh.lead)
        with self._stats_lock:
            self.collectives += 1
            self.collective_s += time.perf_counter() - t0
        return out

    def _build(self) -> None:
        with self._stats_lock:
            self.programs_built += 1

    def note_call(self, name: str) -> None:
        with self._stats_lock:
            self.calls[name] = self.calls.get(name, 0) + 1

    def note_fallback(self) -> None:
        with self._stats_lock:
            self.fallbacks += 1

    def snapshot(self) -> dict:
        with self._stats_lock:
            calls = dict(self.calls)
            built, fallbacks = self.programs_built, self.fallbacks
            collectives, collective_s = self.collectives, self.collective_s
        out = {
            "devices": self.n_devices,
            "meshShape": dict(self.mesh.shape),
            "programsBuilt": built,
            "calls": calls,
            "fallbacks": fallbacks,
        }
        if self.mesh.multiprocess:
            out.update(processes=self.mesh.n_processes, rank=self.mesh.rank,
                       collectives=collectives, collectiveSeconds=collective_s)
        return out

    def dispatch(self, name: str, run, *args):
        """Run one built program: counted for the snapshot and spanned
        as ``mesh.dispatch``."""
        self.note_call(name)
        with GLOBAL_TRACER.span("mesh.dispatch", program=name, devices=self.n_devices):
            return run(*args)

    # --------------------------------------------------- per-block kernels
    def _tree(self, plan: BlockPlan, arrays: list, i: int, j: int, mode: str, count: bool):
        """K1 over block (i, j) of the plan's arrays."""
        sl, wl = self.block_shape(plan.n_shards, plan.n_words, mode)
        return ops.tree_eval(
            [a.blocks[i][j] for a in arrays], plan.leaves, plan.ops, sl, count=count,
            device=self.mesh.grid[i][j], conds=plan.conds, n_words=wl,
        )

    def _filter(self, fplan, i: int, j: int, mode: str):
        """Block (i, j) of a filter for K2, K4 or K5: a placed plane's
        block, or its plan's block as a ``PlannedFilter`` that the
        aggregate's fused mode evaluates (nothing is launched here), or
        None for all columns."""
        if fplan is None:
            return None
        if isinstance(fplan, MeshArray):
            return fplan.blocks[i][j]
        plan, arrays = fplan
        sl, wl = self.block_shape(plan.n_shards, plan.n_words, mode)
        return ops.PlannedFilter([a.blocks[i][j] for a in arrays], plan.leaves, plan.ops, plan.conds, sl, wl)

    def _each(self, fn) -> "list[list]":
        """``fn(i, j)`` for every position this process holds, as a
        blocks grid (None at another rank's positions)."""
        ns, nw = self.mesh.shape[AXIS_SHARDS], self.mesh.shape[AXIS_WORDS]
        return [[fn(i, j) if self.mesh.owns(i) else None for j in range(nw)] for i in range(ns)]

    # --------------------------------------- serving-path program builders
    def bitmap_tree(self, plan: BlockPlan, mode: str):
        """(arrays) → placed int32[S, W]: K1 words per block, no
        collective."""
        self._build()

        def run(arrays: list) -> MeshArray:
            blocks = self._each(lambda i, j: self._tree(plan, arrays, i, j, mode, count=False))
            return MeshArray(self.mesh, (plan.n_shards, plan.n_words), mode, blocks)

        return run

    def count_tree(self, plan: BlockPlan, mode: str):
        """(arrays) → int64 count on the lead device: K1 count per
        block, then the reduction tree."""
        self._build()

        def run(arrays: list) -> torch.Tensor:
            return self._psum_both(self._each(lambda i, j: self._tree(plan, arrays, i, j, mode, count=True)))

        return run

    def topn_tree(self, mode: str, filtered: bool, ids: bool, fplan=None):
        """(matrix, row_ids, filter) → int64[R] (or [K] for ids=) on the
        lead device: K2 per block under the block's filter (its plan,
        evaluated inside K2), then the reduction tree. ``row_ids`` is
        replicated ({device: int32[K]})."""
        self._build()
        if filtered != (fplan is not None):
            raise ValueError("a filtered TopN program needs its filter plan")

        def run(matrix: MeshArray, row_ids=None) -> torch.Tensor:
            if ids != (row_ids is not None):
                raise ValueError("an ids= TopN program needs its row ids")

            def block(i, j):
                blk = matrix.blocks[i][j]
                rid = row_ids[blk.device] if row_ids is not None else None
                return ops.row_counts(blk, self._filter(fplan, i, j, mode), rid)

            return self._psum_both(self._each(block))

        return run

    def sum_tree(self, mode: str, fplan=None):
        """(slices [P, S, W], depth) → (pos[1, D], neg[1, D], n[1]) on the
        lead device: K4 per block under the filter (a plan's inside K4),
        each output reduced by the tree."""
        self._build()

        def run(slices: MeshArray, depth: int):
            def block(i, j):
                filt = self._filter(fplan, i, j, mode)
                return ops.bsi_sum(slices.blocks[i][j], depth, filt[None] if isinstance(filt, torch.Tensor) else filt)

            parts = self._each(block)
            return tuple(self._psum_both(_pick(parts, k)) for k in range(3))

        return run

    def grouped_sum_tree(self, mode: str):
        """(slices, depth, masks [G, S, W]) → (pos[G, D], neg[G, D], n[G])
        on the lead device: K4 grouped per block, reduced by the tree."""
        self._build()

        def run(slices: MeshArray, depth: int, masks: MeshArray):
            parts = self._each(lambda i, j: ops.bsi_sum(slices.blocks[i][j], depth, masks.blocks[i][j]))
            return tuple(self._psum_both(_pick(parts, k)) for k in range(3))

        return run

    def minmax_tree(self, want_max: bool, mode: str, fplan=None):
        """(slices, depth) → (values, counts) on the lead device: K5's
        per-shard extremes of every block under the filter (a plan's
        inside K5), all-gathered words then shards.
        In words mode a block holds a slice of every shard, so its partial
        covers that slice; the executor's finish merges the partials
        exactly (min/max with its count is associative over disjoint
        column blocks)."""
        self._build()

        def run(slices: MeshArray, depth: int):
            parts = self._each(
                lambda i, j: ops.bsi_min_max(slices.blocks[i][j], depth, self._filter(fplan, i, j, mode), want_max)
            )
            values = self._gather_all(_pick(parts, 0))
            counts = self._gather_all(_pick(parts, 1))
            return values, counts

        return run

    def groupby_counts_tree(self, mode: str):
        """(masks [G, S, W], matrix [R, S, W], rows) → int64[G, K] on the
        lead device: K6 counts per block (a row id of -1 or >= R counts
        0), reduced by the tree. ``rows`` is replicated."""
        self._build()

        def run(masks: MeshArray, matrix: MeshArray, rows: dict) -> torch.Tensor:
            return self._psum_both(self._each(
                lambda i, j: ops.gb_counts(masks.blocks[i][j], matrix.blocks[i][j], rows[masks.blocks[i][j].device])
            ))

        return run

    def groupby_masks_tree(self, mode: str):
        """(masks, matrix, g_idx, row_sel) → placed int32[P, S, W]: K6
        masks per block, no collective."""
        self._build()

        def run(masks: MeshArray, matrix: MeshArray, g_idx: dict, row_sel: dict) -> MeshArray:
            def block(i, j):
                dev = masks.blocks[i][j].device
                return ops.gb_masks(masks.blocks[i][j], matrix.blocks[i][j], g_idx[dev], row_sel[dev])

            blocks = self._each(block)
            p = next(b for row in blocks for b in row if b is not None).shape[0]
            return MeshArray(self.mesh, (p,) + tuple(masks.shape[1:]), mode, blocks)

        return run

    # ----------------------------------------------- similarity programs
    def _search(self, metric: str, matrix: MeshArray, query: MeshArray, k: int):
        """(matrix [R, S, W], query [S, W], both in grid mode, k) → (f32
        scores[k], int32 ids[k]) on the lead device: per block K2 gives
        |a ∩ q| (the query block as the filter) and |a|, K1 counts |q|;
        the reduction tree sums the three; ``select_sim`` scores them and
        takes the top k, ties to the lower row, k clamped to R, as
        ``lax.top_k``: up to 4,096 rows in one K10 launch (``small sim``),
        past that K12's keys and K10's select."""
        if matrix.mode != "grid" or query.mode != "grid":
            raise ValueError(
                f"the search takes grid-placed arrays (S divisible by the shards axis, W by the "
                f"words axis), got {matrix.mode} and {query.mode}"
            )
        if tuple(query.shape) != tuple(matrix.shape[1:]):
            raise ValueError(f"query {query.shape} does not match the matrix's {matrix.shape[1:]}")
        if k < 0:
            raise ValueError(f"k must be non-negative, got {k}")
        lead = self.mesh.lead
        n_rows = matrix.shape[0]
        k = min(int(k), n_rows)
        if k == 0:
            return (torch.empty(0, dtype=torch.float32, device=lead), torch.empty(0, dtype=torch.int32, device=lead))
        s_l, w_l = self.block_shape(matrix.shape[1], matrix.shape[2], "grid")
        load = [(ops.bitwise.OP_LOAD, 0)]
        inter = self._psum_both(self._each(lambda i, j: ops.row_counts(matrix.blocks[i][j], query.blocks[i][j])))
        row_pop = self._psum_both(self._each(lambda i, j: ops.row_counts(matrix.blocks[i][j])))
        q_pop = self._psum_both(self._each(lambda i, j: ops.tree_eval(
            [query.blocks[i][j][None]], [(0, 0)], load, s_l, count=True, n_words=w_l,
        ))).reshape(1)
        return similarity.select_sim(inter, row_pop, q_pop, metric, k)

    def tanimoto(self, matrix: MeshArray, query: MeshArray, k: int):
        """Top-k rows by Tanimoto similarity to the query (BASELINE config
        5's search, over the mesh)."""
        self.note_call("tanimoto")
        return self._search("tanimoto", matrix, query, k)

    def cosine(self, matrix: MeshArray, query: MeshArray, k: int):
        """Top-k rows by cosine similarity |a∩q| / sqrt(|a|·|q|)."""
        self.note_call("cosine")
        return self._search("cosine", matrix, query, k)

    def place_allpairs(self, a, b) -> tuple[MeshArray, MeshArray]:
        """(a uint32[N, W], b uint32[M, W]) → placed pair: the rows of a
        over the shards axis and its words over the words axis; b's words
        over the words axis, whole in every shard row. N must divide the
        shards axis and W the words axis."""
        a = similarity.as_words(a, "cpu")
        b = similarity.as_words(b, "cpu")
        ns, nw = self.mesh.shape[AXIS_SHARDS], self.mesh.shape[AXIS_WORDS]
        if a.shape[0] % ns:
            raise ValueError(f"N={a.shape[0]} rows not divisible by the shards axis ({ns})")
        if a.shape[-1] % nw:
            raise ValueError(f"W={a.shape[-1]} words not divisible by the words axis ({nw})")
        if b.shape[-1] != a.shape[-1]:
            raise ValueError(f"a has {a.shape[-1]} words a row, b {b.shape[-1]}")
        return place(self.mesh, a, "grid"), place(self.mesh, b, "cols")

    def _pairwise(self, metric: str, a: MeshArray, b: MeshArray) -> MeshArray:
        """f32[N, M] scores, row-sharded (``rows`` mode, block i on
        position (i, 0)). One words position: K11 in its fused mode per
        block. Several: K11 ``inter`` per block and K2 row counts of the a
        and b blocks, summed over the words axis on position (i, 0), and
        K12 finishes the scores on the reduced counts."""
        if a.mode != "grid" or b.mode != "cols":
            raise ValueError("place the pair with place_allpairs")
        nw = self.mesh.shape[AXIS_WORDS]
        n_rows, m_rows = a.shape[0], b.shape[0]
        blocks = []
        for i, row in enumerate(a.blocks):
            if not self.mesh.owns(i):
                blocks.append([None])
                continue
            if nw == 1:
                blocks.append([similarity.pairwise(row[0], b.blocks[i][0], metric)])
                continue
            home = self.mesh.grid[i][0]
            inter = a_pop = b_pop = None
            for j, ab in enumerate(row):
                bb = b.blocks[i][j]
                part = similarity.pairwise(ab, bb, "inter").to(home)
                ap = ops.row_counts(ab[:, None]).to(home)
                bp = ops.row_counts(bb[:, None]).to(home)
                inter = part if inter is None else inter + part
                a_pop = ap if a_pop is None else a_pop + ap
                b_pop = bp if b_pop is None else b_pop + bp
            blocks.append([similarity.mesh_pairwise_finish(
                inter, a_pop.to(torch.float32), b_pop.to(torch.float32), metric,
            )])
        return MeshArray(self.mesh, (n_rows, m_rows), "rows", blocks)

    def pairwise_tanimoto(self, a: MeshArray, b: MeshArray) -> MeshArray:
        """All-pairs Tanimoto over a placed pair → f32[N, M], rows
        sharded."""
        self.note_call("pairwise_tanimoto")
        return self._pairwise("tanimoto", a, b)

    def pairwise_cosine(self, a: MeshArray, b: MeshArray) -> MeshArray:
        self.note_call("pairwise_cosine")
        return self._pairwise("cosine", a, b)

    # ------------------------------------- placement of the demo programs
    # The reference places [R, S, W] under P(None, shards, words) and
    # [S, W] under P(shards, words): the grid mode.

    def spec_matrix(self) -> str:
        return "grid"

    def spec_row(self) -> str:
        return "grid"

    def _place_grid(self, arr) -> MeshArray:
        s_n, w_n = arr.shape[-2], arr.shape[-1]
        ns, nw = self.mesh.shape[AXIS_SHARDS], self.mesh.shape[AXIS_WORDS]
        if s_n % ns or w_n % nw:
            raise ValueError(
                f"[.., {s_n}, {w_n}] does not divide over the (shards={ns}, words={nw}) mesh"
            )
        return place(self.mesh, arr, "grid")

    def place_matrix(self, stacked) -> MeshArray:
        """uint32 (or int32) ``[.., S, W]``, any leading axes (a row matrix
        [R, S, W], BSI slices [2 + D, S, W]) → placed, sharded (shards,
        words). A numpy array, or a tensor on any device: each block is a
        copy of its slice. Raises where S does not divide the shards axis
        or W the words axis."""
        if stacked.ndim < 2:
            raise ValueError("place_matrix takes [.., S, W]")
        return self._place_grid(stacked)

    def place_row(self, stacked) -> MeshArray:
        """uint32 (or int32) ``[S, W]`` → placed, sharded (shards, words)."""
        if stacked.ndim != 2:
            raise ValueError("place_row takes [S, W]")
        return self._place_grid(stacked)

    def _check_grid(self, matrix: MeshArray, filt: MeshArray, what: str) -> None:
        for a in (matrix, filt):
            if not isinstance(a, MeshArray) or a.mesh is not self.mesh or a.mode != "grid":
                raise ValueError(f"{what} takes arrays placed with place_matrix/place_row on this mesh")
        if tuple(filt.shape) != tuple(matrix.shape[-2:]):
            raise ValueError(f"{what}: [S, W] {filt.shape} does not match {matrix.shape}")

    # ------------------------------------------ demo and bench programs
    def count_and(self, a: MeshArray, b: MeshArray) -> torch.Tensor:
        """|a ∩ b| of two placed [S, W] rows → int64 scalar on the lead
        device: K2 per block (``a``'s block as one row, ``b``'s as the
        filter), then the reduction tree."""
        self._check_grid(a, b, "count_and")
        if len(a.shape) != 2:
            raise ValueError("count_and takes two [S, W] rows")

        def run(a: MeshArray, b: MeshArray) -> torch.Tensor:
            return self._psum_both(
                self._each(lambda i, j: ops.row_counts(a.blocks[i][j][None], b.blocks[i][j]))
            ).reshape(())

        return self.dispatch("count_and", run, a, b)

    def _filtered_counts(self, matrix: MeshArray, filt: MeshArray) -> torch.Tensor:
        return self._psum_both(self._each(lambda i, j: ops.row_counts(matrix.blocks[i][j], filt.blocks[i][j])))

    def topn(self, matrix: MeshArray, filt: MeshArray, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(matrix [R, S, W], filt [S, W]) → (int64 counts[k], int32
        ids[k]) on the lead device: K2 filtered per block, the reduction
        tree, then the integer top-k (ties to the lower row, k clamped to
        R, as ``lax.top_k``)."""
        self._check_grid(matrix, filt, "topn")

        def run(matrix: MeshArray, filt: MeshArray, k: int):
            return ops.select_top_counts(self._filtered_counts(matrix, filt), k)

        return self.dispatch("topn", run, matrix, filt, k)

    def bsi_sum(self, slices: MeshArray, filt: MeshArray) -> tuple[torch.Tensor, torch.Tensor]:
        """(slices [2 + D, S, W], filt [S, W]) → (sum int64, count int64) on
        the lead device: K4 filtered per block, the per-bit counts and n
        through the reduction tree, then the weighting. The reference
        weighs each block's counts and sums the block sums; the port sums
        the counts and weighs once. Both are the same int64 modulo 2^64."""
        self._check_grid(slices, filt, "bsi_sum")
        depth = slices.shape[0] - OFFSET_ROW

        def run(slices: MeshArray, filt: MeshArray):
            parts = self._each(lambda i, j: ops.bsi_sum(slices.blocks[i][j], depth, filt.blocks[i][j][None]))
            pos, neg, n = (self._psum_both(_pick(parts, k)) for k in range(3))
            return weigh_device(pos[0], neg[0]), n[0]

        return self.dispatch("bsi_sum", run, slices, filt)

    def ingest_and_aggregate(
        self, matrix: MeshArray, delta: MeshArray, filt: MeshArray
    ) -> tuple[MeshArray, torch.Tensor, torch.Tensor]:
        """The step: ``matrix |= delta`` and the filtered row counts →
        (matrix, int64[R] counts, int64 total), the counts and total on the
        lead device. K13 per block, in place, then the reduction tree.
        The reference donates the matrix: here its blocks are updated in
        place, so the ``matrix`` handle now holds the new matrix, and it is
        the handle returned. ``delta`` must be placed as ``matrix``."""
        self._check_grid(matrix, filt, "ingest_and_aggregate")
        self._check_grid(delta, filt, "ingest_and_aggregate")
        if tuple(delta.shape) != tuple(matrix.shape):
            raise ValueError(f"delta {delta.shape} is not placed as the matrix {matrix.shape}")

        def run(matrix: MeshArray, delta: MeshArray, filt: MeshArray):
            parts = self._each(
                lambda i, j: ops.ingest_counts(matrix.blocks[i][j], delta.blocks[i][j], filt.blocks[i][j])
            )
            counts = self._psum_both(_pick(parts, 1))
            total = self._psum_both(_pick(parts, 2))
            return matrix, counts, total

        return self.dispatch("ingest_and_aggregate", run, matrix, delta, filt)
