"""Tiered, compressed device residency: the container chooser and packers.

Reference: pilosa_tpu/executor/residency.py, copied with its constants
unchanged so that both packages choose the same container for every row
(docs/device-residency.md). Each RESIDENT row of an over-budget field is
packed as whichever container its population fits —

- ``dense``  — the packed words themselves ([S, W] plane);
- ``sparse`` — a sorted int32 list of global bit positions;
- ``run``    — int32 [start, end) intervals of consecutive bits;

— and K1 decodes the sparse and run payloads in place (its LOAD_SPARSE
and LOAD_RUN opcodes; ops/containers.py holds the plain decodes). A
hot/cold LRU tier sits under the StackCache's byte ledger: hot rows stay
resident compressed, cold rows serve from a one-shot host-packed upload,
and per-row touch counts promote a shifting working set.

Pure numpy: packing runs on fragment host data; the device stores are
orchestrated by compile.StackCache under its lock.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

# The container taxonomy the device chooser emits: the host engine's
# ``decode_container`` (executor/hostpath.py) and the planner's leaf
# opcodes (compile._Planner) each have a branch per kind.
CONTAINER_KINDS = {"dense", "sparse", "run"}

# sparse containers cap their id list; rows past this stay dense (the
# id list would approach the plane size anyway)
SPARSE_MAX_IDS = 2048
# run containers cap their interval list; fragmented rows past this
# fall through to sparse/dense
RUN_MAX_INTERVALS = 128
# touches before a cold row is PROMOTED into the resident tier; below
# it the row serves via a one-shot host-packed upload (host-served,
# merged exactly on device) so one-off scans don't churn the LRU
PROMOTE_TOUCHES = 2
# per-entry bound on remembered touch counts (plain LRU of counters)
MAX_TOUCH_ROWS = 8192
# int32 ids bound the flattened plane bit space
_MAX_PLANE_BITS = 1 << 31


def analyze_plane(plane: np.ndarray) -> tuple[int, int]:
    """(n_bits, n_runs) of a packed uint32 plane — O(words), no bit
    unpacking.  Run starts are ``word & ~(word << 1 | carry)`` with the
    carry chaining bit 31 across flattened word boundaries."""
    y = np.ascontiguousarray(plane).reshape(-1)
    nbits = int(np.bitwise_count(y).sum())
    if nbits == 0:
        return 0, 0
    prev = (y << np.uint32(1)) | np.concatenate(
        ([np.uint32(0)], y[:-1] >> np.uint32(31))
    )
    nruns = int(np.bitwise_count(y & ~prev).sum())
    return nbits, nruns


def choose_container(nbits: int, nruns: int, plane_words: int) -> str:
    """Pick the cheapest container for a row with ``nbits`` set bits in
    ``nruns`` runs over a ``plane_words``-word plane.  Costs in uint32
    words: dense = plane_words, sparse = nbits, run = 2·nruns — the
    Roaring rule with the device store caps applied."""
    if plane_words * 32 > _MAX_PLANE_BITS:
        return "dense"  # int32 id space exhausted — see ops/containers.py
    run_cost = 2 * nruns
    if nruns <= RUN_MAX_INTERVALS and run_cost < min(
        plane_words, nbits if nbits else plane_words
    ):
        return "run"
    if nbits <= SPARSE_MAX_IDS and nbits < plane_words:
        return "sparse"
    return "dense"


def pack_container(kind: str, plane: np.ndarray) -> np.ndarray:
    """Pack a [S, W] plane into its container payload (the inverse of
    hostpath.decode_container).  ``dense`` returns the plane itself."""
    if kind == "dense":
        return plane
    bits = np.unpackbits(
        np.ascontiguousarray(plane).reshape(-1).view(np.uint8),
        bitorder="little",
    )
    if kind == "sparse":
        return np.flatnonzero(bits).astype(np.int32)
    if kind == "run":
        edges = np.diff(bits.astype(np.int8))
        starts = np.flatnonzero(edges == 1) + 1
        ends = np.flatnonzero(edges == -1) + 1
        if bits.size and bits[0]:
            starts = np.concatenate(([0], starts))
        if bits.size and bits[-1]:
            ends = np.concatenate((ends, [bits.size]))
        return np.stack([starts, ends], axis=1).astype(np.int32)
    raise ValueError(f"unknown container kind {kind!r}")


def _pow2_floor(n: int) -> int:
    return 1 << (int(n).bit_length() - 1) if n >= 1 else 0


class TieredEntry:
    """Per-(field, view, shards) residency state: one store per
    container kind (a fixed-capacity device array + row→slot LRU) and
    the touch counters driving promotion.  All mutation happens under
    the owning StackCache's lock; the device arrays are immutable
    snapshots (functional scatter updates swap them), so a query that
    captured (array, slots) can never read a reassigned slot."""

    def __init__(self, n_shards: int, budget: int):
        self.versions: tuple | None = None
        self.view_ver = None
        # stores materialize lazily per kind — an all-sparse field never
        # allocates its dense or run store
        self.stores: dict[str, dict] = {}
        self.kinds: OrderedDict[int, str] = OrderedDict()  # chooser memo
        self.touch: OrderedDict[int, int] = OrderedDict()
        self.n_shards = n_shards
        self.budget = budget

    # ------------------------------------------------------- capacities
    def capacity(self, kind: str, plane_words: int) -> tuple[int, int]:
        """(rows, payload_len) a store of ``kind`` holds.  Dense gets
        half the budget (mirroring hot_capacity — a full-budget store
        would thrash against every dense stack); sparse an eighth, runs
        a sixteenth.  Floors keep tiny test budgets functional."""
        if kind == "dense":
            h = (self.budget // 2) // max(1, plane_words * 4)
            return max(8, _pow2_floor(h)), plane_words
        # sparse/run floors cover a full BSI slice block (≤ 66 slice
        # rows) so over-budget int fields can assemble their [D, S, W]
        # block from compressed slices in ONE atomic batch
        if kind == "sparse":
            k = SPARSE_MAX_IDS
            h = (self.budget // 8) // (k * 4)
            return max(128, _pow2_floor(h)), k
        k = RUN_MAX_INTERVALS
        h = (self.budget // 16) // (k * 2 * 4)
        return max(128, _pow2_floor(h)), k

    def note_touch(self, row: int) -> int:
        """Bump and return a row's touch count (bounded LRU)."""
        n = self.touch.pop(row, 0) + 1
        self.touch[row] = n
        while len(self.touch) > MAX_TOUCH_ROWS:
            self.touch.popitem(last=False)
        return n

    def resident(self, row: int, kind: str) -> bool:
        st = self.stores.get(kind)
        return st is not None and row in st["slots"]

    def resident_rows(self) -> int:
        return sum(len(st["slots"]) for st in self.stores.values())

    def drop_rows(self, rows) -> None:
        """Evict specific rows (stale after a write) — slots return to
        the freelist; kind memos invalidate (the write may have changed
        the row's class)."""
        for st in self.stores.values():
            for r in rows:
                slot = st["slots"].pop(r, None)
                if slot is not None:
                    st["free"].append(slot)
        for r in rows:
            self.kinds.pop(r, None)

    def clear(self) -> None:
        for st in self.stores.values():
            st["free"].extend(st["slots"].values())
            st["slots"].clear()
        self.kinds.clear()
