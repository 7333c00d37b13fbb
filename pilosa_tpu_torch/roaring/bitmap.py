"""64-bit roaring Bitmap (host side).

Reference: roaring/roaring.go (Bitmap) + roaring/btree.go — upstream keys a
B-tree of containers by the high 48 bits of each value. Here a plain dict
(Python dicts are hash maps with O(1) lookup; sorted key order is produced
on demand) maps ``key = value >> 16`` → Container.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from pilosa_tpu_torch import native
from pilosa_tpu_torch.native import uniq_sorted as _uniq_sorted
from pilosa_tpu_torch.roaring import containers as ct

_KEY_SHIFT = np.uint64(16)
_LOW_MASK = np.uint64(0xFFFF)


def _tagged_concat(arr_keys: list[int], arr_datas: list[np.ndarray]) -> np.ndarray:
    """Concatenate per-key sorted uint16 arrays into one GLOBALLY sorted
    uint64 array of full values (key<<16 | low) — keys must ascend.
    Shared by add_many/remove_many's batch merge."""
    lens = np.fromiter((d.size for d in arr_datas), np.int64, len(arr_datas))
    bases = np.repeat(np.asarray(arr_keys, dtype=np.uint64) << _KEY_SHIFT, lens)
    return np.concatenate(arr_datas).astype(np.uint64) | bases


class Bitmap:
    """A set of uint64 values stored as roaring containers."""

    __slots__ = ("_containers",)

    def __init__(self) -> None:
        self._containers: dict[int, ct.Container] = {}

    # ---------------------------------------------------------------- builders
    @classmethod
    def from_values(cls, values: Iterable[int] | np.ndarray) -> "Bitmap":
        b = cls()
        b.add_many(np.asarray(list(values) if not isinstance(values, np.ndarray) else values, dtype=np.uint64))
        return b

    def copy(self) -> "Bitmap":
        b = Bitmap()
        b._containers = {k: ct.Container(c.type, c.data.copy()) for k, c in self._containers.items()}
        return b

    # ---------------------------------------------------------------- mutation
    def add(self, v: int) -> bool:
        key, low = int(v) >> 16, int(v) & 0xFFFF
        c = self._containers.get(key)
        if c is None:
            self._containers[key] = ct.array_container(np.array([low], dtype=np.uint16))
            return True
        nc, changed = ct.container_add(c, low)
        if changed:
            self._containers[key] = nc
        return changed

    def remove(self, v: int) -> bool:
        key, low = int(v) >> 16, int(v) & 0xFFFF
        c = self._containers.get(key)
        if c is None:
            return False
        nc, changed = ct.container_remove(c, low)
        if changed:
            if ct.container_count(nc) == 0:
                del self._containers[key]
            else:
                self._containers[key] = nc
        return changed

    def add_many(self, values: np.ndarray, presorted: bool = False) -> None:
        """Vectorised bulk add. Absent/array-container targets (the common
        case) are handled by ONE globally-sorted merge of the incoming
        values with every touched array container's contents — per-
        container numpy (union1d per key) was the import bottleneck at
        ~64k touched containers per batch. Bitmap/run targets get a
        vectorized word-OR each (few — only containers past 4096 bits).

        ``presorted=True`` asserts ``values`` is already sorted unique
        and skips the radix pass — the bulk-ingest builders sort ONCE on
        a combined (shard, position) key and must not re-sort every
        shard slice (docs/ingest.md)."""
        if values.size == 0:
            return
        if not presorted:
            values = native.sort_unique_u64(values)
        keys = (values >> _KEY_SHIFT).astype(np.int64)
        uniq_keys, starts = _uniq_sorted(keys)
        bounds = np.append(starts, keys.size)
        get = self._containers.get
        arr_datas: list[np.ndarray] = []
        arr_keys: list[int] = []
        light: list[int] = []  # keys absent or array-backed
        heavy: list[tuple[int, int, ct.Container]] = []
        for i, key in enumerate(uniq_keys.tolist()):
            c = get(key)
            if c is None or c.type == ct.TYPE_ARRAY:
                light.append(key)
                if c is not None and c.data.size:
                    arr_datas.append(c.data)
                    arr_keys.append(key)
            else:
                heavy.append((i, key, c))
        if arr_datas:
            merged = native.sort_unique_u64(
                np.concatenate([values, _tagged_concat(arr_keys, arr_datas)]),
                owned=True,  # the concatenate result is scratch
            )
        else:
            merged = values
        if light:
            mkeys = (merged >> _KEY_SHIFT).astype(np.int64)
            muniq, mstarts = _uniq_sorted(mkeys)
            mbounds = np.append(mstarts, mkeys.size)
            mlows = (merged & _LOW_MASK).astype(np.uint16)
            pos_of = {int(k): j for j, k in enumerate(muniq.tolist())}
            containers = self._containers
            arr_max = ct.ARRAY_MAX
            mk_array, t_array = ct.Container, ct.TYPE_ARRAY
            for key in light:
                j = pos_of[key]
                # chunk views alias one batch buffer; containers treat
                # payloads as immutable so sharing is safe. Inlined
                # from_values: a wide import touches ~10^6 containers and
                # every extra call/asarray per container is seconds
                chunk = mlows[mbounds[j] : mbounds[j + 1]]
                if chunk.size > arr_max:
                    containers[key] = ct.bitmap_container(
                        ct._values_to_words(chunk)
                    )
                else:
                    containers[key] = mk_array(t_array, chunk)
        lows = (values & _LOW_MASK).astype(np.int64)
        for i, key, c in heavy:
            chunk = lows[bounds[i] : bounds[i + 1]]
            words = (
                c.data.copy() if c.type == ct.TYPE_BITMAP else ct.as_words(c)
            )
            np.bitwise_or.at(
                words,
                chunk >> 6,
                np.uint64(1) << (chunk & 63).astype(np.uint64),
            )
            out = ct.bitmap_container(words)
            self._containers[key] = (
                ct.optimize(out, runs=True) if c.type == ct.TYPE_RUN else out
            )

    def remove_many(self, values: np.ndarray) -> None:
        """Vectorised bulk remove — mirror of add_many's batch merge:
        array-container targets are filtered by ONE searchsorted
        membership test over their key-tagged concatenation; bitmap/run
        targets get a vectorized word-ANDNOT each."""
        if values.size == 0:
            return
        values = native.sort_unique_u64(values)
        keys = (values >> _KEY_SHIFT).astype(np.int64)
        uniq_keys, starts = _uniq_sorted(keys)
        bounds = np.append(starts, keys.size)
        get = self._containers.get
        arr_datas: list[np.ndarray] = []
        arr_keys: list[int] = []
        heavy: list[tuple[int, int, ct.Container]] = []
        for i, key in enumerate(uniq_keys.tolist()):
            c = get(key)
            if c is None:
                continue
            if c.type == ct.TYPE_ARRAY:
                arr_datas.append(c.data)
                arr_keys.append(key)
            else:
                heavy.append((i, key, c))
        if arr_datas:
            existing_full = _tagged_concat(arr_keys, arr_datas)
            # sorted-membership test: values is sorted unique
            pos = np.searchsorted(values, existing_full)
            posc = np.minimum(pos, values.size - 1)
            keep = values[posc] != existing_full
            kept = existing_full[keep]
            klows = (kept & _LOW_MASK).astype(np.uint16)
            kbounds = np.searchsorted(
                kept >> _KEY_SHIFT, np.asarray(arr_keys + [1 << 48], dtype=np.uint64)
            )
            containers = self._containers
            for j, key in enumerate(arr_keys):
                chunk = klows[kbounds[j] : kbounds[j + 1]]
                if chunk.size == 0:
                    del containers[key]
                else:
                    containers[key] = ct.Container(ct.TYPE_ARRAY, chunk)
        lows = (values & _LOW_MASK).astype(np.int64)
        for i, key, c in heavy:
            chunk = lows[bounds[i] : bounds[i + 1]]
            words = (
                c.data.copy() if c.type == ct.TYPE_BITMAP else ct.as_words(c)
            )
            # ufunc.at, not fancy-index assignment: several cleared bits
            # can share one word and must all accumulate
            np.bitwise_and.at(
                words,
                chunk >> 6,
                ~(np.uint64(1) << (chunk & 63).astype(np.uint64)),
            )
            nc = ct.optimize(
                ct.bitmap_container(words), runs=c.type == ct.TYPE_RUN
            )
            if ct.container_count(nc) == 0:
                del self._containers[key]
            else:
                self._containers[key] = nc

    # ----------------------------------------------------------------- queries
    def contains(self, v: int) -> bool:
        c = self._containers.get(int(v) >> 16)
        return c is not None and ct.container_contains(c, int(v) & 0xFFFF)

    def contains_many(self, values: np.ndarray) -> np.ndarray:
        """Vectorised membership: bool[len(values)].

        Per-touched-container work must stay O(1) *python* ops (no numpy
        call per container): a single-bit mutex probe on a 100k-row
        fragment touches ~100k one-element array containers, and anything
        per-container-vectorised (np.isin, even searchsorted) costs
        microseconds × 100k. Array containers are therefore answered by
        ONE searchsorted over their concatenation — tagging every element
        and query with its container ordinal keeps the concatenation
        globally sorted. Bitmap containers are scalar word probes; run
        containers one small searchsorted each (runs are rare).
        """
        values = np.asarray(values, dtype=np.uint64)
        out = np.zeros(values.size, dtype=bool)
        if values.size == 0 or not self._containers:
            return out
        keys = (values >> _KEY_SHIFT).astype(np.int64)
        lows = (values & _LOW_MASK).astype(np.uint16)
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        uniq, starts = _uniq_sorted(ks)
        bounds = np.append(starts, ks.size)
        arr_parts: list[np.ndarray] = []
        arr_lens: list[int] = []
        arr_sels: list[np.ndarray] = []
        get = self._containers.get
        for i, key in enumerate(uniq.tolist()):
            c = get(key)
            if c is None:
                continue
            sel = order[bounds[i] : bounds[i + 1]]
            t = c.type
            if t == ct.TYPE_ARRAY:
                arr_parts.append(c.data)
                arr_lens.append(c.data.size)
                arr_sels.append(sel)
            elif t == ct.TYPE_BITMAP:
                # one vectorized word probe per container — at most
                # count/4096 bitmap containers exist, and a dense row can
                # receive the whole query batch (mutex_import's candidate
                # grid), which must not degrade to per-probe Python
                q = lows[sel].astype(np.int64)
                out[sel] = (c.data[q >> 6] >> (q & 63).astype(np.uint64)) & np.uint64(1) != 0
            else:  # TYPE_RUN — [start, last] inclusive pairs
                runs = c.data
                if runs.size:
                    q = lows[sel]
                    j = np.searchsorted(runs[:, 0], q, side="right") - 1
                    jc = np.maximum(j, 0)
                    out[sel] = (j >= 0) & (q >= runs[jc, 0]) & (q <= runs[jc, 1])
        if arr_parts:
            combined = np.concatenate(arr_parts).astype(np.int64)
            lens = np.asarray(arr_lens, dtype=np.int64)
            combined |= np.repeat(
                np.arange(lens.size, dtype=np.int64), lens
            ) << 17
            qsel = np.concatenate(arr_sels)
            qlens = np.asarray([s.size for s in arr_sels], dtype=np.int64)
            q = lows[qsel].astype(np.int64) | (
                np.repeat(np.arange(qlens.size, dtype=np.int64), qlens) << 17
            )
            pos = np.searchsorted(combined, q)
            posc = np.minimum(pos, combined.size - 1)
            out[qsel] = combined[posc] == q
        return out

    def count(self) -> int:
        return sum(ct.container_count(c) for c in self._containers.values())

    def values(self) -> np.ndarray:
        """All values, sorted ascending, as uint64."""
        if not self._containers:
            return np.empty(0, dtype=np.uint64)
        keys = sorted(self._containers)
        conts = [self._containers[k] for k in keys]
        if all(c.type == ct.TYPE_ARRAY for c in conts):
            # all-array fast path (the shape of every sparse bulk-load
            # delta): ONE concat + ONE key-offset broadcast instead of
            # an astype+add pair per container
            sizes = np.fromiter(
                (c.data.size for c in conts), np.int64, len(conts)
            )
            vals = np.concatenate([c.data for c in conts]).astype(np.uint64)
            offs = np.repeat(
                np.asarray(keys, np.uint64) << np.uint64(_KEY_SHIFT), sizes
            )
            return vals + offs
        parts = []
        for key, c in zip(keys, conts):
            vals = ct.as_values(c).astype(np.uint64)
            parts.append(vals + (np.uint64(key) << _KEY_SHIFT))
        return np.concatenate(parts)

    def __iter__(self) -> Iterator[int]:
        return iter(self.values().tolist())

    def __len__(self) -> int:
        return self.count()

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Bitmap):
            return NotImplemented
        return np.array_equal(self.values(), other.values())

    def min(self) -> int:
        if not self._containers:
            raise ValueError("empty bitmap")
        key = min(self._containers)
        return (key << 16) | int(ct.as_values(self._containers[key])[0])

    def max(self) -> int:
        if not self._containers:
            raise ValueError("empty bitmap")
        key = max(self._containers)
        return (key << 16) | int(ct.as_values(self._containers[key])[-1])

    def _range_keys(self, start: int, stop: int) -> list[int]:
        """Container keys overlapping [start, stop). For narrow ranges
        (the per-row hot path — one row spans ≤ SHARD_WIDTH/2^16 + 1
        containers) this probes candidate keys directly instead of
        scanning every container: a 100k-row fragment must not pay
        O(containers) per row access."""
        first, last = start >> 16, (stop - 1) >> 16
        if last - first + 1 <= len(self._containers):
            return [k for k in range(first, last + 1) if k in self._containers]
        return sorted(
            k for k in self._containers if first <= k <= last
        )

    def range_count(self, start: int, stop: int) -> int:
        """Count of values in [start, stop)."""
        total = 0
        for key in self._range_keys(start, stop):
            base = key << 16
            c = self._containers[key]
            if start <= base and base + ct.CONTAINER_BITS <= stop:
                total += ct.container_count(c)
            else:
                vals = ct.as_values(c).astype(np.uint64) + np.uint64(base)
                total += int(
                    np.count_nonzero(
                        (vals >= np.uint64(start)) & (vals < np.uint64(stop))
                    )
                )
        return total

    def range_values(self, start: int, stop: int) -> np.ndarray:
        """Values in [start, stop), sorted, as uint64 (absolute positions)."""
        parts = []
        for key in self._range_keys(start, stop):
            base = key << 16
            vals = ct.as_values(self._containers[key]).astype(np.uint64) + np.uint64(base)
            if start > base or base + ct.CONTAINER_BITS > stop:
                vals = vals[(vals >= np.uint64(start)) & (vals < np.uint64(stop))]
            parts.append(vals)
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(parts)

    # ------------------------------------------------------------------ setops
    def _zipped(self, other: "Bitmap", keys: Iterable[int], op) -> "Bitmap":
        out = Bitmap()
        empty = ct.array_container(np.empty(0, dtype=np.uint16))
        for key in keys:
            a = self._containers.get(key, empty)
            b = other._containers.get(key, empty)
            c = op(a, b)
            if ct.container_count(c):
                out._containers[key] = c
        return out

    def intersect(self, other: "Bitmap") -> "Bitmap":
        keys = self._containers.keys() & other._containers.keys()
        return self._zipped(other, keys, ct.container_and)

    def union(self, other: "Bitmap") -> "Bitmap":
        # Import-tuned union (fragment.import_roaring is `self | incoming`):
        # - one-sided keys ADOPT the container by reference — payloads
        #   are immutable (every mutator copies first), so sharing is
        #   safe; a fresh or mostly-disjoint batch is all one-sided.
        # - overlapping array/array pairs merge in ONE global radix
        #   sort-unique over their key-tagged concatenation (the
        #   add_many batch trick) instead of a union1d per container —
        #   per-container numpy was ~16 µs × 64k containers per batch.
        # - only bitmap/run-involved overlaps pay container_or.
        out = Bitmap()
        oc = out._containers
        bc = other._containers
        c_or, count = ct.container_or, ct.container_count
        t_array = ct.TYPE_ARRAY
        aa_keys: list[int] = []
        aa_datas: list[np.ndarray] = []
        for key, a in self._containers.items():
            b = bc.get(key)
            if b is None:
                oc[key] = a
            elif a.type == t_array and b.type == t_array:
                aa_keys.append(key)
                aa_datas.append(a.data)
                aa_datas.append(b.data)
            else:
                c = c_or(a, b)
                if count(c):
                    oc[key] = c
        for key, b in bc.items():
            if key not in oc and key not in self._containers:
                oc[key] = b
        if aa_keys:
            # both sides are per-container sorted; ordering the pairs by
            # key makes each side's tagged concatenation globally sorted,
            # so ONE linear C merge replaces a full radix re-sort
            order = sorted(range(len(aa_keys)), key=aa_keys.__getitem__)
            aa_keys = [aa_keys[i] for i in order]
            merged = native.merge_unique_u64(
                _tagged_concat(aa_keys, [aa_datas[2 * i] for i in order]),
                _tagged_concat(aa_keys, [aa_datas[2 * i + 1] for i in order]),
            )
            mkeys = (merged >> _KEY_SHIFT).astype(np.int64)
            muniq, mstarts = _uniq_sorted(mkeys)
            mbounds = np.append(mstarts, mkeys.size)
            mlows = (merged & _LOW_MASK).astype(np.uint16)
            arr_max = ct.ARRAY_MAX
            for j, key in enumerate(int(k) for k in muniq.tolist()):
                chunk = mlows[mbounds[j] : mbounds[j + 1]]
                if chunk.size > arr_max:
                    oc[key] = ct.bitmap_container(ct._values_to_words(chunk))
                else:
                    oc[key] = ct.Container(t_array, chunk)
        return out

    def union_in_place(self, other: "Bitmap") -> None:
        """Merge ``other`` into this bitmap. An empty receiver ADOPTS
        the other's container dict outright (the dominant fresh-adopt
        replay/import case — zero copies); payload immutability (every
        mutator replaces, never edits, a container) makes the sharing
        safe exactly as in ``union``."""
        if not self._containers:
            self._containers = other._containers
        elif other._containers:
            self._containers = (self | other)._containers

    def difference(self, other: "Bitmap") -> "Bitmap":
        return self._zipped(other, self._containers.keys(), ct.container_andnot)

    def xor(self, other: "Bitmap") -> "Bitmap":
        keys = self._containers.keys() | other._containers.keys()
        return self._zipped(other, keys, ct.container_xor)

    __and__ = intersect
    __or__ = union
    __sub__ = difference
    __xor__ = xor
