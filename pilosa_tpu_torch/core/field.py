"""Field — a typed attribute dimension over columns.

Reference: field.go (Field, FieldOptions, bsiGroup; constants
bsiExistsBit=0, bsiSignBit=1, bsiOffsetBit=2). Field types:

- ``set``   — multi-value bitmap rows (default)
- ``mutex`` — single-value: setting a row clears the column's other rows
- ``bool``  — mutex with exactly rows 0 (false) / 1 (true)
- ``time``  — set + per-quantum bucket views for time-bounded reads
- ``int``   — BSI sign-magnitude bit slices in a "bsi" view
  (row 0 exists, row 1 sign, rows 2.. magnitude LSB-first — the layout
  the BSI kernels consume directly)
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass
from datetime import datetime
from typing import TYPE_CHECKING

import numpy as np

from pilosa_tpu_torch.core import timequantum
from pilosa_tpu_torch.core.attrstore import AttrStore
from pilosa_tpu_torch.core.cache import DEFAULT_CACHE_SIZE
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.core.view import VIEW_BSI, VIEW_STANDARD, View
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils import durable

if TYPE_CHECKING:
    from pilosa_tpu_torch.core.fragment import Fragment


def _shard_slices(cols: np.ndarray):
    """Yield (shard, index_array) per touched shard via one stable
    grouping pass — per-shard boolean masks are O(n × shards) and
    dominate imports that span many shards. Shard ids are small ints,
    so the native counting argsort (O(n + shards)) replaces the
    comparison sort when available."""
    from pilosa_tpu_torch import native

    shards = cols // np.uint64(SHARD_WIDTH)
    order = native.counting_argsort(shards)
    uniq, starts = native.uniq_sorted(shards[order])
    bounds = np.append(starts, order.size)
    for i, shard in enumerate(uniq.tolist()):
        yield int(shard), order[bounds[i] : bounds[i + 1]]

FIELD_SET = "set"
FIELD_MUTEX = "mutex"
FIELD_BOOL = "bool"
FIELD_TIME = "time"
FIELD_INT = "int"

BSI_EXISTS = 0
BSI_SIGN = 1
BSI_OFFSET = 2


@dataclass
class FieldOptions:
    field_type: str = FIELD_SET
    cache_type: str = "ranked"
    cache_size: int = DEFAULT_CACHE_SIZE
    time_quantum: str = ""
    keys: bool = False
    min: int = 0
    max: int = 0
    # True when min/max were EXPLICITLY provided: a field declared with
    # range [0, 0] (only value 0 legal) must enforce it — overloading the
    # 0/0 default as "unbounded" silently accepted any value
    has_range: bool = False
    no_standard_view: bool = False

    def __post_init__(self) -> None:
        # a nonzero range was always enforced (and pre-has_range on-disk
        # metas must stay enforced after upgrade); only the explicit
        # [0, 0] declaration needs has_range=True from the caller
        if self.min != 0 or self.max != 0:
            self.has_range = True

    def validate(self) -> None:
        if self.field_type not in (
            FIELD_SET,
            FIELD_MUTEX,
            FIELD_BOOL,
            FIELD_TIME,
            FIELD_INT,
        ):
            raise ValueError(f"invalid field type {self.field_type!r}")
        if self.field_type == FIELD_TIME:
            timequantum.validate_quantum(self.time_quantum)
        if self.field_type == FIELD_INT and self.min > self.max:
            raise ValueError("int field: min > max")


class Field:
    def __init__(self, index: str, name: str, path: str | None, options: FieldOptions):
        options.validate()
        self.index = index
        self.name = name
        self.path = path  # <index-path>/<field-name>
        self.options = options
        self.views: dict[str, View] = {}
        self._create_lock = threading.Lock()
        self._meta_lock = threading.Lock()
        # background compaction queue, inherited by views/fragments
        # created under this field (injected by the holder chain)
        self.compactor = None
        # row attributes (reference: field.go rowAttrStore) and row-key
        # translation (reference: translate.go)
        self.row_attrs = AttrStore(
            os.path.join(path, ".row_attrs.json") if path else None
        )
        self.row_attrs.open()
        self.row_keys = TranslateStore(
            os.path.join(path, ".rowkeys.jsonl") if path else None
        )
        self.row_keys.open()
        # BSI magnitude bit depth (grows to fit the widest stored value)
        self._bit_depth = max(
            abs(int(options.min)).bit_length(), abs(int(options.max)).bit_length(), 1
        )

    # -------------------------------------------------------------- meta
    def save_meta(self) -> None:
        if self.path is None:
            return
        # serialized: concurrent per-shard import slices can grow
        # bit_depth simultaneously, and two atomic writes to the same
        # path would race on the shared tmp name (one renames it away,
        # the other's rename fails)
        with self._meta_lock:
            os.makedirs(self.path, exist_ok=True)
            meta = {
                "options": asdict(self.options),
                "bit_depth": self._bit_depth,
            }
            durable.atomic_write_file(
                os.path.join(self.path, ".meta.json"), json.dumps(meta)
            )

    @classmethod
    def load(
        cls, index: str, name: str, path: str, compactor=None, pool=None
    ) -> "Field":
        """Load a field's views and fragments from disk. With ``pool``
        (a ThreadPoolExecutor lent by Holder.open), fragment opens —
        the snapshot deserialize + ops-log replay that dominates cold
        start — are submitted concurrently; ``pool.futures`` collects
        them for the holder-level join. create_fragment_if_not_exists
        double-checks under a per-shard lock, so concurrent opens of
        different shards genuinely overlap (a view-wide lock here would
        serialize the whole load)."""
        with open(os.path.join(path, ".meta.json")) as f:
            meta = json.load(f)
        f_obj = cls(index, name, path, FieldOptions(**meta["options"]))
        f_obj._bit_depth = meta.get("bit_depth", f_obj._bit_depth)
        f_obj.compactor = compactor
        views_dir = os.path.join(path, "views")
        if os.path.isdir(views_dir):
            for view_name in sorted(os.listdir(views_dir)):
                view = f_obj.create_view_if_not_exists(view_name)
                frags_dir = os.path.join(views_dir, view_name, "fragments")
                if os.path.isdir(frags_dir):
                    for shard_name in sorted(os.listdir(frags_dir)):
                        if shard_name.isdigit() and not shard_name.endswith(".snapshotting"):
                            if pool is not None:
                                pool.futures.append(
                                    pool.submit(
                                        view.create_fragment_if_not_exists,
                                        int(shard_name),
                                    )
                                )
                            else:
                                view.create_fragment_if_not_exists(int(shard_name))
        return f_obj

    # ------------------------------------------------------------- views
    def view(self, name: str) -> View | None:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        v = self.views.get(name)
        if v is not None:
            return v
        with self._create_lock:
            return self._create_view_locked(name)

    def _create_view_locked(self, name: str) -> View:
        v = self.views.get(name)
        if v is None:
            view_path = os.path.join(self.path, "views", name) if self.path else None
            # BSI views never serve TopN; skip rank-cache maintenance there
            cache_type = "none" if name == VIEW_BSI else self.options.cache_type
            v = View(
                name,
                self.index,
                self.name,
                view_path,
                cache_type,
                self.options.cache_size,
            )
            v.compactor = self.compactor
            self.views[name] = v
        return v

    def available_shards(self) -> set[int]:
        shards: set[int] = set()
        for v in self.views.values():
            shards |= v.available_shards()
        return shards

    @property
    def bit_depth(self) -> int:
        return self._bit_depth

    def time_bounds(self) -> tuple[datetime, datetime] | None:
        """[min, max) datetime range covered by materialized time views —
        bounds open-ended Row(from=/to=) queries to real data instead of
        enumerating calendar buckets from year 1."""
        lo: datetime | None = None
        hi: datetime | None = None
        for name in self.views:
            bucket = timequantum.parse_view_bucket(name, VIEW_STANDARD)
            if bucket is None:
                continue
            start, end = bucket
            lo = start if lo is None or start < lo else lo
            hi = end if hi is None or end > hi else hi
        if lo is None or hi is None:
            return None
        return lo, hi

    def close(self) -> None:
        for v in self.views.values():
            v.close()
        self.row_attrs.close()
        self.row_keys.close()

    # --------------------------------------------------------- set paths
    def _writable_views(self, timestamp: datetime | None) -> list[str]:
        if self.options.field_type == FIELD_TIME:
            names = []
            if not self.options.no_standard_view:
                names.append(VIEW_STANDARD)
            if timestamp is not None:
                names.extend(
                    timequantum.views_by_time(
                        VIEW_STANDARD, timestamp, self.options.time_quantum
                    )
                )
            return names
        return [VIEW_STANDARD]

    def set_bit(self, row: int, col: int, timestamp: datetime | None = None) -> bool:
        if self.options.field_type == FIELD_INT:
            raise ValueError("cannot set bits on an int field; use set_value")
        if self.options.field_type == FIELD_BOOL and row not in (0, 1):
            raise ValueError("bool field rows must be 0 or 1")
        shard = col // SHARD_WIDTH
        changed = False
        for view_name in self._writable_views(timestamp):
            frag = self.create_view_if_not_exists(view_name).create_fragment_if_not_exists(shard)
            if self.options.field_type in (FIELD_MUTEX, FIELD_BOOL) and view_name == VIEW_STANDARD:
                frag.capture_column_reset([col])
                for other in frag.rows_containing(col):
                    if other != row:
                        frag.clear_bit(other, col)
            changed |= frag.set_bit(row, col)
        return changed

    def clear_bit(self, row: int, col: int) -> bool:
        shard = col // SHARD_WIDTH
        changed = False
        for view in self.views.values():
            frag = view.fragment(shard)
            if frag is not None:
                changed |= frag.clear_bit(row, col)
        return changed

    # ---------------------------------------------------------- BSI path
    def _grow_depth(self, needed: int) -> None:
        if needed > self._bit_depth:
            self._bit_depth = needed
            self.save_meta()

    def fit_depth(self, frag: Fragment) -> None:
        """Widen the BSI depth to every magnitude plane of ``frag`` (a
        replica's catch-up installs a copy whose values may be wider
        than any this node wrote)."""
        if frag.bitmap.count():
            self._grow_depth(int(frag.bitmap.max()) // SHARD_WIDTH + 1 - BSI_OFFSET)

    def _check_range(self, lo: int, hi: int) -> None:
        """Reject values outside the declared [min, max] (reference:
        field.go importValue "value out of range"). Fields created
        without an explicit range are unbounded — depth grows with the
        data instead."""
        o = self.options
        if not o.has_range:
            return
        if lo < o.min or hi > o.max:
            bad = lo if lo < o.min else hi
            raise ValueError(
                f"field {self.name!r}: value {bad} out of range "
                f"[{o.min}, {o.max}]"
            )

    def set_value(self, col: int, value: int) -> bool:
        """Store an integer (sign-magnitude BSI write). Overwrites any
        existing value for the column."""
        if self.options.field_type != FIELD_INT:
            raise ValueError(f"field {self.name!r} is not an int field")
        value = int(value)
        self._check_range(value, value)
        self._grow_depth(abs(value).bit_length())
        shard = col // SHARD_WIDTH
        frag = self.create_view_if_not_exists(VIEW_BSI).create_fragment_if_not_exists(shard)
        frag.capture_column_reset([col])
        changed = frag.set_bit(BSI_EXISTS, col)
        if value < 0:
            changed |= frag.set_bit(BSI_SIGN, col)
        else:
            changed |= frag.clear_bit(BSI_SIGN, col)
        mag = abs(value)
        for k in range(self._bit_depth):
            if (mag >> k) & 1:
                changed |= frag.set_bit(BSI_OFFSET + k, col)
            else:
                changed |= frag.clear_bit(BSI_OFFSET + k, col)
        return changed

    def value(self, col: int) -> tuple[int, bool]:
        """(value, exists) for a column."""
        if self.options.field_type != FIELD_INT:
            raise ValueError(f"field {self.name!r} is not an int field")
        view = self.view(VIEW_BSI)
        frag = view.fragment(col // SHARD_WIDTH) if view else None
        if frag is None or not frag.contains(BSI_EXISTS, col):
            return 0, False
        mag = 0
        for k in range(self._bit_depth):
            if frag.contains(BSI_OFFSET + k, col):
                mag |= 1 << k
        return (-mag if frag.contains(BSI_SIGN, col) else mag), True

    def clear_value(self, col: int) -> bool:
        view = self.view(VIEW_BSI)
        frag = view.fragment(col // SHARD_WIDTH) if view else None
        if frag is None:
            return False
        frag.capture_column_reset([col])
        changed = frag.clear_bit(BSI_EXISTS, col)
        frag.clear_bit(BSI_SIGN, col)
        for k in range(self._bit_depth):
            frag.clear_bit(BSI_OFFSET + k, col)
        return changed

    def clear_values(self, cols: np.ndarray) -> None:
        """Batched BSI clear for the given columns (ImportValueRequest
        with clear=true): drops existence, sign, and every magnitude
        slice, grouped by shard."""
        if self.options.field_type != FIELD_INT:
            raise ValueError(f"field {self.name!r} is not an int field")
        cols = np.asarray(cols, dtype=np.uint64)
        view = self.view(VIEW_BSI)
        if cols.size == 0 or view is None:
            return
        shards = cols // np.uint64(SHARD_WIDTH)
        all_rows = [BSI_EXISTS, BSI_SIGN] + [
            BSI_OFFSET + k for k in range(self._bit_depth)
        ]
        for shard in np.unique(shards).tolist():
            frag = view.fragment(int(shard))
            if frag is None:
                continue
            c = cols[shards == shard]
            frag.capture_column_reset(c)
            for row in all_rows:
                frag.bulk_import(
                    np.full(c.size, row, dtype=np.uint64), c, clear=True
                )

    # ------------------------------------------------------ bulk imports
    def import_bulk(
        self,
        rows: np.ndarray,
        cols: np.ndarray,
        timestamps: list[datetime | None] | None = None,
        clear: bool = False,
    ) -> None:
        """Batched bit import grouped by shard (reference: field.Import →
        fragment.bulkImport). ``timestamps`` routes time-field writes into
        bucket views as well."""
        rows = np.asarray(rows, dtype=np.uint64)
        cols = np.asarray(cols, dtype=np.uint64)
        if self.options.field_type in (FIELD_MUTEX, FIELD_BOOL):
            if rows.size == 0:
                return
            if self.options.field_type == FIELD_BOOL and not np.isin(
                rows, (0, 1)
            ).all():
                raise ValueError("bool field rows must be 0 or 1")
            if clear:
                # clearing needs no single-value enforcement — plain batch
                for shard, sl in _shard_slices(cols):
                    frag = self.create_view_if_not_exists(
                        VIEW_STANDARD
                    ).create_fragment_if_not_exists(shard)
                    frag.bulk_import(rows[sl], cols[sl], clear=True)
                return
            # last-wins per column, then one vectorized mutex pass per shard
            _, last = np.unique(cols[::-1], return_index=True)
            keep = np.sort(cols.size - 1 - last)
            rows, cols = rows[keep], cols[keep]
            for shard, sl in _shard_slices(cols):
                frag = self.create_view_if_not_exists(
                    VIEW_STANDARD
                ).create_fragment_if_not_exists(shard)
                frag.mutex_import(rows[sl], cols[sl])
            return
        for shard, sl in _shard_slices(cols):
            if timestamps is None or self.options.field_type != FIELD_TIME:
                views = self._writable_views(None)
                for view_name in views:
                    frag = self.create_view_if_not_exists(view_name).create_fragment_if_not_exists(shard)
                    frag.bulk_import(rows[sl], cols[sl], clear=clear)
            else:
                by_view: dict[str, list[int]] = {}
                for i in sl.tolist():
                    for view_name in self._writable_views(timestamps[i]):
                        by_view.setdefault(view_name, []).append(i)
                for view_name, ids in by_view.items():
                    frag = self.create_view_if_not_exists(view_name).create_fragment_if_not_exists(shard)
                    frag.bulk_import(rows[ids], cols[ids], clear=clear)

    def import_values(self, cols: np.ndarray, values: np.ndarray) -> None:
        """Batched BSI import (reference: field.importValue). Vectorized
        per bit-slice: one add_many/remove_many pair per slice per shard
        (overwrite semantics — old magnitude bits are cleared)."""
        if self.options.field_type != FIELD_INT:
            raise ValueError(f"field {self.name!r} is not an int field")
        cols = np.asarray(cols, dtype=np.uint64)
        values = np.asarray(values, dtype=np.int64)
        if cols.size == 0:
            return
        self._check_range(int(values.min()), int(values.max()))
        self._grow_depth(int(np.abs(values).max()).bit_length())
        shards = cols // np.uint64(SHARD_WIDTH)
        for shard in np.unique(shards).tolist():
            m = shards == shard
            c, v = cols[m], values[m]
            frag = self.create_view_if_not_exists(VIEW_BSI).create_fragment_if_not_exists(int(shard))
            frag.capture_column_reset(c)
            zeros = np.zeros(c.size, dtype=np.uint64)
            frag.bulk_import(zeros + BSI_EXISTS, c)
            neg = v < 0
            frag.bulk_import(zeros[neg] + BSI_SIGN, c[neg])
            frag.bulk_import(zeros[~neg] + BSI_SIGN, c[~neg], clear=True)
            mags = np.abs(v).astype(np.uint64)
            for k in range(self._bit_depth):
                bit = ((mags >> np.uint64(k)) & np.uint64(1)) == 1
                row = np.uint64(BSI_OFFSET + k)
                if bit.any():
                    frag.bulk_import(zeros[bit] + row, c[bit])
                if (~bit).any():
                    frag.bulk_import(zeros[~bit] + row, c[~bit], clear=True)
