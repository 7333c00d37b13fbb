"""Index — a namespace of fields over one column universe.

Reference: index.go (Index, CreateField, DeleteField; options keys /
trackExistence). When ``track_existence`` is on, every column write also
sets row 0 of the internal ``_exists`` field, which backs Not() and All().
"""

from __future__ import annotations

import json
import os
import threading
import shutil
from dataclasses import asdict, dataclass

import numpy as np

from pilosa_tpu_torch.core.attrstore import AttrStore
from pilosa_tpu_torch.core.field import FIELD_SET, VIEW_STANDARD, Field, FieldOptions
from pilosa_tpu_torch.core.translate import TranslateStore
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils import durable

EXISTENCE_FIELD = "_exists"


@dataclass
class IndexOptions:
    keys: bool = False
    track_existence: bool = True


class Index:
    def __init__(self, name: str, path: str | None, options: IndexOptions | None = None):
        self.name = name
        self.path = path  # <holder-path>/<index-name>
        self.options = options or IndexOptions()
        self.fields: dict[str, Field] = {}
        self._create_lock = threading.Lock()
        # background compaction queue, inherited by fields created here
        self.compactor = None
        # column attributes (reference: index.go columnAttrStore) and
        # column-key translation (reference: translate.go)
        self.column_attrs = AttrStore(
            os.path.join(path, ".column_attrs.json") if path else None
        )
        self.column_attrs.open()
        self.column_keys = TranslateStore(
            os.path.join(path, ".keys.jsonl") if path else None
        )
        self.column_keys.open()

    # -------------------------------------------------------------- meta
    def save_meta(self) -> None:
        if self.path is None:
            return
        os.makedirs(self.path, exist_ok=True)
        durable.atomic_write_file(
            os.path.join(self.path, ".meta.json"),
            json.dumps({"options": asdict(self.options)}),
        )

    @classmethod
    def load(
        cls, name: str, path: str, compactor=None, pool=None
    ) -> "Index":
        with open(os.path.join(path, ".meta.json")) as f:
            meta = json.load(f)
        idx = cls(name, path, IndexOptions(**meta["options"]))
        idx.compactor = compactor
        for entry in sorted(os.listdir(path)):
            field_path = os.path.join(path, entry)
            if os.path.isdir(field_path) and os.path.exists(
                os.path.join(field_path, ".meta.json")
            ):
                idx.fields[entry] = Field.load(
                    name, entry, field_path, compactor=compactor, pool=pool
                )
        return idx

    # ------------------------------------------------------------ fields
    def field(self, name: str) -> Field | None:
        return self.fields.get(name)

    def create_field(self, name: str, options: FieldOptions | None = None) -> Field:
        if name in self.fields:
            raise ValueError(f"field {name!r} already exists")
        return self.create_field_if_not_exists(name, options)

    def create_field_if_not_exists(
        self, name: str, options: FieldOptions | None = None
    ) -> Field:
        existing = self.fields.get(name)
        if existing is not None:
            return existing
        with self._create_lock:
            return self._create_field_locked(name, options)

    def _create_field_locked(
        self, name: str, options: FieldOptions | None = None
    ) -> Field:
        existing = self.fields.get(name)
        if existing is not None:
            return existing
        field_path = os.path.join(self.path, name) if self.path else None
        f = Field(self.name, name, field_path, options or FieldOptions())
        f.compactor = self.compactor
        f.save_meta()
        self.fields[name] = f
        return f

    def delete_field(self, name: str) -> None:
        f = self.fields.pop(name, None)
        if f is None:
            raise KeyError(f"field {name!r} not found")
        f.close()
        if f.path and os.path.isdir(f.path):
            shutil.rmtree(f.path)

    # --------------------------------------------------------- existence
    def existence_field(self) -> Field | None:
        if not self.options.track_existence:
            return None
        return self.create_field_if_not_exists(
            EXISTENCE_FIELD, FieldOptions(field_type=FIELD_SET, cache_type="none")
        )

    def mark_columns_exist(self, cols: np.ndarray) -> None:
        ef = self.existence_field()
        if ef is None or not np.asarray(cols).size:
            return
        cols = np.asarray(cols, dtype=np.uint64)
        from pilosa_tpu_torch.core.fragment import MAX_OP_N

        if cols.size <= MAX_OP_N:  # the fragment's own snapshot threshold
            # small delta: the bit-list path op-logs it (cheap, durable)
            ef.import_bulk(np.zeros(cols.size, dtype=np.uint64), cols)
            return
        # bulk delta (import-roaring scale): a per-shard roaring union
        # with one snapshot — the bit-list machinery (sort, group,
        # op-log append, snapshot anyway at this size) is pure overhead
        view = ef.create_view_if_not_exists(VIEW_STANDARD)
        shards = cols // np.uint64(SHARD_WIDTH)
        for sh in np.unique(shards).tolist():
            frag = view.create_fragment_if_not_exists(int(sh))
            # existence row is 0: position == in-shard column offset
            frag.union_positions(cols[shards == sh] % np.uint64(SHARD_WIDTH))

    def mark_shard_columns(self, shard: int, col_bitmap) -> None:
        """Existence marking for a single-shard bulk adopt: the caller
        already holds the delta's shard-relative column set as a Bitmap
        (folded container-wise off the adopt delta — see
        roaring/build.py:fold_to_columns), so this unions it straight
        into the existence fragment with one WAL append. Row 0 of
        ``_exists`` puts position == column offset, so the folded bitmap
        IS the position bitmap."""
        ef = self.existence_field()
        if ef is None or not col_bitmap._containers:
            return
        frag = ef.create_view_if_not_exists(
            VIEW_STANDARD
        ).create_fragment_if_not_exists(int(shard))
        with frag._lock:
            if frag.row_count(0) >= SHARD_WIDTH:
                # every column of the shard is already marked: the union
                # is a no-op and must not pay an O(delta) merge + WAL
                # frame per post — sustained re-ingest into a warm shard
                # hits this on every import
                return
            frag.union_bitmap(col_bitmap)

    def available_shards(self) -> set[int]:
        shards: set[int] = set()
        for f in self.fields.values():
            shards |= f.available_shards()
        return shards

    def close(self) -> None:
        for f in self.fields.values():
            f.close()
        self.column_attrs.close()
        self.column_keys.close()
