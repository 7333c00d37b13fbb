"""L0 bitmap engine: host-side roaring codec, persistence, dense packing.

Reference: roaring/ (roaring.go, btree.go). On TPU the hot ops run on
dense packed words (see ``pilosa_tpu_torch.ops``); this package is the at-rest
format, import/export interchange, CPU oracle, and host baseline.
"""

from pilosa_tpu_torch.roaring.bitmap import Bitmap
from pilosa_tpu_torch.roaring.build import (
    bitmap_from_positions,
    payload_from_positions,
    shard_payloads,
    split_by_shard,
)
from pilosa_tpu_torch.roaring.containers import Container
from pilosa_tpu_torch.roaring.pack import (
    pack_positions,
    pack_range,
    unpack_words,
    words_count,
)
from pilosa_tpu_torch.roaring.serialize import (
    OP_ADD,
    OP_REMOVE,
    OP_UNION,
    ReplayResult,
    append_op,
    append_union_op,
    deserialize,
    replay_ops,
    replay_ops_checked,
    serialize,
    serialize_official,
)

__all__ = [
    "Bitmap",
    "Container",
    "pack_positions",
    "pack_range",
    "unpack_words",
    "words_count",
    "serialize",
    "serialize_official",
    "deserialize",
    "append_op",
    "append_union_op",
    "replay_ops",
    "replay_ops_checked",
    "ReplayResult",
    "OP_ADD",
    "OP_REMOVE",
    "OP_UNION",
    "bitmap_from_positions",
    "payload_from_positions",
    "shard_payloads",
    "split_by_shard",
]
