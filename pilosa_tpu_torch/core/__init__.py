"""L1 storage & data model: Holder → Index → Field → View → Fragment.

Reference: holder.go, index.go, field.go, view.go, fragment.go, cache.go.
"""

from pilosa_tpu_torch.core.cache import LRUCache, NopCache, RankCache, make_cache
from pilosa_tpu_torch.core.field import (
    BSI_EXISTS,
    BSI_OFFSET,
    BSI_SIGN,
    FIELD_BOOL,
    FIELD_INT,
    FIELD_MUTEX,
    FIELD_SET,
    FIELD_TIME,
    Field,
    FieldOptions,
)
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import EXISTENCE_FIELD, Index, IndexOptions
from pilosa_tpu_torch.core.view import VIEW_BSI, VIEW_STANDARD, View

__all__ = [
    "Holder",
    "Index",
    "IndexOptions",
    "Field",
    "FieldOptions",
    "Fragment",
    "View",
    "RankCache",
    "LRUCache",
    "NopCache",
    "make_cache",
    "VIEW_STANDARD",
    "VIEW_BSI",
    "EXISTENCE_FIELD",
    "FIELD_SET",
    "FIELD_MUTEX",
    "FIELD_BOOL",
    "FIELD_TIME",
    "FIELD_INT",
    "BSI_EXISTS",
    "BSI_SIGN",
    "BSI_OFFSET",
]
