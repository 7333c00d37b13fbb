"""L2 query language: PQL parsing (reference: pql/ package)."""

from pilosa_tpu_torch.pql.ast import Call, Condition
from pilosa_tpu_torch.pql.parser import PQLError, coerce_timestamp, parse

__all__ = ["Call", "Condition", "parse", "PQLError", "coerce_timestamp"]
