"""Kernel library: plain torch versions and the hand-written CUDA kernels.

Reference: pilosa_tpu/ops. Three kernels, each with its plain version
beside it and a launch count on ``_cuda.KERNELS``:

- K1 ``bitwise.tree_eval`` (csrc/tree_eval.cu): a bitmap call tree as a
  postfix program → int32[S, W] words or an int64 count;
- K2 ``topn.row_counts`` (csrc/row_counts.cu): per-row masked popcount
  summed over shards → int64[R] (TopN, and its ids= recount);
- K3 ``stack.apply_stack_delta`` (csrc/stack_delta.cu): the point-write
  delta scatter into a resident stack.
"""

from pilosa_tpu_torch.ops import bitwise, stack, topn
from pilosa_tpu_torch.ops._cuda import KERNELS, resolve_device
from pilosa_tpu_torch.ops.bitwise import (
    column_mask,
    count_and,
    count_andnot,
    count_or,
    count_xor,
    matrix_filter_counts,
    popcount,
    popcount_rows,
    popcount_words,
    tree_eval,
)
from pilosa_tpu_torch.ops.stack import apply_stack_delta
from pilosa_tpu_torch.ops.topn import candidate_counts, row_counts

__all__ = [
    "KERNELS",
    "apply_stack_delta",
    "bitwise",
    "candidate_counts",
    "column_mask",
    "count_and",
    "count_andnot",
    "count_or",
    "count_xor",
    "matrix_filter_counts",
    "popcount",
    "popcount_rows",
    "popcount_words",
    "resolve_device",
    "row_counts",
    "stack",
    "topn",
    "tree_eval",
]
