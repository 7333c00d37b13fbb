"""Kernel library: plain torch versions and the hand-written CUDA kernels.

Reference: pilosa_tpu/ops and the GroupBy programs of
pilosa_tpu/executor/executor.py. Eight kernels, each with its plain
version beside it and a launch count on ``_cuda.KERNELS``:

- K1 ``bitwise.tree_eval`` (csrc/tree_eval.cu): a bitmap call tree as a
  postfix program, BSI conditions and compressed (sparse, run) row
  containers included → int32[S, W] words or an int64 count;
- K2 ``topn.row_counts`` (csrc/row_counts.cu): per-row masked popcount
  summed over shards → int64[R] (TopN, and its ids= recount);
- K3 ``stack.apply_stack_delta`` (csrc/stack_delta.cu): the point-write
  delta scatter into a resident stack, and ``stack.scatter_rows``, the
  row scatter into a tiered residency store;
- K4 ``bsi.bsi_sum`` (csrc/bsi_sum.cu): Sum's per-bit counts under G
  masks → int64 pos[G, D], neg[G, D], n[G];
- K5 ``bsi.bsi_min_max`` (csrc/bsi_minmax.cu): Min/Max per shard →
  int64 value[S], count[S];
- K6 ``groupby.gb_counts`` and ``groupby.gb_masks`` (csrc/groupby.cu):
  GroupBy's level counts int64[G, K] and its group masks;
- K7 ``bitwise.shift_words`` (csrc/shift_words.cu): PQL Shift, per shard;
- K8 ``containers.container_count`` (csrc/container_count.cu): the count
  of one sparse or run container, read from its payload.
"""

from pilosa_tpu_torch.ops import bitwise, bsi, containers, groupby, stack, topn
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
    shift_words,
    tree_eval,
)
from pilosa_tpu_torch.ops.bsi import bsi_min_max, bsi_sum
from pilosa_tpu_torch.ops.groupby import gb_counts, gb_masks
from pilosa_tpu_torch.ops.containers import container_count
from pilosa_tpu_torch.ops.stack import apply_stack_delta, scatter_rows
from pilosa_tpu_torch.ops.topn import candidate_counts, row_counts

__all__ = [
    "KERNELS",
    "apply_stack_delta",
    "bitwise",
    "bsi",
    "bsi_min_max",
    "bsi_sum",
    "candidate_counts",
    "column_mask",
    "container_count",
    "containers",
    "count_and",
    "count_andnot",
    "count_or",
    "count_xor",
    "gb_counts",
    "gb_masks",
    "groupby",
    "matrix_filter_counts",
    "popcount",
    "popcount_rows",
    "popcount_words",
    "resolve_device",
    "row_counts",
    "scatter_rows",
    "shift_words",
    "stack",
    "topn",
    "tree_eval",
]
