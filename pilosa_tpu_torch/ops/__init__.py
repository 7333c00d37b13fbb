"""Kernel library: plain torch versions and the hand-written CUDA kernels.

Reference: pilosa_tpu/ops and the GroupBy programs of
pilosa_tpu/executor/executor.py. Thirteen kernels, each with its plain
version beside it and a launch count on ``_cuda.KERNELS``; each line
names the reference function it replaces (paths under pilosa_tpu/):

- K1 ``bitwise.tree_eval`` (csrc/tree_eval.cu) <- executor/compile.py:1334
  ``_Planner.plan`` (with ops/bsi.py:60 compare, ops/containers.py:35,
  :53): a bitmap call tree as a postfix program, BSI conditions and
  compressed (sparse, run) row containers included → int32[S, W] words
  or an int64 count;
- K2 ``topn.row_counts`` (csrc/row_counts.cu) <- ops/bitwise.py:102
  ``matrix_filter_counts`` and ops/topn.py:29 ``candidate_counts``:
  per-row masked popcount summed over shards → int64[R];
- K3 ``stack.apply_stack_delta`` (csrc/stack_delta.cu) <-
  executor/compile.py:194 ``_apply_stack_delta``: the point-write delta
  scatter into a resident stack, and ``stack.scatter_rows`` <- :185
  ``_scatter_rows``, the row scatter into a tiered residency store;
- K4 ``bsi.bsi_sum`` (csrc/bsi_sum.cu) <- ops/bsi.py:113 ``sum_counts``:
  Sum's per-bit counts under G masks → int64 pos[G, D], neg[G, D], n[G];
- K5 ``bsi.bsi_min_max`` (csrc/bsi_minmax.cu) <- ops/bsi.py:152
  ``min_max``: Min/Max per shard → int64 value[S], count[S];
- the fused filters of K2, K4 (one mask) and K5 (``row_counts_tree``,
  ``bsi_sum_tree``, ``bsi_minmax_tree`` in the same sources) <-
  executor/executor.py:1019 ``_filter_plan``: the filter's call tree,
  a ``bitwise.PlannedFilter``, evaluated inside the aggregate's kernel
  by K1's interpreter (csrc/tree_interp.cuh);
- K6 ``groupby.gb_counts`` and ``groupby.gb_masks`` (csrc/groupby.cu) <-
  executor/executor.py:177 ``_gb_counts``, :192 ``_gb_masks``: GroupBy's
  level counts int64[G, K] and its group masks;
- K7 ``bitwise.shift_words`` (csrc/shift_words.cu) <- ops/bitwise.py:112
  ``shift_words``: PQL Shift, per shard;
- K8 ``containers.container_count`` (csrc/container_count.cu) <-
  ops/containers.py:113 ``sparse_count``, :119 ``run_count``: the count
  of one sparse or run container, read from its payload;
- K9 ``similarity.search_keys`` (csrc/similarity_scan.cu) <-
  ops/similarity.py:25 ``tanimoto_search``'s scan: one 64-bit score key
  per row and a histogram of their top digit;
- K10 ``similarity.select_top`` (csrc/similarity_scan.cu) <- the
  ``jax.lax.top_k`` of ops/similarity.py:25: the k largest keys in
  order → f32 scores[k], int32 ids[k]; ``similarity.select_counts``, its
  one-launch route for the top-k of up to 4,096 int64 counts; and
  ``similarity.select_sim``, its one-launch route for the mesh search's
  scores and top-k from up to 4,096 rows' reduced counts;
- K11 ``similarity.pairwise`` (csrc/pairwise.cu) <- ops/similarity.py:51
  ``pairwise_intersections`` (and :44 ``_unpack_bits_bf16``, B14-mm) with
  the epilogues of :63 ``tanimoto_matrix`` and :72 ``cosine_matrix`` →
  f32[N, M], on the tensor cores;
- K12 ``similarity.mesh_sim_keys`` and ``similarity.mesh_pairwise_finish``
  (csrc/mesh_finish.cu) <- parallel/mesh.py:684 and :796, the score
  lines of the mesh similarity programs: K10's keys from reduced
  counts past 4,096 rows, and the all-pairs epilogue on counts summed
  over the mesh; and ``similarity.count_keys`` <- the ``lax.top_k`` of
  int64 counts (parallel/mesh.py:647-652, ops/topn.py:24): the keys that
  K10's int mode selects, ties in row order, for
  ``topn.select_top_counts`` past 4,096 counts;
- K13 ``topn.ingest_counts`` (csrc/ingest_counts.cu) <-
  parallel/mesh.py:852 ``_ingest_prog`` and __graft_entry__.py:65
  ``query_step``: ``matrix |= delta`` in place with every row's count
  under a filter and their total, in one pass.

The public counts of ``ops.bitwise`` (``popcount``, ``popcount_rows``,
``count_*``, ``matrix_filter_counts``) launch K1 or K2 on a CUDA tensor;
``topn.top_rows`` and ``bsi.sum_device`` are the one-device twins of the
mesh engine's ``topn`` and ``bsi_sum``.

K1, K2, K4, K5, K6, K11 and K13 also take a mesh block's slice of the
word axis (parallel/mesh.py).
"""

from pilosa_tpu_torch.ops import bitwise, bsi, containers, groupby, similarity, stack, topn
from pilosa_tpu_torch.ops._cuda import KERNELS, resolve_device
from pilosa_tpu_torch.ops.bitwise import (
    PlannedFilter,
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
    w_and,
    w_andnot,
    w_not,
    w_or,
    w_xor,
)
from pilosa_tpu_torch.ops.bsi import bsi_min_max, bsi_sum, sum_device
from pilosa_tpu_torch.ops.groupby import gb_counts, gb_masks
from pilosa_tpu_torch.ops.containers import container_count
from pilosa_tpu_torch.ops.similarity import (
    cosine_matrix,
    pairwise_intersections,
    tanimoto_matrix,
    tanimoto_search,
)
from pilosa_tpu_torch.ops.stack import apply_stack_delta, scatter_rows
from pilosa_tpu_torch.ops.topn import (
    candidate_counts,
    ingest_counts,
    row_counts,
    select_top_counts,
    top_rows,
)

__all__ = [
    "KERNELS",
    "PlannedFilter",
    "apply_stack_delta",
    "bitwise",
    "bsi",
    "bsi_min_max",
    "bsi_sum",
    "candidate_counts",
    "column_mask",
    "container_count",
    "containers",
    "cosine_matrix",
    "count_and",
    "count_andnot",
    "count_or",
    "count_xor",
    "gb_counts",
    "gb_masks",
    "groupby",
    "ingest_counts",
    "matrix_filter_counts",
    "pairwise_intersections",
    "popcount",
    "popcount_rows",
    "popcount_words",
    "resolve_device",
    "row_counts",
    "scatter_rows",
    "select_top_counts",
    "shift_words",
    "similarity",
    "stack",
    "sum_device",
    "tanimoto_matrix",
    "tanimoto_search",
    "top_rows",
    "topn",
    "tree_eval",
    "w_and",
    "w_andnot",
    "w_not",
    "w_or",
    "w_xor",
]
