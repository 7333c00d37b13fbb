"""Query execution (reference: pilosa_tpu/executor): PQL → postfix
programs and kernel launches, the cost router, the host engine and the
cross-query wave scheduler."""

from pilosa_tpu_torch.executor.executor import ExecutionError, Executor, SumCount
from pilosa_tpu_torch.executor.row import RowResult
from pilosa_tpu_torch.executor.scheduler import WaveScheduler

__all__ = [
    "Executor",
    "ExecutionError",
    "RowResult",
    "SumCount",
    "WaveScheduler",
]
