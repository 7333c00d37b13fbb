"""X1 cross-cutting utilities: stats, tracing, config, logging."""

from pilosa_tpu_torch.utils.stats import Histogram, NopStats, StatsClient
from pilosa_tpu_torch.utils.tracing import GLOBAL_TRACER, Tracer

__all__ = ["StatsClient", "NopStats", "Histogram", "Tracer", "GLOBAL_TRACER"]
