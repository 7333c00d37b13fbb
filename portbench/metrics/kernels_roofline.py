"""Kernels: the bytes the traced window's queries need (``roofline.py``,
from each query and the data's shapes), at the card's peak bandwidth,
over the time some kernel ran (the union of the trace's kernel
intervals), in %. Given only where every answered query ran on the
device once: none routed to the host, none merged into another's
execution by the scheduler, and the trace holds at least as many
kernels as the hand-written kernels' launch counters."""

from portbench.roofline import peak_bytes_per_s
from portbench.trace import union_length


def read(run):
    n = len(run.answered())
    if not n or not run.kernels:
        return None
    on_device = run.delta("decisions", "device") + run.delta("decisions", "mesh")
    launched = sum(run.delta("launches", k) for k in run.after["launches"])
    if on_device != n or run.delta("scheduler", "dedupedQueries") or len(run.kernels) < launched:
        return None
    busy_s = union_length([(a, b) for a, b, _ in run.kernels]) / 1e6
    return 100.0 * run.query_bytes / peak_bytes_per_s(run.card) / busy_s
