"""The 95th percentile (nearest rank) of the latency of every request
sent in the window, from the clients' raw samples; a failed request
counts as slower than any answer. None where the percentile falls on a
failed request: that run is not correct either."""

from portbench.latency import p95


def read(run):
    return p95(run)
