"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card (the union of the device trace's intervals)."""

from portbench.trace import union_length


def read(run):
    window = run.t_done - run.t_go
    if not run.events or window <= 0:
        return None
    return 100.0 * (1.0 - union_length([(a, b) for a, b, _ in run.events]) / 1e6 / window)
