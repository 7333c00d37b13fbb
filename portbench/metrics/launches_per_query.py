"""Planner and aggregates: launches of the hand-written kernels (every
``_cuda.KERNELS`` count) over the traced window, per answered query."""


def read(run):
    n = len(run.answered())
    if not n or not run.after:
        return None
    return sum(run.delta("launches", k) for k in run.after["launches"]) / n
