"""Queries answered inside the window, over the window's seconds."""


def read(run):
    done = [r for r in run.records if r[4] == 200 and r[3] <= run.t_end]
    return len(done) / run.seconds
