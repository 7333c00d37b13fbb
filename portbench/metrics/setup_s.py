"""Set-up: process start to the first timed request (loading, the
device probe, stack uploads, warm-up and, on a first run, the kernels'
build), by the host's clock."""


def read(run):
    return run.setup_s
