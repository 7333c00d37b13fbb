"""Wave scheduler: queries batched per wave over the traced window
(``WaveScheduler.snapshot()``'s batchedQueries over waves)."""


def read(run):
    waves = run.delta("scheduler", "waves")
    return run.delta("scheduler", "batchedQueries") / waves if waves else None
