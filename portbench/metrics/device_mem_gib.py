"""The card's peak of allocated memory over set-up and window
(``torch.cuda.max_memory_allocated()``), in GiB: what the index and
its queries cost of the card."""


def read(run):
    return run.mem_peak_bytes / 2**30 if run.mem_peak_bytes else None
