"""``torch.cuda.max_memory_allocated()`` over set-up and window, GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes is not None else None
