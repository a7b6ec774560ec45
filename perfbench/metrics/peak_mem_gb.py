"""``torch.cuda.max_memory_allocated()`` over the window and the traced
steps after it, reset at the window's start, in GB."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
