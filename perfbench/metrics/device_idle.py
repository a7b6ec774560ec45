"""The share of a step in which no operation runs on the card, in %: one
minus the device's busy time a traced step (the union of the device
events' intervals over the traced steps, one on each of the pool's
batches) over the window's wall time a step. The window runs without the
profiler: its host cost slows a traced step by 8-55 % on an H100,
unevenly from host to host, which would read as idle time of the
program's."""


def read(run):
    if run.trace is None or not run.trace.device or not run.steps:
        return None
    busy = run.trace.busy_ns() / 1e9 / len(run.traced_steps)
    return 100.0 * (1.0 - busy / (run.window_s / len(run.steps)))
