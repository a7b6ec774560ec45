"""Non-padding tokens (prompt and response) of every row of every step in
the window, over the window's wall time (host clock)."""
from perfbench import traffic


def read(run):
    if not run.steps:
        return None
    tokens = sum(traffic.real_tokens(run.pool[s["slot"]]) for s in run.steps)
    return tokens / run.window_s
