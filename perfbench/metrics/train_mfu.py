"""Model operations of the window's steps (``counts``: forward and
backward of every position that predicts a token, the causal attention
term included, remat's recompute not; ``recompute``'s proximal forward
added) over the window's wall time on the host's clock, against the
card's bf16 peak, in %. The window runs without the profiler, whose host
cost would slow it."""
from perfbench import counts


def read(run):
    if not run.steps:
        return None
    flops = sum(counts.train_step_flops(
        run.model, run.pool[s["slot"]]["lengths"], run.traffic["algo"])
        for s in run.steps)
    return 100.0 * flops / run.window_s / counts.PEAK_BF16_FLOPS
