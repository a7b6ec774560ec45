"""Mean over the window's steps of the step's own ``prox_time_s``: the
host clock around the synchronised proximal forward (``recompute``)."""


def read(run):
    if run.traffic["algo"] != "recompute" or not run.steps:
        return None
    return 1e3 * sum(s["prox_s"] for s in run.steps) / len(run.steps)
