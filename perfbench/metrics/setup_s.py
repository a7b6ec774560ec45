"""Process start to the window's start (host clock): imports, the kernel
build or load, weights, inputs and the checked steps that warm the
window's shapes."""


def read(run):
    return getattr(run, "setup_s", None)
