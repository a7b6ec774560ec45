"""Device time a traced step, in ms, of the operations launched inside
the program's ``train_backward`` spans (``training/trainer.py``
``_grads``, ``torch.autograd.grad``): remat's recompute, the model's
backward and the log-prob and A-3PO backward kernels, once a minibatch.
Autograd launches them from its device thread, so they are matched by
launch time, not by thread (``spans``)."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(run, "train_backward")
