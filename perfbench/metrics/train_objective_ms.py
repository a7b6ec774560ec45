"""Device time a traced step, in ms, of the operations launched inside
the program's ``train_objective`` spans (``training/trainer.py``
``_loss_and_grads``, around ``algo.loss``): A-3PO's interpolated proximal
log-prob, the loss kernel's forward and its metric vector (``recompute``:
the decoupled loss), once a minibatch."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(run, "train_objective")
