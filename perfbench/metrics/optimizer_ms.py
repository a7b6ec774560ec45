"""Device time a traced step, in ms, of the operations launched inside
the program's ``train_optimizer`` spans (``training/trainer.py``
``_train_step``): the clip's global norm, the non-finite guard and the
eager float32 Adam over every leaf (``training/optimizer.py``
``adam_update``), once a minibatch."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(run, "train_optimizer")
