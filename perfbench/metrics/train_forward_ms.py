"""Device time a traced step, in ms, of the operations launched inside
the program's ``train_forward`` spans (``training/trainer.py``
``_loss_and_grads``): the model's forward (``forward_hidden``, remat
saving each layer's input) and the tied head's log-prob forward kernel,
once a minibatch (``spans``: matched by launch time on any thread)."""
from perfbench import spans


def read(run):
    return spans.device_ms_per_step(run, "train_forward")
