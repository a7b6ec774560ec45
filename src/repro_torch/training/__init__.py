"""The training step, Adam and checkpoints (``repro.training``)."""
from repro_torch.training.checkpoints import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.training.optimizer import adam_init, adam_update  # noqa: F401
from repro_torch.training.trainer import (  # noqa: F401
    TrainBatch,
    Trainer,
    TrainState,
    assemble_train_batch,
    recompute_prox_logp,
    score_tokens,
    sft_update,
)
from repro_torch.training.warmup import eval_reward, sft_warmup  # noqa: F401
