"""SFT warmup and held-out greedy eval (``benchmarks.bench_training``'s
``sft_warmup`` and ``eval_reward``, which the JAX package's examples
import from its benchmarks).

``sft_warmup`` warms a freshly initialised model with supervised steps on
the task's answers, so that RL starts from a policy that is not
degenerate; ``eval_reward`` scores greedy decoding on held-out prompts
(the paper's Fig. 3). Both run on the card unless the caller asks for the
CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.models.model import require_device
from repro_torch.rollout.engine import RolloutEngine
from repro_torch.training.trainer import Trainer, sft_update


def sft_warmup(cfg: ModelConfig, task: ArithmeticTask, steps: int = 150,
               batch: int = 32, total_len: int = 14, lr: float = 3e-3,
               seed: int = 0, device="cuda"):
    """Supervised warmup so RL starts from a non-degenerate base policy:
    ``steps`` of ``sft_update`` on ``task.sft_batch(batch, total_len)``
    from ``Trainer(cfg, RLConfig()).init_state`` seeded by ``seed``.
    Returns (params, the last step's loss)."""
    device = require_device(device)
    state = Trainer(cfg, RLConfig()).init_state(
        torch.Generator(device=device).manual_seed(seed), device=device)
    params, opt = state.params, state.opt
    loss = None
    for _ in range(steps):
        toks, mask = task.sft_batch(batch, total_len)
        params, opt, loss = sft_update(
            cfg, params, opt, torch.as_tensor(toks, dtype=torch.long,
                                              device=device),
            torch.as_tensor(mask, device=device), lr=lr)
    return params, float(loss)


def eval_reward(cfg: ModelConfig, params, task: ArithmeticTask, n: int = 64,
                max_new: int = 6, seed: int = 123,
                device: Optional[torch.device] = None) -> float:
    """Greedy decoding on ``n`` held-out prompts (``ArithmeticTask`` of the
    same shape, seeded ``seed``) through ``RolloutEngine.generate``: the
    mean reward. It runs where ``params`` lie; ``device``, where given,
    must be that device."""
    where = params["embedding"]["embed"].device
    if device is not None and torch.device(device).type != where.type:
        raise ValueError(f"eval_reward: params lie on {where}, not {device}")
    engine = RolloutEngine(cfg, RLConfig(), max_new_tokens=max_new)
    eval_task = ArithmeticTask(task.max_operand, task.n_terms,
                               task.prompt_len, seed=seed)
    b = eval_task.sample(n)
    rb = engine.generate(params, b.prompts, b.prompt_lengths, greedy=True)
    return float(eval_task.rewards(engine.completions(rb),
                                   b.answers).mean())
