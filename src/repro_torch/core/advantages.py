"""Advantage estimation: group reward normalization (GRPO-style, §4.1;
``repro.core.advantages``)."""
from __future__ import annotations

import torch


def group_normalized_advantages(rewards: torch.Tensor, group_size: int,
                                eps: float = 1e-6) -> torch.Tensor:
    """rewards [B] with B = n_prompts * group_size (grouped contiguously).

    A_i = (r_i - mean_group) / (std_group + eps), the population std as
    ``jnp.std``; broadcast per-token by the caller.
    """
    B = rewards.shape[0]
    assert B % group_size == 0, (B, group_size)
    g = rewards.reshape(B // group_size, group_size).float()
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, unbiased=False)
    return ((g - mean) / (std + eps)).reshape(B)


def broadcast_over_tokens(adv: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """[B] sequence advantages -> [B, T] token advantages (masked)."""
    return adv[:, None] * mask.float()
