"""A-3PO: staleness-aware proximal policy approximation (paper §3;
``repro.core.a3po``).

The proximal policy used as the trust-region anchor in decoupled PPO is
*approximated* by log-linear interpolation between the behavior policy and
the live target policy, weighted by a staleness-aware coefficient:

    log pi_prox = alpha * log pi_behav + (1 - alpha) * log pi_theta
    alpha = 0 if d == 0 else 1/d,   d = version(theta) - version(behav)

plus the generalized alpha schedules of the reference (exp / clipped /
const). ``stop_gradient`` is ``.detach()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import RLConfig


def staleness(versions: torch.Tensor, current_version) -> torch.Tensor:
    """d = v(pi_theta) - v(pi_behav), clipped at >= 0. [B] or [B,T].
    ``current_version`` is a Python int or a 0-d tensor (no host sync)."""
    if isinstance(current_version, torch.Tensor):
        cur = current_version.to(device=versions.device,
                                 dtype=torch.float32)
    else:
        cur = float(current_version)
    return torch.clamp_min(cur - versions.float(), 0.0)


def alpha_from_staleness(d: torch.Tensor, cfg: Optional[RLConfig] = None,
                         schedule: Optional[str] = None) -> torch.Tensor:
    """Staleness-aware coefficient alpha (paper Eq. 4 + extensions).

    ``kl_adaptive`` needs the behavior/target logps (``kl_adaptive_alpha``,
    dispatched by ``core.objective.resolve_alpha``); called with only ``d``
    it degrades to the paper's inverse schedule, as the reference does.
    """
    cfg = cfg or RLConfig()
    schedule = schedule or cfg.alpha_schedule
    d = d.float()
    fresh = d < 1.0
    inv = 1.0 / torch.clamp_min(d, 1.0)
    if schedule in ("inverse", "kl_adaptive"):  # paper: alpha = 1/d, 0 at d=0
        a = torch.where(fresh, 0.0, inv)
    elif schedule == "exp":  # alpha = gamma^d (beyond-paper)
        a = torch.where(fresh, 0.0, torch.pow(cfg.alpha_gamma, d))
    elif schedule == "clipped":  # 1/d clipped into [lo, hi] (beyond-paper)
        lo, hi = cfg.alpha_clip
        a = torch.where(fresh, 0.0, torch.clamp(inv, lo, hi))
    elif schedule == "const":
        a = torch.where(fresh, 0.0, cfg.alpha_const)
    else:
        raise ValueError(f"unknown alpha schedule {schedule!r}")
    return a.float()


def compute_prox_logp_approximation(
    old_logp: torch.Tensor,     # log pi_behav  [B, T]
    logprobs: torch.Tensor,     # log pi_theta  [B, T] (live, detached here)
    versions: torch.Tensor,     # behavior policy versions [B] or [B, T]
    current_version,            # scalar int or 0-d tensor
    cfg: Optional[RLConfig] = None,
) -> torch.Tensor:
    """Approximate proximal log-probabilities (paper Listing 1), detached:
    the proximal policy is a frozen trust-region anchor. Elementwise only."""
    d = staleness(versions, current_version)
    alpha = alpha_from_staleness(d, cfg)
    if alpha.dim() == old_logp.dim() - 1:
        alpha = alpha[..., None]  # per-sequence alpha over tokens
    prox = alpha * old_logp.float() + (1.0 - alpha) * logprobs.float()
    return prox.detach()


def kl_adaptive_alpha(
    old_logp: torch.Tensor,     # log pi_behav  [B, T]
    logprobs: torch.Tensor,     # log pi_theta  [B, T]
    mask: torch.Tensor,         # [B, T] response mask
    target_kl: float = 0.05,
    alpha_min: float = 0.0,
    alpha_max: float = 1.0,
) -> torch.Tensor:
    """Beyond-paper: alpha per sequence so that the anchor sits a fixed KL
    distance from the target policy, alpha = sqrt(target / kl_hat), with
    kl_hat the k1 estimate on the response tokens. Returns [B, 1], detached.
    """
    diff = (logprobs - old_logp).float()
    denom = torch.clamp_min(mask.sum(dim=-1), 1.0)
    kl_hat = torch.abs((diff * mask).sum(dim=-1) / denom)
    alpha = torch.sqrt(target_kl / torch.clamp_min(kl_hat, 1e-8))
    alpha = torch.clamp(alpha, alpha_min, alpha_max)[..., None]
    return alpha.detach()


def compute_prox_logp_kl_adaptive(
    old_logp: torch.Tensor,
    logprobs: torch.Tensor,
    mask: torch.Tensor,
    target_kl: float = 0.05,
    alpha_min: float = 0.0,
    alpha_max: float = 1.0,
) -> torch.Tensor:
    """KL-adaptive proximal anchor: the log-linear interpolation at the
    per-sequence ``kl_adaptive_alpha`` weight, detached."""
    alpha = kl_adaptive_alpha(old_logp, logprobs, mask, target_kl,
                              alpha_min, alpha_max)
    prox = alpha * old_logp.float() + (1.0 - alpha) * logprobs.float()
    return prox.detach()
