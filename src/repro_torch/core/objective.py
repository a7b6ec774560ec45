"""Unified A-3PO training objective (``repro.core.objective``).

One interface for the three methods the paper compares:

* ``sync``      — coupled PPO/GRPO (Eq. 1): pi_old is IS weight + anchor.
* ``recompute`` — decoupled PPO (Eq. 2) with an explicitly recomputed
                  proximal anchor (the forward pass A-3PO deletes).
* ``loglinear`` — A-3PO (Eq. 3-4 / Listing 1): the anchor is a log-linear
                  interpolation weighted by the staleness-aware alpha.

``resolve_alpha`` is the single dispatch point for every alpha schedule,
including the beyond-paper ``kl_adaptive`` controller. The ``loglinear``
objective runs through the reduced ``kernels/a3po_loss`` kernel (an
autograd ``Function`` with an analytic backward): the surrogate, its KL
and entropy terms and its metrics in one launch each way.
``stop_gradient`` is ``.detach()``; masked extremes select with
``torch.where`` and +-inf, never by multiplying.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RLConfig
from repro_torch.core.a3po import (
    alpha_from_staleness,
    kl_adaptive_alpha,
    staleness,
)
from repro_torch.kernels.a3po_loss import (
    REDUCED_KEYS,
    a3po_objective_reduced,
)

Metrics = Dict[str, torch.Tensor]


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask > 0, x, float("-inf")).max()


def _masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask > 0, x, float("inf")).min()


def clip_objective(ratio: torch.Tensor, adv: torch.Tensor, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PPO clipped surrogate per token. Returns (objective, clipped_mask)."""
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - eps, 1.0 + eps) * adv
    obj = torch.minimum(unclipped, clipped)
    was_clipped = (unclipped > clipped).float()
    return obj, was_clipped


def common_metrics(iw, ratio, was_clipped, mask, entropy) -> Metrics:
    m: Metrics = {
        "iw_max": _masked_max(iw, mask),
        "iw_min": _masked_min(iw, mask),
        "iw_mean": masked_mean(iw, mask),
        "ratio_mean": masked_mean(ratio, mask),
        "clipped_tokens": (was_clipped * mask).sum(),
        "clipped_frac": masked_mean(was_clipped, mask),
    }
    if entropy is not None:
        m["entropy"] = masked_mean(entropy, mask)
    return m


def apply_regularizers(loss: torch.Tensor, metrics: Metrics,
                       logp: torch.Tensor, anchor_logp: torch.Tensor,
                       mask: torch.Tensor, cfg: RLConfig,
                       entropy: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, Metrics]:
    """Shared loss tail for every algorithm: KL penalty + entropy bonus.

    ``kl`` is the k1 estimator of KL(pi_theta || anchor) on the response
    tokens against the algorithm's trust-region anchor (detached); always
    reported, added to the loss when ``cfg.kl_coef`` is set.
    """
    kl = masked_mean(logp.float() - anchor_logp.float().detach(), mask)
    metrics["kl"] = kl
    if cfg.kl_coef:
        loss = loss + cfg.kl_coef * kl
    if entropy is not None and cfg.entropy_coef:
        loss = loss - cfg.entropy_coef * metrics["entropy"]
    return loss, metrics


# ------------------------------------------------------------- alpha dispatch
def resolve_alpha(
    cfg: RLConfig,
    *,
    versions: Optional[torch.Tensor] = None,
    current_version=None,
    logp: Optional[torch.Tensor] = None,
    behav_logp: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    schedule: Optional[str] = None,
) -> torch.Tensor:
    """The one place every alpha schedule is dispatched from.

    Staleness schedules need the ``[B]`` or ``[B, T]`` version stamps;
    ``kl_adaptive`` needs the live/behavior logps and yields ``[B, 1]``.
    The result broadcasts against ``[B, T]`` and carries no gradient.
    """
    schedule = schedule or cfg.alpha_schedule
    if schedule == "kl_adaptive":
        assert logp is not None and behav_logp is not None \
            and mask is not None, "kl_adaptive alpha needs logps + mask"
        return kl_adaptive_alpha(behav_logp, logp, mask)
    assert versions is not None and current_version is not None, \
        f"schedule {schedule!r} needs version stamps"
    return alpha_from_staleness(staleness(versions, current_version), cfg,
                                schedule)


# --------------------------------------------------------------- plain paths
def coupled_ppo_loss(
    logp: torch.Tensor,        # log pi_theta  [B, T]
    behav_logp: torch.Tensor,  # log pi_behav  [B, T]
    advantages: torch.Tensor,  # [B, T] (already broadcast / normalized)
    mask: torch.Tensor,        # [B, T] response mask
    cfg: RLConfig,
    entropy: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Metrics]:
    """Standard PPO/GRPO (Eq. 1): pi_old doubles as IS weight + anchor."""
    logp = logp.float()
    behav_logp = behav_logp.float()
    ratio = torch.exp(logp - behav_logp)
    obj, was_clipped = clip_objective(ratio, advantages, cfg.clip_eps)
    loss = -masked_mean(obj, mask)
    metrics = common_metrics(ratio, ratio, was_clipped, mask, entropy)
    return apply_regularizers(loss, metrics, logp, behav_logp, mask, cfg,
                              entropy)


def decoupled_ppo_loss(
    logp: torch.Tensor,
    behav_logp: torch.Tensor,
    prox_logp: torch.Tensor,   # frozen trust-region anchor [B, T]
    advantages: torch.Tensor,
    mask: torch.Tensor,
    cfg: RLConfig,
    entropy: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Metrics]:
    """Decoupled loss (Eq. 2): behavior IS weight x prox-anchored clip."""
    logp = logp.float()
    behav_logp = behav_logp.float()
    prox_logp = prox_logp.float().detach()
    # importance weight pi_prox / pi_behav: detached, capped for stability
    iw = torch.clamp(torch.exp(prox_logp - behav_logp),
                     max=cfg.behav_weight_cap).detach()
    # trust-region ratio pi_theta / pi_prox
    ratio = torch.exp(logp - prox_logp)
    obj, was_clipped = clip_objective(ratio, advantages, cfg.clip_eps)
    loss = -masked_mean(iw * obj, mask)
    metrics = common_metrics(iw, ratio, was_clipped, mask, entropy)
    return apply_regularizers(loss, metrics, logp, prox_logp, mask, cfg,
                              entropy)


# ---------------------------------------------------------------- fused path
def fused_a3po_loss(
    logp: torch.Tensor,
    behav_logp: torch.Tensor,
    alpha: torch.Tensor,       # [B, T], [B, 1] or [B]: broadcast over tokens
    advantages: torch.Tensor,
    mask: torch.Tensor,
    cfg: RLConfig,
    entropy: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Metrics]:
    """A-3PO decoupled loss through the reduced kernel + analytic backward.

    Numerically the ``decoupled_ppo_loss`` over the log-linear anchor
    ``alpha * behav + (1 - alpha) * logp``, with interpolation, IS weight,
    ratio, clip, masking, the masked reductions of the loss and its
    metrics and the regularizers of ``apply_regularizers`` in one pass.
    """
    logp = logp.float()
    behav_logp = behav_logp.float()
    if alpha.dim() == logp.dim() - 1:
        alpha = alpha[..., None]
    alpha = torch.broadcast_to(alpha, logp.shape).float().detach()
    loss, vec = a3po_objective_reduced(
        logp, behav_logp, alpha, advantages, mask, entropy,
        clip_eps=cfg.clip_eps, iw_cap=cfg.behav_weight_cap,
        kl_coef=cfg.kl_coef, entropy_coef=cfg.entropy_coef)
    metrics: Metrics = dict(zip(REDUCED_KEYS, vec.unbind()))
    del metrics["denom"]
    if entropy is None:
        del metrics["entropy"]
    return loss, metrics


# ------------------------------------------------------------------ dispatch
def policy_objective(
    algo=None,
    logp: Optional[torch.Tensor] = None,
    behav_logp: Optional[torch.Tensor] = None,
    advantages: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    cfg: Optional[RLConfig] = None,
    *,
    versions: Optional[torch.Tensor] = None,
    current_version=None,
    recomputed_prox_logp: Optional[torch.Tensor] = None,
    entropy: Optional[torch.Tensor] = None,
    method: Optional[str] = None,
) -> Tuple[torch.Tensor, Metrics]:
    """Unified objective, dispatched through the Algorithm registry.

    ``algo`` is an ``Algorithm`` instance (``repro_torch.core.algorithms``)
    or a registry name. A name, positionally or as the legacy ``method=``
    keyword, still resolves but emits a ``DeprecationWarning``.
    """
    import warnings

    from repro_torch.core.algorithms import (
        Algorithm,
        LossInputs,
        get_algorithm,
    )

    if method is not None:
        warnings.warn(
            "policy_objective(method=...) is deprecated; pass an Algorithm "
            "from repro_torch.core.algorithms (e.g. get_algorithm('a3po'))",
            DeprecationWarning, stacklevel=2)
        if algo is None:
            algo = method
    if isinstance(algo, str):
        if method is None:
            warnings.warn(
                f"stringly-typed policy_objective({algo!r}, ...) is "
                "deprecated; pass an Algorithm from "
                "repro_torch.core.algorithms",
                DeprecationWarning, stacklevel=2)
        algo = get_algorithm(algo)
    assert isinstance(algo, Algorithm), algo
    batch = LossInputs(
        behav_logp=behav_logp, advantages=advantages, mask=mask,
        versions=versions, current_version=current_version,
        prox_logp=recomputed_prox_logp, entropy=entropy)
    return algo.loss(logp, batch, cfg or RLConfig())
