"""Plain PyTorch version of the fused A-3PO loss kernel
(``repro.kernels.a3po_loss.ref``) and of its analytic backward
(``repro.kernels.a3po_loss.ops._a3po_objective_bwd``).

``a3po_loss_ref`` is differentiable end to end (the prox anchor and the
importance weight are detached, as in the modular loss), so the tests use
it as the gradient oracle of the fused path. The operation order follows
the reference, so that the CUDA kernel, which keeps each rounding, agrees
with it to the last bit on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def a3po_loss_ref(logp: torch.Tensor, behav_logp: torch.Tensor,
                  alpha: torch.Tensor, adv: torch.Tensor, mask: torch.Tensor,
                  *, clip_eps: float, iw_cap: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Per-token fused A-3PO objective.

    Returns (loss_tok [T] (negated objective, masked), clipped [T]
    (masked), iw [T], ratio [T]).
    """
    logp = logp.float()
    behav = behav_logp.float()
    prox = (alpha * behav + (1.0 - alpha) * logp).detach()
    iw = torch.clamp(torch.exp(prox - behav), max=iw_cap).detach()
    ratio = torch.exp(logp - prox)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    obj = torch.minimum(unclipped, clipped)
    was_clipped = (unclipped > clipped).float() * mask
    return -iw * obj * mask, was_clipped, iw, ratio


def a3po_loss_bwd_ref(g_loss: torch.Tensor, clip_tok: torch.Tensor,
                      iw: torch.Tensor, ratio: torch.Tensor,
                      adv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """d loss_tok / d logp times the cotangent ``g_loss``.

    The anchor and the importance weight are frozen, so the only path is
    -iw * mask * d obj / d logp, with d obj / d logp = ratio * adv on the
    unclipped branch and 0 where the clip is active (``clip_tok`` folds
    the mask in). At exact min-ties both branches carry ratio * adv, as
    ``jnp.minimum``'s split gradient does.
    """
    live = 1.0 - torch.where(clip_tok > 0, 1.0, 0.0)
    return g_loss.float() * (-(iw * ratio * adv) * mask * live)
