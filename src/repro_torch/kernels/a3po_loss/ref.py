"""Plain PyTorch version of the fused A-3PO loss kernel
(``repro.kernels.a3po_loss.ref``) and of its analytic backward
(``repro.kernels.a3po_loss.ops._a3po_objective_bwd``).

``a3po_loss_ref`` is differentiable end to end (the prox anchor and the
importance weight are detached, as in the modular loss), so the tests use
it as the gradient oracle of the fused path. The operation order follows
the reference, so that the CUDA kernel, which keeps each rounding, agrees
with it to the last bit on the card.

``a3po_reduced_ref`` / ``a3po_reduced_bwd_ref`` are the plain versions of
the reduced kernels: the A-3PO objective of a minibatch (the masked-mean
loss with its KL and entropy terms, and its metrics) and its gradient,
as the eager sequence of ``core.objective`` computed them op for op
before the reductions moved into the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# Slots of the reduced kernels' metric vector, in order (``csrc/a3po_loss.cu``
# writes the same order). ``denom`` is max(sum(mask), 1), which the
# backward divides by; ``entropy`` is NaN where no entropy was given.
REDUCED_KEYS = ("iw_max", "iw_min", "iw_mean", "ratio_mean",
                "clipped_tokens", "clipped_frac", "kl", "entropy", "denom")


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
    return g_loss.float() * a3po_bwd_coef(clip_tok, iw, ratio, adv, mask)


def a3po_bwd_coef(clip_tok: torch.Tensor, iw: torch.Tensor,
                  ratio: torch.Tensor, adv: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """d loss_tok / d logp per token, c = -iw * ratio * adv * mask * live
    (live: 0 where the clip is active)."""
    live = 1.0 - torch.where(clip_tok > 0, 1.0, 0.0)
    return -(iw * ratio * adv) * mask * live


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def a3po_reduced_ref(logp: torch.Tensor, behav_logp: torch.Tensor,
                     alpha: torch.Tensor, adv: torch.Tensor,
                     mask: torch.Tensor, entropy: Optional[torch.Tensor],
                     *, clip_eps: float, iw_cap: float, kl_coef: float,
                     entropy_coef: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The A-3PO objective of a minibatch, any shape (all operands alike).

    Returns ``(loss, metrics [len(REDUCED_KEYS)], coef)``: the masked-mean
    surrogate plus ``kl_coef`` x KL to the log-linear anchor minus
    ``entropy_coef`` x the masked-mean entropy (each term only where its
    coefficient is set, and the entropy's only where ``entropy`` is
    given), the metrics by ``REDUCED_KEYS``, and the per-token backward
    coefficient ``a3po_bwd_coef`` [T]. Not differentiable: the gradient
    is ``a3po_reduced_bwd_ref``.
    """
    flat = [x.reshape(-1) for x in (logp, behav_logp, alpha, adv)]
    loss_tok, clip_tok, iw, ratio = (
        o.reshape(logp.shape) for o in a3po_loss_ref(
            *flat, mask.float().reshape(-1), clip_eps=clip_eps,
            iw_cap=iw_cap))
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = loss_tok.sum() / denom
    clipped = clip_tok.sum()
    kl = _masked_mean(logp - (alpha * behav_logp + (1.0 - alpha) * logp),
                      mask)
    ent = (_masked_mean(entropy, mask) if entropy is not None
           else torch.full_like(kl, float("nan")))
    metrics = torch.stack([
        torch.where(mask > 0, iw, float("-inf")).max(),
        torch.where(mask > 0, iw, float("inf")).min(),
        _masked_mean(iw, mask), _masked_mean(ratio, mask), clipped,
        clipped / denom, kl, ent, denom]).float()
    if kl_coef:
        loss = loss + kl_coef * kl
    if entropy is not None and entropy_coef:
        loss = loss - entropy_coef * ent
    coef = a3po_bwd_coef(clip_tok, iw, ratio, adv,
                         mask.float()).reshape(-1)
    return loss, metrics, coef


def a3po_reduced_bwd_ref(g: torch.Tensor, denom: torch.Tensor,
                         coef: torch.Tensor, mask: torch.Tensor, *,
                         kl_coef: float, entropy_coef: float,
                         with_entropy: bool
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradient of ``a3po_reduced_ref``'s loss: (d logp, d entropy or
    None) [T] for the loss's cotangent ``g`` (0-d), rounded as autograd
    rounds the eager sequence (g / denom times c, plus (g kl_coef) / denom
    times the mask; (-g entropy_coef) / denom times the mask)."""
    g_logp = (g / denom) * coef
    if kl_coef:
        g_logp = g_logp + ((g * kl_coef) / denom) * mask
    g_ent = None
    if with_entropy and entropy_coef:
        g_ent = ((-g * entropy_coef) / denom) * mask
    return g_logp, g_ent


def a3po_reduced_scale(logp: torch.Tensor, behav_logp: torch.Tensor,
                       alpha: torch.Tensor, adv: torch.Tensor,
                       mask: torch.Tensor, entropy: Optional[torch.Tensor],
                       *, clip_eps: float, iw_cap: float, kl_coef: float,
                       entropy_coef: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The size of ``a3po_reduced_ref``'s sums, sum(|terms|) / denom, for
    the loss and each slot of the metric vector: a float32 sum taken in
    another order is held to a multiple of it (the loss and the KL are
    signed sums that cancel, so a tolerance relative to the result has
    no floor). 0 for the iw extremes, the clipped count and the
    denominator, which no order moves (for a 0/1 mask)."""
    flat = [x.reshape(-1) for x in (logp, behav_logp, alpha, adv)]
    m = mask.float().reshape(-1)
    loss_tok, clip_tok, iw, ratio = a3po_loss_ref(
        *flat, m, clip_eps=clip_eps, iw_cap=iw_cap)
    lp, bl, al = flat[:3]
    denom = torch.clamp_min(m.sum(), 1.0)
    kl = ((lp - (al * bl + (1.0 - al) * lp)) * m).abs().sum()
    ent = (torch.zeros_like(kl) if entropy is None
           else (entropy.reshape(-1) * m).abs().sum())
    zero = torch.zeros_like(kl)
    scale = torch.stack([zero, zero, (iw * m).abs().sum(),
                         (ratio * m).abs().sum(), zero, clip_tok.abs().sum(),
                         kl, ent, zero]) / denom
    loss = loss_tok.abs().sum() + abs(kl_coef) * kl
    if entropy is not None:
        loss = loss + abs(entropy_coef) * ent
    return loss / denom, scale
