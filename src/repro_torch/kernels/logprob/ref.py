"""Plain PyTorch version of the fused token-logprob + entropy kernel
(``repro.kernels.logprob.ref``) and of its analytic backward.

It materialises the [T, V] logits: fine as an oracle and for small-vocab
CPU runs; the CUDA kernel streams vocab tiles and never writes them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def token_logprob_entropy_stats_ref(hidden: torch.Tensor, w: torch.Tensor,
                                    targets: torch.Tensor
                                    ) -> Tuple[torch.Tensor, ...]:
    """(logp, entropy, logz, mean logit) [T], float32: the outputs and the
    two row statistics the backward needs. Both operands are upcast to
    float32 first, as the reference, so autograd casts the cotangents back
    to the operands' dtypes."""
    logits = hidden.float() @ w.float()
    logz = torch.logsumexp(logits, dim=-1)
    logp = logits.gather(-1, targets.long()[:, None])[:, 0] - logz
    mean_logit = (torch.softmax(logits, dim=-1) * logits).sum(dim=-1)
    return logp, logz - mean_logit, logz, mean_logit


def token_logprob_entropy_ref(hidden: torch.Tensor, w: torch.Tensor,
                              targets: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [T, d], w [d, V], targets [T] -> (logp [T], entropy [T])."""
    return token_logprob_entropy_stats_ref(hidden, w, targets)[:2]


def dlogits_ref(logits: torch.Tensor, targets: torch.Tensor,
                logz: torch.Tensor, mean_logit: torch.Tensor,
                g_logp: Optional[torch.Tensor],
                g_ent: Optional[torch.Tensor]) -> torch.Tensor:
    """The float32 cotangent of the logits. With p = softmax(l) and
    mu = sum p*l: dl_j = g_logp*(1[j=t] - p_j) - g_ent*p_j*(l_j - mu)."""
    p = torch.exp(logits - logz[:, None])
    dl = torch.zeros_like(logits)
    if g_logp is not None:
        onehot = torch.zeros_like(logits)
        onehot.scatter_(1, targets.long()[:, None], 1.0)
        dl = dl + g_logp.float()[:, None] * (onehot - p)
    if g_ent is not None:
        dl = dl - g_ent.float()[:, None] * p * (logits - mean_logit[:, None])
    return dl


def token_logprob_entropy_bwd_ref(hidden: torch.Tensor, w: torch.Tensor,
                                  targets: torch.Tensor, logz: torch.Tensor,
                                  mean_logit: torch.Tensor,
                                  g_logp: Optional[torch.Tensor],
                                  g_ent: Optional[torch.Tensor]
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic gradient of ``token_logprob_entropy_ref``: (dh [T, d] in
    hidden's dtype, dw [d, V] in w's dtype). A None cotangent counts as
    zero. dh = dl @ w^T and dw = h^T @ dl, in float32."""
    h32, w32 = hidden.float(), w.float()
    dl = dlogits_ref(h32 @ w32, targets, logz, mean_logit, g_logp, g_ent)
    return (dl @ w32.T).to(hidden.dtype), (h32.T @ dl).to(w.dtype)


def split_hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float32 tensor as a bf16 high part and the bf16 rounding of the
    remainder (the plain version of the form in which the wgmma cotangent
    kernel stores dl): hi + lo is x to a relative 2^-16 (each rounding is
    to 8 significant bits)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)
