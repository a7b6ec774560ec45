"""Plain PyTorch version of the Adam kernels (``csrc/adam.cu``), over
lists of leaves: what the kernels compute, op for op, on any device (the
reference's ``repro.training.optimizer``, eagerly). ``ops`` runs it for
every leaf off the card.

The update has the kernel's interface: the new weights go to ``outs``
(which may be the weights themselves), the moments are written in place,
and where ``apply`` is False nothing of the state changes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

TINY = 1e-9  # added to the norm before the clip's division


def sum_squares_ref(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of squares of every leaf, in float32."""
    return sum(torch.square(g.float()).sum() for g in grads)


def global_norm_ref(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum_squares_ref(grads))


def adam_update_ref(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                    outs: Sequence[torch.Tensor], gnorm: torch.Tensor,
                    t: torch.Tensor, apply: Optional[torch.Tensor], *,
                    lr: float, b1: float, b2: float, eps: float,
                    weight_decay: float, max_norm: float) -> None:
    """One Adam step of every leaf; ``t`` is the new step count (0-d
    int32), ``gnorm`` the clip's norm (0-d float32)."""
    # PyTorch rounds max_norm / tensor as the reciprocal times max_norm
    scale = torch.clamp(torch.reciprocal(gnorm + TINY) * max_norm, max=1.0)
    tf = t.float()
    c1 = 1.0 - torch.pow(b1, tf)
    c2 = 1.0 - torch.pow(b2, tf)
    for p, g, m, v, out in zip(params, grads, ms, vs, outs):
        g = g.float() * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        step = lr * (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p.float()
        p2 = (p.float() - step).to(p.dtype)
        if apply is not None:
            p2 = torch.where(apply, p2, p)
            m2 = torch.where(apply, m2, m)
            v2 = torch.where(apply, v2, v)
        m.copy_(m2)
        v.copy_(v2)
        out.copy_(p2)
