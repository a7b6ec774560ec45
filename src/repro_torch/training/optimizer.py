"""Adam(W) with global-norm clipping and float32 moments, by hand
(``repro.training.optimizer``).

Not ``torch.optim.Adam``: the reference adds ``lr * wd * p`` to the step
(its ``weight_decay`` is not an L2 term on the gradient) and clips by the
global norm of all gradients. The step count ``t``, the bias corrections
and the clip scale stay device tensors, so an update never waits for the
device. Parameters, gradients and moments are trees (nested dicts, or a
``ParamTree`` for the parameters) and are matched by path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RLConfig
from repro_torch.models.params import ParamTree, walk

OptState = Dict[str, Any]  # {"m": tree, "v": tree, "t": 0-d int32 tensor}


def flatten(tree) -> Dict[str, torch.Tensor]:
    """Leaves of a tree by "/"-joined path, in sorted path order."""
    return {"/".join(p): v for p, v in walk(tree)}


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def adam_init(params) -> OptState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in flatten(params).items()}
    dev = next(iter(zeros.values())).device
    return {"m": unflatten(zeros),
            "v": unflatten({k: torch.zeros_like(z) for k, z in zeros.items()}),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a flat dict of
    path -> tensor is a tree too)."""
    return torch.sqrt(sum(torch.square(g.float()).sum()
                          for g in flatten(tree).values()))


def _leaf(p, g, m, v, scale, c1, c2, rl: RLConfig):
    """One leaf's update, as the reference: (new p, new m, new v)."""
    b1, b2, eps = rl.adam_b1, rl.adam_b2, rl.adam_eps
    g = g.float() * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    step = rl.learning_rate * (m / c1) / (torch.sqrt(v / c2) + eps)
    if rl.weight_decay:
        step = step + rl.learning_rate * rl.weight_decay * p.float()
    return (p.float() - step).to(p.dtype), m, v


@torch.no_grad()
def adam_update(grads, state: OptState, params, rl: RLConfig, *,
                donate_params: bool = False,
                gnorm: Optional[torch.Tensor] = None,
                apply: Optional[torch.Tensor] = None
                ) -> Tuple[Any, OptState, torch.Tensor]:
    """Returns (new_params, state, grad_norm).

    The moments and ``t`` are updated in place in ``state`` (the reference
    donates them). ``donate_params`` writes the parameters into ``params``
    too; otherwise new ones come back as a new ``ParamTree`` with the old
    leaves' ``requires_grad`` (or a dict for a dict). ``gnorm`` may be
    passed when already known. ``apply`` (a 0-d bool tensor) selects on the
    device: where it is False the parameters, the moments and ``t`` keep
    their values.
    """
    flat_g = flatten(grads)
    flat_p = flatten(params)
    flat_m, flat_v = flatten(state["m"]), flatten(state["v"])
    if gnorm is None:
        gnorm = global_norm(flat_g)
    scale = torch.clamp(rl.max_grad_norm / (gnorm + 1e-9), max=1.0)
    t = state["t"] + 1
    tf = t.float()
    c1 = 1.0 - torch.pow(rl.adam_b1, tf)
    c2 = 1.0 - torch.pow(rl.adam_b2, tf)

    def keep(new, old):
        return new if apply is None else torch.where(apply, new, old)

    new_p = {}
    for k, p in flat_p.items():
        p2, m2, v2 = _leaf(p, flat_g[k], flat_m[k], flat_v[k], scale, c1,
                           c2, rl)
        flat_m[k].copy_(keep(m2, flat_m[k]))
        flat_v[k].copy_(keep(v2, flat_v[k]))
        if donate_params:
            p.copy_(keep(p2, p))
        else:
            new_p[k] = keep(p2, p)
    state["t"].copy_(keep(t, state["t"]))
    if donate_params:
        return params, state, gnorm
    if isinstance(params, ParamTree):
        grad = any(p.requires_grad for p in flat_p.values())
        return ParamTree(unflatten(new_p), requires_grad=grad), state, gnorm
    return unflatten(new_p), state, gnorm
