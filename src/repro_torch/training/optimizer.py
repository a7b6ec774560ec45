"""Adam(W) with global-norm clipping and float32 moments, by hand
(``repro.training.optimizer``).

Not ``torch.optim.Adam``: the reference adds ``lr * wd * p`` to the step
(its ``weight_decay`` is not an L2 term on the gradient) and clips by the
global norm of all gradients. The step count ``t``, the bias corrections
and the clip scale stay device tensors, so an update never waits for the
device. Parameters, gradients and moments are trees (nested dicts, or a
``ParamTree`` for the parameters) and are matched by path.

Both halves run in ``kernels.adam``: on the card the clip's norm in one
read of the gradients and the update in one pass over every leaf (a leaf
the kernels cannot take raises), elsewhere its plain version. Each update
records where its elements went as the installed tracer's
``adam_update`` counter (``fused_elems``: the kernels, ``plain_elems``:
the plain version).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RLConfig
from repro_torch.kernels.adam import ops as adam_ops
from repro_torch.models.params import ParamTree, walk
from repro_torch.obs.tracing import get_tracer

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
    return adam_ops.global_norm(list(flatten(tree).values()))


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
    t = state["t"] + 1
    keys = list(flat_p)
    outs = [flat_p[k] if donate_params else torch.empty_like(flat_p[k])
            for k in keys]
    fused, plain = adam_ops.adam_update(
        [flat_p[k] for k in keys], [flat_g[k] for k in keys],
        [flat_m[k] for k in keys], [flat_v[k] for k in keys], outs, gnorm,
        t, apply, lr=rl.learning_rate, b1=rl.adam_b1, b2=rl.adam_b2,
        eps=rl.adam_eps, weight_decay=rl.weight_decay,
        max_norm=rl.max_grad_norm)
    state["t"].copy_(t if apply is None else torch.where(apply, t,
                                                         state["t"]))
    tracer = get_tracer()
    if tracer is not None:
        tracer.counter("adam_update", fused_elems=fused, plain_elems=plain)
    if donate_params:
        return params, state, gnorm
    new_p = unflatten(dict(zip(keys, outs)))
    if isinstance(params, ParamTree):
        grad = any(p.requires_grad for p in flat_p.values())
        return ParamTree(new_p, requires_grad=grad), state, gnorm
    return new_p, state, gnorm
