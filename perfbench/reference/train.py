"""The reference training step: GRPO advantages, the ``a3po`` and
``recompute`` objectives, the minibatch loop, the global-norm clip and
Adam, in plain PyTorch.

Parameters are stored in the configuration's dtype (bfloat16), as the
configuration runs them: each minibatch computes on float32 copies of the
stored values and writes the Adam step back rounded to the stored dtype.
Adam's moments are float32. ``Precision`` sets the dtype of the
activations and the rounding of the matrix products' operands.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from perfbench.reference.common import Precision, token_logp_entropy


def arch_module(m: dict):
    return importlib.import_module(f"perfbench.reference.{m['arch']}")


def score(weights: Dict[str, torch.Tensor], m: dict, tokens: torch.Tensor,
          pr: Precision, rows: int = 8) -> torch.Tensor:
    """log p(tokens[:, 1:]) [B, T-1], float32, without a gradient, ``rows``
    rows at a time."""
    arch = arch_module(m)
    out = []
    with torch.no_grad():
        for r0 in range(0, tokens.shape[0], rows):
            t = tokens[r0:r0 + rows]
            h = arch.forward_hidden(weights, m, t[:, :-1], pr)
            out.append(token_logp_entropy(pr, h, weights["embedding/embed"],
                                          t[:, 1:])[0])
    return torch.cat(out)


def group_advantages(rewards: torch.Tensor, group: int) -> torch.Tensor:
    """(r - mean) / (population std + 1e-6) within each group of
    ``group`` consecutive rows."""
    g = rewards.float().reshape(-1, group)
    return ((g - g.mean(1, keepdim=True))
            / (g.std(1, unbiased=False, keepdim=True) + 1e-6)).reshape(-1)


def alpha_inverse(d: torch.Tensor) -> torch.Tensor:
    """The paper's staleness schedule (the port's default, ``inverse``): 0
    at d = 0, else 1 / d."""
    return torch.where(d < 1, torch.zeros_like(d), 1.0 / d.clamp_min(1.0))


def objective(algo: str, logp, entropy, behav, prox, d, adv, mask, rl):
    """(loss, metrics) of one minibatch. ``prox`` is the recomputed anchor
    for ``recompute`` and unused for ``a3po``, whose anchor is
    alpha * behav + (1 - alpha) * logp (alpha from staleness ``d``)."""
    if algo == "a3po":
        alpha = alpha_inverse(d)[:, None]
        prox = alpha * behav + (1.0 - alpha) * logp.detach()
    elif algo != "recompute":
        raise ValueError(f"reference objective: unknown algo {algo!r}")
    prox = prox.detach()
    iw = torch.clamp(torch.exp(prox - behav), max=rl["behav_weight_cap"])
    ratio = torch.exp(logp - prox)
    a = adv[:, None] * mask
    eps = rl["clip_eps"]
    obj = torch.minimum(ratio * a, torch.clamp(ratio, 1 - eps, 1 + eps) * a)
    denom = mask.sum().clamp_min(1.0)
    terms = iw * obj * mask
    metrics = {"loss_scale": terms.abs().sum() / denom,
               "entropy": (entropy * mask).sum() / denom,
               "iw_mean": (iw * mask).sum() / denom}
    return -terms.sum() / denom, metrics


def train(weights: Dict[str, torch.Tensor], m: dict, rl: dict, algo: str,
          batches: List[dict], steps: int, pr: Precision) -> dict:
    """``steps`` training steps of ``rl["num_minibatches"]`` Adam updates
    each, from ``weights`` (not modified) and zero Adam state, on
    ``batches[i]`` for step i. A batch holds ``tokens`` [B, T] int64,
    ``lengths`` [B] (real tokens a row), ``mask`` and ``behav`` [B, T-1],
    ``stale`` [B] (float) and ``rewards`` [B].

    Returns the per-step means over minibatches ("loss", "loss_scale",
    "grad_norm" (before the clip), "entropy", "iw_mean"), the norm of each
    leaf's first moment after step 1 (``m1``) and of each leaf's change
    over all the steps (``change``)."""
    if rl.get("kl_coef") or rl.get("entropy_coef"):
        raise NotImplementedError("reference objective: no KL or entropy "
                                  "term")
    arch = arch_module(m)
    stored = {k: v.clone() for k, v in weights.items()}
    mom = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for k, v in stored.items()}
    vel = {k: torch.zeros_like(x) for k, x in mom.items()}
    b1, b2, lr = rl["adam_b1"], rl["adam_b2"], rl["learning_rate"]
    t = 0
    out = {"steps": [], "m1": None}
    for s in range(steps):
        bt = batches[s]
        B = bt["tokens"].shape[0]
        adv = group_advantages(bt["rewards"], rl["group_size"])
        prox_all = (score(stored, m, bt["tokens"], pr) if algo == "recompute"
                    else None)
        nmb = min(rl["num_minibatches"], B)
        mb = B // nmb
        acc: Dict[str, List[torch.Tensor]] = {}
        for i in range(nmb):
            rows = slice(i * mb, (i + 1) * mb)
            T = int(bt["lengths"][rows].max())
            tok = bt["tokens"][rows, :T]
            cols = slice(0, T - 1)
            leaves = {k: v.float().requires_grad_(True)
                      for k, v in stored.items()}
            h = arch.forward_hidden(leaves, m, tok[:, :-1], pr)
            logp, ent = token_logp_entropy(pr, h, leaves["embedding/embed"],
                                           tok[:, 1:])
            prox = None if prox_all is None else prox_all[rows, cols]
            loss, met = objective(algo, logp, ent, bt["behav"][rows, cols],
                                  prox, bt["stale"][rows], adv[rows],
                                  bt["mask"][rows, cols], rl)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            del h, logp, ent, leaves
            g = dict(zip(stored, grads))
            gnorm = torch.sqrt(sum(x.square().sum() for x in g.values()))
            scale = torch.clamp(rl["max_grad_norm"] / (gnorm + 1e-9), max=1.0)
            t += 1
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            with torch.no_grad():
                for k, w in stored.items():
                    gk = g[k] * scale
                    mom[k].mul_(b1).add_((1 - b1) * gk)
                    vel[k].mul_(b2).add_((1 - b2) * gk.square())
                    step = lr * (mom[k] / c1) / (torch.sqrt(vel[k] / c2)
                                                + rl["adam_eps"])
                    stored[k] = (w.float() - step).to(w.dtype)
            del g, grads
            for k, v in dict(met, loss=loss, grad_norm=gnorm).items():
                acc.setdefault(k, []).append(v.detach())
        out["steps"].append({k: float(torch.stack(v).mean())
                             for k, v in acc.items()})
        if s == 0:
            out["m1"] = {k: float(v.norm()) for k, v in mom.items()}
    out["change"] = {k: float((stored[k].float() - weights[k].float()).norm())
                     for k in stored}
    return out

