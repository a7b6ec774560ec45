"""Top-k MoE with capacity-based dispatch, plus shared experts
(``repro.models.moe``).

``moe_apply`` is the reference's capacity path (``moe_apply_gspmd``): the
routed (token, expert) pairs are sorted by expert, each expert takes at
most ``capacity`` of them in token order, the rest are dropped, and the
experts run as batched products over a dense [E, C, d] buffer. The
reference's expert-parallel path (``moe_apply_ep``: an ``all_to_all`` over
a mesh) belongs to the distributed port and is not here; on one device the
reference takes the capacity path too.

Every one of the B * S tokens is routed, pad tokens included (the
reference passes no pad mask to the FFN), so the pad tokens of a
right-padded row take capacity and can drop a later row's real tokens.
The capacity depends on B * S: a whole-sequence forward and a prefill +
decode route under different capacities, and agree only where nothing is
dropped.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import swiglu, swiglu_spec
from repro_torch.models.params import ParamSpec


def moe_spec(cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.moe
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "router": ParamSpec((d, m.num_experts), ("embed", "experts")),
        "w_gate": ParamSpec((m.num_experts, d, m.d_ff_expert),
                            ("experts", "embed", "expert_ff")),
        "w_up": ParamSpec((m.num_experts, d, m.d_ff_expert),
                          ("experts", "embed", "expert_ff")),
        "w_down": ParamSpec((m.num_experts, m.d_ff_expert, d),
                            ("experts", "expert_ff", "embed")),
    }
    if m.num_shared_experts > 0:
        spec["shared"] = swiglu_spec(d, m.num_shared_experts * m.d_ff_expert)
    return spec


def capacity(m: MoEConfig, num_tokens: int) -> int:
    """Pairs each expert takes for ``num_tokens`` routed tokens."""
    c = int(math.ceil(m.top_k * num_tokens / m.num_experts
                      * m.capacity_factor))
    return max(c, m.top_k)


def route(router_w: torch.Tensor, x_flat: torch.Tensor, m: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_flat [T, d] -> (probs [T, E] float32, top-k weights [T, k]
    float32, renormalised, top-k expert ids [T, k]). The router logits
    accumulate in float32 (the reference's ``preferred_element_type``):
    a bf16 product is exact in float32, so the float32 product of the
    operands is that accumulation."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_i


def load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor,
                      m: MoEConfig) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e (f_e, the share of
    routed pairs on expert e, carries no gradient)."""
    T = probs.shape[0]
    counts = torch.bincount(top_i.reshape(-1),
                            minlength=m.num_experts).float()
    f = counts / (T * m.top_k)
    return m.num_experts * torch.sum(f * probs.mean(dim=0))


def dispatch_slots(top_i: torch.Tensor, m: MoEConfig, C: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity dispatch of the flat (token, expert) pairs, token-major
    with k minor: (order [N], the pairs stably sorted by expert; slot [N],
    each sorted pair's row in the [E * C] expert buffer, or E * C (the
    trash row) for a pair past its expert's capacity). Nothing here reads
    a device value on the host."""
    E = m.num_experts
    N = top_i.numel()
    flat_e = top_i.reshape(N)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(E, device=se.device))
    pos = torch.arange(N, device=se.device) - starts[se]
    slot = torch.where(pos < C, se * C + pos, torch.full_like(se, E * C))
    return order, slot


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux loss, float32 0-d): the reference's
    capacity path (``moe_apply_gspmd``); its expert-parallel path is part
    of the distributed port."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    probs, top_w, top_i = route(params["router"], xf, m)
    aux = load_balance_loss(probs, top_i, m) * m.router_aux_weight

    E = m.num_experts
    C = capacity(m, T)
    order, slot = dispatch_slots(top_i, m, C)
    st = order // m.top_k  # the token of each sorted pair
    sw = top_w.reshape(-1).to(x.dtype)[order]
    # the trash row takes every dropped pair and is cut off
    buf = x.new_zeros((E * C + 1, d)).index_put((slot,), xf[st])
    xe = buf[: E * C].reshape(E, C, d)
    h = F.silu(torch.bmm(xe, params["w_gate"])) \
        * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"])
    padded = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    y = x.new_zeros((T, d)).index_add(0, st, padded[slot] * sw[:, None])
    if m.num_shared_experts > 0:
        y = y + swiglu(params["shared"], xf)
    return y.reshape(B, S, d), aux
