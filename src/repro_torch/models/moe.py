"""Top-k MoE with capacity-based dispatch, plus shared experts
(``repro.models.moe``).

``moe_apply`` is the reference's capacity path (``moe_apply_gspmd``): the
routed (token, expert) pairs are sorted by expert, each expert takes at
most ``capacity`` of them in token order, the rest are dropped, and the
experts run as batched products over a dense [E, C, d] buffer. Under a
``ShardingEnv`` with ``ep_shard_map`` (the dry-run's ``--ep-moe``) it takes
the expert-parallel path, ``moe_apply_ep``: two-level bucketing and an
``all_to_all_single`` over the mesh's "model" ranks.

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
from repro_torch.distributed.sharding import constrain, current_env
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
    # a scatter of ones, not bincount: its output size depends on the
    # values, which a meta tensor (the dry-run) does not have
    flat = top_i.reshape(-1)
    counts = torch.zeros(m.num_experts, dtype=torch.float32,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=flat.device))
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
    """x [B, S, d] -> (y [B, S, d], aux loss, float32 0-d). Chooses the
    expert-parallel path (``moe_apply_ep``) under an env with
    ``ep_shard_map`` whose "model" axis divides the experts and the
    sequence is at least that long, else the capacity path
    (``moe_apply_gspmd``), as the reference."""
    env = current_env()
    if (env is not None and getattr(env, "ep_shard_map", False)
            and "model" in env.axis_names):
        n_ranks = env.axis_sizes["model"]
        if cfg.moe.num_experts % n_ranks == 0 and x.shape[1] >= n_ranks:
            return moe_apply_ep(params, x, cfg, env)
    return moe_apply_gspmd(params, x, cfg)


def moe_apply_gspmd(params, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux loss, float32 0-d): the capacity
    path (``moe_apply_gspmd``)."""
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
    xe = constrain(buf[: E * C].reshape(E, C, d), "experts", None, None)
    h = F.silu(torch.bmm(xe, params["w_gate"])) \
        * torch.bmm(xe, params["w_up"])
    h = constrain(h, "experts", None, None)
    ye = constrain(torch.bmm(h, params["w_down"]), "experts", None, None)
    padded = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    y = x.new_zeros((T, d)).index_add(0, st, padded[slot] * sw[:, None])
    if m.num_shared_experts > 0:
        y = y + swiglu(params["shared"], xf)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------- EP path
def _bucket_by(ids: torch.Tensor, values: torch.Tensor, n_buckets: int,
               cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort (ids, values) into [n_buckets, cap, ...] with overflow drop.

    Returns (bucketed values, slot index per pair (== n_buckets * cap for
    dropped), sort order) so callers can route auxiliary arrays the same
    way and invert the permutation."""
    N = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    starts = torch.searchsorted(
        sid, torch.arange(n_buckets, device=ids.device, dtype=sid.dtype))
    pos = torch.arange(N, device=ids.device) - starts[sid]
    slot = torch.where(pos < cap, sid * cap + pos,
                       torch.full_like(sid, n_buckets * cap))
    buf = values.new_zeros((n_buckets * cap + 1,) + values.shape[1:]) \
        .index_put((slot,), values[order])
    return (buf[:-1].reshape((n_buckets, cap) + values.shape[1:]), slot,
            order)


def _ep_body(x, router_w, w_gate, w_up, w_down, *, m: MoEConfig,
             n_ranks: int, exchange):
    """Per-rank expert-parallel MoE. x: [T_loc, d] (this rank's tokens);
    w_*: this rank's expert slab [E / n_ranks, ...]; ``exchange`` the
    all-to-all over the model ranks (dim 0 split by destination). Returns
    (y [T_loc, d], this rank's aux loss)."""
    T, d = x.shape
    e_per = m.num_experts // n_ranks
    k = m.top_k

    probs, top_w, top_i = route(router_w, x, m)
    aux = load_balance_loss(probs, top_i, m) * m.router_aux_weight

    N = T * k
    flat_e = top_i.reshape(N)
    flat_w = top_w.reshape(N).to(x.dtype)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    dest = flat_e // e_per

    # first-level bucket: destination rank, with the local-expert id (+1,
    # 0 marks padding) riding along in an int payload
    cap_send = max(int(math.ceil(N / n_ranks * m.capacity_factor)), k)
    send_x, slot, order = _bucket_by(dest, x[flat_t], n_ranks, cap_send)
    eid = ((flat_e % e_per) + 1).to(torch.int32)  # 0 == invalid
    send_e = torch.zeros((n_ranks * cap_send + 1,), dtype=torch.int32,
                         device=x.device).index_put((slot,), eid[order])
    send_e = send_e[:-1].reshape(n_ranks, cap_send)

    recv_x = exchange(send_x)
    recv_e = exchange(send_e)

    # second-level bucket: local expert (invalid slots -> trash bucket)
    Rn = n_ranks * cap_send
    rx = recv_x.reshape(Rn, d)
    re_flat = recv_e.reshape(Rn)
    rexp = torch.where(re_flat > 0, re_flat - 1,
                       torch.full_like(re_flat, e_per)).long()
    C2 = max(int(math.ceil(Rn / e_per * m.capacity_factor)), 1)
    xe_full, slot2, order2 = _bucket_by(rexp, rx, e_per + 1, C2)
    xe = xe_full[:e_per]

    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)

    # invert second-level bucketing back to the recv layout: the trash
    # bucket and the overflow row read zeros
    padded2 = torch.cat([ye.reshape(e_per * C2, d),
                         ye.new_zeros((C2 + 1, d))])
    y_sorted = padded2[torch.clamp(slot2, max=e_per * C2)]
    y_sorted = torch.where((slot2 < e_per * C2)[:, None], y_sorted,
                           torch.zeros_like(y_sorted))
    inv2 = torch.argsort(order2, stable=True)
    ry = y_sorted[inv2].to(x.dtype)  # [Rn, d], recv layout

    # reverse exchange back to the source ranks
    back = exchange(ry.reshape(n_ranks, cap_send, d))
    flat_back = torch.cat([back.reshape(n_ranks * cap_send, d),
                           back.new_zeros((1, d))])
    y_pairs_sorted = flat_back[slot]  # dropped pairs hit the zero row
    inv = torch.argsort(order, stable=True)
    y_pairs = y_pairs_sorted[inv] * flat_w[:, None]
    y = x.new_zeros((T, d)).index_add(0, flat_t, y_pairs)
    return y, aux


def moe_apply_ep(params, x: torch.Tensor, cfg: ModelConfig, env
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE: each rank routes its own tokens and exchanges
    them with ``all_to_all_single`` over the mesh's "model" sub-group (the
    reference's ``shard_map``). x [B, S, d] is batch-sharded over
    ("pod", "data") and sequence-sharded over "model" inside the exchange
    (the sequence padded to a multiple of the model axis); each rank holds
    E / n_ranks experts. The aux loss is averaged over all ranks; the
    shared experts run on the whole input after the exchange.

    On a mesh of more than one device x and the weights are DTensors (or
    plain tensors equal on every rank, taken as replicated) and so is y.
    On a one-device mesh the exchange is the identity: one rank holds
    every expert."""
    from repro_torch.distributed.sharding import is_distributed
    m = cfg.moe
    B, S, d = x.shape
    n_ranks = env.axis_sizes["model"]
    orig_S = S
    S = -(-S // n_ranks) * n_ranks
    if S != orig_S:
        x = F.pad(x, (0, 0, 0, S - orig_S))
    if not is_distributed(env.mesh):
        if n_ranks != 1:
            raise ValueError("moe_apply_ep: a mesh of several devices must "
                             "be a DeviceMesh")
        y, aux = _ep_body(x.reshape(B * S, d), params["router"],
                          params["w_gate"], params["w_up"], params["w_down"],
                          m=m, n_ranks=1, exchange=lambda t: t)
        y = y.reshape(B, S, d)
    else:
        y, aux = _ep_distributed(params, x, m, env, n_ranks)
    if m.num_shared_experts > 0:
        y = y + swiglu(params["shared"], x.reshape(B * S, d)
                       ).reshape(B, S, d)
    if S != orig_S:
        y = y[:, :orig_S]
    return y, aux


def _ep_distributed(params, x, m: MoEConfig, env, n_ranks: int):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = env.mesh
    names = list(mesh.mesh_dim_names)
    rep = [Replicate()] * mesh.ndim
    plain = not isinstance(x, DTensor)

    def as_dt(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, rep, run_check=False)

    x_pl = list(rep)
    for a in ("pod", "data"):
        if a in names:
            x_pl[names.index(a)] = Shard(0)
    x_pl[names.index("model")] = Shard(1)
    w_pl = list(rep)
    w_pl[names.index("model")] = Shard(0)
    xd = as_dt(x)
    x_blk = xd.redistribute(mesh, x_pl).to_local()
    router = as_dt(params["router"]).redistribute(mesh, rep).to_local()
    w = [as_dt(params[k]).redistribute(mesh, w_pl).to_local()
         for k in ("w_gate", "w_up", "w_down")]
    group = mesh.get_group("model")

    def exchange(t):
        return funcol.all_to_all_single_autograd(t.contiguous(), None, None,
                                                 group)

    lb, ls, d = x_blk.shape
    y_blk, aux = _ep_body(x_blk.reshape(lb * ls, d), router, *w, m=m,
                          n_ranks=n_ranks, exchange=exchange)
    y = DTensor.from_local(y_blk.reshape(lb, ls, d), mesh, x_pl,
                           run_check=False, shape=xd.shape,
                           stride=xd.stride())
    aux = DTensor.from_local(aux, mesh, [Partial("avg")] * mesh.ndim,
                             run_check=False).redistribute(mesh, rep)
    # back to the input's layout (a partial input comes back replicated)
    y = y.redistribute(mesh, [Replicate() if isinstance(p, Partial) else p
                              for p in xd.placements])
    if plain:
        return y.to_local(), aux.to_local()
    return y, aux
