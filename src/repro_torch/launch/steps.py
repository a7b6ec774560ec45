"""The production step functions and their abstract inputs
(``repro.launch.steps``).

These are the programs the dry-run runs for every (arch x shape x mesh)
and that the card runs at full width:

* ``train_step``   — full RL update: score + algorithm loss + bwd + Adam
* ``prefill_step`` — prompt ingestion, returns last-token logits + cache
* ``decode_step``  — one token for every sequence against a full cache

All steps take one ``batch`` dict whose shapes and dtypes come from
``input_specs`` (``meta`` tensors: nothing is allocated). The reference
scans microbatches with ``lax.scan``; here they are a Python loop with
float32 gradient accumulators, averaged as the reference averages them
(equally, not by tokens as ``Trainer.step`` does). On the card scoring
runs the fused logprob kernel op and the A-3PO loss its reduced op, each
with its backward; a ``meta`` tensor (the dry-run) takes their plain
versions for shapes only.

On a DTensor batch (the dry-run's mesh) a microbatch is each rank's j-th
chunk of its own rows, so no rows move between ranks: the per-device
shapes are the reference's, the row grouping is not. On plain tensors it
is rows [j B / nm, (j + 1) B / nm), as the reference's reshape.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig, RLConfig
from repro_torch.core.algorithms import LossInputs, resolve_algorithm
from repro_torch.distributed.sharding import (
    ShardingEnv,
    constrain,
    current_env,
)
from repro_torch.kernels.logprob import token_logprob_entropy
from repro_torch.models import model as M
from repro_torch.models.layers import logits_from_hidden, output_head_weight
from repro_torch.models.params import shardings_from_specs
from repro_torch.training.optimizer import adam_update, flatten, unflatten
from repro_torch.training.trainer import _grads, _trainable_views

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def decode_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    """Sliding-window policy at the long-context decode point.

    SSM/hybrid state is O(1); MLA's latent cache is compact enough to keep
    the full 500k context. Full-attention archs use the documented
    sliding-window variant."""
    if shape.name != "long_500k":
        return None
    if cfg.arch_type in ("ssm", "hybrid"):
        return None
    if cfg.mla is not None:
        return None
    return cfg.long_context_window


# ------------------------------------------------------------- microbatches
def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def microbatch(t: torch.Tensor, j: int, nm: int, dim: int = 0
               ) -> torch.Tensor:
    """The j-th of ``nm`` microbatches of ``t`` along ``dim`` (see the
    module docstring for a DTensor)."""
    if not _is_dtensor(t):
        n = t.shape[dim] // nm
        return t.narrow(dim, j * n, n)
    from torch.distributed.tensor import DTensor
    local = t.to_local()
    n = local.shape[dim] // nm
    shape = list(t.shape)
    shape[dim] //= nm
    part = local.narrow(dim, j * n, n).contiguous()
    return DTensor.from_local(part, t.device_mesh, t.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def concat_microbatches(parts, dim: int = 0) -> torch.Tensor:
    """The inverse of ``microbatch`` over j = 0 .. nm - 1."""
    if not _is_dtensor(parts[0]):
        return torch.cat(parts, dim=dim)
    from torch.distributed.tensor import DTensor
    local = torch.cat([p.to_local() for p in parts], dim=dim)
    shape = list(parts[0].shape)
    shape[dim] *= len(parts)
    return DTensor.from_local(local, parts[0].device_mesh,
                              parts[0].placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ----------------------------------------------------------------- factories
def _hoisted_gather(flat_p: Dict[str, torch.Tensor], cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """FSDP all-gather hoisting: a compute copy of the weights in their
    non-FSDP placements, made once per training step instead of once per
    microbatch x fwd/bwd. Plain tensors (no mesh) are returned as they
    are."""
    env = current_env()
    if env is None or env.n_devices == 1:
        return flat_p
    gathered_env = ShardingEnv(env.mesh, rules=tuple(env.rules.items()),
                               fsdp=False, tp_fallback=env.tp_fallback)
    sh = flatten(shardings_from_specs(M.model_spec(cfg), gathered_env))
    return {k: (p.redistribute(p.device_mesh, sh[k].placements)
                if _is_dtensor(p) else p) for k, p in flat_p.items()}


def make_train_step(cfg: ModelConfig, rl: RLConfig, algo="a3po",
                    current_version: int = 4, num_microbatches: int = 8,
                    hoist_fsdp_gather: bool = False):
    """Full RL training step over the global batch:
    ``train_step(params, opt, batch) -> (params, opt, loss, entropy,
    grad_norm)``.

    ``algo`` is an ``Algorithm`` or registry name; its requires-flags
    decide which batch operands feed the loss (``behav_logp`` stands in
    for the recomputed prox, as in the reference). Gradients accumulate
    over ``num_microbatches`` in float32 and are averaged. ``opt`` is
    updated in place and returned; the parameters come back new."""
    algo = resolve_algorithm(algo, rl)
    F = cfg.frontend_tokens if cfg.frontend else 0

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        hidden, aux = M.forward_hidden(params, cfg, tokens[:, :-1],
                                       embeds=batch.get("embeds"))
        if F:
            hidden = hidden[:, F:]  # loss only over text positions
        # the scoring head's input as an activation (the reference's GSPMD
        # places it so; on one device a no-op)
        hidden = constrain(hidden, "batch", None, "act_embed")
        w = output_head_weight(params["embedding"], cfg)
        logp, entropy = token_logprob_entropy(hidden, w, tokens[:, 1:])
        loss, metrics = algo.loss(logp, LossInputs(
            advantages=batch["advantages"], mask=batch["mask"],
            behav_logp=batch["behav_logp"], versions=batch["versions"],
            current_version=current_version,
            prox_logp=(batch["behav_logp"] if algo.needs_prox_forward
                       else None),
            entropy=entropy), rl)
        return loss + aux, metrics

    def value_and_grad(views, batch):
        loss, metrics = loss_fn(unflatten(views), batch)
        return loss.detach(), metrics["entropy"].detach(), _grads(loss, views)

    def train_step(params, opt, batch):
        B = batch["tokens"].shape[0]
        nm = num_microbatches if B % num_microbatches == 0 else 1
        flat_p = flatten(params)
        compute = (_hoisted_gather(flat_p, cfg) if hoist_fsdp_gather
                   else flat_p)
        views = _trainable_views(compute)
        if nm == 1:
            loss, entropy, grads = value_and_grad(views, batch)
        else:
            grads = loss = entropy = None
            for j in range(nm):
                micro = {k: microbatch(v, j, nm) for k, v in batch.items()}
                l_j, e_j, g_j = value_and_grad(views, micro)
                if grads is None:
                    grads = {k: g.float() for k, g in g_j.items()}
                    loss, entropy = l_j.float(), e_j.float()
                else:
                    for k, g in g_j.items():
                        grads[k] += g.float()
                    loss, entropy = loss + l_j, entropy + e_j
            grads = {k: g / nm for k, g in grads.items()}
            loss, entropy = loss / nm, entropy / nm
        if compute is not flat_p:
            # back onto the FSDP layout: the reduce-scatter of the hoist
            grads = {k: (g.redistribute(g.device_mesh, flat_p[k].placements)
                         if _is_dtensor(g) else g)
                     for k, g in grads.items()}
        new_params, opt, gnorm = adam_update(unflatten(grads), opt, params,
                                             rl)
        return new_params, opt, loss, entropy, gnorm

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: InputShape,
                      num_microbatches: int = 1):
    """Prefill the prompt batch: ``prefill_step(params, batch) -> (last
    logits [B, V] float32, cache)``. ``num_microbatches`` > 1 runs batch
    chunks one after another (prefill chunking: activation memory scales
    with the live chunk while the produced cache is unchanged)."""
    window = decode_window(cfg, shape)

    def one(params, batch):
        hidden, cache = M.prefill(params, cfg, batch["tokens"],
                                  embeds=batch.get("embeds"), window=window)
        logits = logits_from_hidden(params["embedding"], hidden[:, -1:],
                                    cfg)[:, 0]
        return logits, cache

    if num_microbatches <= 1:
        return one

    def prefill_step(params, batch):
        B = batch["tokens"].shape[0]
        nm = num_microbatches if B % num_microbatches == 0 else 1
        if nm == 1:
            return one(params, batch)
        outs = [one(params, {k: microbatch(v, j, nm)
                             for k, v in batch.items()})
                for j in range(nm)]
        # un-chunk: logits and "lengths" along dim 0, the per-layer cache
        # leaves [L, B/nm, ...] along dim 1 (the reference's moveaxis +
        # reshape of its scanned [nm, L, B/nm, ...])
        logits = concat_microbatches([o[0] for o in outs], 0)

        def cat(path_leaves):
            return concat_microbatches(path_leaves,
                                       1 if path_leaves[0].dim() >= 3 else 0)

        caches = [o[1] for o in outs]
        cache = _zip_map(cat, caches)
        return logits, cache

    return prefill_step


def _zip_map(fn, trees):
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in trees[0]}
    return fn(trees)


def make_decode_step(cfg: ModelConfig, shape: InputShape):
    """``decode_step(params, batch) -> (logits [B, V], cache)``: one token
    for every sequence; the cache's tensors are written in place."""
    window = decode_window(cfg, shape)

    def decode_step(params, batch):
        return M.decode_step(params, cfg, batch["cache"], batch["tokens"],
                             window=window)

    return decode_step


def make_step(cfg: ModelConfig, shape: InputShape, rl: RLConfig,
              algo="a3po"):
    if shape.kind == "train":
        return make_train_step(cfg, rl, algo)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape)
    return make_decode_step(cfg, shape)


# --------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape: InputShape,
                rl: Optional[RLConfig] = None) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this workload (the
    reference's ``ShapeDtypeStruct``s): nothing is allocated."""
    del rl
    B, S = shape.global_batch, shape.seq_len
    dtype = _DTYPES[cfg.dtype]
    i32, f32 = torch.int32, torch.float32

    def meta(shape_, dt):
        return torch.empty(shape_, dtype=dt, device="meta")

    F = cfg.frontend_tokens if cfg.frontend else 0
    specs: Dict[str, Any] = {}
    if shape.kind == "train":
        # total context = F frontend embeddings + (S - F) text tokens
        Tt = S - F
        specs["tokens"] = meta((B, Tt), i32)
        specs["behav_logp"] = meta((B, Tt - 1), f32)
        specs["advantages"] = meta((B, Tt - 1), f32)
        specs["mask"] = meta((B, Tt - 1), f32)
        specs["versions"] = meta((B,), i32)
        if F:
            specs["embeds"] = meta((B, F, cfg.d_model), dtype)
    elif shape.kind == "prefill":
        specs["tokens"] = meta((B, S - F), i32)
        if F:
            specs["embeds"] = meta((B, F, cfg.d_model), dtype)
    elif shape.kind == "decode":
        specs["tokens"] = meta((B,), i32)
        specs["cache"] = M.init_cache(cfg, B, S,
                                      window=decode_window(cfg, shape),
                                      device="meta")
    else:
        raise ValueError(shape.kind)
    return specs


def abstract_opt_state(params_abstract):
    """Abstract Adam state matching ``training.optimizer.adam_init``:
    float32 moments, a 0-d int32 step count, all on ``meta``."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"m": _tree_map(f32, params_abstract),
            "v": _tree_map(f32, params_abstract),
            "t": torch.empty((), dtype=torch.int32, device="meta")}


def opt_shardings(param_sh, env: ShardingEnv):
    return {"m": param_sh, "v": param_sh, "t": env.sharding((), ())}


def batch_shardings(cfg: ModelConfig, shape: InputShape, env: ShardingEnv,
                    specs: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, spec in specs.items():
        if name == "cache":
            out["cache"] = M.cache_shardings(cfg, env, spec)
        elif name == "embeds":
            out[name] = env.sharding(spec.shape, ("batch", None, "act_embed"))
        elif spec.dim() == 1:
            out[name] = env.sharding(spec.shape, ("batch",))
        else:
            logical = ("batch",) + (None,) * (spec.dim() - 1)
            out[name] = env.sharding(spec.shape, logical)
    return out
