"""Decoder LM over the assigned families: dense, MoE (with MLA), SSM
(Mamba2), hybrid (Zamba2), and the vision and audio stacks, whose
precomputed frontend embeddings are projected and prepended to the text
(``repro.models.model``).

Public entry points: ``model_spec`` / ``init_params``; the whole-sequence
``forward_hidden`` (hidden state and the MoE load-balance loss: the
training forward) / ``forward_logits`` (the reference the serving engines
are checked against); and the dense-cache generation path of the rollout
engine, ``init_cache`` / ``prefill`` / ``decode_step``. Layers are a
Python loop over the stack (the reference scans it), each stacked leaf
unbound once per forward (``unstack_model``); a hybrid stack runs its SSM
blocks in order with the one shared attention block after every
``attn_every - 1`` of them, as ``cfg.block_kinds()`` lists them; the
shared block's one parameter set is used at each of those positions, and
its gradient accumulates across the uses, under remat too. With
``cfg.remat`` and gradients enabled each layer is recomputed in the
backward (``torch.utils.checkpoint``), as the reference's remat does. An
SSM block differentiates the model's plain chunked scan while a gradient
is recorded (the training forward and its remat recompute) and runs the
intra-chunk kernel otherwise (``models.ssm.ssd_chunked``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models.layers import (
    embed_tokens,
    embedding_spec,
    logits_from_hidden,
    rmsnorm,
    rmsnorm_spec,
)
from repro_torch.models import ssm as ssm_mod
from repro_torch.distributed.sharding import (
    constrain,
    current_env,
    is_distributed,
    shard_tree,
)
from repro_torch.models.params import (
    ParamSpec,
    ParamTree,
    SpecTree,
    abstract_from_specs,
    init_from_specs,
    shardings_from_specs,
    stack_specs,
    unstack_layers,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def require_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asked for
    the CPU, and an error when CUDA is asked for but absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return device


ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_arch(cfg: ModelConfig) -> None:
    """Raise for a stack the port cannot run: an arch type outside the
    reference's six families."""
    if cfg.arch_type not in ARCH_TYPES:
        raise NotImplementedError(
            f"{cfg.name}: arch type {cfg.arch_type!r} is not one of "
            f"{ARCH_TYPES}")


def layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_attn, n_ssm): the attention and SSM layers of the stack, in
    ``cfg.block_kinds()`` order (the reference's ``_layout``). The
    attention layers of a hybrid stack all apply its one shared block."""
    kinds = cfg.block_kinds()
    n_attn = sum(1 for k in kinds if k == "attn")
    if cfg.arch_type == "hybrid" and not cfg.share_attn_params:
        raise NotImplementedError(f"{cfg.name}: hybrid wiring assumes one "
                                  "shared attention block")
    return n_attn, len(kinds) - n_attn


def model_spec(cfg: ModelConfig) -> SpecTree:
    check_arch(cfg)
    spec: SpecTree = {"embedding": embedding_spec(cfg),
                      "final_norm": rmsnorm_spec(cfg.d_model)}
    if cfg.frontend is not None:
        # the projector of the precomputed frontend embeddings
        spec["frontend_proj"] = ParamSpec(
            (cfg.d_model, cfg.d_model), ("embed", "act_embed"),
            scale=cfg.d_model ** -0.5)
    n_ssm = layout(cfg)[1]
    if cfg.arch_type == "hybrid":
        spec["ssm_blocks"] = stack_specs(blocks.ssm_block_spec(cfg), n_ssm)
        spec["shared_attn"] = blocks.attn_block_spec(cfg)
    elif cfg.arch_type == "ssm":
        spec["blocks"] = stack_specs(blocks.ssm_block_spec(cfg),
                                     cfg.num_layers)
    else:
        spec["blocks"] = stack_specs(blocks.attn_block_spec(cfg),
                                     cfg.num_layers)
    return spec


# (kind, layer params, index among the layers of that kind): the "attn"
# layers of a hybrid stack all hold the one shared block
Layer = Tuple[str, Dict[str, Any], int]


def unstack_model(params, cfg: ModelConfig) -> List[Layer]:
    """The stack in order, each stacked leaf unbound once: [(kind, layer
    params, index among its kind)]. An attention layer's index is its slot
    in the attention caches, an SSM layer's its slot in the SSM caches."""
    check_arch(cfg)
    if cfg.arch_type != "hybrid":
        kind = "ssm" if cfg.arch_type == "ssm" else "attn"
        return [(kind, lp, i) for i, lp in enumerate(
            unstack_layers(params["blocks"], cfg.num_layers))]
    ssm_layers = unstack_layers(params["ssm_blocks"], layout(cfg)[1])
    out: List[Layer] = []
    n = {"attn": 0, "ssm": 0}
    for kind in cfg.block_kinds():
        lp = ssm_layers[n["ssm"]] if kind == "ssm" else params["shared_attn"]
        out.append((kind, lp, n[kind]))
        n[kind] += 1
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype: Optional[torch.dtype] = None,
                requires_grad: bool = False) -> ParamTree:
    """Seeded random weights with the reference's stds. ``generator``
    defaults to a fresh one seeded 0 on ``device``."""
    device = require_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return init_from_specs(model_spec(cfg), generator, device=device,
                           dtype=dtype or torch_dtype(cfg),
                           requires_grad=requires_grad)


def abstract_params(cfg: ModelConfig, dtype: Optional[torch.dtype] = None):
    """``meta`` tensors of every weight (the dry-run's stand-ins)."""
    return abstract_from_specs(model_spec(cfg), dtype or torch_dtype(cfg))


def param_shardings(cfg: ModelConfig, env):
    """The ``Sharding`` of every weight under ``env``, mirroring the
    params."""
    return shardings_from_specs(model_spec(cfg), env)


def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                  embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings [B,St,d], after the projected frontend embeddings
    [B,F,d] of a vision or audio stack: [B,F+St,d]."""
    x = embed_tokens(params["embedding"], tokens, cfg)
    if cfg.frontend is not None:
        if embeds is None:
            raise ValueError(f"{cfg.name} needs frontend embeds")
        fe = torch.einsum("bfd,de->bfe", embeds.to(x.dtype),
                          params["frontend_proj"])
        x = torch.cat([fe, x], dim=1)
    return constrain(x, "batch", None, "act_embed")


def _block_hidden(kind, lp, x, cfg, positions, pad_mask):
    if kind == "ssm":
        return blocks.ssm_block_full(lp, x, cfg, pad_mask)[0], None
    return blocks.attn_block_full(lp, x, cfg, positions, pad_mask)[:2]


def forward_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   pad_mask: Optional[torch.Tensor] = None, *,
                   embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,St] (+ ``embeds`` [B,F,d] for a frontend stack) ->
    (final-normed hidden [B,S,d], S = F + St, and the summed MoE
    load-balance loss, float32 0-d: zero without MoE). SSM blocks run the
    differentiable plain chunked scan while a gradient is recorded and the
    intra-chunk kernel op otherwise; attention runs the plain
    ``chunked_causal_attention``."""
    x = _embed_inputs(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = x.new_zeros((), dtype=torch.float32)  # a DTensor on a mesh
    seq_sp = cfg.arch_type not in ("ssm", "hybrid")
    for kind, lp, _ in unstack_model(params, cfg):
        if seq_sp:
            # sequence-parallel region boundary of the attention stacks:
            # under the opt-in ("seq_sp" -> "model") rule the residual
            # stream is seq-sharded between blocks; by default a no-op
            x = constrain(x, "batch", "seq_sp", "act_embed")
        if remat:
            # no randomness in a layer, so no RNG state to stash
            x, a = checkpoint(_block_hidden, kind, lp, x, cfg, positions,
                              pad_mask, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _block_hidden(kind, lp, x, cfg, positions, pad_mask)
        if a is not None:
            aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward_logits(params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   pad_mask: Optional[torch.Tensor] = None, *,
                   embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B,St] (+ ``embeds``) -> float32 logits [B,S,V]. The
    reference also returns the aux loss; ``forward_hidden`` gives it."""
    h, _ = forward_hidden(params, cfg, tokens, positions, pad_mask,
                          embeds=embeds)
    return logits_from_hidden(params["embedding"], h, cfg)


# -------------------------------------------------------------------- caches
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               window: Optional[int] = None,
               dtype: Optional[torch.dtype] = None,
               device="cuda") -> Dict[str, Any]:
    """Stacked per-layer decode caches + per-sequence lengths, as the
    reference's: {"attn": {"k", "v": [n_attn, batch, L, KV, hd]}} when the
    stack has attention layers (MLA: {"ckv": [n_attn, batch, L, r],
    "krope": [n_attn, batch, L, rope]}), L = ``max_len`` (or ``window``
    when shorter); {"ssm": {"conv": [n_ssm, batch, K-1, Cd], "state": [n_ssm,
    batch, nh, hd, ds] float32}} when it has SSM layers; "lengths" [batch]
    int32. In the model's dtype unless ``dtype``."""
    check_arch(cfg)
    device = require_device(device)
    dtype = dtype or torch_dtype(cfg)
    n_attn, n_ssm = layout(cfg)

    def stack(one, n):
        return {k: torch.zeros((n,) + v.shape, dtype=v.dtype, device=device)
                for k, v in one.items()}

    cache: Dict[str, Any] = {}
    if n_attn:
        cache["attn"] = stack(blocks.attn_cache_for(
            cfg, batch, max_len, window=window, dtype=dtype, device=device),
            n_attn)
    if n_ssm:
        cache["ssm"] = stack(ssm_mod.init_ssm_cache(
            cfg, batch, dtype=dtype, device=device), n_ssm)
    cache["lengths"] = torch.zeros((batch,), dtype=torch.int32,
                                   device=device)
    env = current_env()
    if env is not None and is_distributed(env.mesh):
        # on a mesh the cache is born in its placements (the dry-run)
        cache = shard_tree(cache, cache_shardings(cfg, env, cache))
    return cache


def cache_logical_axes(cfg: ModelConfig, cache: Dict[str, Any]):
    """The logical axes of every leaf of a decode cache."""
    out: Dict[str, Any] = {}
    if "attn" in cache:
        log = blocks.attn_cache_logical(cfg)
        out["attn"] = {k: ("layers",) + v for k, v in log.items()}
    if "ssm" in cache:
        out["ssm"] = {k: ("layers",) + v
                      for k, v in ssm_mod.SSM_CACHE_LOGICAL.items()}
    out["lengths"] = ("batch",)
    return out


def cache_shardings(cfg: ModelConfig, env, cache: Dict[str, Any]):
    """``env.sharding`` of every leaf of ``cache``, mirroring it."""
    logical = cache_logical_axes(cfg, cache)

    def walk(c, log):
        if isinstance(c, dict):
            return {k: walk(c[k], log[k]) for k in c}
        return env.sharding(tuple(c.shape), log)

    return walk(cache, logical)


# ------------------------------------------------------------------- prefill
@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None,
            window: Optional[int] = None, *,
            embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompts, returning (final-normed hidden [B,S,d], a decode
    cache populated with their keys and values).

    ``lengths`` [B] are the true prompt lengths of right-padded prompts
    (default: all of tokens' width). A frontend stack takes ``embeds``
    [B,F,d], prepended to every row: S = F + tokens' width, and the cache
    holds ``lengths + F`` valid positions. GQA/MHA attention runs through
    the flash attention kernel op, causal with no pad mask: a valid row
    attends only positions before it, which are all valid, so it gets
    exactly what the reference's masked prefill gives it. Pad rows, and
    the cache entries at positions >= lengths, differ from the
    reference's; decode never reads them (it writes position ``lengths``
    before attending ``lengths + 1`` keys). An MoE stack routes the pad
    rows too, as the reference does, so where capacity drops pairs the
    drop set can differ from the reference's. MLA attends through the
    plain path with the pad mask and caches the latent (``ckv``) and the
    rope key (``krope``).

    SSM blocks run the chunked scan with pad steps frozen (dt = 0) and
    take each row's conv window at its true end (``valid_lens=lengths``),
    so a short row resumes decoding exactly as its unpadded prefill would.
    That differs from the reference on purpose: its prefill keeps the conv
    window of the last K-1 (pad) rows. No gradient is recorded (the flash
    and SSD ops are forward only).
    """
    x = _embed_inputs(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    max_len = max_len or S
    if window is None and max_len < S:
        raise ValueError(
            f"decode cache max_len={max_len} < prompt length {S} (includes "
            "frontend tokens); only windowed caches may wrap")
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    if lengths is None:
        lengths = torch.full((B,), tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    if cfg.frontend is not None:
        lengths = lengths + cfg.frontend_tokens  # the prefix is valid
    cache = init_cache(cfg, B, max_len, window=window, device=tokens.device)
    pad_mask = torch.arange(S, device=tokens.device)[None, :] \
        < lengths[:, None]
    slots = None
    if "attn" in cache:
        L = next(iter(cache["attn"].values())).shape[2]
        if S > L:
            slots = torch.arange(S - L, S, device=tokens.device) % L
    names = ("ckv", "krope") if cfg.mla is not None else ("k", "v")
    for kind, lp, i in unstack_model(params, cfg):
        if kind == "ssm":
            x, c = blocks.ssm_block_full(lp, x, cfg, pad_mask,
                                         valid_lens=lengths)
            cache["ssm"]["conv"][i] = c["conv"]
            cache["ssm"]["state"][i] = c["state"]
            continue
        if cfg.mla is not None:
            x, _, kv = blocks.attn_block_full(lp, x, cfg, positions,
                                              pad_mask, window)
        else:
            x, _, kv = blocks.attn_block_full(lp, x, cfg, positions, None,
                                              window, flash=True)
        for name, new in zip(names, kv):
            buf = cache["attn"][name][i]
            if slots is None:
                buf[:, :S] = new
            else:
                buf[:, slots] = new[:, S - L:]
    cache["lengths"] = lengths.to(torch.int32)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), cache


# -------------------------------------------------------------------- decode
@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, window: Optional[int] = None, *,
                layers: Optional[List[Layer]] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence: tokens [B] -> (float32 logits [B,V],
    cache). Each attention layer's key and value (MLA: latent and rope
    key), and each SSM layer's conv window and state, are written into
    ``cache``'s tensors in place; the returned cache dict shares them and
    carries ``lengths + 1``. ``layers`` (``unstack_model(params, cfg)``)
    may be passed to skip unbinding the stacked weights on every token.
    Nothing here reads a device value on the host."""
    lengths = cache["lengths"]
    if layers is None:
        layers = unstack_model(params, cfg)
    x = embed_tokens(params["embedding"], tokens[:, None], cfg)[:, 0]
    x = constrain(x, "batch", "act_embed")
    if "attn" in cache:
        per_layer = {k: torch.unbind(v, 0) for k, v in cache["attn"].items()}
        L = next(iter(per_layer.values()))[0].shape[1]
        # the cache slot, keys attended and rope angles: one for all layers
        index = attn_mod.decode_index(cfg, lengths, L, window)
    if "ssm" in cache:
        convs = torch.unbind(cache["ssm"]["conv"], 0)
        states = torch.unbind(cache["ssm"]["state"], 0)
    for kind, lp, i in layers:
        if kind == "ssm":
            x, _ = blocks.ssm_block_decode(
                lp, x, cfg, {"conv": convs[i], "state": states[i]})
        else:
            x, _ = blocks.attn_block_decode(
                lp, x, cfg, {k: v[i] for k, v in per_layer.items()}, index)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(params["embedding"], x, cfg)
    return logits, dict(cache, lengths=lengths + 1)
