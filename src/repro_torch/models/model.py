"""Dense decoder LM (``repro.models.model``, ``arch_type="dense"`` only).

Public entry points: ``model_spec`` / ``init_params``; the whole-sequence
``forward_hidden`` / ``forward_logits`` (the training forward, and the
reference the serving engines are checked against); and the dense-cache
generation path of the rollout engine, ``init_cache`` / ``prefill`` /
``decode_step``. Layers are a Python loop over the stacked leading axis
(the reference scans it), each stacked leaf unbound once per forward; with
``cfg.remat`` and gradients enabled each layer is recomputed in the
backward (``torch.utils.checkpoint``), as the reference's remat does.
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
from repro_torch.models.params import (
    ParamTree,
    SpecTree,
    init_from_specs,
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


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: only dense architectures are ported")


def model_spec(cfg: ModelConfig) -> SpecTree:
    _check_dense(cfg)
    return {
        "embedding": embedding_spec(cfg),
        "final_norm": rmsnorm_spec(cfg.d_model),
        "blocks": stack_specs(blocks.attn_block_spec(cfg), cfg.num_layers),
    }


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


def _block_hidden(lp, x, cfg, positions, pad_mask):
    return blocks.attn_block_full(lp, x, cfg, positions, pad_mask)[0]


def forward_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B,S] -> final-normed hidden [B,S,d]."""
    _check_dense(cfg)
    x = embed_tokens(params["embedding"], tokens, cfg)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in unstack_layers(params["blocks"], cfg.num_layers):
        if remat:
            # no randomness in a layer, so no RNG state to stash
            x = checkpoint(_block_hidden, lp, x, cfg, positions, pad_mask,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block_hidden(lp, x, cfg, positions, pad_mask)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward_logits(params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B,S] -> float32 logits [B,S,V]."""
    h = forward_hidden(params, cfg, tokens, positions, pad_mask)
    return logits_from_hidden(params["embedding"], h, cfg)


# -------------------------------------------------------------------- caches
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               window: Optional[int] = None,
               dtype: Optional[torch.dtype] = None,
               device="cuda") -> Dict[str, Any]:
    """Stacked per-layer decode caches + per-sequence lengths:
    {"attn": {"k", "v": [layers, batch, L, KV, hd]}, "lengths": [batch]
    int32}, L = ``max_len`` (or ``window`` when shorter), in the model's
    dtype unless ``dtype``."""
    _check_dense(cfg)
    device = require_device(device)
    one = blocks.attn_cache_for(cfg, batch, max_len, window=window,
                                dtype=dtype or torch_dtype(cfg),
                                device=device)
    n = cfg.num_layers
    return {"attn": {k: torch.zeros((n,) + v.shape, dtype=v.dtype,
                                    device=device)
                     for k, v in one.items()},
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


# ------------------------------------------------------------------- prefill
@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None,
            window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompts, returning (final-normed hidden [B,S,d], a decode
    cache populated with their keys and values).

    ``lengths`` [B] are the true prompt lengths of right-padded prompts
    (default: all S). Attention runs through the flash attention kernel op,
    causal with no pad mask: a valid row attends only positions before it,
    which are all valid, so it gets exactly what the reference's masked
    prefill gives it. Pad rows, and the cache entries at positions >=
    lengths, differ from the reference's; decode never reads them (it
    writes position ``lengths`` before attending ``lengths + 1`` keys). No
    gradient is recorded (the flash op is forward only).
    """
    _check_dense(cfg)
    x = embed_tokens(params["embedding"], tokens, cfg)
    B, S, _ = x.shape
    max_len = max_len or S
    if window is None and max_len < S:
        raise ValueError(
            f"decode cache max_len={max_len} < prompt length {S}; only "
            "windowed caches may wrap")
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32,
                             device=tokens.device)
    cache = init_cache(cfg, B, max_len, window=window, device=tokens.device)
    L = cache["attn"]["k"].shape[2]
    slots = None if S <= L else torch.arange(S - L, S,
                                             device=tokens.device) % L
    for i, lp in enumerate(unstack_layers(params["blocks"],
                                          cfg.num_layers)):
        x, (k, v) = blocks.attn_block_full(lp, x, cfg, positions, None,
                                           window, flash=True)
        for buf, new in ((cache["attn"]["k"][i], k),
                         (cache["attn"]["v"][i], v)):
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
                layers: Optional[List[Dict[str, Any]]] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence: tokens [B] -> (float32 logits [B,V],
    cache). Each layer's key and value are written into ``cache``'s
    tensors in place; the returned cache dict shares them and carries
    ``lengths + 1``. ``layers`` (``unstack_layers(params["blocks"])``) may
    be passed to skip unbinding the stacked weights on every token.
    Nothing here reads a device value on the host."""
    _check_dense(cfg)
    lengths = cache["lengths"]
    if layers is None:
        layers = unstack_layers(params["blocks"], cfg.num_layers)
    x = embed_tokens(params["embedding"], tokens[:, None], cfg)[:, 0]
    ks = torch.unbind(cache["attn"]["k"], 0)
    vs = torch.unbind(cache["attn"]["v"], 0)
    # the cache slot, keys attended and rope angles: the same in every layer
    index = attn_mod.decode_index(cfg, lengths, ks[0].shape[1], window)
    for lp, kc, vc in zip(layers, ks, vs):
        x, _ = blocks.attn_block_decode(lp, x, cfg, {"k": kc, "v": vc},
                                        index)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_from_hidden(params["embedding"], x, cfg)
    return logits, dict(cache, lengths=lengths + 1)
