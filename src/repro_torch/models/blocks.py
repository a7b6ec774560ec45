"""Block wiring (``repro.models.blocks``): pre-norm residual or
Cohere-style parallel attention + FFN, and the pre-norm residual Mamba2
(SSD) block, each over a whole sequence or one decode token, and the
per-layer attention decode cache. MLA and MoE blocks are not ported."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    rmsnorm,
    rmsnorm_spec,
    swiglu,
    swiglu_spec,
)


def attn_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError("MLA and MoE blocks are not ported yet")
    d = cfg.d_model
    spec: Dict[str, Any] = {"ln1": rmsnorm_spec(d),
                            "attn": attn_mod.attention_spec(cfg)}
    if not cfg.parallel_block:
        spec["ln2"] = rmsnorm_spec(d)
    spec["ffn"] = swiglu_spec(d, cfg.d_ff)
    return spec


def ssm_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": rmsnorm_spec(cfg.d_model), "ssm": ssm_mod.ssm_spec(cfg)}


def _ffn_out(params, x: torch.Tensor, h: torch.Tensor, a_out: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """Residual + FFN after the attention output ``a_out`` of ``h`` =
    ln1(x), sequential or parallel."""
    if cfg.parallel_block:
        return x + a_out + swiglu(params["ffn"], h)
    x = x + a_out
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + swiglu(params["ffn"], h2)


def attn_block_full(params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None,
                    window: Optional[int] = None, *, flash: bool = False
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Returns (x, kv) with kv the block's (k, v), the cacheables for a
    prefill (the reference also returns an auxiliary loss, zero for the
    dense blocks ported here). ``flash``: see ``attention_full``."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a_out, kv = attn_mod.attention_full(params["attn"], h, cfg, positions,
                                        pad_mask, window, flash=flash)
    return _ffn_out(params, x, h, a_out, cfg), kv


def attn_block_decode(params, x: torch.Tensor, cfg: ModelConfig,
                      cache: Dict[str, torch.Tensor],
                      index: attn_mod.DecodeIndex
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, d]; cache: this layer's {"k", "v"}, written in place; index:
    ``attention.decode_index`` of the token, shared by every layer.
    Returns (x, cache)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a_out, cache = attn_mod.attention_decode(params["attn"], h, cfg, cache,
                                             index)
    return _ffn_out(params, x, h, a_out, cfg), cache


def ssm_block_full(params, x: torch.Tensor, cfg: ModelConfig,
                   pad_mask: Optional[torch.Tensor] = None,
                   initial_cache: Optional[Dict[str, torch.Tensor]] = None,
                   valid_lens: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (x, cache) with cache the block's final {"conv", "state"}
    (the reference also returns an auxiliary loss, zero for SSM blocks)."""
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    y, cache = ssm_mod.ssm_full(params["ssm"], h, cfg, initial_cache,
                                pad_mask=pad_mask, valid_lens=valid_lens)
    return x + y, cache


def ssm_block_decode(params, x: torch.Tensor, cfg: ModelConfig,
                     cache: Dict[str, torch.Tensor],
                     update: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, d]; cache: this layer's {"conv", "state"}, updated in place
    (rows where ``update`` is False keep theirs). Returns (x, cache)."""
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    y, cache = ssm_mod.ssm_decode(params["ssm"], h, cfg, cache, update)
    return x + y, cache


def attn_cache_for(cfg: ModelConfig, batch: int, max_len: int, *,
                   window: Optional[int] = None,
                   dtype: Optional[torch.dtype] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """One layer's decode cache: a ring of ``window`` positions when that
    is shorter than ``max_len``."""
    L = min(max_len, window) if window else max_len
    return attn_mod.init_kv_cache(cfg, batch, L, dtype=dtype, device=device)
