"""Block wiring (``repro.models.blocks``): pre-norm residual or
Cohere-style parallel attention (GQA/MHA or MLA) + FFN (SwiGLU or MoE),
and the pre-norm residual Mamba2 (SSD) block, each over a whole sequence
or one decode token, and the per-layer attention decode cache."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    rmsnorm,
    rmsnorm_spec,
    swiglu,
    swiglu_spec,
)


def attn_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {"ln1": rmsnorm_spec(d)}
    spec["attn"] = (mla_mod.mla_spec(cfg) if cfg.mla is not None
                    else attn_mod.attention_spec(cfg))
    if not cfg.parallel_block:
        spec["ln2"] = rmsnorm_spec(d)
    spec["ffn"] = (moe_mod.moe_spec(cfg) if cfg.moe is not None
                   else swiglu_spec(d, cfg.d_ff))
    return spec


def ssm_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": rmsnorm_spec(cfg.d_model), "ssm": ssm_mod.ssm_spec(cfg)}


def _ffn(params, x: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, aux): the MoE's load-balance loss, or None for a SwiGLU FFN
    (the reference's zero, left out of the sums)."""
    if cfg.moe is not None:
        if x.dim() == 2:  # one decode token a row: route the B tokens
            y, aux = moe_mod.moe_apply(params, x[:, None], cfg)
            return y[:, 0], aux
        return moe_mod.moe_apply(params, x, cfg)
    return swiglu(params, x), None


def _ffn_out(params, x: torch.Tensor, h: torch.Tensor, a_out: torch.Tensor,
             cfg: ModelConfig) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Residual + FFN after the attention output ``a_out`` of ``h`` =
    ln1(x), sequential or parallel, with the FFN's aux."""
    if cfg.parallel_block:
        f_out, aux = _ffn(params["ffn"], h, cfg)
        return x + a_out + f_out, aux
    x = x + a_out
    f_out, aux = _ffn(params["ffn"], rmsnorm(params["ln2"], x, cfg.norm_eps),
                      cfg)
    return x + f_out, aux


def attn_block_full(params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None,
                    window: Optional[int] = None, *, flash: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (x, aux, kv): aux the MoE load-balance loss (None without
    MoE), kv the cacheables for a prefill, the block's (k, v), or MLA's
    (c_kv, k_rope). ``flash``: see ``attention_full`` (MLA attends through
    the plain path and takes the pad mask)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a_out, kv = mla_mod.mla_full(params["attn"], h, cfg, positions,
                                     pad_mask, window)
    else:
        a_out, kv = attn_mod.attention_full(params["attn"], h, cfg,
                                            positions, pad_mask, window,
                                            flash=flash)
    x, aux = _ffn_out(params, x, h, a_out, cfg)
    return x, aux, kv


def attn_block_decode(params, x: torch.Tensor, cfg: ModelConfig,
                      cache: Dict[str, torch.Tensor],
                      index: attn_mod.DecodeIndex
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, d]; cache: this layer's {"k", "v"} (MLA: {"ckv", "krope"}),
    written in place; index: ``attention.decode_index`` of the token,
    shared by every layer (MLA reads only its lengths). Returns (x,
    cache); the decode's aux is dropped, as the reference drops it."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a_out, cache = mla_mod.mla_decode(params["attn"], h, cfg, cache,
                                          index.lengths)
    else:
        a_out, cache = attn_mod.attention_decode(params["attn"], h, cfg,
                                                 cache, index)
    return _ffn_out(params, x, h, a_out, cfg)[0], cache


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


def attn_cache_logical(cfg: ModelConfig):
    return (mla_mod.MLA_CACHE_LOGICAL if cfg.mla is not None
            else attn_mod.KV_CACHE_LOGICAL)


def attn_cache_for(cfg: ModelConfig, batch: int, max_len: int, *,
                   window: Optional[int] = None,
                   dtype: Optional[torch.dtype] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """One layer's decode cache ({"k", "v"}, or MLA's {"ckv", "krope"}):
    a ring of ``window`` positions when that is shorter than ``max_len``."""
    L = min(max_len, window) if window else max_len
    if cfg.mla is not None:
        return mla_mod.init_mla_cache(cfg, batch, L, dtype=dtype,
                                      device=device)
    return attn_mod.init_kv_cache(cfg, batch, L, dtype=dtype, device=device)
