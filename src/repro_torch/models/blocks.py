"""Transformer block wiring, dense only (``repro.models.blocks``):
pre-norm residual or Cohere-style parallel attention + FFN."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
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


def attn_block_full(params, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a_out = attn_mod.attention_full(params["attn"], h, cfg, positions,
                                    pad_mask)
    if cfg.parallel_block:
        return x + a_out + swiglu(params["ffn"], h)
    x = x + a_out
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + swiglu(params["ffn"], h2)
