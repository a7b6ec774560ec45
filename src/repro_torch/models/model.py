"""Dense decoder LM (``repro.models.model``, ``arch_type="dense"`` only).

Public entry points: ``model_spec`` / ``init_params`` and the
whole-sequence reference ``forward_hidden`` / ``forward_logits`` that the
serving engine is checked against. Layers are a Python loop over the
stacked leading axis (the reference scans it).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
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
    layer_slice,
    stack_specs,
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
                device="cuda", dtype: Optional[torch.dtype] = None
                ) -> ParamTree:
    """Seeded random weights with the reference's stds. ``generator``
    defaults to a fresh one seeded 0 on ``device``."""
    device = require_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return init_from_specs(model_spec(cfg), generator, device=device,
                           dtype=dtype or torch_dtype(cfg))


def forward_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B,S] -> final-normed hidden [B,S,d]."""
    _check_dense(cfg)
    x = embed_tokens(params["embedding"], tokens, cfg)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    for li in range(cfg.num_layers):
        x = blocks.attn_block_full(layer_slice(params["blocks"], li), x, cfg,
                                   positions, pad_mask)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward_logits(params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B,S] -> float32 logits [B,S,V]."""
    h = forward_hidden(params, cfg, tokens, positions, pad_mask)
    return logits_from_hidden(params["embedding"], h, cfg)
