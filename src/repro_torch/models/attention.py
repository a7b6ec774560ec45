"""GQA/MHA attention: whole-sequence causal attention and single-query
decode attention, plain PyTorch (``repro.models.attention``).

These are the references the paged kernels and the serving engine are held
against; neither calls a fused library attention.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30


def attention_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    spec = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                               init="zeros")
        spec["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"),
                               init="zeros")
    return spec


def project_qkv(params, x: torch.Tensor, cfg: ModelConfig):
    """x [..., d] -> q [..., H, hd], k/v [..., KV, hd] (before rope)."""
    q = torch.einsum("...d,dhk->...hk", x, params["wq"])
    k = torch.einsum("...d,dhk->...hk", x, params["wk"])
    v = torch.einsum("...d,dhk->...hk", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return q, k, v


def chunked_causal_attention(
    q: torch.Tensor,             # [B, S, H, hd]
    k: torch.Tensor,             # [B, Skv, KV, hd]
    v: torch.Tensor,             # [B, Skv, KV, hd]
    *,
    q_positions: torch.Tensor,   # [B, S]
    kv_positions: torch.Tensor,  # [B, Skv]
    kv_valid: Optional[torch.Tensor] = None,  # [B, Skv] bool
    q_chunk: int = 512,
) -> torch.Tensor:
    """Causal GQA attention in query chunks, so the [S, Skv] score matrix
    exists for one chunk at a time. Scores in the input dtype, softmax in
    float32, as the reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    out = []
    for c0 in range(0, S, q_chunk):
        q_i = q[:, c0: c0 + q_chunk].reshape(B, -1, KV, G, hd)
        qpos_i = q_positions[:, c0: c0 + q_chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", q_i, k).float() * scale
        mask = qpos_i[:, :, None] >= kv_positions[:, None, :]
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
        out.append(o.reshape(B, -1, H, hd).to(q.dtype))
    return torch.cat(out, dim=1)


def decode_attention(
    q: torch.Tensor,         # [B, H, hd] (rope already applied)
    k_cache: torch.Tensor,   # [B, L, KV, hd]
    v_cache: torch.Tensor,   # [B, L, KV, hd]
    kv_valid: torch.Tensor,  # [B, L] bool
) -> torch.Tensor:
    """Single-query attention over a dense cache: q·k in the input dtype,
    then float32 softmax (``repro.models.attention.decode_attention``)."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k_cache).float() * hd ** -0.5
    s = torch.where(kv_valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, H, hd).to(q.dtype)


def attention_full(params, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor,
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole-sequence attention block body: x [B,S,d] -> [B,S,d]."""
    q, k, v = project_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_causal_attention(q, k, v, q_positions=positions,
                                   kv_positions=positions, kv_valid=pad_mask)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])
