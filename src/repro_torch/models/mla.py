"""Multi-head Latent Attention (DeepSeek-V2) (``repro.models.mla``).

K/V state is compressed into a rank-``r`` latent plus one shared RoPE key;
the decode cache is {"ckv": [B, L, r], "krope": [B, L, rope]} instead of
per-head keys and values. The whole-sequence path expands the latent into
per-head keys and values and attends through the plain
``chunked_causal_attention`` (query/key width nope + rope, value width
``v_head_dim``), as the reference's XLA path does; the flash kernel takes
one head width and is not used here. The decode path is the *absorbed*
form: the query is projected into the latent space, so one token attends
the cached latent directly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, write_rows
from repro_torch.models.attention import NEG_INF, chunked_causal_attention
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_spec
from repro_torch.models.params import ParamSpec


def mla_spec(cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamSpec((d, h, qk), ("embed", "heads", "head_dim")),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", "mla_rank")),
        "kv_norm": rmsnorm_spec(m.kv_lora_rank),
        "w_uk": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim),
                          ("mla_rank", "heads", "head_dim")),
        "w_uv": ParamSpec((m.kv_lora_rank, h, m.v_head_dim),
                          ("mla_rank", "heads", "head_dim")),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def _scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def _latent(params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (c_kv [B,S,r] normed, k_rope [B,S,rope] roped)."""
    m = cfg.mla
    dkv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"])
    c_kv, k_rope = torch.split(dkv, [m.kv_lora_rank, m.qk_rope_head_dim],
                               dim=-1)
    c_kv = rmsnorm(params["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None], positions,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_full(params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor,
             pad_mask: Optional[torch.Tensor] = None,
             window: Optional[int] = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Train/prefill MLA: x [B,S,d] -> (out [B,S,d], (c_kv, k_rope)), the
    latent and the roped shared key, the cacheables for a prefill."""
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.num_heads
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv, k_rope = _latent(params, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"])
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        B, S, h, m.qk_rope_head_dim)], dim=-1)
    qc = torch.cat([q_nope, q_rope], dim=-1)
    qc = constrain(qc, "batch", None, "act_heads", None)
    k = constrain(k, "batch", None, "act_heads", None)
    out = chunked_causal_attention(
        qc, k, v, q_positions=positions, kv_positions=positions,
        kv_valid=pad_mask, window=window, softmax_scale=_scale(cfg))
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, (c_kv, k_rope)


def mla_decode(params, x: torch.Tensor, cfg: ModelConfig,
               cache: Dict[str, torch.Tensor], lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed one-token decode against the latent cache. x [B, d];
    cache {"ckv": [B, L, r], "krope": [B, L, rope]}; lengths [B] tokens
    already cached. The token's latent and rope key are written in place
    (the reference returns a new cache) at ``min(lengths, L - 1)``, then
    it attends the first ``min(lengths + 1, L)`` positions: scores are
    (q_nope W_uk) . c_kv + q_rope . k_rope. Returns (y [B, d], cache).
    Nothing here reads a device value on the host."""
    m = cfg.mla
    pos = lengths[:, None]
    q = torch.einsum("bd,dhk->bhk", x, params["wq"])
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope[:, None], pos, cfg.rope_theta)[:, 0]
    c_kv_t, k_rope_t = _latent(params, x[:, None], cfg, pos)

    ckv, krope = cache["ckv"], cache["krope"]
    L = ckv.shape[1]
    idx = torch.clamp(lengths, max=L - 1).long()
    write_rows(ckv, idx, c_kv_t[:, 0])
    write_rows(krope, idx, k_rope_t[:, 0])
    valid = torch.arange(L, device=x.device)[None, :] \
        < torch.clamp(lengths + 1, max=L)[:, None]

    q_lat = torch.einsum("bhk,rhk->bhr", q_nope, params["w_uk"])
    s = (torch.einsum("bhr,blr->bhl", q_lat.to(ckv.dtype), ckv).float()
         + torch.einsum("bhp,blp->bhl", q_rope.to(krope.dtype),
                        krope).float()) * _scale(cfg)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhl,blr->bhr", p.to(ckv.dtype), ckv).to(x.dtype)
    o = torch.einsum("bhr,rhk->bhk", o_lat, params["w_uv"])
    return torch.einsum("bhk,hkd->bd", o, params["wo"]), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype: Optional[torch.dtype] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Zero latent cache {"ckv": [batch, max_len, r], "krope": [batch,
    max_len, rope]} (bfloat16 unless ``dtype``)."""
    m = cfg.mla
    dtype = dtype or torch.bfloat16
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                 dtype=dtype, device=device)}


# the latent cache's logical axes (the reference's ``MLA_CACHE_LOGICAL``)
MLA_CACHE_LOGICAL = {"ckv": ("batch", "kv_seq", "mla_rank"),
                     "krope": ("batch", "kv_seq", None)}
