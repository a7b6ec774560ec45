"""GQA/MHA attention: whole-sequence causal attention, single-query
decode attention and the dense decode cache (``repro.models.attention``).

``chunked_causal_attention`` is plain PyTorch: the training forward
attends through it, and it is a reference the kernels and the serving
engines are held against. ``decode_attention`` (the reference's masked
single-query attention) dispatches as ``attention_decode`` does: the dense
decode kernel op on the card, its plain version
(``kernels/decode_attn/ref.py``) on the CPU. The rollout engine's dense
prefill attends through the flash attention kernel op
(``attention_full(..., flash=True)``) and its decode through the dense
decode kernel op (``attention_decode``). No fused library attention is
called.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, current_env, write_rows
from repro_torch.kernels.decode_attn import ref as decode_ref
from repro_torch.kernels.decode_attn.ops import decode_attention_op
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models.layers import (
    apply_rope,
    apply_rope_cos_sin,
    rope_cos_sin,
)
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
    v: torch.Tensor,             # [B, Skv, KV, dv]
    *,
    q_positions: torch.Tensor,   # [B, S]
    kv_positions: torch.Tensor,  # [B, Skv]
    kv_valid: Optional[torch.Tensor] = None,  # [B, Skv] bool
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Causal GQA attention in query chunks, so the [S, Skv] score matrix
    exists for one chunk at a time (with ``window``, query position i sees
    only keys with i - j < window). Scores in the input dtype, softmax in
    float32, as the reference. The value width ``dv`` may differ from the
    key width (MLA); the scale defaults to hd ** -0.5."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    out = []
    for c0 in range(0, S, q_chunk):
        q_i = q[:, c0: c0 + q_chunk].reshape(B, -1, KV, G, hd)
        qpos_i = q_positions[:, c0: c0 + q_chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", q_i, k).float() * scale
        mask = qpos_i[:, :, None] >= kv_positions[:, None, :]
        if window is not None:
            mask = mask & ((qpos_i[:, :, None] - kv_positions[:, None, :])
                           < window)
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
        out.append(o.reshape(B, -1, H, dv).to(q.dtype))
    return torch.cat(out, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_valid: torch.Tensor, *,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Single-query attention over a dense cache. q [B,H,hd] (rope
    applied); k/v_cache [B,L,KV,hd]; kv_valid [B,L] bool -> [B,H,hd].

    On the CPU this is the plain version. On the card it is the dense
    decode kernel op, as ``attention_decode`` calls it, and its contract
    narrows: the kernel masks keys from a length on, so ``kv_valid`` must
    hold a prefix of each row (checked on the host, which reads the mask
    and so synchronises: the engines call the op with lengths instead),
    else it raises; and a ``softmax_scale`` other than hd^-0.5 is folded
    into q in q's dtype, where the plain version scales q·k in float32, so
    in bf16 the two differ by q's rounding.
    """
    if q.device.type in ("cpu", "meta"):
        return decode_ref.decode_attention(q, k_cache, v_cache, kv_valid,
                                           softmax_scale=softmax_scale)
    lengths = kv_valid.sum(-1, dtype=torch.int32)
    keys = torch.arange(kv_valid.shape[1], device=kv_valid.device)
    if not torch.equal(kv_valid, keys[None, :] < lengths[:, None]):
        raise ValueError("decode_attention: on the card kv_valid must be a "
                         "prefix of each row (the kernel reads lengths)")
    hd = q.shape[-1]
    if softmax_scale is not None and softmax_scale != hd ** -0.5:
        q = q * (softmax_scale * hd ** 0.5)
    return decode_attention_op(q.contiguous(), k_cache, v_cache, lengths)


# --------------------------------------------------------------------- cache
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  dtype: Optional[torch.dtype] = None,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Zero K/V cache {"k", "v"}: [batch, max_len, KV, hd] each (bfloat16
    unless ``dtype``), as the reference's ``init_kv_cache``."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dtype = dtype or torch.bfloat16
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class DecodeIndex(NamedTuple):
    """What every layer's decode of one token shares, made once per token
    by ``decode_index``."""
    rows: torch.Tensor       # [B] int64: 0 .. B-1
    write_idx: torch.Tensor  # [B] int64: the cache slot of the new key
    n_valid: torch.Tensor    # [B] int32: keys attended, the new one included
    cos: torch.Tensor        # [B, 1, 1, hd/2] rope at position `lengths`
    sin: torch.Tensor
    lengths: torch.Tensor    # [B] int32: tokens already cached (MLA reads it)


def decode_index(cfg: ModelConfig, lengths: torch.Tensor, L: int,
                 window: Optional[int] = None) -> DecodeIndex:
    """lengths [B] int32 tokens already in a cache of L positions -> the
    shared indices: the new key goes to ``min(lengths, L - 1)``, or to
    ``lengths % window`` in a sliding-window ring of length ``window``, and
    attention runs over the first ``lengths + 1`` (at most L) positions.
    Nothing here reads a device value on the host."""
    if window is not None and L == window:
        write_idx = lengths % window
        n_valid = torch.clamp(lengths + 1, max=window)
    else:
        write_idx = torch.clamp(lengths, max=L - 1)
        n_valid = torch.clamp(lengths + 1, max=L)
    cos, sin = rope_cos_sin(lengths[:, None], cfg.resolved_head_dim,
                            cfg.rope_theta)
    return DecodeIndex(torch.arange(lengths.shape[0], device=lengths.device),
                       write_idx.long(), n_valid.to(torch.int32), cos, sin,
                       lengths)


def _write_cache(cache_arr: torch.Tensor, new: torch.Tensor,
                 index: DecodeIndex) -> torch.Tensor:
    """cache [B, L, KV, hd] <- new [B, KV, hd] at ``index.write_idx``, in
    place, as one indexed write on the device (the reference returns a new
    array). Returns ``cache_arr``."""
    if current_env() is None:
        cache_arr[index.rows, index.write_idx] = new.to(cache_arr.dtype)
        return cache_arr
    return write_rows(cache_arr, index.write_idx, new)


def attention_full(params, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor,
                   pad_mask: Optional[torch.Tensor] = None,
                   window: Optional[int] = None, *, flash: bool = False
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """Whole-sequence attention block body: x [B,S,d] -> (out [B,S,d],
    (k, v)), k/v [B,S,KV,hd] after rope, the cacheables for a prefill.

    ``flash`` attends through the flash attention kernel op: causal by
    index (``positions`` must be 0..S-1 in every row), no pad mask, no
    gradient. Otherwise the plain ``chunked_causal_attention``, which the
    training forward differentiates.
    """
    q, k, v = project_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", None, "act_heads", None)
    k = constrain(k, "batch", None, "act_heads", None)
    if flash:
        if pad_mask is not None:
            raise ValueError("flash attention takes no pad mask")
        # [B,S,H,hd] viewed as [B,H,S,hd]: the kernel reads and writes the
        # activations through their strides
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.contiguous().transpose(1, 2),
                              window=window).transpose(1, 2)
    else:
        out = chunked_causal_attention(q, k, v, q_positions=positions,
                                       kv_positions=positions,
                                       kv_valid=pad_mask, window=window)
    out = constrain(out, "batch", None, "act_heads", None)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (k, v)


def attention_decode(params, x: torch.Tensor, cfg: ModelConfig,
                     cache: Dict[str, torch.Tensor], index: DecodeIndex
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x [B, d]; cache {"k", "v"} [B, L, KV, hd];
    ``index`` from ``decode_index`` over the tokens already in the cache
    (the reference takes those lengths and the window and derives it in
    every layer).

    The new key and value are written into ``cache`` in place (the
    reference returns a new cache) at ``index.write_idx``; attention then
    runs over the first ``index.n_valid`` positions through the dense
    decode kernel op. Returns (y [B, d], cache). Nothing here reads a
    device value on the host.
    """
    q = torch.einsum("bd,dhk->bhk", x, params["wq"])
    k = torch.einsum("bd,dhk->bhk", x, params["wk"])
    v = torch.einsum("bd,dhk->bhk", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    # rope at absolute position = lengths
    q = apply_rope_cos_sin(q[:, None], index.cos, index.sin)[:, 0]
    k = apply_rope_cos_sin(k[:, None], index.cos, index.sin)[:, 0]
    _write_cache(cache["k"], k, index)
    _write_cache(cache["v"], v, index)
    o = decode_attention_op(q.contiguous(), cache["k"], cache["v"],
                            index.n_valid)
    return torch.einsum("bhk,hkd->bd", o, params["wo"]), cache


def prefill_into_cache(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                       v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Copy prefill keys/values [B,S,KV,hd] into the head of a (longer)
    decode cache, in place. Returns ``cache``."""
    S = k.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return cache


# the decode cache's logical axes (the reference's ``KV_CACHE_LOGICAL``)
KV_CACHE_LOGICAL = {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
                    "v": ("batch", "kv_seq", "kv_heads", "head_dim")}
