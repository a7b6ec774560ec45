"""Plain PyTorch decode attention, dense and paged
(``repro.kernels.decode_attn.ref``).

``decode_attention`` is the masked single-query attention over a dense
cache, and ``decode_attention_ref`` runs it with keys masked from
``lengths`` on. ``paged_decode_attention_ref`` is the gather adaptation of
the paged pointer walk: index the block pool with the block table (one
gather) and run the same masked attention over the result. They are the
correctness oracles for the CUDA kernels and the paths the ops take for
tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention(
    q: torch.Tensor,         # [B, H, hd] (rope already applied)
    k_cache: torch.Tensor,   # [B, L, KV, hd]
    v_cache: torch.Tensor,   # [B, L, KV, hd]
    kv_valid: torch.Tensor,  # [B, L] bool
    *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-query attention over a dense cache: q·k in the input dtype,
    then float32 softmax (``repro.models.attention.decode_attention``; the
    port's ``models.attention.decode_attention`` takes it on the CPU)."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k_cache).float() * scale
    s = torch.where(kv_valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q [B,H,hd]; k/v_cache [B,L,KV,hd]; lengths [B] valid-key counts ->
    [B,H,hd]. A row of length 0 averages V over its masked cache, as the
    reference does (the CUDA kernel writes 0 there)."""
    valid = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
             < lengths[:, None])
    return decode_attention(q, k_cache, v_cache, valid)


def paged_decode_attention_ref(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q [S,H,hd]; pool_k/v [n_blocks,bs,KV,hd]; block_tables [S,mb]
    (-1 = unmapped); lengths [S] valid-token counts -> [S,H,hd]."""
    S, mb = block_tables.shape
    bs = pool_k.shape[1]
    safe = block_tables.clamp_min(0).long()
    k = pool_k[safe].reshape(S, mb * bs, *pool_k.shape[2:])
    v = pool_v[safe].reshape(S, mb * bs, *pool_v.shape[2:])
    valid = (torch.arange(mb * bs, device=q.device)[None, :]
             < lengths[:, None])
    return decode_attention(q, k, v, valid)
