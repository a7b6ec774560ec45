"""Plain PyTorch paged decode attention (``repro.kernels.decode_attn.ref``).

The gather adaptation of the paged pointer walk: index the block pool with
the block table (one gather) and run the regular masked decode attention
over the result. It is the correctness oracle for the CUDA kernel and the
path the op takes for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import decode_attention


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
