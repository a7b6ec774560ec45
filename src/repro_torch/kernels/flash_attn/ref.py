"""Plain PyTorch causal (windowed) flash attention
(``repro.kernels.flash_attn.ref``).

The correctness oracle for the CUDA kernel and the path the op takes for
tensors on the CPU. Scores and the value product accumulate in float32 on
the inputs' values (JAX's ``preferred_element_type=float32``); the softmax
weights are cast to v's dtype before the product, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: Optional[int] = None) -> torch.Tensor:
    """q [B,H,S,hd], k/v [B,KV,S,hd] (GQA) -> [B,H,S,hd]."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    qg = q.reshape(B, KV, H // KV, S, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) \
        * hd ** -0.5
    i = torch.arange(S, device=q.device)
    mask = i[:, None] >= i[None, :]
    if window is not None:
        mask &= (i[:, None] - i[None, :]) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)
