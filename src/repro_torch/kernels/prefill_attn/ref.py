"""Plain PyTorch chunked paged prefill attention
(``repro.kernels.prefill_attn.ref``).

Row ``i`` of a chunk attends exactly the keys a decode step at position
``q_pos[i]`` would see: its own slot's pages up to and including itself.
So the reference gives every row its own slot's block table and the
inclusive length ``q_pos + 1``; causality within the chunk and isolation
between packed prompts both follow. Padding rows (``seg_ids < 0``) are 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn.ref import paged_decode_attention_ref


def paged_prefill_attention_ref(q: torch.Tensor, pool_k: torch.Tensor,
                                pool_v: torch.Tensor,
                                block_tables: torch.Tensor,
                                seg_ids: torch.Tensor,
                                q_pos: torch.Tensor) -> torch.Tensor:
    """q [C,H,hd]; pool_k/v [n_blocks,bs,KV,hd]; block_tables [S,mb]
    (-1 = unmapped); seg_ids [C] slot per row (-1 = padding row);
    q_pos [C] absolute position per row -> [C,H,hd] (0 for padding)."""
    row_tables = block_tables[seg_ids.clamp_min(0).long()]     # [C, mb]
    out = paged_decode_attention_ref(q, pool_k, pool_v, row_tables,
                                     q_pos + 1)
    return torch.where((seg_ids >= 0)[:, None, None], out,
                       torch.zeros_like(out))
