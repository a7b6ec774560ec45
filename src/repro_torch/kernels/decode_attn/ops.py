"""Dispatch wrapper for paged decode attention
(``repro.kernels.decode_attn.ops.paged_decode_attention_op``).

A tensor on the CPU takes the plain PyTorch version; a CUDA tensor takes
the CUDA kernel or raises — there is no fallback. ``LAUNCHES`` counts the
kernel's launches (and nothing else), so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn import paged_kernel
from repro_torch.kernels.decode_attn.ref import paged_decode_attention_ref

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_paged_inputs(q, pool_k, pool_v, block_tables, *int_rows):
    """Validate the operands a paged kernel takes; returns (dtype code, H,
    KV, hd, bs, mb)."""
    dev = q.device
    tensors = (q, pool_k, pool_v, block_tables) + int_rows
    if any(t.device != dev for t in tensors):
        raise ValueError("paged attention: all operands on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention: operands must be contiguous")
    if q.dtype not in _DTYPE_CODES or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise ValueError(f"paged attention: q/pool dtypes {q.dtype}, "
                         f"{pool_k.dtype}, {pool_v.dtype}; need one of "
                         f"{list(_DTYPE_CODES)}")
    if any(t.dtype != torch.int32 for t in (block_tables,) + int_rows):
        raise ValueError("paged attention: tables and row indices are int32")
    if q.dim() != 3 or pool_k.dim() != 4 or pool_v.shape != pool_k.shape \
            or block_tables.dim() != 2:
        raise ValueError(f"paged attention: shapes q {tuple(q.shape)}, pool "
                         f"{tuple(pool_k.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    _, H, hd = q.shape
    _, bs, KV, hd_k = pool_k.shape
    if hd_k != hd or hd not in (64, 128) or H % KV:
        raise ValueError(f"paged attention: head_dim {hd} (pool {hd_k}) must "
                         f"be 64 or 128, and H={H} a multiple of KV={KV}")
    if H // KV > paged_kernel.MAX_QUERY_VECTORS:
        raise ValueError(f"paged attention: group H/KV={H // KV} > "
                         f"{paged_kernel.MAX_QUERY_VECTORS}")
    return _DTYPE_CODES[q.dtype], H, KV, hd, bs, block_tables.shape[1]


def paged_decode_attention_op(q: torch.Tensor, pool_k: torch.Tensor,
                              pool_v: torch.Tensor,
                              block_tables: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Block-table-aware decode attention over one layer's paged pool.

    q [S,H,hd]; pool_k/v [n_blocks,bs,KV,hd]; block_tables [S,max_blocks]
    int32 (-1 = unmapped); lengths [S] int32 valid-token counts (at least
    1; a row of length 0 gives 0 on the card) -> [S,H,hd].
    """
    global LAUNCHES
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pool_k, pool_v, block_tables,
                                          lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: no kernel for {q.device}")
    code, H, KV, hd, bs, mb = check_paged_inputs(q, pool_k, pool_v,
                                                 block_tables, lengths)
    S = q.shape[0]
    if block_tables.shape[0] != S or lengths.shape != (S,):
        raise ValueError(f"paged decode: {S} rows, tables "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    out = torch.empty_like(q)
    if S == 0:
        return out
    err = paged_kernel.fn()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        S, H, KV, hd, bs, mb, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA error {err}")
    LAUNCHES += 1
    return out
