"""Dispatch wrappers for decode attention, paged and dense
(``repro.kernels.decode_attn.ops``).

A tensor on the CPU takes the plain PyTorch version; a CUDA tensor takes
the CUDA kernel or raises — there is no fallback. ``LAUNCHES`` counts the
paged kernel's launches and ``DENSE_LAUNCHES`` the dense kernel's (and
nothing else), so a run can show that its main path went through them;
``DENSE_PLAN`` is the split plan of the dense kernel's last launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn import kernel, paged_kernel
from repro_torch.kernels.decode_attn.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)

LAUNCHES = 0        # paged_decode_attention_op's kernel
DENSE_LAUNCHES = 0  # decode_attention_op's kernel
DENSE_PLAN = None   # (split_keys, n_splits) of its last launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_paged_inputs(q, pool_k, pool_v, block_tables, *int_rows):
    """Validate the operands a paged kernel takes; returns (dtype code, H,
    KV, hd, bs, mb). Any group size H / KV is taken."""
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
    if hd_k != hd or hd not in (64, 128) or KV == 0 or H % KV:
        raise ValueError(f"paged attention: head_dim {hd} (pool {hd_k}) must "
                         f"be 64 or 128, and H={H} a multiple of KV={KV}")
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
    if q.device.type in ("cpu", "meta"):  # meta: the dry-run's shapes
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
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError("paged decode: q and pools must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if S == 0:
        return out
    dev = q.device.index
    n_sm = paged_kernel.sm_count(torch.cuda.current_device() if dev is None
                                 else dev)
    pps, n_splits = paged_kernel.split_plan(mb, bs, S, KV, n_sm)
    err = paged_kernel.fn()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        S, H, KV, hd, bs, mb, pps, n_splits, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA error {err}")
    LAUNCHES += 1
    return out


def check_dense_inputs(q, k_cache, v_cache, lengths):
    """Validate the operands the dense decode kernel takes; returns (dtype
    code, B, H, KV, L, hd). Any group size H / KV is taken."""
    tensors = (q, k_cache, v_cache, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode attention: all operands on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode attention: operands must be contiguous")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype or lengths.dtype != torch.int32:
        raise ValueError(f"decode attention: dtypes q/k/v {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype} (one of "
                         f"{list(_DTYPE_CODES)}), lengths {lengths.dtype} "
                         f"(int32)")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode attention: shapes q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}")
    B, H, hd = q.shape
    _, L, KV, hd_k = k_cache.shape
    if k_cache.shape[0] != B or lengths.shape != (B,) or hd_k != hd \
            or L == 0 or KV == 0 or H % KV:
        raise ValueError(f"decode attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"decode attention: head_dim {hd} must be 64 or "
                         f"128")
    return _DTYPE_CODES[q.dtype], B, H, KV, L, hd


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Single-query attention over a dense cache.

    q [B,H,hd]; k/v_cache [B,L,KV,hd]; lengths [B] int32 valid-key counts
    (keys at positions >= lengths[b] are masked; a row of length 0 gives 0
    on the card) -> [B,H,hd] in q's dtype. On the card bf16 takes the
    split-KV kernel under ``kernel.split_plan`` (host-known sizes only:
    nothing here reads ``lengths`` on the host), float32 the first design.
    """
    global DENSE_LAUNCHES, DENSE_PLAN
    if q.device.type in ("cpu", "meta"):  # meta: the dry-run's shapes
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: no kernel for {q.device}")
    code, B, H, KV, L, hd = check_dense_inputs(q, k_cache, v_cache,
                                               lengths)
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode attention: q and caches must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    # bf16 takes the split-KV kernel, float32 the first design (one split)
    split_keys, n_splits = L, 1
    if code == 1:
        dev = q.device.index
        split_keys, n_splits = kernel.split_plan(
            B, KV, L, paged_kernel.sm_count(torch.cuda.current_device()
                                            if dev is None else dev))
    err = kernel.fn()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, KV, L, hd, split_keys,
        n_splits, code, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: CUDA error {err}")
    DENSE_LAUNCHES += 1
    DENSE_PLAN = (split_keys, n_splits)
    return out
