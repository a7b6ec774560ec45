"""Dispatch wrapper for chunked paged prefill attention
(``repro.kernels.prefill_attn.ops.paged_prefill_attention_op``).

A tensor on the CPU takes the plain PyTorch version; a CUDA tensor takes
the CUDA kernel or raises — there is no fallback. ``LAUNCHES`` counts the
kernel's launches (and nothing else).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attn import paged_kernel
from repro_torch.kernels.decode_attn.ops import check_paged_inputs
from repro_torch.kernels.prefill_attn import kernel
from repro_torch.kernels.prefill_attn.ref import paged_prefill_attention_ref

LAUNCHES = 0


def paged_prefill_attention_op(q: torch.Tensor, pool_k: torch.Tensor,
                               pool_v: torch.Tensor,
                               block_tables: torch.Tensor,
                               seg_ids: torch.Tensor, q_pos: torch.Tensor,
                               kv_lens: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Segment-packed prefill attention over one layer's paged pool.

    q [C,H,hd]; pool_k/v [n_blocks,bs,KV,hd]; block_tables [S,max_blocks]
    int32 (-1 = unmapped); seg_ids [C] int32 slot per row (-1 = padding);
    q_pos [C] int32 absolute positions -> [C,H,hd]. ``kv_lens`` [S] (the
    per-slot resident counts) is accepted for the reference's signature and
    not needed: each row's ``q_pos`` already bounds what it attends.
    """
    global LAUNCHES
    del kv_lens
    if q.device.type in ("cpu", "meta"):  # meta: the dry-run's shapes
        return paged_prefill_attention_ref(q, pool_k, pool_v, block_tables,
                                           seg_ids, q_pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: no kernel for {q.device}")
    code, H, KV, hd, bs, mb = check_paged_inputs(q, pool_k, pool_v,
                                                 block_tables, seg_ids, q_pos)
    C = q.shape[0]
    if seg_ids.shape != (C,) or q_pos.shape != (C,):
        raise ValueError(f"paged prefill: {C} rows, seg_ids "
                         f"{tuple(seg_ids.shape)}, q_pos {tuple(q_pos.shape)}")
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError("paged prefill: q and pools must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if C == 0:
        return out
    if code == 0:  # float32: the simple kernel, one split
        pps, n_splits = mb, 1
    else:
        dev = q.device.index
        n_sm = paged_kernel.sm_count(torch.cuda.current_device()
                                     if dev is None else dev)
        pps, n_splits = kernel.split_plan(C, H // KV, KV, mb, bs, n_sm)
    err = kernel.fn()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_tables.data_ptr(), seg_ids.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), C, H, KV, hd, bs, mb, pps, n_splits, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attention: CUDA error {err}")
    LAUNCHES += 1
    return out
