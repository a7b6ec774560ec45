"""Dispatch wrapper for causal flash attention
(``repro.kernels.flash_attn.ops.flash_attention``).

A tensor on the CPU takes the plain PyTorch version; a CUDA tensor takes
the CUDA kernel or raises — there is no fallback. ``LAUNCHES`` counts the
kernel's launches (and nothing else). Forward only: the JAX package has no
backward kernel, and the rollout engine's prefill, its caller, runs
without gradients.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn import kernel
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: Optional[int]) -> int:
    """Validate what the kernel takes; returns the dtype code. Any strides
    over (batch, head, position) are taken, hd must be contiguous, and bf16
    rows must start on 16-byte boundaries, with no stride of 0 over a
    dimension longer than 1 (the kernel's TMA tensor maps). Any group size
    H / KV is taken."""
    tensors = (q, k, v)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention: all operands on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; need one of {list(_DTYPE_CODES)}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if k.shape != (B, KV, S, hd) or KV == 0 or H % KV or S == 0:
        raise ValueError(f"flash attention: q {tuple(q.shape)} against k/v "
                         f"{tuple(k.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"flash attention: head_dim {hd} must be 64 or "
                         f"128")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash attention: head_dim must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
            for t in tensors):
        raise ValueError("flash attention: bf16 rows must be 16-byte "
                         "aligned (pointers and strides)")
    if q.dtype == torch.bfloat16 and any(
            n > 1 and st == 0 for t in tensors
            for n, st in zip(t.shape[:3], t.stride()[:3])):
        raise ValueError("flash attention: bf16 operands cannot broadcast "
                         "(a stride of 0): the kernel's TMA maps need "
                         "distinct rows")
    if window is not None and window < 1:
        raise ValueError(f"flash attention: window {window} < 1")
    return _DTYPE_CODES[q.dtype]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention: q [B,H,S,hd], k/v [B,KV,S,hd] -> [B,H,S,hd]
    in q's dtype, position i attending positions j <= i (and i - j <
    ``window``). On the card the output has q's memory layout: a
    transposed view of [B,S,H,hd] activations gives one back, with no
    copy on either side."""
    global LAUNCHES
    if q.device.type in ("cpu", "meta"):  # meta: the dry-run's shapes
        return flash_attention_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {q.device}")
    code = check_inputs(q, k, v, window)
    B, H, S, hd = q.shape
    out = torch.empty_like(q)
    err = kernel.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], B, S, H, k.shape[1], hd, window or 0, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err}")
    LAUNCHES += 1
    return out
