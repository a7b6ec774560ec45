"""Dispatch + autodiff wrapper for the fused token logprob + entropy
(``repro.kernels.logprob.ops``).

``token_logprob_entropy`` is a ``torch.autograd.Function``. On a CUDA
tensor its forward is a CUDA kernel (the [T, V] logits never reach device
memory), chosen by dtype and alignment: bf16 operands whose rows are
16-byte aligned take the TMA + wgmma kernel, any others the first design
(wmma or float32 FMAs). Its backward recomputes the logits tile by tile in
a second kernel that writes the float32 logit cotangent for a chunk of
``CHUNK`` tokens; ``dh = dl @ w^T`` and ``dw += h^T @ dl`` then go to
float32 ``torch.matmul``, as the reference leaves its gradient products to
XLA.
On a CPU tensor both directions take the plain version in ``ref.py``
(``use_kernel=False`` selects it on any device, as a check). There is no
fallback from a CUDA tensor to the plain version.

``LAUNCHES`` counts kernel launches by direction (the backward launches
once per token chunk), and nothing else; ``"forward_wgmma"`` counts the
forward launches that took the wgmma kernel (they count in ``"forward"``
too).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.decode_attn.paged_kernel import sm_count
from repro_torch.kernels.logprob import kernel
from repro_torch.kernels.logprob.ref import (
    token_logprob_entropy_bwd_ref,
    token_logprob_entropy_stats_ref,
)

LAUNCHES = {"forward": 0, "forward_wgmma": 0, "backward": 0}

# tokens per backward chunk: the float32 [CHUNK, V] cotangent buffer is
# 0.6 GB at V = 151,936
CHUNK = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_inputs(hidden: torch.Tensor, w: torch.Tensor,
                 targets: torch.Tensor):
    """Validate what the kernels take; returns (dtype code, sk, sn, vec),
    vec = 1 where the first design's 16-byte loads apply."""
    if hidden.dim() != 2 or w.dim() != 2 or targets.dim() != 1 \
            or w.shape[0] != hidden.shape[1] \
            or targets.shape[0] != hidden.shape[0]:
        raise ValueError(f"token_logprob_entropy: shapes hidden "
                         f"{tuple(hidden.shape)}, w {tuple(w.shape)}, "
                         f"targets {tuple(targets.shape)}")
    if hidden.device != w.device or targets.device != hidden.device:
        raise ValueError("token_logprob_entropy: operands on one device")
    if hidden.dtype not in _DTYPE_CODES or w.dtype != hidden.dtype:
        raise ValueError(f"token_logprob_entropy: dtypes {hidden.dtype}, "
                         f"{w.dtype}; need one of {list(_DTYPE_CODES)}")
    if targets.dtype != torch.int32 or not targets.is_contiguous() \
            or not hidden.is_contiguous():
        raise ValueError("token_logprob_entropy: contiguous hidden and "
                         "int32 targets")
    sk, sn = w.stride()
    if sk != 1 and sn != 1:
        raise ValueError(f"token_logprob_entropy: w strides {w.stride()}; "
                         "one of them must be 1")
    d = hidden.shape[1]
    vec = (hidden.dtype == torch.bfloat16 and sk == 1 and d % 8 == 0
           and hidden.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    return _DTYPE_CODES[hidden.dtype], sk, sn, int(vec)


def takes_wgmma(hidden: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the forward takes the TMA + wgmma kernel: bf16 operands whose
    rows start on 16-byte boundaries (d and w's other stride multiples of
    8, both pointers 16-byte aligned), as its tensor maps need. The
    operands are checked by ``check_inputs`` first."""
    sk, sn = w.stride()
    return (hidden.dtype == torch.bfloat16 and hidden.shape[1] % 8 == 0
            and (sn if sk == 1 else sk) % 8 == 0
            and hidden.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def _forward_kernel(hidden, w, targets):
    code, sk, sn, vec = check_inputs(hidden, w, targets)
    T, d = hidden.shape
    V = w.shape[1]
    wgmma = takes_wgmma(hidden, w)
    if wgmma:
        dev = hidden.device.index
        splits, per = kernel.wgmma_plan(T, V, sm_count(
            torch.cuda.current_device() if dev is None else dev))
    else:
        splits, per = kernel.split_plan(T, V)
    f32 = dict(dtype=torch.float32, device=hidden.device)
    part = torch.empty(4, splits, T, **f32)
    logp, ent, logz, mu = (torch.empty(T, **f32) for _ in range(4))
    ptrs = (hidden.data_ptr(), w.data_ptr(), targets.data_ptr(),
            part.data_ptr(), logp.data_ptr(), ent.data_ptr(), logz.data_ptr(),
            mu.data_ptr())
    if wgmma:
        err = kernel.forward_wgmma_fn()(*ptrs, T, d, V, sk, sn, splits, per,
                                        _stream(hidden))
    else:
        err = kernel.forward_fn()(*ptrs, T, d, V, sk, sn, splits, per, code,
                                  vec, _stream(hidden))
    if err != 0:
        raise RuntimeError(f"token_logprob_entropy_forward: CUDA error {err}")
    LAUNCHES["forward"] += 1
    LAUNCHES["forward_wgmma"] += int(wgmma)
    return logp, ent, logz, mu


def _backward_kernel(hidden, w, targets, logz, mu, g_logp, g_ent,
                     need_dh: bool, need_dw: bool):
    T, d = hidden.shape
    V = w.shape[1]
    w32 = w.float()
    h32 = hidden.float()
    f32 = dict(dtype=torch.float32, device=hidden.device)
    dh = torch.empty(T, d, **f32) if need_dh else None
    dw = torch.zeros(d, V, **f32) if need_dw else None
    buf = torch.empty(min(CHUNK, T), V, **f32)
    g_logp = None if g_logp is None else g_logp.float().contiguous()
    g_ent = None if g_ent is None else g_ent.float().contiguous()
    for r0 in range(0, T, CHUNK):
        r1 = min(r0 + CHUNK, T)
        h_c = hidden[r0:r1]
        code, sk, sn, vec = check_inputs(h_c, w, targets[r0:r1])
        dl = buf[: r1 - r0]
        err = kernel.dlogits_fn()(
            h_c.data_ptr(), w.data_ptr(), targets[r0:r1].data_ptr(),
            logz[r0:r1].data_ptr(), mu[r0:r1].data_ptr(),
            0 if g_logp is None else g_logp[r0:r1].data_ptr(),
            0 if g_ent is None else g_ent[r0:r1].data_ptr(),
            dl.data_ptr(), r1 - r0, d, V, sk, sn, code, vec,
            _stream(hidden))
        if err != 0:
            raise RuntimeError(
                f"token_logprob_entropy_dlogits: CUDA error {err}")
        LAUNCHES["backward"] += 1
        if need_dh:
            torch.matmul(dl, w32.T, out=dh[r0:r1])
        if need_dw:
            dw.addmm_(h32[r0:r1].T, dl)
    return (None if dh is None else dh.to(hidden.dtype),
            None if dw is None else dw.to(w.dtype))


class _TokenLogprobEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, w, targets, use_kernel):
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        kern = use_kernel and hidden.device.type != "cpu"
        if kern:
            logp, ent, logz, mu = _forward_kernel(hidden, w, targets)
        else:
            logp, ent, logz, mu = token_logprob_entropy_stats_ref(
                hidden, w, targets)
        ctx.kern = kern
        ctx.save_for_backward(hidden, w, targets, logz, mu)
        return logp, ent

    @staticmethod
    def backward(ctx, g_logp, g_ent):
        hidden, w, targets, logz, mu = ctx.saved_tensors
        need_dh, need_dw = ctx.needs_input_grad[:2]
        if (g_logp is None and g_ent is None) or not (need_dh or need_dw):
            return None, None, None, None
        if ctx.kern:
            dh, dw = _backward_kernel(hidden, w, targets, logz, mu, g_logp,
                                      g_ent, need_dh, need_dw)
        else:
            dh, dw = token_logprob_entropy_bwd_ref(hidden, w, targets, logz,
                                                   mu, g_logp, g_ent)
        return (dh if need_dh else None, dw if need_dw else None, None,
                None)


def token_logprob_entropy(hidden: torch.Tensor, w: torch.Tensor,
                          targets: torch.Tensor, *, use_kernel: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [..., d], w [d, V], targets [...] -> (logp, entropy) [...],
    float32, differentiable w.r.t. ``hidden`` and ``w``. ``w`` may be a
    transposed view (the tied embedding's ``embed.T``): it is read through
    its strides, never copied."""
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1]).contiguous()
    t2 = targets.reshape(-1).to(torch.int32).contiguous()
    logp, ent = _TokenLogprobEntropy.apply(h2, w, t2, bool(use_kernel))
    return logp.reshape(lead), ent.reshape(lead)
