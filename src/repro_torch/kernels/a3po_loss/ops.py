"""Dispatch + autodiff wrappers for the fused A-3PO loss
(``repro.kernels.a3po_loss.ops``).

``a3po_objective`` is the training-path entry point: a
``torch.autograd.Function`` whose forward runs the fused kernel and whose
backward is the analytic elementwise gradient of the clipped surrogate,
also a kernel. Each direction dispatches by device: a CUDA tensor takes the
CUDA kernel (or raises; there is no fallback), a CPU tensor the plain
version in ``ref.py``, so the CPU tests exercise the same ``Function`` and
the same backward formula. ``use_kernel=False`` selects the plain version
on any device (a check; the training path never passes it).

``LAUNCHES`` counts the kernels' launches by direction, and nothing else.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.a3po_loss import kernel
from repro_torch.kernels.a3po_loss.ref import a3po_loss_bwd_ref, a3po_loss_ref

LAUNCHES = {"forward": 0, "backward": 0}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    n = tensors[0].numel()
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.numel() != n:
            raise ValueError(
                f"{name}: operands must be contiguous float32 of one size on "
                f"one device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} tokens exceed int32 indexing")


def _forward_kernel(logp, behav, alpha, adv, mask, clip_eps, iw_cap):
    _check("a3po_loss", logp, behav, alpha, adv, mask)
    outs = [torch.empty_like(logp) for _ in range(4)]
    err = kernel.forward_fn()(
        logp.data_ptr(), behav.data_ptr(), alpha.data_ptr(), adv.data_ptr(),
        mask.data_ptr(), *(o.data_ptr() for o in outs), logp.numel(),
        1.0 - clip_eps, 1.0 + clip_eps, iw_cap, _stream(logp))
    if err != 0:
        raise RuntimeError(f"a3po_loss_forward: CUDA error {err}")
    LAUNCHES["forward"] += 1
    return tuple(outs)


def _backward_kernel(g, clip_tok, iw, ratio, adv, mask):
    _check("a3po_loss_bwd", g, clip_tok, iw, ratio, adv, mask)
    out = torch.empty_like(g)
    err = kernel.backward_fn()(
        g.data_ptr(), clip_tok.data_ptr(), iw.data_ptr(), ratio.data_ptr(),
        adv.data_ptr(), mask.data_ptr(), out.data_ptr(), g.numel(),
        _stream(g))
    if err != 0:
        raise RuntimeError(f"a3po_loss_backward: CUDA error {err}")
    LAUNCHES["backward"] += 1
    return out


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.detach().float().reshape(-1).contiguous()


def _run_forward(logp, behav, alpha, adv, mask, clip_eps, iw_cap,
                 use_kernel):
    args = tuple(_flat(x) for x in (logp, behav, alpha, adv, mask))
    if use_kernel and logp.device.type != "cpu":
        return _forward_kernel(*args, clip_eps, iw_cap)
    return a3po_loss_ref(*args, clip_eps=clip_eps, iw_cap=iw_cap)


class _A3POObjective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logp, behav, alpha, adv, mask, clip_eps, iw_cap,
                use_kernel):
        outs = _run_forward(logp, behav, alpha, adv, mask, clip_eps, iw_cap,
                            use_kernel)
        _, clip_tok, iw, ratio = outs
        ctx.save_for_backward(clip_tok, iw, ratio, _flat(adv), _flat(mask))
        ctx.use_kernel = use_kernel
        ctx.shape = logp.shape
        outs = tuple(o.reshape(logp.shape) for o in outs)
        ctx.mark_non_differentiable(*outs[1:])
        return outs

    @staticmethod
    def backward(ctx, g_loss, *_unused):
        # cotangents of the metric outputs and the data operands are zero
        # by construction (they are detached downstream)
        clip_tok, iw, ratio, adv, mask = ctx.saved_tensors
        g = _flat(g_loss)
        if ctx.use_kernel and g.device.type != "cpu":
            g_logp = _backward_kernel(g, clip_tok, iw, ratio, adv, mask)
        else:
            g_logp = a3po_loss_bwd_ref(g, clip_tok, iw, ratio, adv, mask)
        return (g_logp.reshape(ctx.shape),) + (None,) * 7


def a3po_objective(logp: torch.Tensor, behav_logp: torch.Tensor,
                   alpha: torch.Tensor, adv: torch.Tensor, mask: torch.Tensor,
                   *, clip_eps: float = 0.2, iw_cap: float = 5.0,
                   use_kernel: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Differentiable fused A-3PO objective over [B, T] (or [T]) tensors.

    Returns per-token ``(loss_tok, clip_tok, iw, ratio)``; ``loss_tok`` is
    the negated, masked clipped surrogate and carries the analytic gradient
    w.r.t. ``logp``; the metric outputs are not differentiable. All float32.
    """
    return _A3POObjective.apply(logp, behav_logp, alpha, adv, mask,
                                float(clip_eps), float(iw_cap),
                                bool(use_kernel))


def a3po_loss_fused(logp: torch.Tensor, behav_logp: torch.Tensor,
                    alpha: torch.Tensor, adv: torch.Tensor,
                    mask: torch.Tensor, *, clip_eps: float = 0.2,
                    iw_cap: float = 5.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Forward only: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    outs = _run_forward(logp, behav_logp, alpha, adv, mask, float(clip_eps),
                        float(iw_cap), True)
    return tuple(o.reshape(logp.shape) for o in outs)
