"""Dispatch + autodiff wrappers for the fused A-3PO loss
(``repro.kernels.a3po_loss.ops``).

``a3po_objective_reduced`` is the training-path entry point: a
``torch.autograd.Function`` over a minibatch whose forward runs the
reduced kernel (the token pass and every masked reduction of the loss and
its metrics in one launch) and whose backward is the analytic gradient,
also one launch. ``a3po_objective`` is the per-token ``Function`` of the
Pallas kernel's own function (per-token loss, clip, iw, ratio) with its
elementwise backward. Each direction dispatches by device: a CUDA tensor
takes the CUDA kernel (or raises; there is no fallback), a CPU tensor the
plain version in ``ref.py``, so the CPU tests exercise the same
``Function`` and the same backward formula. ``use_kernel=False`` selects
the plain version on any device (a check; the training path never passes
it).

``LAUNCHES`` counts the kernels' launches by direction (the reduced and
the per-token kernels together), and nothing else.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.a3po_loss import kernel
from repro_torch.kernels.a3po_loss.ref import (
    REDUCED_KEYS,
    a3po_loss_bwd_ref,
    a3po_loss_ref,
    a3po_reduced_bwd_ref,
    a3po_reduced_ref,
)

LAUNCHES = {"forward": 0, "backward": 0}
DENOM = REDUCED_KEYS.index("denom")
# the reduced forward's completion counter, one per (device, stream): the
# last block to finish resets it to 0, so it is zeroed once
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


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


def _counter(t: torch.Tensor, stream: int) -> torch.Tensor:
    key = (t.device.index, stream)
    c = _COUNTERS.get(key)
    if c is None:
        c = _COUNTERS[key] = torch.zeros(1, dtype=torch.int32,
                                         device=t.device)
    return c


def _reduced_forward_kernel(logp, behav, alpha, adv, mask, entropy, *,
                            clip_eps, iw_cap, kl_coef, entropy_coef,
                            blocks=None):
    """(loss 0-d, metrics [len(REDUCED_KEYS)], coef [T]) in one launch.
    ``blocks`` overrides the plan's grid (a measurement; the path never
    passes it)."""
    ops = (logp, behav, alpha, adv, mask) + (
        () if entropy is None else (entropy,))
    _check("a3po_loss", *ops)
    T = logp.numel()
    if blocks is None:
        blocks = kernel.reduced_blocks(
            T, torch.cuda.get_device_properties(logp.device)
            .multi_processor_count)
    n_partials, n_slots = kernel.reduced_layout()
    if n_slots != len(REDUCED_KEYS):
        raise RuntimeError(f"a3po_loss: the library writes {n_slots} "
                           f"metrics, REDUCED_KEYS has {len(REDUCED_KEYS)}")
    stream = _stream(logp)
    loss = torch.empty((), dtype=torch.float32, device=logp.device)
    metrics = torch.empty(len(REDUCED_KEYS), dtype=torch.float32,
                          device=logp.device)
    coef = torch.empty_like(logp)
    partials = torch.empty(blocks * n_partials, dtype=torch.float32,
                           device=logp.device)
    err = kernel.reduced_forward_fn()(
        *(x.data_ptr() for x in ops[:5]),
        None if entropy is None else entropy.data_ptr(), coef.data_ptr(),
        loss.data_ptr(), metrics.data_ptr(), partials.data_ptr(),
        _counter(logp, stream).data_ptr(), T, blocks, 1.0 - clip_eps,
        1.0 + clip_eps, iw_cap, kl_coef, entropy_coef, stream)
    if err != 0:
        raise RuntimeError(f"a3po_reduced_forward: CUDA error {err}")
    LAUNCHES["forward"] += 1
    return loss, metrics, coef


def _reduced_backward_kernel(g, metrics, coef, mask, *, kl_coef,
                             entropy_coef, with_entropy):
    """(d logp [T], d entropy [T] or None) in one launch; ``g`` and the
    denominator are read on the device."""
    _check("a3po_loss_bwd", coef, mask)
    if g.numel() != 1 or g.dtype != torch.float32 \
            or g.device != coef.device:
        raise ValueError(f"a3po_loss_bwd: the cotangent must be one float32 "
                         f"on {coef.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    g_logp = torch.empty_like(coef)
    g_ent = (torch.empty_like(coef) if with_entropy and entropy_coef
             else None)
    err = kernel.reduced_backward_fn()(
        g.data_ptr(), metrics.data_ptr(), coef.data_ptr(), mask.data_ptr(),
        g_logp.data_ptr(), None if g_ent is None else g_ent.data_ptr(),
        coef.numel(), kl_coef, entropy_coef, _stream(coef))
    if err != 0:
        raise RuntimeError(f"a3po_reduced_backward: CUDA error {err}")
    LAUNCHES["backward"] += 1
    return g_logp, g_ent


# devices that take the plain version: the CPU, and meta (the dry-run
# traces shapes only)
_PLAIN = ("cpu", "meta")


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.detach().float().reshape(-1).contiguous()


def _run_forward(logp, behav, alpha, adv, mask, clip_eps, iw_cap,
                 use_kernel):
    args = tuple(_flat(x) for x in (logp, behav, alpha, adv, mask))
    if use_kernel and logp.device.type not in _PLAIN:
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
        if ctx.use_kernel and g.device.type not in _PLAIN:
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


class _A3POObjectiveReduced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logp, behav, alpha, adv, mask, entropy, clip_eps,
                iw_cap, kl_coef, entropy_coef, use_kernel):
        ctx.set_materialize_grads(False)
        kw = dict(clip_eps=clip_eps, iw_cap=iw_cap, kl_coef=kl_coef,
                  entropy_coef=entropy_coef)
        if use_kernel and logp.device.type not in _PLAIN:
            ent = None if entropy is None else _flat(entropy)
            loss, metrics, coef = _reduced_forward_kernel(
                *(_flat(x) for x in (logp, behav, alpha, adv, mask)), ent,
                **kw)
        else:
            loss, metrics, coef = a3po_reduced_ref(
                logp, behav, alpha, adv, mask, entropy, **kw)
        ctx.save_for_backward(metrics, coef, _flat(mask))
        ctx.kw = dict(kl_coef=kl_coef, entropy_coef=entropy_coef,
                      with_entropy=entropy is not None)
        ctx.use_kernel = use_kernel
        ctx.shapes = logp.shape, None if entropy is None else entropy.shape
        ctx.mark_non_differentiable(metrics)
        return loss, metrics

    @staticmethod
    def backward(ctx, g, _unused):
        grads = [None] * 11
        if g is None:
            return tuple(grads)
        metrics, coef, mask = ctx.saved_tensors
        kw = dict(ctx.kw)
        kw["with_entropy"] &= ctx.needs_input_grad[5]
        if ctx.use_kernel and coef.device.type not in _PLAIN:
            g_logp, g_ent = _reduced_backward_kernel(
                g.detach().float().reshape(1), metrics, coef, mask, **kw)
        else:
            g_logp, g_ent = a3po_reduced_bwd_ref(g, metrics[DENOM], coef,
                                                 mask, **kw)
        grads[0] = g_logp.reshape(ctx.shapes[0])
        if g_ent is not None:
            grads[5] = g_ent.reshape(ctx.shapes[1])
        return tuple(grads)


def a3po_objective_reduced(logp: torch.Tensor, behav_logp: torch.Tensor,
                           alpha: torch.Tensor, adv: torch.Tensor,
                           mask: torch.Tensor,
                           entropy: Optional[torch.Tensor] = None, *,
                           clip_eps: float = 0.2, iw_cap: float = 5.0,
                           kl_coef: float = 0.0, entropy_coef: float = 0.0,
                           use_kernel: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable A-3PO objective of a minibatch: ``(loss, metrics)``.

    All operands share one shape (alpha broadcast already), float32.
    ``loss`` (0-d) is the masked-mean clipped surrogate plus ``kl_coef``
    x the k1 KL to the log-linear anchor minus ``entropy_coef`` x the
    masked-mean entropy; it carries the gradient w.r.t. ``logp`` and
    ``entropy``. ``metrics`` is the vector of ``REDUCED_KEYS``, not
    differentiable.
    """
    return _A3POObjectiveReduced.apply(
        logp, behav_logp, alpha, adv, mask, entropy, float(clip_eps),
        float(iw_cap), float(kl_coef), float(entropy_coef),
        bool(use_kernel))
