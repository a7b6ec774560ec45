"""Dispatch + autodiff wrapper for the fused token logprob + entropy
(``repro.kernels.logprob.ops``).

``token_logprob_entropy`` is a ``torch.autograd.Function``. On a CUDA
tensor both directions are CUDA kernels, chosen by dtype and alignment
(``takes_wgmma``): bf16 operands whose rows are 16-byte aligned take the
TMA + wgmma kernels, any others the first design (wmma or float32 FMAs).

The forward never writes the [T, V] logits to device memory. The backward
recomputes them tile by tile for a chunk of ``CHUNK`` tokens and writes
their cotangent dl; ``dh = dl @ w^T`` and ``dw = h^T @ dl`` then go to
library products, as the reference leaves its gradient products to XLA.
On the wgmma route dl is a bf16 high part and a bf16 remainder (~16 bits,
the float32 value to a relative 2^-16; ``ref.split_hi_lo`` is its plain
version) and the products run on the tensor cores in bf16 with float32
accumulation over both parts (``torch.mm(..., out_dtype=torch.float32)``);
no operand is copied to float32. Its bound at the training step's shape (T
2300, d 1536, V 151,936) is three products of 2 T d V flops (the logit
recompute, dh, dw) at the card's bf16 rate, 3.26 ms; the parts make dh's
and dw's products twice as long as that, so the route does 5/3 of the
bound's work. The first design writes a float32 dl and runs float32
products (its operands copied to float32).

On a CPU tensor both directions take the plain version in ``ref.py``
(``use_kernel=False`` selects it on any device, as a check). There is no
fallback from a CUDA tensor to the plain version.

``LAUNCHES`` counts kernel launches by direction (the backward launches
once per token chunk), and nothing else; ``"forward_wgmma"`` and
``"backward_wgmma"`` count the launches that took the wgmma kernels (they
count in ``"forward"`` and ``"backward"`` too).
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

LAUNCHES = {"forward": 0, "forward_wgmma": 0, "backward": 0,
            "backward_wgmma": 0}

# tokens per backward chunk: the [CHUNK, V] cotangent buffer (float32, or
# bf16 high parts and remainders) is 0.6 GB at V = 151,936
CHUNK = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _n_sm(t: torch.Tensor) -> int:
    dev = t.device.index
    return sm_count(torch.cuda.current_device() if dev is None else dev)


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
        splits, per = kernel.wgmma_plan(T, V, _n_sm(hidden))
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
    """(dh in hidden's dtype or None, dw [d, V] in w's dtype or None), by
    token chunks of at most CHUNK: the bf16 operands the wgmma forward takes
    go to the wgmma cotangent kernel and bf16 tensor-core products, any
    others to the first design."""
    g_logp = None if g_logp is None else g_logp.float().contiguous()
    g_ent = None if g_ent is None else g_ent.float().contiguous()
    back = _backward_wgmma if takes_wgmma(hidden, w) else _backward_first
    return back(hidden, w, targets, logz, mu, g_logp, g_ent, need_dh,
                need_dw)


def _dlogits_launch(fn, hidden, w, targets, logz, mu, g_logp, g_ent, r0,
                    r1, dl, *sizes):
    """Launch a cotangent kernel on the token rows [r0, r1) into ``dl``;
    ``sizes``: the kernel's sizes, strides and plan."""
    err = fn(hidden[r0:r1].data_ptr(), w.data_ptr(),
             targets[r0:r1].data_ptr(), logz[r0:r1].data_ptr(),
             mu[r0:r1].data_ptr(),
             0 if g_logp is None else g_logp[r0:r1].data_ptr(),
             0 if g_ent is None else g_ent[r0:r1].data_ptr(), dl.data_ptr(),
             *sizes, _stream(hidden))
    if err != 0:
        raise RuntimeError(f"token_logprob_entropy_dlogits: CUDA error {err}")
    LAUNCHES["backward"] += 1


def dlogits_parts(hidden, w, targets, logz, mu, g_logp, g_ent, r0, r1,
                  buf=None):
    """The wgmma cotangent kernel on token rows [r0, r1) (n of them): dl as
    bf16 [2n, ldv], rows 0 .. n - 1 the high parts and n .. 2n - 1 the
    remainders, ldv = V rounded up to a multiple of 8 (columns past V
    unset). ``buf``: bf16 storage of at least 2 n ldv elements to use. The
    operands are those ``takes_wgmma`` accepts; the cotangents float32 or
    None (zero)."""
    n, d = r1 - r0, hidden.shape[1]
    V = w.shape[1]
    _, sk, sn, _ = check_inputs(hidden, w, targets)
    ldv = -(-V // 8) * 8
    if buf is None:
        buf = torch.empty(2 * n * ldv, dtype=torch.bfloat16,
                          device=hidden.device)
    dl = buf[: 2 * n * ldv].view(2 * n, ldv)
    splits, per = kernel.wgmma_plan(n, V, _n_sm(hidden))
    _dlogits_launch(kernel.dlogits_wgmma_fn(), hidden, w, targets, logz, mu,
                    g_logp, g_ent, r0, r1, dl, n, d, V, sk, sn, ldv, splits,
                    per)
    LAUNCHES["backward_wgmma"] += 1
    return dl


def _embedding_layout(w) -> bool:
    """Whether ``w`` [d, V] is the transpose of a contiguous [V, d] (the
    tied embedding's ``embed.T``). The backward then writes dw^T, so that
    the gradient reaches the embedding in its own layout: a transposed
    one would cost a strided pass wherever it is added or copied."""
    return w.stride(0) == 1 and w.stride(1) == w.shape[0]


def _backward_wgmma(hidden, w, targets, logz, mu, g_logp, g_ent,
                    need_dh, need_dw):
    """Each chunk's dl comes from ``dlogits_parts``; the products take both
    parts at once on the tensor cores, bf16 operands and float32
    accumulation and output: dh = (hi + lo) w^T is the sum of the two
    halves of one product's rows, and dw = h^T (hi + lo) = [h; h]^T [hi;
    lo] accumulates over the chunks in one float32 buffer (beta 0 on the
    first chunk, which reads none of it). One K = 2n product a chunk
    reads and writes that buffer once; a product per part would do it
    twice. No operand is copied to float32. dw is laid out as w
    (``_embedding_layout``)."""
    T, d = hidden.shape
    V = w.shape[1]
    dev = hidden.device
    f32 = torch.float32
    wt = _embedding_layout(w)
    buf = torch.empty(2 * min(CHUNK, T) * (-(-V // 8) * 8),
                      dtype=torch.bfloat16, device=dev)
    dh = torch.empty(T, d, dtype=hidden.dtype, device=dev) if need_dh \
        else None
    dw = torch.empty((V, d) if wt else (d, V), dtype=f32, device=dev) \
        if need_dw else None
    for r0 in range(0, T, CHUNK):
        r1 = min(r0 + CHUNK, T)
        n = r1 - r0
        parts = dlogits_parts(hidden, w, targets, logz, mu, g_logp, g_ent,
                              r0, r1, buf)[:, :V]
        if need_dh:
            p = torch.mm(parts, w.T, out_dtype=f32)
            dh[r0:r1] = p[:n] + p[n:]
        if need_dw:
            h2 = hidden[r0:r1].repeat(2, 1)
            a, b = (parts.T, h2) if wt else (h2.T, parts)
            torch.addmm(dw, a, b, out_dtype=f32, out=dw,
                        beta=0 if r0 == 0 else 1)
    if dw is None:
        return dh, None
    dw = dw.to(w.dtype)
    return dh, dw.T if wt else dw


def _backward_first(hidden, w, targets, logz, mu, g_logp, g_ent, need_dh,
                    need_dw):
    """The first design, for float32 operands and bf16 rows the tensor maps
    do not take: the wmma (or float32 FMA) kernel writes a chunk's float32
    dl, and float32 library products take it. dw is laid out as w
    (``_embedding_layout``)."""
    T, d = hidden.shape
    V = w.shape[1]
    w32 = w.float()
    h32 = hidden.float()
    f32 = dict(dtype=torch.float32, device=hidden.device)
    wt = _embedding_layout(w)
    dh = torch.empty(T, d, **f32) if need_dh else None
    dw = torch.zeros((V, d) if wt else (d, V), **f32) if need_dw else None
    buf = torch.empty(min(CHUNK, T), V, **f32)
    for r0 in range(0, T, CHUNK):
        r1 = min(r0 + CHUNK, T)
        code, sk, sn, vec = check_inputs(hidden[r0:r1], w, targets[r0:r1])
        dl = buf[: r1 - r0]
        _dlogits_launch(kernel.dlogits_fn(), hidden, w, targets, logz, mu,
                        g_logp, g_ent, r0, r1, dl, r1 - r0, d, V, sk, sn,
                        code, vec)
        if need_dh:
            torch.matmul(dl, w32.T, out=dh[r0:r1])
        if need_dw:
            h = h32[r0:r1]
            dw.addmm_(*((dl.T, h) if wt else (h.T, dl)))
    if dw is not None:
        dw = dw.to(w.dtype)
        dw = dw.T if wt else dw
    return None if dh is None else dh.to(hidden.dtype), dw


class _TokenLogprobEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, w, targets, use_kernel):
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        # meta tensors (the dry-run's shapes) take the plain version
        kern = use_kernel and hidden.device.type not in ("cpu", "meta")
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
