"""ctypes binding of the CUDA fused A-3PO loss kernels
(``csrc/a3po_loss.cu``), the Hopper counterpart of
``repro.kernels.a3po_loss.kernel.a3po_loss_pallas`` and of the analytic
backward in ``repro.kernels.a3po_loss.ops``.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def forward_fn():
    """a3po_loss_forward(logp, behav, alpha, adv, mask, loss, clip, iw,
    ratio, T, clip_lo, clip_hi, iw_cap, stream) -> cudaError_t."""
    fn = _build.load("a3po_loss").a3po_loss_forward
    fn.argtypes = [_P] * 9 + [_I, _F, _F, _F, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def backward_fn():
    """a3po_loss_backward(g, clip, iw, ratio, adv, mask, g_logp, T,
    stream) -> cudaError_t."""
    fn = _build.load("a3po_loss").a3po_loss_backward
    fn.argtypes = [_P] * 7 + [_I, _P]
    fn.restype = _I
    return fn
