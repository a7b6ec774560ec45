"""ctypes binding of the CUDA fused A-3PO loss kernels
(``csrc/a3po_loss.cu``), the Hopper counterpart of
``repro.kernels.a3po_loss.kernel.a3po_loss_pallas`` and of the analytic
backward in ``repro.kernels.a3po_loss.ops``: the reduced objective of a
minibatch (forward and backward) and the per-token kernels.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

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


# Tokens a block of the reduced forward takes before the plan adds one:
# up to this many (the training step's minibatch) run in one block, which
# skips the merge of partials; larger T fills up to two blocks an SM.
REDUCED_TOKENS_PER_BLOCK = 4096
# the reduced forward's block and the tokens a thread loads a pass
# (kRedThreads, kUnroll in csrc/a3po_loss.cu)
REDUCED_THREADS, REDUCED_UNROLL = 512, 4


def reduced_blocks(T: int, n_sm: int) -> int:
    """The reduced forward's grid: from T and the SM count only, so the
    reduction order, and with it every bit of the result, is the same on
    every launch on one card."""
    return max(1, min(-(-T // REDUCED_TOKENS_PER_BLOCK), 2 * n_sm))


@functools.lru_cache(maxsize=None)
def reduced_layout():
    """(floats of scratch a block writes, length of the metric vector),
    from the library."""
    lib = _build.load("a3po_loss")
    for name in ("a3po_reduced_partials", "a3po_reduced_slots"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I
    return lib.a3po_reduced_partials(), lib.a3po_reduced_slots()


@functools.lru_cache(maxsize=None)
def reduced_forward_fn():
    """a3po_reduced_forward(logp, behav, alpha, adv, mask, entropy or None,
    coef, loss, metrics, partials, counter, T, blocks, clip_lo, clip_hi,
    iw_cap, kl_coef, entropy_coef, stream) -> cudaError_t."""
    fn = _build.load("a3po_loss").a3po_reduced_forward
    fn.argtypes = [_P] * 11 + [_I, _I] + [_F] * 5 + [_P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def reduced_backward_fn():
    """a3po_reduced_backward(g, metrics, coef, mask, g_logp, g_ent or None,
    T, kl_coef, entropy_coef, stream) -> cudaError_t."""
    fn = _build.load("a3po_loss").a3po_reduced_backward
    fn.argtypes = [_P] * 6 + [_I, _F, _F, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def empty_launch_fn():
    """a3po_empty_launch(stream) -> cudaError_t: an empty kernel, the
    launch floor."""
    fn = _build.load("a3po_loss").a3po_empty_launch
    fn.argtypes = [_P]
    fn.restype = _I
    return fn


def reduced_walk(T: int, blocks: int):
    """Which block of the reduced forward takes each token, and in which
    of its passes (a mirror of the kernel's loop: 512 threads a block,
    4 tokens a thread a pass, one grid-wide stride between them).
    Returns two int64 tensors [T]: (block, pass)."""
    i = torch.arange(T, dtype=torch.int64)
    stride = blocks * REDUCED_THREADS
    return (i % stride) // REDUCED_THREADS, i // (REDUCED_UNROLL * stride)
