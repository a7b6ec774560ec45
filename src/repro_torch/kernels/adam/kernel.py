"""ctypes binding of the CUDA Adam kernels (``csrc/adam.cu``): the clip's
global norm over every gradient and the one-pass update of every leaf.
They replace no Pallas kernel: the JAX package leaves its optimizer to
XLA's fusion, which eager PyTorch does not have.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def max_leaves() -> int:
    """Leaves one launch takes (the argument table's length); more take
    another launch of each kernel."""
    fn = _build.load("adam").adam_max_leaves
    fn.argtypes, fn.restype = [], _I
    return fn()


@functools.lru_cache(maxsize=None)
def norm_blocks(n_sm: int) -> int:
    """Blocks of one norm launch on a card of ``n_sm`` SMs: one partial
    each."""
    fn = _build.load("adam").adam_norm_blocks
    fn.argtypes, fn.restype = [_I], _I
    return fn(n_sm)


@functools.lru_cache(maxsize=None)
def norm_fn():
    """adam_global_norm(g[], n[], is_bf16[], n_leaves, blocks, root,
    partials, out, stream) -> cudaError_t (root 0: the sum of squares)."""
    fn = _build.load("adam").adam_global_norm
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def update_fn():
    """adam_update(p[], out[], g[], m[], v[], n[], is_bf16[], g_is_bf16[],
    n_leaves, gnorm, t, apply or None, lr, b1, 1 - b1, b2, 1 - b2, eps,
    lr * wd, decay, max_norm, tiny, stream) -> cudaError_t."""
    fn = _build.load("adam").adam_update
    fn.argtypes = [_P] * 8 + [_I, _P, _P, _P] + [_F] * 7 + [_I, _F, _F, _P]
    fn.restype = _I
    return fn
