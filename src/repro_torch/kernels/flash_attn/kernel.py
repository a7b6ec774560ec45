"""ctypes binding of the CUDA flash attention forward kernel
(``csrc/flash_attn.cu``), the Hopper counterpart of
``repro.kernels.flash_attn.kernel.flash_attention_pallas``.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def fn():
    """flash_attention_forward(q, k, v, out, 12 strides (batch, head,
    position of q, k, v, out), B, S, H, KV, hd, window, dtype, stream) ->
    cudaError_t."""
    f = _build.load("flash_attn").flash_attention_forward
    f.argtypes = [_P] * 4 + [_L] * 12 + [_I] * 7 + [_P]
    f.restype = _I
    return f
