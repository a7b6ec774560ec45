"""ctypes binding of the CUDA dense-cache decode attention kernel
(``csrc/decode_attn.cu``), the Hopper counterpart of
``repro.kernels.decode_attn.kernel.decode_attention_pallas``.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def fn():
    """decode_attention(q, k_cache, v_cache, lengths, out, B, H, KV, L, hd,
    dtype, stream) -> cudaError_t."""
    f = _build.load("decode_attn").decode_attention
    f.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    f.restype = _I
    return f
