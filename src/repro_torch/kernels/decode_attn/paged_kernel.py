"""ctypes binding of the CUDA paged decode attention kernel
(``csrc/paged_decode_attn.cu``), the Hopper counterpart of
``repro.kernels.decode_attn.paged_kernel.paged_decode_attention_pallas``.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int

# query vectors (rows x query heads of one KV head) one thread block serves:
# kMaxQ in csrc/paged_attn_common.cuh
MAX_QUERY_VECTORS = 32


@functools.lru_cache(maxsize=None)
def fn():
    """The C entry point, argument types declared."""
    lib = _build.load("paged_decode_attn")
    fn = lib.paged_decode_attention
    # q, pool_k, pool_v, tables, lengths, out, S, H, KV, hd, bs, mb, dtype,
    # stream
    fn.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    fn.restype = _I
    return fn
