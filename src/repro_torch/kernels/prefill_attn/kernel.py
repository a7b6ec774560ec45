"""ctypes binding of the CUDA chunked paged prefill attention kernel
(``csrc/paged_prefill_attn.cu``), the Hopper counterpart of
``repro.kernels.prefill_attn.kernel.paged_prefill_attention_pallas``.

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


def rows_per_block(group: int) -> int:
    """Chunk rows per thread block for ``group`` = H / KV query heads."""
    return max(1, MAX_QUERY_VECTORS // group)


@functools.lru_cache(maxsize=None)
def fn():
    """The C entry point, argument types declared."""
    lib = _build.load("paged_prefill_attn")
    fn = lib.paged_prefill_attention
    # q, pool_k, pool_v, tables, seg_ids, q_pos, out, C, H, KV, hd, bs, mb,
    # rows_per_block, dtype, stream
    fn.argtypes = [_P] * 7 + [_I] * 8 + [_P]
    fn.restype = _I
    return fn
