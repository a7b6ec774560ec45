"""ctypes binding of the CUDA SSD kernels (``csrc/ssd.cu``), the Hopper
counterparts of ``repro.kernels.ssd.kernel.ssd_decode_step_pallas`` and
``ssd_intra_chunk_pallas``.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# what the intra-chunk kernel takes (csrc/ssd.cu): heads per block, the
# longest chunk, and the head and state widths it is instantiated for
HEADS_PER_BLOCK = 4
MAX_CHUNK = 256
HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def decode_fn():
    """ssd_decode_step(state, x, dt, a_log, b, c, update, new_state, y, B,
    nh, hd, ds, sxb, sbb, scb, dtype, alog_dtype, stream) -> cudaError_t;
    ``update`` may be null."""
    f = _build.load("ssd").ssd_decode_step
    f.argtypes = [_P] * 9 + [_I] * 4 + [_L] * 3 + [_I] * 2 + [_P]
    f.restype = _I
    return f


@functools.lru_cache(maxsize=None)
def intra_chunk_fn():
    """ssd_intra_chunk(xdt, la, b, c, y, s_local, cdec, B, S, nh, hd, ds,
    chunk, sb_b, sb_s, sc_b, sc_s, dtype, stream) -> cudaError_t."""
    f = _build.load("ssd").ssd_intra_chunk
    f.argtypes = [_P] * 7 + [_I] * 6 + [_L] * 4 + [_I] + [_P]
    f.restype = _I
    return f
