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

# what the intra-chunk kernels take (csrc/ssd.cu): the longest chunk, the
# head and state widths they are instantiated for, and heads per block by
# dtype code (float32: the FMA kernel's 4; bf16: the mma kernel's 1)
MAX_CHUNK = 256
HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 32, 64, 128)
HEADS_PER_BLOCK = {0: 4, 1: 1}


@functools.lru_cache(maxsize=None)
def _plan_fns():
    lib = _build.load("ssd")
    intra, decode = lib.ssd_intra_chunk_plan, lib.ssd_decode_plan
    intra.argtypes = [_I] * 7 + [_P]
    decode.argtypes = [_I] * 4 + [_P]
    intra.restype = decode.restype = _I
    return intra, decode


@functools.lru_cache(maxsize=None)
def intra_plan(code: int, B: int, S: int, L: int, nh: int, hd: int,
               ds: int) -> dict:
    """The launch plan of the intra-chunk kernel for b/c of dtype ``code``
    (0 float32, 1 bf16) at [B, S] rows in chunks of ``L``, ``nh`` heads of
    ``hd``, d_state ``ds``, as csrc/ssd.cu computes and launches it
    (``ssd_intra_chunk_plan``; its library is built on first call).

    bf16 (``route`` "mma"): ``blocks`` blocks of ``threads``, one per
    (chunk, head, slot); slots 0 .. y_tiles - 1 are y tiles of ``y_rows``
    rows walked in stages of ``key_stage`` keys, the last tile first, and
    the s_blocks slots that follow take ``s_cols`` columns of d_state each,
    ``warp_s_cols`` a warp. Block k is slot k // P of (chunk, head) pair
    k % P, P = B * nc * nh. float32 (``route`` "fma"): y_tiles row tiles
    and s_blocks state tiles of ``s_rows`` rows of hd for each (4 heads,
    chunk).
    """
    out = (ctypes.c_int * 8)()
    if _plan_fns()[0](code, B, S, nh, hd, ds, L, out) != 0:
        raise ValueError(f"ssd_intra_chunk: no plan for dtype code {code}, "
                         f"B {B}, S {S}, chunk {L}, nh {nh}, hd {hd}, "
                         f"ds {ds}")
    threads, blocks, n_y, n_s, y_rows, key_stage, s_w, warp_s = out
    plan = {"threads": threads, "blocks": blocks, "y_tiles": n_y,
            "s_blocks": n_s, "y_rows": y_rows, "key_stage": key_stage}
    if code == 1:
        return {"route": "mma", **plan, "s_cols": s_w, "warp_s_cols": warp_s}
    return {"route": "fma", **plan, "s_rows": s_w}


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, nh: int, hd: int, ds: int) -> dict:
    """The decode kernel's launch plan, as csrc/ssd.cu computes and
    launches it (``ssd_decode_plan``): ``units`` threads, each
    ``rows_per_thread`` rows x one float4 column of one (slot, head),
    ``lanes_per_row`` to a row, in ``blocks`` blocks of ``threads``."""
    out = (ctypes.c_int * 5)()
    if _plan_fns()[1](B, nh, hd, ds, out) != 0:
        raise ValueError(f"ssd_decode_step: no plan for B {B}, nh {nh}, "
                         f"hd {hd}, ds {ds}")
    return dict(zip(("threads", "blocks", "units", "rows_per_thread",
                     "lanes_per_row"), out))


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
    """ssd_intra_chunk(xdt, la, b, c, y, s_local, cdec, cum, B, S, nh, hd,
    ds, chunk, sb_b, sb_s, sc_b, sc_s, dtype, stream) -> cudaError_t."""
    f = _build.load("ssd").ssd_intra_chunk
    f.argtypes = [_P] * 8 + [_I] * 6 + [_L] * 4 + [_I] + [_P]
    f.restype = _I
    return f
