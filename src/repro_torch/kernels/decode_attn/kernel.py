"""ctypes binding of the CUDA dense-cache decode attention kernel
(``csrc/decode_attn.cu``), the Hopper counterpart of
``repro.kernels.decode_attn.kernel.decode_attention_pallas``, and its
split plan.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn.paged_kernel import (
    MAX_SPLITS,
    MIN_SPLIT_KEYS,
    WAVES,
)

_P, _I = ctypes.c_void_p, ctypes.c_int

TILE = 16  # keys per warp tile (kTile in csrc/decode_split.cuh)


def split_plan(B: int, KV: int, L: int, n_sm: int) -> Tuple[int, int]:
    """(keys per split, number of splits) of the bf16 kernel for ``B``
    rows of a cache of ``L`` positions and ``KV`` heads on a card of
    ``n_sm`` SMs: paged decode's plan (``paged_kernel.split_plan``) with
    16-key tiles in place of pages.

    Host-known sizes only, never the lengths: the decode loop must not
    wait for the device. Splits are runs of whole tiles that cover
    positions 0 .. L - 1 exactly once; there are at most MAX_SPLITS of
    them, none empty.
    """
    want = min(MAX_SPLITS, -(-WAVES * n_sm // max(1, B * KV)))
    tiles = -(-L // TILE)
    per = max(-(-MIN_SPLIT_KEYS // TILE), -(-tiles // want))
    per = min(per, tiles)
    return per * TILE, -(-tiles // per)


@functools.lru_cache(maxsize=None)
def fn():
    """decode_attention(q, k_cache, v_cache, lengths, out, B, H, KV, L, hd,
    split_keys, n_splits, dtype, stream) -> cudaError_t."""
    f = _build.load("decode_attn").decode_attention
    f.argtypes = [_P] * 5 + [_I] * 8 + [_P]
    f.restype = _I
    return f
