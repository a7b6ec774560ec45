"""ctypes binding of the CUDA paged decode attention kernel
(``csrc/paged_decode_attn.cu``), the Hopper counterpart of
``repro.kernels.decode_attn.paged_kernel.paged_decode_attention_pallas``,
and its split plan.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int

# split plan: at least WAVES blocks per SM when every slot is full, no
# split shorter than MIN_SPLIT_KEYS keys (one 16-key tile per warp), and at
# most MAX_SPLITS splits, the blocks of one thread-block cluster that merge
# through shared memory (kMaxSplits in csrc/decode_split.cuh); dense
# decode's plan (kernel.py) takes the same constants
WAVES = 2
MIN_SPLIT_KEYS = 64
MAX_SPLITS = 8


def split_plan(mb: int, bs: int, S: int, KV: int,
               n_sm: int) -> Tuple[int, int]:
    """(pages per split, number of splits) for tables of ``mb`` pages of
    ``bs`` keys, ``S`` slots and ``KV`` heads on a card of ``n_sm`` SMs.

    Host-known sizes only, never the lengths: the engine's decode horizon
    must not wait for the device. Splits are runs of whole pages and cover
    the table's ``mb * bs`` key positions exactly once; there are at most
    MAX_SPLITS of them.
    """
    want = min(MAX_SPLITS, -(-WAVES * n_sm // max(1, S * KV)))
    pps = max(-(-MIN_SPLIT_KEYS // bs), -(-mb // want))
    pps = min(pps, mb)
    return pps, -(-mb // pps)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def fn():
    """The C entry point, argument types declared."""
    lib = _build.load("paged_decode_attn")
    fn = lib.paged_decode_attention
    # q, pool_k, pool_v, tables, lengths, out, S, H, KV, hd, bs, mb, pps,
    # n_splits, dtype, stream
    fn.argtypes = [_P] * 6 + [_I] * 9 + [_P]
    fn.restype = _I
    return fn
