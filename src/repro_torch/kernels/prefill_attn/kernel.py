"""ctypes binding of the CUDA chunked paged prefill attention kernel
(``csrc/paged_prefill_attn.cu``), the Hopper counterpart of
``repro.kernels.prefill_attn.kernel.paged_prefill_attention_pallas``, and
its split plan.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int

# query vectors (row, head pairs of one KV head) per bf16 block (tc::BM)
BLOCK_VECTORS = 64
# split plan, as paged decode's: at least WAVES blocks per SM when every
# row attends the whole table, no split shorter than MIN_SPLIT_KEYS keys
# (two ring stages), at most MAX_SPLITS splits (one thread-block cluster,
# kMaxSplits in the source)
WAVES = 2
MIN_SPLIT_KEYS = 64
MAX_SPLITS = 8


def split_plan(C: int, G: int, KV: int, mb: int, bs: int,
               n_sm: int) -> Tuple[int, int]:
    """(pages per split, number of splits) for a chunk of ``C`` rows, ``G``
    query heads per KV head, ``KV`` heads, tables of ``mb`` pages of ``bs``
    keys, on a card of ``n_sm`` SMs.

    Host-known sizes only, never seg_ids or q_pos: they live on the device
    and the engine must not wait for it. Splits are runs of whole pages and
    cover the table's ``mb * bs`` key positions exactly once; there are at
    most MAX_SPLITS of them.
    """
    tiles = -(-C * G // BLOCK_VECTORS) * KV
    want = min(MAX_SPLITS, -(-WAVES * n_sm // max(1, tiles)))
    pps = max(-(-MIN_SPLIT_KEYS // bs), -(-mb // want))
    pps = min(pps, mb)
    return pps, -(-mb // pps)


@functools.lru_cache(maxsize=None)
def fn():
    """The C entry point, argument types declared."""
    lib = _build.load("paged_prefill_attn")
    fn = lib.paged_prefill_attention
    # q, pool_k, pool_v, tables, seg_ids, q_pos, out, C, H, KV, hd, bs, mb,
    # pps, n_splits, dtype, stream
    fn.argtypes = [_P] * 7 + [_I] * 9 + [_P]
    fn.restype = _I
    return fn
