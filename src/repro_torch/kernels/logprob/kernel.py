"""ctypes binding of the CUDA token-logprob + entropy kernels
(``csrc/token_logprob_entropy.cu``), the Hopper counterpart of
``repro.kernels.logprob.kernel.token_logprob_entropy_pallas`` and of the
autodiff of its reference.

The library is built and loaded on first call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# tile sizes of the first design (BM tokens x BN vocab entries per tile):
# the backward, and the forward of operands the wgmma kernel does not take
BM, BN = 64, 128
# the bf16 forward through TMA and wgmma (namespace wg): a block owns
# WG_BM tokens and walks a range of WG_BN-entry vocab tiles
WG_BM, WG_BN = 128, 128
# a block's fixed cost (start, ring fill, statistics written) in tiles
WG_BLOCK_COST = 0.5
# token tiles x vocab ranges the forward aims to put in flight: a few
# blocks for each of the card's 132 SMs
TARGET_BLOCKS = 1056


def split_plan(rows: int, vocab: int):
    """(splits, tiles_per_split) of the forward's split-V grid: every range
    holds at least one vocab tile."""
    n_tiles = -(-vocab // BN)
    t_blocks = max(-(-rows // BM), 1)
    splits = min(n_tiles, max(1, -(-TARGET_BLOCKS // t_blocks)))
    per = -(-n_tiles // splits)
    return -(-n_tiles // per), per


@functools.lru_cache(maxsize=None)
def wgmma_plan(rows: int, vocab: int, n_sm: int):
    """(splits, tiles_per_split) of the wgmma forward's grid of (token
    tile, vocab range) blocks, one block per SM at a time: the ranges that
    minimise the waves of blocks times each block's tiles (plus its fixed
    cost), the fewest splits among equals. Host-known sizes only; the
    ranges cover the vocabulary's tiles exactly once, none empty."""
    n_mt = max(-(-rows // WG_BM), 1)
    n_vt = -(-vocab // WG_BN)
    best = None
    for per in range(1, n_vt + 1):
        splits = -(-n_vt // per)
        cost = -(-n_mt * splits // n_sm) * (per + WG_BLOCK_COST)
        if best is None or cost < best[0]:
            best = (cost, per, splits)
    return best[2], best[1]


@functools.lru_cache(maxsize=None)
def forward_fn():
    """token_logprob_entropy_forward(h, w, targets, part, logp, ent, logz,
    mean_logit, rows, d, V, sk, sn, splits, tiles_per_split, dtype, vec,
    stream) -> cudaError_t."""
    fn = _build.load("token_logprob_entropy").token_logprob_entropy_forward
    fn.argtypes = [_P] * 8 + [_I] * 3 + [_L] * 2 + [_I] * 4 + [_P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def dlogits_fn():
    """token_logprob_entropy_dlogits(h, w, targets, logz, mean_logit,
    g_logp, g_ent, dl, rows, d, V, sk, sn, dtype, vec, stream) ->
    cudaError_t; a null cotangent counts as zero."""
    fn = _build.load("token_logprob_entropy").token_logprob_entropy_dlogits
    fn.argtypes = [_P] * 8 + [_I] * 3 + [_L] * 2 + [_I] * 2 + [_P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def forward_wgmma_fn():
    """token_logprob_entropy_forward_wgmma(h, w, targets, part, logp, ent,
    logz, mean_logit, rows, d, V, sk, sn, splits, tiles_per_split, stream)
    -> cudaError_t."""
    fn = _build.load("token_logprob_entropy") \
        .token_logprob_entropy_forward_wgmma
    fn.argtypes = [_P] * 8 + [_I] * 3 + [_L] * 2 + [_I] * 2 + [_P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def dlogits_wgmma_fn():
    """token_logprob_entropy_dlogits_wgmma(h, w, targets, logz, mean_logit,
    g_logp, g_ent, dl, rows, d, V, sk, sn, ldv, splits, tiles_per_split,
    stream) -> cudaError_t; dl is bf16 [2, rows, ldv] (high parts, then
    remainders), a null cotangent counts as zero."""
    fn = _build.load("token_logprob_entropy") \
        .token_logprob_entropy_dlogits_wgmma
    fn.argtypes = [_P] * 8 + [_I] * 3 + [_L] * 3 + [_I] * 2 + [_P]
    fn.restype = _I
    return fn
