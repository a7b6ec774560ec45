"""Operation and byte counts of the work that any implementation must do,
and the card's published peaks. Frozen here, apart from the program.

Model operations count the matrix products alone, 2 per multiply-add:
the projections and the tied head of every position that predicts a
token, and causal attention's two products over the keys at and before
each position. A training step is three forward passes' worth (the
forward and a backward of twice its work); remat's recompute is not
counted. ``recompute``'s proximal forward is one more forward.
"""
from __future__ import annotations

from typing import Iterable

# NVIDIA H100 SXM data sheet, dense, at its full power limit of 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def _attn_block(m: dict):
    """(matrix parameters, attention flops per (query, key) pair); a bias
    adds no product."""
    d, H, KV, hd, f = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], m["d_ff"])
    return d * H * hd * 2 + 2 * d * KV * hd + 3 * d * f, 4 * H * hd


def forward_flops(m: dict, positions: Iterable[int]) -> float:
    """Forward operations over rows of the given numbers of positions."""
    if m["arch"] != "dense":
        raise ValueError(f"no operation count for arch {m['arch']!r}")
    p, pair = _attn_block(m)
    per_pos = 2 * m["d_model"] * m["vocab_size"] + 2 * p * m["num_layers"]
    per_pair = pair * m["num_layers"]
    total = 0.0
    for n in positions:
        total += per_pos * n + per_pair * n * (n + 1) / 2
    return total


def train_step_flops(m: dict, lengths: Iterable[int], algo: str) -> float:
    """One training step over rows of ``lengths`` real tokens: each row
    has length - 1 positions that predict a token."""
    pos = [int(n) - 1 for n in lengths]
    f = 3 * forward_flops(m, pos)
    if algo == "recompute":
        f += forward_flops(m, pos)
    return f


def logprob_least_s(T: int, d: int, V: int, backward: bool) -> float:
    """The least time of the tied head's log-prob + entropy over T tokens:
    the forward's product h w (2 T d V) or the backward's two (dh = dl
    w^T, dw = h^T dl), at the bf16 peak, or its bytes (h, w and the
    targets read once; logp and entropy, or dh, dw, written once; the
    backward also reads the log-prob cotangent) at the HBM rate."""
    if backward:
        flops = 4 * T * d * V
        nbytes = 2 * (T * d + d * V) + 4 * T + 4 * T + 2 * (T * d + d * V)
    else:
        flops = 2 * T * d * V
        nbytes = 2 * (T * d + d * V) + 4 * T + 8 * T
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)
