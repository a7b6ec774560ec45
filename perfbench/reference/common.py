"""Plain PyTorch pieces shared by the reference stacks: the operand
precision, RMSNorm, rotary embedding, causal GQA attention, SwiGLU and the
tied output head's per-token log-probability and entropy.

Every function takes float32 or bfloat16 activations and computes in the
``Precision`` it is given. The reference's own runs use float32 with TF32
off; the benchmark's input generator runs the same code in bfloat16; the
control rounds every matrix product's operands to float8 (e4m3, one scale
per tensor, as fp8 training recipes scale them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (amax to the
    format's largest value) and returned in x's dtype. The scale is a
    constant of the rounding: the gradient passes straight through."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    s = FP8_MAX / amax
    q = (x.detach().float() * s).to(torch.float8_e4m3fn).float() / s
    return x + (q.to(x.dtype) - x).detach()


@dataclasses.dataclass(frozen=True)
class Precision:
    """Activation dtype and the rounding applied to each matrix product's
    two operands."""

    dtype: torch.dtype = torch.float32
    operand: Callable[[torch.Tensor], torch.Tensor] = _identity

    def mm(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.operand(a.to(self.dtype)),
                            self.operand(b.to(self.dtype)))


FLOAT32 = Precision(torch.float32)
BFLOAT16 = Precision(torch.bfloat16)
FP8 = Precision(torch.float32, fp8_round)

PRECISIONS = {"float32": FLOAT32, "bfloat16": BFLOAT16, "fp8": FP8}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half layout (Qwen2's ``rotate_half``), at
    positions 0 .. S-1. x [B, S, heads, hd]."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def causal_attention(pr: Precision, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd), causal) v with grouped KV heads: query
    head h reads KV head h // (H / KV). q [B,S,H,hd], k/v [B,S,KV,hd]."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    s = pr.mm("bqkgd,bskd->bkgqs", qg, k).float() / math.sqrt(hd)
    i = torch.arange(S, device=q.device)
    s = s.masked_fill(i[None, :] > i[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = pr.mm("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(B, S, H, hd).to(pr.dtype)


def swiglu(pr: Precision, x: torch.Tensor, w_gate, w_up, w_down
           ) -> torch.Tensor:
    g = pr.mm("bsd,df->bsf", x, w_gate)
    u = pr.mm("bsd,df->bsf", x, w_up)
    return pr.mm("bsf,fd->bsd", F.silu(g) * u, w_down)


def attention_block(pr: Precision, x: torch.Tensor, p: dict, *, heads: int,
                    kv_heads: int, head_dim: int, theta: float, eps: float,
                    bias: bool) -> torch.Tensor:
    """Pre-norm residual block: x + attn(ln1 x), then + SwiGLU(ln2 x).
    ``p`` holds one layer's leaves under the port's names."""
    h = rmsnorm(x, p["ln1/scale"], eps)
    q = pr.mm("bsd,dhk->bshk", h, p["attn/wq"])
    k = pr.mm("bsd,dhk->bshk", h, p["attn/wk"])
    v = pr.mm("bsd,dhk->bshk", h, p["attn/wv"])
    if bias:
        q = q + p["attn/bq"].to(q.dtype)
        k = k + p["attn/bk"].to(k.dtype)
        v = v + p["attn/bv"].to(v.dtype)
    o = causal_attention(pr, rope(q, theta), rope(k, theta), v)
    x = x + pr.mm("bshk,hkd->bsd", o, p["attn/wo"]).to(x.dtype)
    h = rmsnorm(x, p["ln2/scale"], eps)
    return x + swiglu(pr, h, p["ffn/w_gate"], p["ffn/w_up"],
                      p["ffn/w_down"]).to(x.dtype)


def layer_views(params: dict, prefix: str, n: int) -> list:
    """The ``n`` layers of the stacked leaves under ``prefix`` as dicts of
    views keyed by the rest of the path (each leaf unbound once, so its
    gradient is one stack and not ``n`` full-size sums)."""
    keys = [k for k in params if k.startswith(prefix + "/")]
    parts = {k[len(prefix) + 1:]: torch.unbind(params[k], 0) for k in keys}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def run_layer(fn, x: torch.Tensor, *args):
    """One layer, recomputed in the backward when a gradient is recorded
    (so that a minibatch's float32 activations fit the card)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, x, *args, use_reentrant=False)
    return fn(x, *args)


def embed(pr: Precision, table: torch.Tensor, tokens: torch.Tensor
          ) -> torch.Tensor:
    """Tied input embedding, scaled by sqrt(d) as the port scales a tied
    table (Qwen2 as published does not scale it)."""
    return table[tokens].to(pr.dtype) * math.sqrt(table.shape[1])


def _head_chunk(pr: Precision, h: torch.Tensor, table: torch.Tensor,
                targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = pr.mm("td,vd->tv", h, table).float()
    logz = torch.logsumexp(logits, dim=-1)
    logp = logits.gather(-1, targets[:, None])[:, 0] - logz
    ent = logz - (torch.softmax(logits, dim=-1) * logits).sum(-1)
    return logp, ent


def token_logp_entropy(pr: Precision, hidden: torch.Tensor,
                       table: torch.Tensor, targets: torch.Tensor,
                       chunk: int = 1024
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log p(target), entropy), float32, of the tied head's softmax over
    the whole vocabulary. hidden [B, S, d], targets [B, S]; the [rows, V]
    logits exist for ``chunk`` rows at a time (recomputed in the
    backward)."""
    B, S, d = hidden.shape
    h2 = hidden.reshape(B * S, d)
    t2 = targets.reshape(B * S)
    lp, en = [], []
    for r0 in range(0, B * S, chunk):
        a, b = run_layer(lambda hh, tt: _head_chunk(pr, hh, table, tt),
                         h2[r0:r0 + chunk], t2[r0:r0 + chunk])
        lp.append(a)
        en.append(b)
    return torch.cat(lp).reshape(B, S), torch.cat(en).reshape(B, S)
