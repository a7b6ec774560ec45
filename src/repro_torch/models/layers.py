"""Shared primitive layers: RMSNorm, RoPE, SwiGLU FFN, embeddings
(``repro.models.layers``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models.params import ParamSpec


# ----------------------------------------------------------------------- norm
def rmsnorm_spec(d: int):
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32, returned in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ----------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    # a Python-number base: a tensor made from it on the card would be a
    # blocking host-to-device copy in every layer
    return 1.0 / torch.pow(float(theta), exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (cos, sin) [..., seq, 1, head_dim / 2] of the rotary angles
    at ``positions`` [..., seq], broadcast over heads."""
    freqs = rope_freqs(head_dim, theta, positions.device)      # [half]
    angles = positions.float()[..., None] * freqs               # [..., S, half]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half rotary embedding with float32 angles.

    x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    return apply_rope_cos_sin(x, *rope_cos_sin(positions, x.shape[-1],
                                               theta))


def apply_rope_cos_sin(x: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
    """``apply_rope`` with the angles' (cos, sin) from ``rope_cos_sin``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------ ffn
def swiglu_spec(d: int, d_ff: int):
    return {
        "w_gate": ParamSpec((d, d_ff), ("embed", "ff")),
        "w_up": ParamSpec((d, d_ff), ("embed", "ff")),
        "w_down": ParamSpec((d_ff, d), ("ff", "embed")),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    # the leading dim stays "batch": None would force its replication
    h = constrain(F.silu(g) * u, "batch", *((None,) * (x.dim() - 2)),
                  "act_ff")
    return h @ params["w_down"]


# ------------------------------------------------------------------ embedding
def embedding_spec(cfg: ModelConfig):
    # std d^-0.5: tied logits h @ embed.T stay O(1); the input side is
    # rescaled by sqrt(d) in embed_tokens (Gemma/Cohere convention).
    spec = {"embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"),
                               scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        spec["out_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"))
    return spec


def embed_tokens(params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.tie_embeddings:
        # scale tied embeddings so logits stay O(1) (Gemma/Cohere style)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def output_head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    """[d_model, vocab] matrix producing logits."""
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["out_head"]


def logits_from_hidden(params, hidden: torch.Tensor, cfg: ModelConfig,
                       w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float32 logits. In float32 a plain product; in bf16 the product
    accumulates in float32 and is written in float32 (``out_dtype``), as
    JAX's ``preferred_element_type`` does, without a float32 copy of the
    head."""
    w = output_head_weight(params, cfg) if w is None else w
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    if h2.dtype == torch.float32:
        out = h2 @ w.float()
    else:
        out = torch.mm(h2, w, out_dtype=torch.float32)
    out = out.reshape(*lead, w.shape[-1])
    return constrain(out, "batch", *((None,) * (out.dim() - 2)), "vocab")
