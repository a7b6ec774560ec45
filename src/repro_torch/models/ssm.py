"""Mamba2 (SSD) block (``repro.models.ssm``): the chunked scan over a whole
sequence and the O(1) recurrent decode step.

The whole-sequence block runs the chunked scan of
``kernels.ssd.ops.ssd_scan`` with one of two intra-chunk blocks, chosen
in one place (``ssd_chunked``): while autograd records a gradient
through the scan's operands, the model's own differentiable block
(``_intra_chunk_autograd``, plain PyTorch in float32; with it the scan is
the counterpart of the reference's jnp ``ssd_chunked``, which the
reference's training differentiates); otherwise the intra-chunk op (the
CUDA kernel on the card), which has no backward. Serving, prefill,
scoring and ``recompute``'s no-grad prox forward therefore take the
kernel, the training forward and its remat recompute the plain block.
The reference's ``ssm_full`` reaches no Pallas kernel. The decode step
runs ``ssd_decode_step`` (the decode CUDA kernel on the card) and updates
the cache in place.

The depthwise causal convolution is K shifted multiply-adds, as the
reference writes it (never ``F.conv1d``: cuDNN runs a float32 convolution
in TF32 by default), accumulated in float32 and rounded once to the model
dtype, in both the whole-sequence and the one-token form.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.ssd.ops import ssd_decode_step, ssd_scan
from repro_torch.models.params import ParamSpec


def ssm_spec(cfg: ModelConfig) -> Dict[str, Any]:
    s = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    nh = s.num_heads(d)
    conv_dim = din + 2 * s.d_state
    return {
        "in_proj": ParamSpec((d, 2 * din + 2 * s.d_state + nh),
                             ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.d_conv, conv_dim), ("conv", "ssm_inner"),
                            scale=s.d_conv ** -0.5),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((nh,), ("ssm_heads",), init="a_log"),
        "d_skip": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="dt_bias"),
        "norm": ParamSpec((din,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((din, d), ("ssm_inner", "embed")),
    }


def _split_proj(zxbcdt: torch.Tensor, s: SSMConfig, d_model: int):
    """in_proj output -> (z [.., din], xbc [.., din + 2 ds], dt [.., nh])."""
    din = s.d_inner(d_model)
    sizes = [din, din + 2 * s.d_state, s.num_heads(d_model)]
    return torch.split(zxbcdt, sizes, dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time + SiLU. xbc [B,S,Cd]; w [K,Cd]."""
    K = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0)).float()
    wf = w.float()
    out = sum(pad[:, i:i + S, :] * wf[i] for i in range(K))
    return F.silu(out + b.float()).to(xbc.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    yf = (y * F.silu(z)).float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _intra_chunk_autograd(xdt: torch.Tensor, la: torch.Tensor,
                          b: torch.Tensor, c: torch.Tensor, chunk: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """The scan's intra-chunk block through autograd-friendly PyTorch ops,
    in float32: ``ops.ssd_intra_chunk_cum``'s outputs (y_intra [B,S,nh,hd],
    s_local [B,nc,nh,hd,ds], cdec [B,nc,nh], the in-chunk cumsum ``cum``
    [B,S,nh]) for xdt [B,S,nh,hd], la [B,S,nh] and b/c [B,S,ds], S a
    multiple of ``chunk``:

      y_intra[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
      s_local    = sum_j exp(cum_last - cum_j) xdt_j (x) B_j
      cdec       = exp(cum_last)

    The decay is masked by select before ``exp``: exp(cum_i - cum_j) for
    j > i overflows once a chunk's decay passes ~88, and 0 * inf in the
    backward of a select after ``exp`` (the reference's order) makes the
    gradient NaN.
    """
    B, S, nh, hd = xdt.shape
    ds = b.shape[-1]
    nc = S // chunk
    # heads ahead of positions, so that the in-chunk products are batched
    # matmuls over [B, nc, nh]
    x = xdt.reshape(B, nc, chunk, nh, hd).transpose(2, 3)
    cum = torch.cumsum(la.reshape(B, nc, chunk, nh), dim=2).transpose(2, 3)
    bc = b.float().reshape(B, nc, 1, chunk, ds)
    cc = c.float().reshape(B, nc, 1, chunk, ds)
    seg = cum[..., :, None] - cum[..., None, :]  # [B,nc,nh,i,j]
    i = torch.arange(chunk, device=xdt.device)
    causal = i[:, None] >= i[None, :]
    m = (cc @ bc.transpose(-1, -2)) * torch.exp(
        torch.where(causal, seg, float("-inf")))
    y = (m @ x).transpose(2, 3).reshape(B, S, nh, hd)
    w = torch.exp(cum[..., -1:] - cum)  # [B,nc,nh,chunk]
    s_local = (x * w[..., None]).transpose(-1, -2) @ bc
    cdec = torch.exp(cum[..., -1])
    return y, s_local, cdec, cum.transpose(2, 3).reshape(B, S, nh)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the reference's public name and the scan
    ``ssm_full`` runs: ``kernels.ssd.ops.ssd_scan``, whose intra-chunk
    block is the model's differentiable one (``_intra_chunk_autograd``)
    while a gradient is recorded through the operands and the intra-chunk
    op (the kernel on the card, which has no backward) otherwise.

    x [B,S,nh,hd] (conv'd, head-split), dt [B,S,nh] (softplus'd), b, c
    [B,S,ds] (one group) -> (y [B,S,nh,hd], final state [B,nh,hd,ds]
    float32). A sequence longer than ``chunk`` that it does not divide is
    padded to whole chunks, where the reference takes one chunk of S: the
    same values (``ssd_scan``).
    """
    # the differentiable block while autograd records a gradient through
    # the operands; the remat recompute (torch.utils.checkpoint,
    # non-reentrant) reruns the block with gradients enabled on the same
    # leaves, so it takes the same route
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, dt, a_log, b, c, initial_state))
    intra = _intra_chunk_autograd if grad else None
    return ssd_scan(x, dt, a_log, b, c, chunk=chunk,
                    initial_state=initial_state, intra=intra)


def ssm_full(params, x: torch.Tensor, cfg: ModelConfig,
             initial_cache: Optional[Dict[str, torch.Tensor]] = None,
             pad_mask: Optional[torch.Tensor] = None,
             valid_lens: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba2 block. x [B,S,d] -> (y [B,S,d], final cache
    {"conv" [B,K-1,Cd], "state" [B,nh,hd,ds] float32}).

    ``initial_cache`` resumes from a cache (its conv window is prepended).
    ``pad_mask`` [B,S] zeroes dt on pad steps, so they leave the state as
    it is. ``valid_lens`` [B] is each row's count of real tokens under right
    padding: the returned conv window is taken at each row's true end, not
    from the last K-1 rows (a row with 0 valid tokens gets its old window
    back). Unlike the reference it does not need ``initial_cache``: without
    one the window before the sequence is zeros.
    """
    s = cfg.ssm
    d = cfg.d_model
    din, nh, hd = s.d_inner(d), s.num_heads(d), s.head_dim
    K = s.d_conv
    B, S, _ = x.shape

    zxbcdt = torch.einsum("bsd,de->bse", x, params["in_proj"])
    zxbcdt = constrain(zxbcdt, "batch", None, "ssm_inner")
    z, xbc_raw, dt = _split_proj(zxbcdt, s, d)

    init_state = None
    if initial_cache is not None:
        # prepend the cached conv inputs for causal continuity
        xbc_raw = torch.cat([initial_cache["conv"].to(xbc_raw.dtype),
                             xbc_raw], dim=1)
        init_state = initial_cache["state"]
        xbc = _causal_conv(xbc_raw, params["conv_w"],
                           params["conv_b"])[:, K - 1:]
    else:
        xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs, b, c = torch.split(xbc, [din, s.d_state, s.d_state], dim=-1)
    xh = xs.reshape(B, S, nh, hd)
    dt = F.softplus(dt.float() + params["dt_bias"])
    if pad_mask is not None:
        # padded steps must not advance the state: dt = 0 => a = 1, no input
        dt = dt * pad_mask[..., None].to(dt.dtype)

    y, state = ssd_chunked(xh, dt, params["a_log"], b, c, s.chunk_size,
                           initial_state=init_state)
    y = y + xh * params["d_skip"][None, None, :, None].to(xh.dtype)
    y = _gated_norm(y.reshape(B, S, din), z, params["norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"])
    if valid_lens is not None:
        # the window after consuming v real tokens: rows v .. v + K - 2 of
        # the sequence behind its K - 1 window rows (zeros without a cache)
        src = xbc_raw if initial_cache is not None else F.pad(
            xbc_raw, (0, 0, K - 1, 0))
        idx = valid_lens.long()[:, None] + torch.arange(K - 1,
                                                        device=x.device)
        conv_tail = src.gather(
            1, idx[..., None].expand(-1, -1, src.shape[-1]))
    else:
        conv_tail = xbc_raw[:, -(K - 1):, :]
    return out, {"conv": conv_tail, "state": state}


def ssm_decode(params, x: torch.Tensor, cfg: ModelConfig,
               cache: Dict[str, torch.Tensor],
               update: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step. x [B,d]; cache {"conv" [B,K-1,Cd], "state"
    [B,nh,hd,ds] float32} -> (y [B,d], cache).

    The cache is updated in place (the reference returns a new one);
    with ``update`` (bool [B]) the rows where it is False keep their conv
    window and state bit for bit, as the reference's masked select keeps
    them. Returns the same cache dict.
    """
    s = cfg.ssm
    d = cfg.d_model
    din, nh, hd = s.d_inner(d), s.num_heads(d), s.head_dim
    B = x.shape[0]

    zxbcdt = torch.einsum("bd,de->be", x, params["in_proj"])
    z, xbc_t, dt = _split_proj(zxbcdt, s, d)

    conv = cache["conv"]
    win = torch.cat([conv, xbc_t[:, None].to(conv.dtype)], dim=1)  # [B,K,Cd]
    conv_out = F.silu((win.float() * params["conv_w"].float()).sum(dim=1)
                      + params["conv_b"].float()).to(x.dtype)
    xs, b, c = torch.split(conv_out, [din, s.d_state, s.d_state], dim=-1)
    xh = xs.reshape(B, nh, hd)
    dt = F.softplus(dt.float() + params["dt_bias"])  # [B,nh]
    y, _ = ssd_decode_step(cache["state"], xh, dt, params["a_log"], b, c,
                           out=cache["state"], update=update)
    y = y.to(x.dtype) + xh * params["d_skip"][None, :, None].to(x.dtype)
    y = _gated_norm(y.reshape(B, din), z, params["norm"], cfg.norm_eps)
    out = torch.einsum("be,ed->bd", y, params["out_proj"])
    new_conv = win[:, 1:]
    if update is not None:
        new_conv = torch.where(update[:, None, None], new_conv, conv)
    conv.copy_(new_conv)
    return out, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, *,
                   dtype: torch.dtype = torch.bfloat16,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Zero cache {"conv" [batch,K-1,Cd] in ``dtype``, "state"
    [batch,nh,hd,ds] float32}."""
    s = cfg.ssm
    d = cfg.d_model
    conv_dim = s.d_inner(d) + 2 * s.d_state
    return {"conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, s.num_heads(d), s.head_dim,
                                  s.d_state), dtype=torch.float32,
                                 device=device)}


# the decode cache's logical axes (the reference's ``SSM_CACHE_LOGICAL``)
SSM_CACHE_LOGICAL = {"conv": ("batch", None, "ssm_inner"),
                     "state": ("batch", "ssm_heads", None, None)}
