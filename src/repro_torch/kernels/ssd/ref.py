"""Plain PyTorch versions of the Mamba2 SSD kernels (``repro.kernels.ssd.ref``
and the body of ``repro.kernels.ssd.kernel``).

``ssd_decode_step_ref`` and ``ssd_sequential_ref`` mirror the JAX
package's functions of those names. ``ssd_intra_chunk_ref`` is the plain
version of the Pallas intra-chunk kernel's body (the JAX package has none:
its oracle is the sequential scan). They are what the ops take for tensors
on the CPU, and what the CUDA kernels are held against on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_decode_step_ref(state: torch.Tensor, x: torch.Tensor,
                        dt: torch.Tensor, a_log: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step (the O(1) decode update).

    state [B,nh,hd,ds] float32; x [B,nh,hd]; dt [B,nh] (softplus'd); a_log
    [nh]; b/c [B,ds]. Returns (y [B,nh,hd] in c's dtype, new state float32).
    As the reference, the new state is rounded to c's dtype before the C
    product (the CUDA kernel takes that product in float32).
    """
    a = torch.exp(dt * -torch.exp(a_log.float()))  # [B,nh]
    state = state * a[..., None, None] + torch.einsum(
        "bh,bhd,bs->bhds", dt, x.float(), b.float())
    y = torch.einsum("bs,bhds->bhd", c, state.to(c.dtype))
    return y, state


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor,
                       initial_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step scan, the defining form. x [B,S,nh,hd], dt [B,S,nh],
    b/c [B,S,ds] -> (y [B,S,nh,hd] in x's dtype, final state float32)."""
    B, S, nh, hd = x.shape
    ds = b.shape[-1]
    a = -torch.exp(a_log.float())
    state = (torch.zeros((B, nh, hd, ds), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * a)
        upd = torch.einsum("bh,bhd,bs->bhds", dt[:, t], x[:, t].float(),
                           b[:, t].float())
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bs,bhds->bhd", c[:, t].float(), state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_intra_chunk_ref(xdt: torch.Tensor, la: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Per (batch, chunk, head), in float32 (the Pallas kernel's body):

      y_intra[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
      s_local    = sum_j exp(cum_last - cum_j) xdt_j (x) B_j
      cdec       = exp(cum_last)

    with ``cum`` the in-chunk cumulative sum of ``la``. xdt [B,S,nh,hd]
    (x pre-scaled by dt), la [B,S,nh] (log decay per step), b/c [B,S,ds];
    S a multiple of ``chunk``. Returns (y_intra [B,S,nh,hd], s_local
    [B,nc,nh,hd,ds], cdec [B,nc,nh]), all float32. The decay is masked by
    select before ``exp`` (exp(cum_i - cum_j) overflows for j > i).
    """
    B, S, nh, hd = xdt.shape
    ds = b.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_intra_chunk_ref: S={S} is not a multiple "
                         f"of chunk={chunk}")
    nc = S // chunk
    x = xdt.float().reshape(B, nc, chunk, nh, hd)
    cum = torch.cumsum(la.float().reshape(B, nc, chunk, nh), dim=2)
    bc = b.float().reshape(B, nc, chunk, ds)
    cc = c.float().reshape(B, nc, chunk, ds)
    cb = torch.einsum("bnis,bnjs->bnij", cc, bc)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,i,j,nh]
    i = torch.arange(chunk, device=xdt.device)
    causal = (i[:, None] >= i[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, seg, float("-inf")))
    m = cb[..., None] * decay
    y = torch.einsum("bnijh,bnjhd->bnihd", m, x)
    decay_last = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,cs,nh]
    s_local = torch.einsum("bnjh,bnjhd,bnjs->bnhds", decay_last, x, bc)
    cdec = torch.exp(cum[:, :, -1, :])
    return y.reshape(B, S, nh, hd), s_local, cdec
