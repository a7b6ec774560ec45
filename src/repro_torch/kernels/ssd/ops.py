"""Dispatch wrappers for the Mamba2 SSD kernels and the chunked scan built
on them (``repro.kernels.ssd.ops``).

A tensor on the CPU takes the plain PyTorch version in ``ref.py``; a CUDA
tensor takes the CUDA kernel or raises — there is no fallback. The kernels
have no backward (the JAX package trains SSM stacks through XLA autodiff
of its jnp scan and has no backward kernel either): SSM training runs the
model's own differentiable intra-chunk block inside ``ssd_scan``
(``models.ssm.ssd_chunked`` picks it while a gradient is recorded), so on
a CUDA tensor that requires a gradient, under autograd, these ops raise:
a route that slipped fails loudly. ``LAUNCHES`` counts
each kernel's launches, and nothing else; ``PLANS`` holds the launch plan
(``kernel.decode_plan`` / ``kernel.intra_plan``, read from the CUDA
library that computes it) of each kernel's last launch.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import (
    ssd_decode_step_ref,
    ssd_intra_chunk_ref,
)

LAUNCHES = {"ssd_decode_step": 0, "ssd_intra_chunk": 0}
PLANS = {"ssd_decode_step": None, "ssd_intra_chunk": None}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version; also for ``meta``
    tensors, which the dry-run traces for shapes only); True for CUDA
    tensors that the kernel may take; raises for any other device and
    under autograd on the card."""
    dev = tensors[0].device
    if dev.type in ("cpu", "meta"):
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; a "
                           "gradient through the SSD scan takes the model's "
                           "differentiable block (models.ssm.ssd_chunked), "
                           "so this call under autograd is a route that "
                           "slipped")
    return True


def check_decode_inputs(state, x, dt, a_log, b, c, out=None, update=None
                        ) -> Tuple[int, int]:
    """Validate what the decode kernel takes; returns (dtype code of x, b
    and c, dtype code of a_log)."""
    tensors = [t for t in (state, x, dt, a_log, b, c, out, update)
               if t is not None]
    if any(t.device != state.device for t in tensors):
        raise ValueError("ssd_decode_step: all operands on one device")
    if state.dim() != 4:
        raise ValueError(f"ssd_decode_step: state {tuple(state.shape)}")
    B, nh, hd, ds = state.shape
    if (x.shape != (B, nh, hd) or dt.shape != (B, nh)
            or a_log.shape != (nh,) or b.shape != (B, ds)
            or c.shape != (B, ds)
            or (out is not None and out.shape != state.shape)
            or (update is not None and update.shape != (B,))):
        raise ValueError(
            f"ssd_decode_step: shapes state {tuple(state.shape)}, x "
            f"{tuple(x.shape)}, dt {tuple(dt.shape)}, a_log "
            f"{tuple(a_log.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    if (state.dtype != torch.float32 or dt.dtype != torch.float32
            or x.dtype not in _DTYPE_CODES or b.dtype != x.dtype
            or c.dtype != x.dtype or a_log.dtype not in _DTYPE_CODES
            or (out is not None and out.dtype != torch.float32)
            or (update is not None and update.dtype != torch.bool)):
        raise ValueError(
            f"ssd_decode_step: dtypes state {state.dtype}, x {x.dtype}, dt "
            f"{dt.dtype}, a_log {a_log.dtype}, b {b.dtype}, c {c.dtype}; "
            "need float32 state and dt, x/b/c of one of "
            f"{list(_DTYPE_CODES)}, a bool update")
    if not all(t.is_contiguous() for t in (state, dt, a_log)) \
            or (out is not None and not out.is_contiguous()) \
            or (update is not None and not update.is_contiguous()):
        raise ValueError("ssd_decode_step: state, dt, a_log, out and "
                         "update must be contiguous")
    if x.stride(2) != 1 or x.stride(1) != hd or b.stride(1) != 1 \
            or c.stride(1) != 1:
        raise ValueError("ssd_decode_step: x's heads and b/c's state "
                         "entries must be contiguous within a row")
    if ds not in kernel.STATE_DIMS:
        raise ValueError(f"ssd_decode_step: d_state {ds} (need one of "
                         f"{kernel.STATE_DIMS})")
    if state.data_ptr() % 16 or (out is not None and out.data_ptr() % 16):
        raise ValueError("ssd_decode_step: state and out must be 16-byte "
                         "aligned")
    return _DTYPE_CODES[x.dtype], _DTYPE_CODES[a_log.dtype]


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    *, out: Optional[torch.Tensor] = None,
                    update: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step: state [B,nh,hd,ds] float32, x [B,nh,hd], dt
    [B,nh] float32 (softplus'd), a_log [nh], b/c [B,ds] in x's dtype ->
    (y [B,nh,hd] in x's dtype, new state float32).

    ``out`` receives the new state (it may be ``state`` itself: an update
    in place) and is returned; with ``update`` (bool [B], requires
    ``out``) the rows where it is False keep ``out``'s values bit for bit,
    as the reference's masked select keeps them. On the card y is the
    float32 product of the new state with c (the Pallas kernel's); the
    plain version rounds the state to c's dtype first, as the JAX
    reference does.
    """
    if update is not None and out is None:
        raise ValueError("ssd_decode_step: update requires out")
    if not _on_card("ssd_decode_step", state, x, dt, a_log, b, c):
        y, new = ssd_decode_step_ref(state, x, dt, a_log, b, c)
        if update is not None:
            new = torch.where(update[:, None, None, None], new, out)
        if out is not None:
            out.copy_(new)
            new = out
        return y, new
    code, alog_code = check_decode_inputs(state, x, dt, a_log, b, c, out,
                                          update)
    B, nh, hd, ds = state.shape
    plan = kernel.decode_plan(B, nh, hd, ds)
    new = torch.empty_like(state) if out is None else out
    y = torch.empty((B, nh, hd), dtype=x.dtype, device=x.device)
    err = kernel.decode_fn()(
        state.data_ptr(), x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
        b.data_ptr(), c.data_ptr(),
        None if update is None else update.data_ptr(), new.data_ptr(),
        y.data_ptr(), B, nh, hd, ds, x.stride(0), b.stride(0), c.stride(0),
        code, alog_code, _stream(x))
    if err != 0:
        raise RuntimeError(f"ssd_decode_step: CUDA error {err}")
    LAUNCHES["ssd_decode_step"] += 1
    PLANS["ssd_decode_step"] = plan
    return y, new


def check_intra_chunk_inputs(xdt, la, b, c, chunk: int) -> int:
    """Validate what the intra-chunk kernel takes; returns the dtype code
    of b and c."""
    if any(t.device != xdt.device for t in (la, b, c)):
        raise ValueError("ssd_intra_chunk: all operands on one device")
    if xdt.dim() != 4:
        raise ValueError(f"ssd_intra_chunk: xdt {tuple(xdt.shape)}")
    B, S, nh, hd = xdt.shape
    ds = b.shape[-1]
    if la.shape != (B, S, nh) or b.shape != (B, S, ds) \
            or c.shape != (B, S, ds):
        raise ValueError(f"ssd_intra_chunk: shapes xdt {tuple(xdt.shape)}, "
                         f"la {tuple(la.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}")
    if xdt.dtype != torch.float32 or la.dtype != torch.float32 \
            or b.dtype not in _DTYPE_CODES or c.dtype != b.dtype:
        raise ValueError(f"ssd_intra_chunk: dtypes xdt {xdt.dtype}, la "
                         f"{la.dtype}, b {b.dtype}, c {c.dtype}; need "
                         "float32 xdt and la, b/c of one of "
                         f"{list(_DTYPE_CODES)}")
    if not (0 < chunk <= kernel.MAX_CHUNK) or S % chunk:
        raise ValueError(f"ssd_intra_chunk: chunk {chunk} must divide S={S} "
                         f"and be at most {kernel.MAX_CHUNK}")
    code = _DTYPE_CODES[b.dtype]
    per_block = kernel.HEADS_PER_BLOCK[code]
    if hd not in kernel.HEAD_DIMS or ds not in kernel.STATE_DIMS \
            or nh % per_block:
        raise ValueError(f"ssd_intra_chunk: head_dim {hd} (need one of "
                         f"{kernel.HEAD_DIMS}), d_state {ds} (need one of "
                         f"{kernel.STATE_DIMS}), heads {nh} (a multiple of "
                         f"{per_block} for {b.dtype} b/c)")
    if not xdt.is_contiguous() or not la.is_contiguous() \
            or xdt.data_ptr() % 16:
        raise ValueError("ssd_intra_chunk: xdt (16-byte aligned) and la "
                         "must be contiguous")
    if b.stride(2) != 1 or c.stride(2) != 1:
        raise ValueError("ssd_intra_chunk: b/c state entries must be "
                         "contiguous")
    return code


def _rows_16b(t: torch.Tensor) -> bool:
    """Whether every row of a bf16 [B,S,ds] tensor starts 16-byte aligned
    (the mma kernel's cp.async loads)."""
    return (t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
            and t.stride(1) % 8 == 0)


def _intra_chunk_card(xdt, la, b, c, chunk: int):
    """Launch the intra-chunk kernel on CUDA tensors: (y_intra, s_local,
    cdec, cum), cum the in-chunk inclusive cumsum of la [B,S,nh] float32."""
    code = check_intra_chunk_inputs(xdt, la, b, c, chunk)
    if code == 1:
        # the mma kernel loads b/c rows 16 bytes at a time; other strides
        # are copied (the engines' conv slices are aligned)
        b = b if _rows_16b(b) else b.contiguous()
        c = c if _rows_16b(c) else c.contiguous()
    B, S, nh, hd = xdt.shape
    ds = b.shape[-1]
    nc = S // chunk
    plan = kernel.intra_plan(code, B, S, chunk, nh, hd, ds)
    y = torch.empty_like(xdt)
    s_local = torch.empty((B, nc, nh, hd, ds), dtype=torch.float32,
                          device=xdt.device)
    cdec = torch.empty((B, nc, nh), dtype=torch.float32, device=xdt.device)
    cum = torch.empty_like(la)
    err = kernel.intra_chunk_fn()(
        xdt.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), s_local.data_ptr(), cdec.data_ptr(),
        cum.data_ptr(), B, S, nh, hd, ds, chunk, b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), code, _stream(xdt))
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk: CUDA error {err}")
    LAUNCHES["ssd_intra_chunk"] += 1
    PLANS["ssd_intra_chunk"] = plan
    return y, s_local, cdec, cum


def ssd_intra_chunk(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD block: xdt [B,S,nh,hd] float32, la [B,S,nh] float32,
    b/c [B,S,ds]; ``chunk`` divides S -> (y_intra [B,S,nh,hd], s_local
    [B,nc,nh,hd,ds], cdec [B,nc,nh]), all float32 (see ``ref.py``). bf16
    b/c take the tensor-core kernel, float32 b/c the FMA kernel; on the
    card this is ``ssd_intra_chunk_cum``'s launch with its cum dropped."""
    if not _on_card("ssd_intra_chunk", xdt, la, b, c):
        return ssd_intra_chunk_ref(xdt, la, b, c, chunk)
    return _intra_chunk_card(xdt, la, b, c, chunk)[:3]


def ssd_intra_chunk_cum(xdt: torch.Tensor, la: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """``ssd_intra_chunk`` and the in-chunk inclusive cumsum of la
    ([B,S,nh] float32) that the chunked scan needs: on the card the kernel
    writes the one it computes, on the CPU it is ``torch.cumsum``."""
    if not _on_card("ssd_intra_chunk", xdt, la, b, c):
        B, S, nh = la.shape
        cum = torch.cumsum(la.reshape(B, S // chunk, chunk, nh), dim=2)
        return (*ssd_intra_chunk_ref(xdt, la, b, c, chunk),
                cum.reshape(B, S, nh))
    return _intra_chunk_card(xdt, la, b, c, chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None,
             intra: Optional[Callable] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: the intra-chunk op plus the inter-chunk recurrence
    (a loop over S / chunk in torch ops, the reference's ``lax.scan``) and
    ``y_inter = exp(cum) C . S_prev`` (float32 einsum, as the reference
    leaves them outside its kernel; on the card cum comes from the
    intra-chunk kernel).

    x [B,S,nh,hd], dt [B,S,nh] float32 (softplus'd), a_log [nh], b/c
    [B,S,ds] -> (y [B,S,nh,hd] in x's dtype, final state [B,nh,hd,ds]
    float32). A sequence no longer than ``chunk`` is one chunk, as in the
    reference; a longer one that ``chunk`` does not divide is padded with
    zero xdt and zero log decay up to a multiple (the reference falls back
    to one chunk of length S instead). That is exact: a pad step leaves
    the state as it is and adds nothing, and its rows are cut off.
    ``intra`` takes the place of ``ssd_intra_chunk_cum`` (same arguments
    and outputs): the model's differentiable block under autograd
    (``models.ssm.ssd_chunked``).
    """
    B, S, nh, hd = x.shape
    ds = b.shape[-1]
    la = dt * -torch.exp(a_log.float())
    xdt = x.float() * dt[..., None]
    L = min(chunk, S)
    pad = -S % L
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // L
    y_intra, s_local, cdec, cum = (intra or ssd_intra_chunk_cum)(
        xdt, la, b, c, L)
    cum = cum.reshape(B, nc, L, nh)
    state = (torch.zeros((B, nh, hd, ds), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for n in range(nc):
        prev.append(state)  # the state entering chunk n
        state = state * cdec[:, n, :, None, None] + s_local[:, n]
    y_inter = torch.einsum("bnis,bnhds->bnihd",
                           c.reshape(B, nc, L, ds).float(),
                           torch.stack(prev, dim=1))
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = y_intra + y_inter.reshape(B, Sp, nh, hd)
    return y[:, :S].to(x.dtype), state
