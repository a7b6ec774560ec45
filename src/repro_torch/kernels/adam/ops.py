"""Dispatch for the Adam kernels: the clip's global norm and the one-pass
update over lists of leaves, by the leaves' device.

CUDA leaves take the kernels, with no fallback: a leaf they cannot take
raises. Weights are bf16 or float32, a gradient bf16 or float32 of its
own (the step programs' float32 accumulators of bf16 weights), the
moments float32; a non-contiguous gradient is copied contiguous first
(the weights, moments and outputs are the state's own tensors and must be
contiguous). Leaves anywhere else (the CPU, ``meta``) run the plain
version in ``ref.py``.

A ``DTensor`` off ``meta`` is taken shard by shard. The update is
elementwise, so each rank updates its local shards (p, m, v and the
output placed alike; a gradient placed otherwise is redistributed to its
weight's placements first). The norm sums each group of alike-placed
gradients' local squares, adds the group's sums over the mesh dimensions
it is sharded on, then takes the root. A ``meta`` DTensor (the dry-run's
shapes) runs ``ref.py`` on the DTensors themselves.

``LAUNCHES`` counts the kernels' launches (the norm's partial and final
launches, the update's launches), and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.adam import kernel
from repro_torch.kernels.adam.ref import TINY, adam_update_ref, sum_squares_ref

LAUNCHES = {"norm": 0, "update": 0}
_PLAIN = (torch.Tensor, torch.nn.Parameter)
_DTYPES = (torch.bfloat16, torch.float32)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sharded(xs: Sequence[torch.Tensor]) -> bool:
    return xs[0].device.type != "meta" and any(_is_dtensor(x) for x in xs)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptrs(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _sizes(ts: Sequence[torch.Tensor]):
    return (ctypes.c_int64 * len(ts))(*(t.numel() for t in ts))


def _bf16(ts: Sequence[torch.Tensor]):
    return (ctypes.c_int * len(ts))(*(t.dtype == torch.bfloat16 for t in ts))


def _grad(g: torch.Tensor, dev, what: str) -> torch.Tensor:
    """``g`` as the kernels read it: contiguous, or raise."""
    if type(g) not in _PLAIN or g.dtype not in _DTYPES or g.device != dev:
        raise ValueError(f"{what}: no kernel for a {type(g).__name__} "
                         f"gradient {g.dtype} {tuple(g.shape)} on "
                         f"{g.device} (leaves on {dev})")
    return g.contiguous()


def _scalar(x: Optional[torch.Tensor], dtype: torch.dtype, dev,
            name: str) -> None:
    if x is None:
        return
    if x.dtype != dtype or x.numel() != 1 or x.device != dev:
        raise ValueError(f"adam: {name} must be one {dtype} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _sum_squares(grads: Sequence[torch.Tensor], root: bool) -> torch.Tensor:
    """The gradients' sum of squares (its root with ``root``), a 0-d
    float32 tensor on their device: two launches on the card (more past
    ``kernel.max_leaves()`` leaves), bit for bit the same on the same
    inputs; off the card ``ref.py``."""
    dev = grads[0].device
    if dev.type != "cuda":
        s = sum_squares_ref(grads)
        return torch.sqrt(s) if root else s
    grads = [_grad(g, dev, "adam global_norm") for g in grads]
    out = torch.empty((), dtype=torch.float32, device=dev)
    blocks = kernel.norm_blocks(_n_sm(dev.index))
    launches = -(-len(grads) // kernel.max_leaves())
    partials = torch.empty(launches * blocks, dtype=torch.float32,
                           device=dev)
    err = kernel.norm_fn()(_ptrs(grads), _sizes(grads), _bf16(grads),
                           len(grads), blocks, int(root), partials.data_ptr(),
                           out.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam_global_norm: CUDA error {err}")
    LAUNCHES["norm"] += launches + 1
    return out


def _sharded_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate
    groups, plain = {}, []
    for g in grads:
        if not _is_dtensor(g):
            plain.append(g)
            continue
        # a partial sum's squares are not the square of the sum
        pl = tuple(Replicate() if p.is_partial() else p
                   for p in g.placements)
        if pl != tuple(g.placements):
            g = g.redistribute(g.device_mesh, pl)
        groups.setdefault((g.device_mesh, pl), []).append(g.to_local())
    total = _sum_squares(plain, root=False) if plain else None
    for (mesh, pl), local in groups.items():
        s = DTensor.from_local(
            _sum_squares(local, root=False), mesh,
            [Partial() if p.is_shard() else Replicate() for p in pl],
            run_check=False).full_tensor()
        total = s if total is None else total + s
    return torch.sqrt(total)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, a 0-d float32 tensor
    on their device (see the module docstring for the devices)."""
    if not grads:
        raise ValueError("adam global_norm: no gradients")
    if _sharded(grads):
        return _sharded_norm(grads)
    return _sum_squares(grads, root=True)


def _full(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return x.full_tensor() if _is_dtensor(x) else x


def _local_leaves(params, grads, ms, vs, outs):
    """Each leaf's local shards (p, g, m, v, out), the gradient placed as
    its weight."""
    leaves = []
    for p, g, m, v, o in zip(params, grads, ms, vs, outs):
        if _is_dtensor(p):
            if not _is_dtensor(g):
                raise ValueError(f"adam_update: a plain gradient "
                                 f"{tuple(g.shape)} of a DTensor weight")
            if (g.device_mesh, g.placements) != (p.device_mesh,
                                                 p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
            for x in (m, v, o):
                if not _is_dtensor(x) or (x.device_mesh, x.placements) != (
                        p.device_mesh, p.placements):
                    raise ValueError(
                        f"adam_update: a moment or output placed otherwise "
                        f"than its weight {p.placements}")
        leaves.append(tuple(x.to_local() if _is_dtensor(x) else x
                            for x in (p, g, m, v, o)))
    return [list(xs) for xs in zip(*leaves)]


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], outs: Sequence[torch.Tensor],
                gnorm: torch.Tensor, t: torch.Tensor,
                apply: Optional[torch.Tensor] = None, *, lr: float,
                b1: float, b2: float, eps: float, weight_decay: float,
                max_norm: float) -> Tuple[int, int]:
    """One Adam step of every leaf (``ref.adam_update_ref``'s contract):
    the new weights into ``outs`` (``outs[i]`` may be ``params[i]``), the
    moments in place; ``gnorm`` (0-d float32), ``t`` (the new step count,
    0-d int32) and ``apply`` (0-d bool or None) are read on the device.
    One launch on the card (more past ``kernel.max_leaves()`` leaves).
    Returns the elements (of this rank's shards) the kernels updated and
    those the plain version did."""
    if not (len(params) == len(grads) == len(ms) == len(vs) == len(outs)):
        raise ValueError("adam_update: lists of different lengths")
    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              max_norm=max_norm)
    if not params:
        return 0, 0
    if _sharded(params):
        return adam_update(*_local_leaves(params, grads, ms, vs, outs),
                           _full(gnorm), _full(t), _full(apply), **hp)
    n = sum(p.numel() for p in params)
    dev = params[0].device
    if dev.type != "cuda":
        adam_update_ref(params, grads, ms, vs, outs, gnorm, t, apply, **hp)
        return 0, n
    grads = [_grad(g, dev, "adam_update") for g in grads]
    for p, g, m, v, o in zip(params, grads, ms, vs, outs):
        if p.dtype not in _DTYPES or not (
                m.dtype == v.dtype == torch.float32 and o.dtype == p.dtype
                and all(type(x) in _PLAIN and x.is_contiguous()
                        and x.device == dev and x.shape == p.shape
                        for x in (p, g, m, v, o))):
            raise ValueError(
                f"adam_update: no kernel for {type(p).__name__} {p.dtype} "
                f"{tuple(p.shape)} on {p.device} (gradient {g.dtype}, "
                f"moments {m.dtype} / {v.dtype}, output {o.dtype}; all "
                f"contiguous on {dev})")
    _scalar(gnorm, torch.float32, dev, "gnorm")
    _scalar(t, torch.int32, dev, "t")
    _scalar(apply, torch.bool, dev, "apply")
    err = kernel.update_fn()(
        _ptrs(params), _ptrs(outs), _ptrs(grads), _ptrs(ms), _ptrs(vs),
        _sizes(params), _bf16(params), _bf16(grads), len(params),
        gnorm.data_ptr(), t.data_ptr(),
        None if apply is None else apply.data_ptr(), lr, b1, 1 - b1, b2,
        1 - b2, eps, lr * weight_decay, int(bool(weight_decay)), max_norm,
        TINY, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam_update: CUDA error {err}")
    LAUNCHES["update"] += -(-len(params) // kernel.max_leaves())
    # written through raw pointers: bump the version counters as the
    # in-place ops of the plain version do
    torch.autograd.graph.increment_version([*ms, *vs, *outs])
    return n, 0
