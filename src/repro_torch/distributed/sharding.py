"""Logical-axis sharding rules mapped onto a ``DeviceMesh``
(``repro.distributed.sharding``).

Weights and activations are annotated with *logical* axis names; this
module maps them onto whatever mesh is active, with the reference's rules
and its divisibility fallback: a tensor dimension that its mesh axes do not
divide (kv_heads 8 on a model axis of 16) is replicated instead of failing.

``ShardingEnv.spec`` gives the reference's ``PartitionSpec`` as a tuple of
mesh-axis entries (``None``, an axis name, or a tuple of names), trailing
``None``s trimmed; ``placements`` turns it into DTensor placements, one per
mesh dimension. A tensor dimension over several mesh axes is always over
them in mesh order (the only multi-axis rule is batch over ("pod",
"data")), which is DTensor's order for repeated ``Shard(dim)``, so the
rules never need ``_StridedShard``; no mesh axis shards two tensor
dimensions (``spec`` uses each axis once).

The mesh is a ``DeviceMesh`` or an ``AbstractMesh`` (axis names and sizes
only: the spec arithmetic, and the one-device mesh that needs no process
group). ``constrain`` is the identity when no env is active or the mesh has
one device, as in the reference; otherwise it redistributes a DTensor to
the resolved placements (a plain tensor is left as it is).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

AxisRule = Tuple[str, Union[str, Tuple[str, ...], None]]
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]

# Default logical->mesh mapping. "embed" is the FSDP axis (weight d_model
# dims sharded over data); activations use "act_embed" which is never
# sharded over data.
DEFAULT_RULES: Tuple[AxisRule, ...] = (
    ("batch", ("pod", "data")),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("ff", "model"),
    ("experts", "model"),
    ("expert_ff", None),
    ("ssm_inner", "model"),
    ("ssm_heads", "model"),
    ("mla_rank", None),
    ("embed", "data"),      # FSDP weight sharding
    ("act_embed", None),
    ("act_heads", "model"),
    ("act_ff", "model"),
    ("seq", None),
    ("seq_sp", None),  # sequence-parallel residual stream (opt-in: "model")
    ("kv_seq", None),
    ("layers", None),
    ("head_dim", None),
    ("ssm_state", None),
    ("conv", None),
    ("capacity", None),
)


class AbstractMesh:
    """A mesh as axis names and sizes, with no devices or process group:
    the spec arithmetic, and the one-device local mesh."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 device_type: str = "cpu"):
        assert len(axis_sizes) == len(axis_names), (axis_sizes, axis_names)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))
        self.device_type = device_type

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.device_type!r})"


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Optional[Sequence[str]] = None
                  ) -> AbstractMesh:
    """``AbstractMesh`` of these sizes; the names default to the production
    meshes' ("data", "model") or ("pod", "data", "model")."""
    if axis_names is None:
        axis_names = ("pod", "data", "model")[-len(axis_sizes):]
    return AbstractMesh(axis_sizes, axis_names)


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The ``NamedSharding`` counterpart: a mesh, the reference's spec and
    the DTensor placements (one per mesh dimension)."""

    mesh: object
    spec: Spec
    placements: Tuple[object, ...]

    @property
    def is_fully_replicated(self) -> bool:
        return all(p is None for p in self.spec)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-device shape of a tensor of ``shape`` (the reference's
        ``NamedSharding.shard_shape``)."""
        sizes = mesh_axes(self.mesh)
        out = list(shape)
        for i, entry in enumerate(self.spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            out[i] //= math.prod(sizes[a] for a in axes)
        return tuple(out)


class ShardingEnv:
    """A mesh + rule set, resolving logical axes to concrete shardings.
    ``ep_shard_map`` selects the expert-parallel MoE path (the dry-run's
    ``--ep-moe``)."""

    def __init__(self, mesh, rules: Sequence[AxisRule] = DEFAULT_RULES,
                 fsdp: bool = True, tp_fallback: bool = False):
        self.mesh = mesh
        self.rules: Dict[str, Union[str, Tuple[str, ...], None]] = dict(rules)
        self.fsdp = fsdp
        # tp_fallback: if a weight leaves the "model" axis unused (e.g.
        # heads=56 on model=16), shard its d_model ("embed") axis over
        # "model" instead — row-parallel TP with an extra activation
        # all-reduce, instead of full weight replication.
        self.tp_fallback = tp_fallback
        self.ep_shard_map = False
        self.axis_sizes = mesh_axes(mesh)
        self.axis_names = tuple(self.axis_sizes)

    @property
    def n_devices(self) -> int:
        return math.prod(self.axis_sizes.values())

    def _mesh_axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        target = self.rules.get(logical, None)
        if target is None:
            return ()
        if logical == "embed" and not self.fsdp:
            return ()
        if isinstance(target, str):
            target = (target,)
        return tuple(a for a in target if a in self.axis_names)

    def spec(self, shape: Sequence[int],
             logical_axes: Sequence[Optional[str]]) -> Spec:
        """The reference's PartitionSpec for ``shape``, divisibility-aware,
        as a tuple with trailing ``None``s trimmed."""
        assert len(shape) == len(logical_axes), (shape, logical_axes)
        used: set = set()
        parts = []
        for dim, name in zip(shape, logical_axes):
            axes = self._mesh_axes_for(name)
            axes = tuple(a for a in axes if a not in used)
            size = math.prod(self.axis_sizes[a] for a in axes)
            if axes and dim % size == 0 and dim >= size:
                used.update(axes)
                parts.append(axes if len(axes) > 1 else axes[0])
            else:
                parts.append(None)
        if (self.tp_fallback and "model" in self.axis_names
                and "model" not in used):
            msize = self.axis_sizes["model"]
            for i, (dim, name) in enumerate(zip(shape, logical_axes)):
                if (name == "embed" and parts[i] is None
                        and dim % msize == 0 and dim >= msize):
                    parts[i] = "model"
                    break
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def placements(self, shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]]) -> Tuple[object, ...]:
        """DTensor placements, one per mesh axis: ``Shard(dim)`` where
        ``spec`` puts tensor dim ``dim`` over that axis, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate() for _ in self.axis_names]
        for dim, entry in enumerate(self.spec(shape, logical_axes)):
            for a in (entry,) if isinstance(entry, str) else (entry or ()):
                out[self.axis_names.index(a)] = Shard(dim)
        return tuple(out)

    def sharding(self, shape: Sequence[int],
                 logical_axes: Sequence[Optional[str]]) -> Sharding:
        return Sharding(self.mesh, self.spec(shape, logical_axes),
                        self.placements(shape, logical_axes))


_LOCAL = threading.local()


def current_env() -> Optional[ShardingEnv]:
    return getattr(_LOCAL, "env", None)


@contextlib.contextmanager
def use_sharding(env: Optional[ShardingEnv]):
    prev = current_env()
    _LOCAL.env = env
    try:
        yield env
    finally:
        _LOCAL.env = prev


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the placements its logical axes resolve
    to; the identity outside a mesh, on a one-device mesh, and for a
    plain tensor."""
    env = current_env()
    if env is None or env.n_devices == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    target = env.placements(x.shape, logical_axes)
    if tuple(x.placements) == target:
        return x
    return _Constrain.apply(x, target)


class _Constrain(torch.autograd.Function):
    """``x.redistribute(mesh, target)`` whose backward takes the gradient
    back to x's placements (a partial of x's replicated over its dim) and
    also accepts a plain tensor of x's global shape: autograd materialises
    an absent gradient as plain zeros, which DTensor's own redistribute
    backward refuses."""

    @staticmethod
    def forward(ctx, x, target):
        from torch.distributed.tensor import Partial, Replicate
        ctx.mesh = x.device_mesh
        ctx.target = tuple(target)
        ctx.back = tuple(Replicate() if isinstance(p, Partial) else p
                         for p in x.placements)
        return x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        if not isinstance(g, DTensor):
            g = shard_tensor(g, Sharding(ctx.mesh, (), ctx.target))
        return g.redistribute(ctx.mesh, ctx.back), None


def is_distributed(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` of more than one device (the
    only mesh on which tensors become DTensors)."""
    return not isinstance(mesh, AbstractMesh) and mesh.size() > 1


def shard_tensor(t: torch.Tensor, sharding: Sharding,
                 device=None) -> torch.Tensor:
    """``t`` as a DTensor in ``sharding``'s placements, this rank keeping
    only its local shard, moved to ``device`` if given (a ``meta`` tensor
    gets a ``meta`` shard of the local shape). On a one-device mesh ``t``
    is returned as it is."""
    mesh = sharding.mesh
    if not is_distributed(mesh):
        return t
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    local_shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, sharding.placements)
    if t.is_meta:
        local = torch.empty(local_shape, dtype=t.dtype, device="meta")
    else:
        local = t.detach()[tuple(slice(o, o + n) for o, n in
                                 zip(offset, local_shape))].contiguous()
        if device is not None:
            local = local.to(device)
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def shard_tree(tree, shardings):
    """``shard_tensor`` over a nested dict of tensors and its mirror of
    ``Sharding``s."""
    if isinstance(tree, dict) or hasattr(tree, "_parameters"):
        return {k: shard_tree(tree[k], shardings[k]) for k in tree}
    return shard_tensor(tree, shardings)


def write_rows(buf: torch.Tensor, cols: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
    """``buf[b, cols[b]] = value[b]`` for every row b, in place (a decode
    cache write: buf [B, L, ...], cols [B], value [B, ...]); returns
    ``buf``. On a DTensor cache whose sequence dim is not sharded, each
    rank writes its own rows (a ``local_map`` of the indexed write: DTensor
    has no rule for it, and a replicated write would gather the cache)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not (isinstance(buf, DTensor) and all(
            not (isinstance(p, Shard) and p.dim == 1)
            for p in buf.placements)):
        rows = torch.arange(buf.shape[0], device=cols.device)
        buf[rows, cols] = value.to(buf.dtype)
        return buf
    mesh = buf.device_mesh
    vp = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2 else
          (Shard(0) if isinstance(p, Shard) else Replicate())
          for p in buf.placements]
    cp = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in buf.placements]
    local = buf.to_local()

    def to_local(t, placements):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, placements).to_local()

    v = to_local(value, vp)
    c = to_local(cols, cp)
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, c] = v.to(local.dtype)
    return buf
