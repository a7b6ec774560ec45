"""Parameter spec trees and the module that holds the weights.

Model code declares parameters as nested dicts of ``ParamSpec`` (shape +
logical axis names + init kind), as in ``repro.models.params``. Weights keep
the JAX package's layouts (``wq [L,d,H,hd]``, ``wo [L,H,hd,d]``, layer axis
first), so the einsums of the port read like the reference's.

``ParamTree`` is the ``nn.Module`` that holds them: one submodule per dict
level, one ``nn.Parameter`` per leaf (frozen unless built with
``requires_grad=True``, as the trainer builds them), and
``tree["blocks"]["attn"]`` indexing, so the functional model code takes
either it or a plain dict.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | a_log | dt_bias
    scale: Optional[float] = None  # stddev override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


SpecTree = Dict[str, Any]  # nested dicts of ParamSpec


def _fan_in(shape: Tuple[int, ...]) -> int:
    # weights are stored input-major: all but the last axis feed the output
    # (for stacked specs that includes the layer axis, as in the reference)
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return int(np.prod(shape[:-1]))


def walk(tree: Mapping[str, Any], path=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """Yield (path, leaf) in sorted key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, (Mapping, ParamTree)):
            yield from walk(v, path + (k,))
        else:
            yield path + (k,), v


def count_params(specs: SpecTree) -> int:
    """Number of scalars a spec tree declares."""
    return sum(math.prod(s.shape) for _, s in walk(specs))


def stack_specs(spec: SpecTree, n: int, axis_name: str = "layers") -> SpecTree:
    """Prepend a stacked (layer) axis to every leaf of a block spec tree."""
    return {k: (stack_specs(v, n, axis_name) if isinstance(v, dict)
                else ParamSpec((n,) + v.shape, (axis_name,) + v.logical,
                               v.init, v.scale))
            for k, v in spec.items()}


# A "normal" leaf with more elements than this is drawn one leading-axis
# slice at a time (MoE expert stacks: qwen3-moe's w_gate is 9.66 G
# elements, a 38.6 GB float32 draw). Smaller leaves are drawn whole: every
# leaf of the dense configs that fit one card is (qwen3-8b's largest is
# 1.81 G elements).
WHOLE_DRAW_MAX = 1 << 31


def _std(spec: ParamSpec) -> float:
    return spec.scale if spec.scale is not None else _fan_in(spec.shape) ** -0.5


def _init_leaf(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=generator.device)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=generator.device)
    if spec.init == "a_log":
        # Mamba2 A uniform in [1, 16]
        u = torch.rand(spec.shape, generator=generator,
                       device=generator.device)
        return torch.log(1.0 + u * 15.0)
    if spec.init == "dt_bias":
        # inverse softplus of dt log-uniform in [1e-3, 1e-1]
        u = torch.rand(spec.shape, generator=generator,
                       device=generator.device)
        lo, hi = np.log(1e-3), np.log(1e-1)
        dt = torch.exp(u * (hi - lo) + lo)
        return dt + torch.log(-torch.expm1(-dt))
    if spec.init != "normal":
        raise ValueError(f"init {spec.init!r} is not ported yet")
    return torch.randn(spec.shape, generator=generator,
                       device=generator.device).mul_(_std(spec))


def _init_sliced(spec: ParamSpec, generator: torch.Generator, *, device,
                 dtype) -> torch.Tensor:
    """A large "normal" leaf drawn one leading-axis slice at a time into
    its ``dtype`` tensor on ``device``: the float32 transient is one
    slice (one layer of a stacked leaf), not the whole leaf."""
    std = _std(spec)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for i in range(spec.shape[0]):
        out[i] = torch.randn(spec.shape[1:], generator=generator,
                             device=generator.device).mul_(std)
    return out


class ParamTree(nn.Module):
    """Nested weights: a submodule per dict level, a parameter per leaf
    (trainable only with ``requires_grad=True``). ``tree[key]`` returns the
    child (subtree or tensor)."""

    def __init__(self, tree: Mapping[str, Any], requires_grad: bool = False):
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v, requires_grad))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v),
                                    requires_grad=requires_grad))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters

    def __iter__(self):
        return iter(sorted(list(self._modules) + list(self._parameters)))


def init_from_specs(specs: SpecTree, generator: torch.Generator, *,
                    device="cuda", dtype=torch.bfloat16,
                    requires_grad: bool = False) -> ParamTree:
    """Draw every leaf in sorted-path order from ``generator`` (in float32
    on the generator's device), scale by the reference's std in place,
    then cast to ``dtype`` on ``device``; a "normal" leaf of more than
    ``WHOLE_DRAW_MAX`` elements is drawn a leading-axis slice at a time
    (``_init_sliced``). The values are not the JAX package's (its
    threefry draws are not reproduced); the distributions are."""
    out: Dict[str, Any] = {}
    for path, spec in walk(specs):
        sub = out
        for p in path[:-1]:
            sub = sub.setdefault(p, {})
        if spec.init == "normal" and math.prod(spec.shape) > WHOLE_DRAW_MAX:
            leaf = _init_sliced(spec, generator, device=device, dtype=dtype)
        else:
            leaf = _init_leaf(spec, generator).to(device=device, dtype=dtype)
        sub[path[-1]] = leaf
    return ParamTree(out, requires_grad)


def abstract_from_specs(specs: SpecTree, dtype=torch.bfloat16
                        ) -> Dict[str, Any]:
    """``meta`` tensors of every leaf's shape in ``dtype``: the dry-run's
    stand-ins (the reference's ``ShapeDtypeStruct``s); nothing is
    allocated."""
    return {k: (abstract_from_specs(v, dtype) if isinstance(v, dict)
                else torch.empty(v.shape, dtype=dtype, device="meta"))
            for k, v in specs.items()}


def shardings_from_specs(specs: SpecTree, env) -> Dict[str, Any]:
    """``env.sharding`` of every leaf (``distributed.sharding.Sharding``:
    the reference's spec and the DTensor placements), mirroring the
    tree."""
    return {k: (shardings_from_specs(v, env) if isinstance(v, dict)
                else env.sharding(v.shape, v.logical))
            for k, v in specs.items()}


def logical_axes_tree(specs: SpecTree) -> Dict[str, Any]:
    return {k: (logical_axes_tree(v) if isinstance(v, dict) else v.logical)
            for k, v in specs.items()}


def from_jax(params: Mapping[str, Any], *, device="cuda",
             dtype: Optional[torch.dtype] = None,
             requires_grad: bool = False) -> ParamTree:
    """Weights from the JAX package, as numpy arrays, into a ``ParamTree``.

    Takes either the flat-key format of ``repro.training.checkpoints``
    (``"params/blocks/attn/wq"``; keys outside ``params/`` are ignored when
    that prefix is present) or a nested dict of arrays (the param pytree
    after ``jax.device_get``). Layouts are kept as they are.
    """
    if any(isinstance(v, Mapping) for v in params.values()):
        flat = {"/".join(p): v for p, v in walk(params)}
    else:
        flat = dict(params)
    if any(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()
                if k.startswith("params/")}
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = torch.from_numpy(np.array(val, copy=True))
        node[parts[-1]] = t.to(device=device, dtype=dtype or t.dtype)
    return ParamTree(tree, requires_grad)


def unstack_layers(stacked: Mapping[str, Any], n: int) -> List[Dict[str, Any]]:
    """The ``n`` layers of a stacked block tree, as nested dicts of views.

    Each stacked leaf is unbound once: under autograd the backward of an
    unbind is one stack per leaf, where indexing layer by layer would make a
    full-size zero-filled gradient for every leaf in every layer."""
    out: List[Dict[str, Any]] = [{} for _ in range(n)]
    for k in stacked:
        v = stacked[k]
        parts = (unstack_layers(v, n) if isinstance(v, (Mapping, ParamTree))
                 else torch.unbind(v, 0))
        for layer, part in zip(out, parts):
            layer[k] = part
    return out
