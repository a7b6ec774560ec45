"""Parameter spec trees and the module that holds the weights.

Model code declares parameters as nested dicts of ``ParamSpec`` (shape +
logical axis names + init kind), as in ``repro.models.params``. Weights keep
the JAX package's layouts (``wq [L,d,H,hd]``, ``wo [L,H,hd,d]``, layer axis
first), so the einsums of the port read like the reference's.

``ParamTree`` is the ``nn.Module`` that holds them: one submodule per dict
level, one frozen ``nn.Parameter`` per leaf, and ``tree["blocks"]["attn"]``
indexing, so the functional model code takes either it or a plain dict.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
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


def stack_specs(spec: SpecTree, n: int, axis_name: str = "layers") -> SpecTree:
    """Prepend a stacked (layer) axis to every leaf of a block spec tree."""
    return {k: (stack_specs(v, n, axis_name) if isinstance(v, dict)
                else ParamSpec((n,) + v.shape, (axis_name,) + v.logical,
                               v.init, v.scale))
            for k, v in spec.items()}


def _init_leaf(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=generator.device)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=generator.device)
    if spec.init != "normal":
        raise ValueError(f"init {spec.init!r} is not ported yet")
    std = spec.scale if spec.scale is not None else _fan_in(spec.shape) ** -0.5
    return torch.randn(spec.shape, generator=generator,
                       device=generator.device) * std


class ParamTree(nn.Module):
    """Nested weights: a submodule per dict level, a frozen parameter per
    leaf. ``tree[key]`` returns the child (subtree or tensor)."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v), requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters

    def __iter__(self):
        return iter(sorted(list(self._modules) + list(self._parameters)))


def init_from_specs(specs: SpecTree, generator: torch.Generator, *,
                    device="cuda", dtype=torch.bfloat16) -> ParamTree:
    """Draw every leaf in sorted-path order from ``generator`` (in float32
    on the generator's device), scale by the reference's std, then cast to
    ``dtype`` on ``device``. The values are not the JAX package's (its
    threefry draws are not reproduced); the distributions are."""
    out: Dict[str, Any] = {}
    for path, spec in walk(specs):
        sub = out
        for p in path[:-1]:
            sub = sub.setdefault(p, {})
        sub[path[-1]] = _init_leaf(spec, generator).to(device=device,
                                                       dtype=dtype)
    return ParamTree(out)


def from_jax(params: Mapping[str, Any], *, device="cuda",
             dtype: Optional[torch.dtype] = None) -> ParamTree:
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
    return ParamTree(tree)


def layer_slice(stacked: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked block tree, as a nested dict of views."""
    out = {}
    for k in stacked:
        v = stacked[k]
        out[k] = (layer_slice(v, i) if isinstance(v, (Mapping, ParamTree))
                  else v[i])
    return out
