"""Seeded weights for a configuration, drawn on the device.

The shapes and initialisers come from the reference stack of the
configuration's ``arch`` (``reference/<arch>.py``: ``param_specs``), so
the weights are the benchmark's own input: the harness hands the same
tensors to the program and, drawn again from the same seed, to the
reference. Every normally distributed leaf comes from one ``randn`` call
in the stored dtype, sliced and scaled per leaf. ``weight_scale`` in the
configuration's file multiplies the leaves it names (patterns as
``fnmatch`` takes them): with the initialisers' small stds a random model
puts nearly all its probability on one token, and scaled layer weights
make its outputs depend on its inputs.
"""
from __future__ import annotations

import fnmatch
import math
from typing import Dict

import torch

from perfbench.reference.train import arch_module

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def std_of(shape, init: str, m: dict) -> float:
    if init == "normal_d":
        return m["d_model"] ** -0.5
    return math.prod(shape[:-1]) ** -0.5


def draw(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: tensor} in the configuration's dtype on ``device``."""
    specs = arch_module(m).param_specs(m)
    dtype = DTYPES[m["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = sorted(k for k, (_, init) in specs.items()
                    if init.startswith("normal"))
    n = sum(math.prod(specs[k][0]) for k in normal)
    buf = torch.randn(n, generator=gen, device=device, dtype=dtype)
    scale = m.get("weight_scale", {})
    out, at = {}, 0
    for k in sorted(specs):
        shape, init = specs[k]
        size = math.prod(shape)
        if init.startswith("normal"):
            factor = std_of(shape, init, m)
            if any(fnmatch.fnmatchcase(k, p)
                   for p in scale.get("leaves", ())):
                factor *= scale["factor"]
            out[k] = buf[at:at + size].view(shape).mul_(factor)
            at += size
        elif init == "ones":
            out[k] = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            out[k] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"{k}: unknown initialiser {init!r}")
    return out
