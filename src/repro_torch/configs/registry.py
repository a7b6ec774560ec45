"""Architecture registry: ``--arch <id>`` resolution (the paper's models,
the toy models, and the SSM and hybrid families; the other assigned
architectures come with later slices)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import mamba2_370m, paper_models, zamba2_1_2b
from repro_torch.configs.base import ModelConfig, reduced

REGISTRY: Dict[str, ModelConfig] = {
    "qwen2.5-1.5b": paper_models.QWEN25_1_5B,
    "qwen3-8b": paper_models.QWEN3_8B,
    "toy-20m": paper_models.TOY_20M,
    "toy-2m": paper_models.TOY_2M,
    "mamba2-370m": mamba2_370m.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return reduced(get_config(name[: -len("-reduced")]))
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
