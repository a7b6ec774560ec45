"""Architecture registry: ``--arch <id>`` resolution (the paper's models
and the toy models; the assigned architectures come with later slices)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import paper_models
from repro_torch.configs.base import ModelConfig, reduced

REGISTRY: Dict[str, ModelConfig] = {
    "qwen2.5-1.5b": paper_models.QWEN25_1_5B,
    "qwen3-8b": paper_models.QWEN3_8B,
    "toy-20m": paper_models.TOY_20M,
    "toy-2m": paper_models.TOY_2M,
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return reduced(get_config(name[: -len("-reduced")]))
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
