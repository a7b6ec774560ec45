"""Architecture registry: ``--arch <id>`` resolution
(``repro.configs.registry``)."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (
    codeqwen1_5_7b,
    command_r_plus_104b,
    deepseek_coder_33b,
    deepseek_v2_lite_16b,
    granite_34b,
    llava_next_mistral_7b,
    mamba2_370m,
    musicgen_large,
    paper_models,
    qwen3_moe_30b_a3b,
    zamba2_1_2b,
)
from repro_torch.configs.base import ModelConfig, reduced

# The 10 assigned architectures (public-literature pool).
ASSIGNED: Dict[str, ModelConfig] = {
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "granite-34b": granite_34b.CONFIG,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
    "musicgen-large": musicgen_large.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
    "mamba2-370m": mamba2_370m.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "deepseek-coder-33b": deepseek_coder_33b.CONFIG,
    "codeqwen1.5-7b": codeqwen1_5_7b.CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
}

# Paper experiment + toy models.
EXTRA: Dict[str, ModelConfig] = {
    "qwen2.5-1.5b": paper_models.QWEN25_1_5B,
    "qwen3-8b": paper_models.QWEN3_8B,
    "toy-20m": paper_models.TOY_20M,
    "toy-2m": paper_models.TOY_2M,
}

REGISTRY: Dict[str, ModelConfig] = {**ASSIGNED, **EXTRA}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return reduced(get_config(name[: -len("-reduced")]))
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs(assigned_only: bool = False) -> List[str]:
    return sorted(ASSIGNED if assigned_only else REGISTRY)
