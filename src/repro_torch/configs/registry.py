"""Architecture registry: ``--arch <id>`` resolution (the paper's models,
the toy models, the four dense assigned architectures, and the SSM and
hybrid families; the MoE, MLA and frontend architectures, and with them
``ASSIGNED`` / ``list_archs``, come with a later slice)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (
    codeqwen1_5_7b,
    command_r_plus_104b,
    deepseek_coder_33b,
    granite_34b,
    mamba2_370m,
    paper_models,
    zamba2_1_2b,
)
from repro_torch.configs.base import ModelConfig, reduced

REGISTRY: Dict[str, ModelConfig] = {
    "qwen2.5-1.5b": paper_models.QWEN25_1_5B,
    "qwen3-8b": paper_models.QWEN3_8B,
    "toy-20m": paper_models.TOY_20M,
    "toy-2m": paper_models.TOY_2M,
    "mamba2-370m": mamba2_370m.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "command-r-plus-104b": command_r_plus_104b.CONFIG,
    "granite-34b": granite_34b.CONFIG,
    "deepseek-coder-33b": deepseek_coder_33b.CONFIG,
    "codeqwen1.5-7b": codeqwen1_5_7b.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return reduced(get_config(name[: -len("-reduced")]))
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
