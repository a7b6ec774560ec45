"""Thin compatibility layer over ``core.objective`` / ``core.algorithms``
(``repro.core.losses``): the original import surface (``policy_loss`` and
the two modular losses); stringly-typed ``method`` dispatch through it
resolves via the Algorithm registry and emits a ``DeprecationWarning``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RLConfig
from repro_torch.core.algorithms import (  # noqa: F401
    Algorithm,
    LossInputs,
    get_algorithm,
    resolve_algorithm,
)
from repro_torch.core.objective import (  # noqa: F401
    Metrics,
    coupled_ppo_loss,
    decoupled_ppo_loss,
    policy_objective,
)


def policy_loss(
    method,
    logp: torch.Tensor,
    behav_logp: torch.Tensor,
    advantages: torch.Tensor,
    mask: torch.Tensor,
    cfg: RLConfig,
    *,
    versions: Optional[torch.Tensor] = None,
    current_version=None,
    recomputed_prox_logp: Optional[torch.Tensor] = None,
    entropy: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Legacy dispatch: ``method`` may be an ``Algorithm`` or a registry
    name. Delegates to ``objective.policy_objective`` (names warn)."""
    return policy_objective(
        method, logp, behav_logp, advantages, mask, cfg,
        versions=versions, current_version=current_version,
        recomputed_prox_logp=recomputed_prox_logp, entropy=entropy)
