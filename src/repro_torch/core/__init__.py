"""The A-3PO objective and the algorithm registry (``repro.core``)."""
from repro_torch.core.a3po import (  # noqa: F401
    alpha_from_staleness,
    compute_prox_logp_approximation,
    compute_prox_logp_kl_adaptive,
    kl_adaptive_alpha,
    staleness,
)
from repro_torch.core.advantages import (  # noqa: F401
    broadcast_over_tokens,
    group_normalized_advantages,
)
from repro_torch.core.objective import (  # noqa: F401
    fused_a3po_loss,
    policy_objective,
    resolve_alpha,
)
from repro_torch.core.losses import (  # noqa: F401
    coupled_ppo_loss,
    decoupled_ppo_loss,
    policy_loss,
)
from repro_torch.core.algorithms import (  # noqa: F401
    Algorithm,
    LossInputs,
    available,
    get_algorithm,
    register,
    registry_table,
    resolve_algorithm,
)
