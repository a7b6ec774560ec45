from repro_torch.kernels.a3po_loss.ops import (  # noqa: F401
    a3po_loss_fused,
    a3po_objective,
    a3po_objective_reduced,
)
from repro_torch.kernels.a3po_loss.ref import (  # noqa: F401
    REDUCED_KEYS,
    a3po_loss_ref,
)
