from repro_torch.kernels.a3po_loss.ops import (  # noqa: F401
    a3po_loss_fused,
    a3po_objective,
)
from repro_torch.kernels.a3po_loss.ref import a3po_loss_ref  # noqa: F401
