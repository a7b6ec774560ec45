from repro_torch.kernels.logprob.ops import token_logprob_entropy  # noqa: F401
from repro_torch.kernels.logprob.ref import (  # noqa: F401
    token_logprob_entropy_bwd_ref,
    token_logprob_entropy_ref,
)
