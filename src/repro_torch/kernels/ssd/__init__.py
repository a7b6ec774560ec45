from repro_torch.kernels.ssd.ops import (  # noqa: F401
    ssd_decode_step,
    ssd_intra_chunk,
    ssd_scan,
)
from repro_torch.kernels.ssd.ref import ssd_sequential_ref  # noqa: F401
