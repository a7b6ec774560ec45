"""Logical-axis sharding on DeviceMesh / DTensor, the roofline and the
per-device cost census (``repro.distributed``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ShardingEnv,
    constrain,
    current_env,
    use_sharding,
)
