"""Async RL runtime (``repro.async_rl``): the rollout queue, the weight
store, the threaded orchestrator and the deterministic simulation."""
from repro_torch.async_rl.buffer import RolloutQueue  # noqa: F401
from repro_torch.async_rl.orchestrator import (  # noqa: F401
    AsyncOrchestrator,
    StepRecord,
    simulate_async,
)
from repro_torch.async_rl.weights import WeightStore  # noqa: F401
