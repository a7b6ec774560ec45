"""Staleness-aware rollout control plane (scheduler / interrupts /
prefix cache / metrics) between the async orchestrator and the
continuous-batching engine (``repro.serving``)."""
from repro_torch.serving.control_plane import ServingControlPlane
from repro_torch.serving.interrupts import InterruptController, InterruptEvent
from repro_torch.serving.metrics import Histogram, ServingMetrics
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.scheduler import AdmissionScheduler, SchedulerConfig

__all__ = [
    "AdmissionScheduler",
    "Histogram",
    "InterruptController",
    "InterruptEvent",
    "RadixPrefixCache",
    "SchedulerConfig",
    "ServingControlPlane",
    "ServingMetrics",
]
