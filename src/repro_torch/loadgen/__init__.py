"""Trace-driven multi-tenant load harness over the serving control plane
(``repro.loadgen``).

``traces`` synthesizes (or loads) versioned workload traces — bursty
arrivals, tenant mix, priority classes with SLO targets, weight-publish
events. ``harness`` replays them on a virtual clock through
``ServingControlPlane`` and records per-request lifecycles. ``slo``
turns the per-class SLO targets into scheduling policy (deadline-aware
shedding + overload preemption).

CLI: ``python -m repro_torch.loadgen --trace synthetic --seed 0`` (on the
card; ``--device cpu`` for the CPU).
"""
from repro_torch.loadgen.traces import (
    DEFAULT_CLASSES,
    TRACE_SCHEMA_VERSION,
    PublishEvent,
    SLOClass,
    Trace,
    TraceConfig,
    TraceRequest,
    load_trace,
    prompt_tokens,
    save_trace,
    synthesize,
)

__all__ = [
    "DEFAULT_CLASSES",
    "PublishEvent",
    "SLOClass",
    "TRACE_SCHEMA_VERSION",
    "Trace",
    "TraceConfig",
    "TraceRequest",
    "load_trace",
    "prompt_tokens",
    "save_trace",
    "synthesize",
]
