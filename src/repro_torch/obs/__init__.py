"""Unified observability for the async-RL loop (``repro.obs``).

Three pillars, one import surface:

* ``obs.tracing`` — a low-overhead span tracer (``span(...)`` context
  manager, thread-aware, monotonic clocks) exporting Chrome/Perfetto
  ``trace.json``, with flow events tying a weight publish to the serving
  step that resumed under it, and ``torch.profiler`` brackets when
  profiling.
* ``obs.metrics`` — a process-wide metrics registry (Counter / Gauge /
  Histogram with labels); ``serving.metrics.ServingMetrics`` is a thin
  facade over it and training-side metrics land in the same registry, so
  one ``registry.snapshot()`` serves the orchestrator, benchmarks, and
  tests.
* ``obs.runlog`` — a schema-versioned JSONL run log (one record per
  training step) behind the ``--log-jsonl``/``--quiet`` CLI surface.

``python -m repro_torch.obs.report`` renders a run summary from the JSONL +
trace pair; ``python -m repro_torch.obs.validate`` is the CI schema gate.
"""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from repro_torch.obs.runlog import (
    RUNLOG_SCHEMA_VERSION,
    STEP_REQUIRED_KEYS,
    RunLogger,
    step_record_dict,
)
from repro_torch.obs.tracing import (
    SpanTracer,
    annotate,
    flow_end,
    flow_start,
    get_tracer,
    install_tracer,
    span,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RUNLOG_SCHEMA_VERSION",
    "RunLogger",
    "STEP_REQUIRED_KEYS",
    "SpanTracer",
    "annotate",
    "flow_end",
    "flow_start",
    "get_registry",
    "get_tracer",
    "install_tracer",
    "span",
    "step_record_dict",
]
