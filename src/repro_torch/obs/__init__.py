"""Span tracing (a copy of ``repro.obs.tracing``, annotated for
``torch.profiler``)."""
from repro_torch.obs.tracing import (
    SpanTracer,
    annotate,
    get_tracer,
    install_tracer,
    span,
)

__all__ = ["SpanTracer", "annotate", "get_tracer", "install_tracer", "span"]
