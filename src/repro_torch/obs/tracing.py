"""Low-overhead span tracing with Chrome/Perfetto ``trace.json`` export.

Design constraints (the async loop is the hot path being measured):

* **Off by default, ~free when off.** ``span(...)`` checks one module
  global and whether ``torch.profiler`` is recording; with neither on it
  returns a shared no-op object: no allocation, no clock read.
  Instrumentation stays permanently in the library code.
* **One mechanism for both consumers.** Under an installed
  ``SpanTracer`` a span records a complete event; while ``torch.profiler``
  records, the same span also opens a ``torch.profiler.record_function``
  of its name, so a device profile carries the program's regions and the
  operations launched inside them.
* **Thread-aware.** Spans record the emitting thread; the rollout worker,
  the trainer loop, and benchmark threads land on separate Perfetto
  tracks (thread-name metadata events included), so the async
  interleaving A-3PO exploits is visually inspectable.
* **The profiler's clock.** Durations come from the monotonic
  ``time.perf_counter_ns``; exported timestamps are Unix-epoch
  microseconds (one ``time.time_ns`` anchor taken with a
  ``perf_counter_ns`` reading when the tracer is made), the basis of
  ``torch.profiler``'s host and CUPTI events (``kineto_results``). The
  export's ``metadata.t0_us`` is the install time on that clock. A
  profile's ``export_chrome_trace`` writes its ``ts`` relative to the
  ``baseTimeNanoseconds`` it records beside them: add that base, in
  microseconds, to each of its ``ts`` to lay it on the same timeline.
* **Causality.** ``flow_start``/``flow_end`` emit Chrome flow events
  (``ph: s/f``) that arrows a weight publish to the serving/rollout span
  that first ran under the published version.

Spans carry arbitrary key=value attributes (``args`` in the trace event),
e.g. per-span staleness, token counts, weight versions; the profiler's
copy of a span carries only its name.
"""
from __future__ import annotations

import functools
import json
import threading
import time
from typing import Any, Dict, List, Optional

import torch

# whether torch.profiler is recording on this thread: ~0.05 us a call,
# where an idle ``record_function`` costs microseconds
_profiling = torch._C._autograd._profiler_enabled

# ----------------------------------------------------------------- no-op path


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class _ProfiledSpan:
    """A span that also brackets its region with
    ``torch.profiler.record_function`` (the profiler is recording)."""

    __slots__ = ("_inner", "_rf")

    def __init__(self, inner, name: str):
        self._inner = inner
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        self._inner.__enter__()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self._inner.__exit__(*exc)
        return False

    def set(self, **attrs) -> None:
        self._inner.set(**attrs)


# ------------------------------------------------------------------- tracer
class _Span:
    """A live span; records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "_start_ns", "attrs")

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._start_ns = 0

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (token counts etc.)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self):
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._tracer._complete(self.name, self._start_ns, end, self.attrs)
        return False


class SpanTracer:
    """Collects trace events; exports Chrome trace-event JSON.

    Thread safe: each event append takes one lock. Events are plain dicts
    in the Chrome trace 'X'/'s'/'f'/'C'/'M' phases; ``export`` writes the
    JSON-object-with-``traceEvents`` flavor Perfetto and chrome://tracing
    both load.
    """

    def __init__(self, process_name: str = "repro-a3po"):
        # one anchor pair: offsets on the monotonic clock, placed on the
        # epoch that torch.profiler stamps
        self._t0_ns = time.perf_counter_ns()
        self._epoch0_ns = time.time_ns()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._tids: Dict[int, int] = {}
        self._flow_started: set = set()
        self.process_name = process_name
        self._events.append({
            "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
            "args": {"name": process_name}})

    # ------------------------------------------------------------- internals
    def _us(self, t_ns: int) -> float:
        """Unix-epoch microseconds of a ``perf_counter_ns`` reading."""
        return (self._epoch0_ns + (t_ns - self._t0_ns)) / 1e3

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[ident] = tid
            self._events.append({
                "ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                "args": {"name": threading.current_thread().name}})
        return tid

    def _complete(self, name: str, start_ns: int, end_ns: int,
                  attrs: Optional[Dict[str, Any]]) -> None:
        ev = {"ph": "X", "pid": 1, "name": name,
              "ts": self._us(start_ns),
              "dur": max((end_ns - start_ns) / 1e3, 0.001)}
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            ev["tid"] = self._tid()
            self._events.append(ev)

    # ------------------------------------------------------------------- api
    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs or None)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration marker ('i' phase)."""
        ev = {"ph": "i", "pid": 1, "name": name, "s": "t",
              "ts": self._us(time.perf_counter_ns())}
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            ev["tid"] = self._tid()
            self._events.append(ev)

    def counter(self, name: str, **values) -> None:
        """A counter-track sample ('C' phase) — e.g. queue depth."""
        ev = {"ph": "C", "pid": 1, "name": name,
              "ts": self._us(time.perf_counter_ns()),
              "args": {k: float(v) for k, v in values.items()}}
        with self._lock:
            ev["tid"] = self._tid()
            self._events.append(ev)

    def flow_start(self, name: str, flow_id: int, **attrs) -> None:
        """Open a flow arrow (must be emitted inside an open span)."""
        ev = {"ph": "s", "pid": 1, "name": name, "cat": "flow",
              "id": int(flow_id),
              "ts": self._us(time.perf_counter_ns())}
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            self._flow_started.add(int(flow_id))
            ev["tid"] = self._tid()
            self._events.append(ev)

    def flow_end(self, name: str, flow_id: int, **attrs) -> None:
        """Close a flow arrow; dropped if no matching ``flow_start``
        happened (e.g. resuming under the initial weights)."""
        with self._lock:
            if int(flow_id) not in self._flow_started:
                return
            ev = {"ph": "f", "pid": 1, "name": name, "cat": "flow",
                  "id": int(flow_id), "bp": "e",
                  "ts": self._us(time.perf_counter_ns()),
                  "tid": self._tid()}
            if attrs:
                ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
            self._flow_started.discard(int(flow_id))
            self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_dict(self) -> Dict[str, Any]:
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms",
                "metadata": {"process": self.process_name,
                             "clock": "unix_epoch_us",
                             "t0_us": self._epoch0_ns / 1e3}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        return float(v)  # numpy / torch scalars
    except (TypeError, ValueError):
        return str(v)


# ----------------------------------------------------------- module controls
_TRACER: Optional[SpanTracer] = None


def install_tracer(tracer: Optional[SpanTracer] = None
                   ) -> Optional[SpanTracer]:
    """Install (or, with ``None``, remove) the process-wide tracer."""
    global _TRACER
    _TRACER = tracer
    return tracer


def get_tracer() -> Optional[SpanTracer]:
    return _TRACER


def span(name: str, **attrs):
    """Context manager timing a region under the installed tracer and,
    while ``torch.profiler`` records, bracketing it with a
    ``record_function`` of the same name.

    With neither on this is one global load, one cheap check and a shared
    no-op object: safe to leave in hot loops.
    """
    t = _TRACER
    sp = _NOOP if t is None else t.span(name, **attrs)
    return _ProfiledSpan(sp, name) if _profiling() else sp


def instant(name: str, **attrs) -> None:
    """Zero-duration marker under the installed tracer (no-op otherwise) —
    fault injections, worker restarts, checkpoint restores."""
    t = _TRACER
    if t is not None:
        t.instant(name, **attrs)


def flow_start(name: str, flow_id: int, **attrs) -> None:
    t = _TRACER
    if t is not None:
        t.flow_start(name, flow_id, **attrs)


def flow_end(name: str, flow_id: int, **attrs) -> None:
    t = _TRACER
    if t is not None:
        t.flow_end(name, flow_id, **attrs)


def trace_span(name: Optional[str] = None, **attrs):
    """Decorator form of ``span`` (span name defaults to the function's
    qualified name)."""
    def deco(fn):
        sp_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            t = _TRACER
            if t is None:
                return fn(*a, **kw)
            with t.span(sp_name, **attrs):
                return fn(*a, **kw)
        return wrapped
    return deco


# ----------------------------------------------------- phase classification
# Canonical leaf spans per loop phase. Aggregations (the report CLI, the
# quick-bench breakdown) sum ONLY these names so nested wrappers (e.g. the
# orchestrator's outer "train_step" around the trainer's "train_update")
# are never double counted.
PHASE_SPANS: Dict[str, str] = {
    "rollout_generate": "rollout",
    "serve_generate": "rollout",
    "prefill": "prefill",
    "prefill_chunk": "prefill",
    "decode_step": "decode",
    "decode_horizon": "decode",
    "prox_forward": "train",
    "train_update": "train",
    "weight_publish": "publish",
}


def phase_breakdown(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Aggregate trace events into per-phase totals.

    Returns ``{phase: {"total_s", "count", "mean_ms"}}`` over the
    canonical ``PHASE_SPANS`` names.
    """
    acc: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        phase = PHASE_SPANS.get(ev.get("name", ""))
        if phase is None:
            continue
        acc.setdefault(phase, []).append(ev.get("dur", 0.0))
    out: Dict[str, Dict[str, float]] = {}
    for phase, durs in sorted(acc.items()):
        total_us = sum(durs)
        out[phase] = {"total_s": total_us / 1e6,
                      "count": float(len(durs)),
                      "mean_ms": total_us / 1e3 / max(len(durs), 1)}
    return out
