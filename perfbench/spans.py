"""Device time of the operations launched inside one of the program's
spans (``obs/tracing.py``'s ``span``, which opens a
``torch.profiler.record_function`` of its name while the profiler records).

An operation belongs to a span when the API call that launched it falls
inside one of that span's host intervals, on any thread: autograd runs a
CUDA backward node on its own device thread, not on the thread that
called ``autograd.grad``. The traced steps run one trainer thread, so an
interval holds only its own step's launches. Only device time is read:
the profiler's host cost stretches a traced step's wall time.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def intervals(trace, name: str) -> List[Tuple[int, int]]:
    """The host intervals of the spans called ``name``, merged and
    sorted."""
    out: List[Tuple[int, int]] = []
    for t0, t1, *_ in sorted(e for e in trace.host if e[2] == name):
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def launched_in(trace, name: str) -> Optional[List[tuple]]:
    """Device events whose launch falls inside a span called ``name``;
    None where the trace holds no such span."""
    spans = intervals(trace, name)
    if not spans:
        return None
    starts = [s[0] for s in spans]
    out = []
    for ev in trace.device:
        at = trace.launch.get(ev[3])
        if at is None:
            continue
        i = bisect.bisect_right(starts, at[0]) - 1
        if i >= 0 and at[0] <= spans[i][1]:
            out.append(ev)
    return out


def device_ms_per_step(run, name: str) -> Optional[float]:
    """Device time a traced step, in ms, of the operations launched
    inside the span ``name``: None without a trace, device events or the
    span."""
    tr = run.trace
    if tr is None or not tr.device or not run.traced_steps:
        return None
    evs = launched_in(tr, name)
    if evs is None:
        return None
    return sum(e[1] - e[0] for e in evs) / 1e6 / len(run.traced_steps)
