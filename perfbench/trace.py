"""The device trace of a traced window, read from ``torch.profiler``'s raw
events in integer nanoseconds (float64 microseconds since the epoch
round to 0.25 us).

Device events are the operations that ran on the card; busy time is the
union of their intervals. Host events are the CPU ops, spans and CUDA
API calls, each with its thread; a device event's launch is the API
call that carries its correlation id. Building ``prof.events()`` (every
CPU op's FunctionEvent and the op tree) is not needed and takes tens of
seconds for a training step, so it is never called.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple


class Trace:
    def __init__(self, device: List[tuple], host: List[tuple],
                 window_s: float):
        # (start_ns, end_ns, name, correlation id), sorted by start
        self.device = sorted(device)
        # (start_ns, end_ns, name, thread, correlation id)
        self.host = host
        self.window_s = window_s
        self.launch = {c: (t0, tid) for t0, _, name, tid, c in host
                       if c and _is_api(name)}

    def busy_ns(self, events: Optional[Iterable[tuple]] = None) -> int:
        """Length of the union of the events' intervals (all by default)."""
        busy, end = 0, None
        for t0, t1, *_ in sorted(self.device if events is None else events):
            if end is None or t0 > end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy

    def by_name(self) -> Dict[str, Tuple[int, int]]:
        """{name: (device ns, count)}."""
        out: Dict[str, list] = defaultdict(lambda: [0, 0])
        for t0, t1, name, _ in self.device:
            out[name][0] += t1 - t0
            out[name][1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    def launched_within(self, host_name: str) -> List[tuple]:
        """Device events launched (by an API call on the same thread)
        inside a host event whose name contains ``host_name``."""
        spans: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for t0, t1, name, tid, _ in self.host:
            if host_name in name:
                spans[tid].append((t0, t1))
        for v in spans.values():
            v.sort()
        out = []
        for ev in self.device:
            at = self.launch.get(ev[3])
            if at is None or at[1] not in spans:
                continue
            s = spans[at[1]]
            i = bisect.bisect_right(s, (at[0], float("inf"))) - 1
            if i >= 0 and s[i][0] <= at[0] <= s[i][1]:
                out.append(ev)
        return out

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time between consecutive busy intervals, summed by
        what the host was doing in the middle of each gap: the innermost
        host op, on the thread that launched the operation ending the
        gap, that encloses the gap's midpoint. Largest first."""
        gaps, end = [], None
        for t0, t1, _, corr in self.device:
            if end is not None and t0 > end:
                gaps.append(((t0 + end) // 2, t0 - end, corr))
            end = t1 if end is None else max(end, t1)
        by_tid: Dict[int, List[tuple]] = defaultdict(list)
        for t0, t1, name, tid, _ in self.host:
            if not _is_api(name):
                by_tid[tid].append((t0, -t1, name))
        queries: Dict[int, List[tuple]] = defaultdict(list)
        label: Dict[str, int] = defaultdict(int)
        for mid, ns, corr in gaps:
            at = self.launch.get(corr)
            if at is None:
                label["(launch not traced)"] += ns
            else:
                queries[at[1]].append((mid, ns))
        for tid, qs in queries.items():
            evs = sorted(by_tid.get(tid, ()))
            stack: List[tuple] = []
            i = 0
            for mid, ns in sorted(qs):
                while i < len(evs) and evs[i][0] <= mid:
                    t0, neg_t1, name = evs[i]
                    while stack and stack[-1][0] < t0:
                        stack.pop()
                    stack.append((-neg_t1, name))
                    i += 1
                while stack and stack[-1][0] < mid:
                    stack.pop()
                label[stack[-1][1] if stack else "(python, no op)"] += ns
        rows = sorted(label.items(), key=lambda kv: -kv[1])[:top]
        return [[k[:120], v / 1e9] for k, v in rows]

    def top_ops(self, top: int = 10) -> List[list]:
        rows = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])
        return [[k[:120], v[0] / 1e9] for k, v in rows[:top]]


# the prefix of the harness's own spans (``record_function``)
SPAN = "bench."


def _is_api(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and "::" not in name


def read(prof, window_s: float) -> Trace:
    """The raw events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.is_hidden_event():
            continue
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation() or ev.name().startswith(SPAN):
                continue  # a span's device-side range is no operation
            device.append((ev.start_ns(), ev.end_ns(), ev.name(),
                           ev.correlation_id()))
        else:
            host.append((ev.start_ns(), ev.end_ns(), ev.name(),
                         ev.start_thread_id(), ev.correlation_id()))
    return Trace(device, host, window_s)
