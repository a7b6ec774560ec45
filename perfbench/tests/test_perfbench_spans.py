"""The readers of the program's phase spans on a synthetic trace: an
operation counts toward the span whose host interval holds its launch,
on any thread (autograd launches the backward from its own thread), and
toward no span where its launch lies outside them all."""
from types import SimpleNamespace

import pytest

from perfbench import harness, spans
from perfbench.trace import Trace

READERS = {"train_forward_ms": "train_forward",
           "train_objective_ms": "train_objective",
           "train_backward_ms": "train_backward",
           "optimizer_ms": "train_optimizer"}
MAIN, AUTOGRAD = 11, 12


def _trace() -> Trace:
    """Two traced steps; host ns on the trainer thread (MAIN) and
    autograd's device thread (AUTOGRAD); each launch is a
    ``cudaLaunchKernel`` with the device event's correlation id."""
    host, device = [], []
    corr = [0]

    def launch(at, tid, dur):
        corr[0] += 1
        host.append((at, at + 5, "cudaLaunchKernel", tid, corr[0]))
        device.append((at + 50, at + 50 + dur, f"k{corr[0]}", corr[0]))

    for base in (0, 10_000):
        host.append((base, base + 9_000, "train_update", MAIN, 0))
        host.append((base + 100, base + 1_000, "train_forward", MAIN, 0))
        launch(base + 200, MAIN, 300)
        host.append((base + 1_000, base + 1_500, "train_objective", MAIN, 0))
        launch(base + 1_100, MAIN, 20)
        host.append((base + 2_000, base + 5_000, "train_backward", MAIN, 0))
        launch(base + 2_500, AUTOGRAD, 700)   # autograd's thread
        launch(base + 3_000, AUTOGRAD, 100)
        host.append((base + 6_000, base + 8_000, "train_optimizer", MAIN, 0))
        launch(base + 6_100, MAIN, 200)
        launch(base + 8_500, MAIN, 1_000)     # inside no phase span
    return Trace(device, host, 1.0)


def _run(trace, steps=2):
    return SimpleNamespace(trace=trace, traced_steps=[{}] * steps)


@pytest.mark.parametrize("metric,want_ns", [
    ("train_forward_ms", 300), ("train_objective_ms", 20),
    ("train_backward_ms", 800), ("optimizer_ms", 200)])
def test_reader_counts_launches_inside_its_span(metric, want_ns):
    got = harness.reader(metric)(_run(_trace()))
    assert got == pytest.approx(want_ns / 1e6)


def test_launch_on_another_thread_counts_and_outside_counts_nowhere():
    tr = _trace()
    inside = {e[2] for n in READERS.values() for e in spans.launched_in(
        tr, n)}
    assert {"k3", "k4", "k9", "k10"} <= inside  # autograd's thread
    assert "k6" not in inside and "k12" not in inside  # after every span
    # thread-matched attribution would miss the backward entirely
    assert tr.launched_within("train_backward") == []


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_without_a_trace_or_span_returns_none(metric):
    read = harness.reader(metric)
    assert read(_run(None)) is None
    assert read(_run(Trace([], [], 1.0))) is None
    tr = _trace()
    parent = Trace(tr.device, [e for e in tr.host
                               if e[2] != READERS[metric]], 1.0)
    assert read(_run(parent)) is None   # a program without the span
    assert read(_run(tr, steps=0)) is None


def test_nested_intervals_merge():
    tr = Trace([], [(0, 10, "s", 1, 0), (5, 20, "s", 2, 0),
                    (30, 40, "s", 1, 0), (12, 14, "t", 1, 0)], 1.0)
    assert spans.intervals(tr, "s") == [(0, 20), (30, 40)]
