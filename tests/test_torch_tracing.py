"""The port's spans on the CPU: one ``span`` reaches both the installed
``SpanTracer`` and a recording ``torch.profiler``, and costs nothing with
neither on. ``Trainer.step`` splits ``train_update`` into the phase spans
``train_forward``, ``train_objective`` and ``train_backward`` (one each a
microbatch) and ``train_optimizer`` (one a minibatch); the tracer's export
is on the profiler's clock (Unix-epoch microseconds).
"""
import dataclasses
import json
import statistics
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.obs import tracing
from repro_torch.training import trainer as tr

B, T, NMB = 8, 12, 2
PHASES = ("train_forward", "train_objective", "train_backward")
NAMES = PHASES + ("train_optimizer", "train_update", "prox_forward")


def _batch(vocab: int) -> tr.TrainBatch:
    g = torch.Generator().manual_seed(3)
    mask = (torch.arange(T - 1)[None, :] >= 4).float().expand(B, -1)
    return tr.TrainBatch(
        tokens=torch.randint(4, vocab - 4, (B, T), generator=g),
        response_mask=mask.contiguous(),
        behav_logp=-torch.rand(B, T - 1, generator=g) * mask,
        versions=torch.zeros(B, dtype=torch.int32),
        rewards=torch.rand(B, generator=g))


def _step(algo: str, nmi: int = 1):
    cfg = dataclasses.replace(get_config("toy-2m"), dtype="float32")
    t = tr.Trainer(cfg, RLConfig(group_size=4, num_minibatches=NMB), algo,
                   num_microbatches=nmi)
    st = t.init_state(torch.Generator().manual_seed(0), device="cpu")
    return t.step(st, _batch(cfg.vocab_size))[1]


def _check_phases(events, algo: str, nmi: int) -> None:
    """``events``: (name, start, end) of every span of one step."""
    by = {n: [(t0, t1) for m, t0, t1 in events if m == n] for n in NAMES}
    for n in PHASES:
        assert len(by[n]) == NMB * nmi, n
    assert len(by["train_optimizer"]) == NMB
    assert len(by["prox_forward"]) == (1 if algo == "recompute" else 0)
    (u0, u1), = by["train_update"]
    for n in PHASES + ("train_optimizer",):
        assert all(u0 <= t0 <= t1 <= u1 for t0, t1 in by[n]), n
    for p0, p1 in by["prox_forward"]:
        assert p1 <= u0


CASES = [("a3po", 1), ("a3po", 2), ("recompute", 1), ("recompute", 2)]


@pytest.mark.parametrize("algo,nmi", CASES)
def test_profiler_alone_sees_the_step_phases(algo, nmi):
    assert tracing.get_tracer() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(algo, nmi)
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in NAMES]
    _check_phases(events, algo, nmi)


@pytest.mark.parametrize("algo,nmi", CASES)
def test_tracer_alone_sees_the_step_phases(algo, nmi):
    tracer = tracing.install_tracer(tracing.SpanTracer("t"))
    try:
        _step(algo, nmi)
    finally:
        tracing.install_tracer(None)
    events = [(e["name"], e["ts"], e["ts"] + e["dur"])
              for e in tracer.events()
              if e["ph"] == "X" and e["name"] in NAMES]
    _check_phases(events, algo, nmi)


def test_neither_on_enters_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        entered.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert tracing.get_tracer() is None
    assert tracing.span("x", a=1) is tracing.span("y")
    m = _step("recompute")
    assert entered == []
    assert m["prox_time_s"] > 0.0


def _shared_spans(n: int = 7):
    """``n`` spans under both a tracer and the profiler: the tracer's X
    events and the profiler."""
    tracer = tracing.install_tracer(tracing.SpanTracer("t"))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(n):
                with tracing.span("shared", a=i) as sp:
                    sp.set(b=2)
                    time.sleep(0.005)
    finally:
        tracing.install_tracer(None)
    evs = [e for e in tracer.events() if e.get("name") == "shared"]
    assert [e["args"] for e in evs] == [{"a": i, "b": 2} for i in range(n)]
    assert all(e["dur"] >= 5e3 for e in evs)
    return evs, prof


def _median_gaps_us(pairs):
    """Median |start gap| and |end gap| of (tracer event, start_us,
    end_us) pairs: one span preempted between the two clock reads
    cannot move it, an offset between the clocks does."""
    gaps = [(abs(s - e["ts"]), abs(t - e["ts"] - e["dur"]))
            for e, s, t in pairs]
    return (statistics.median(g[0] for g in gaps),
            statistics.median(g[1] for g in gaps))


def test_tracer_and_profiler_share_a_clock():
    """A span under both gives a tracer event and a profiler event of its
    name whose starts and ends lie within 1 ms of each other (the tracer
    once stamped from its own install, ~the Unix epoch away)."""
    evs, prof = _shared_spans()
    kin = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "shared"]
    assert len(kin) == len(evs)
    kin.sort(key=lambda e: e.start_ns())
    gaps = _median_gaps_us(
        (e, k.start_ns() / 1e3, k.end_ns() / 1e3) for e, k in zip(evs, kin))
    assert max(gaps) < 1e3, gaps


def test_chrome_export_shifted_by_its_base_lies_on_the_tracer(tmp_path):
    """``export_chrome_trace`` writes ``ts`` relative to its
    ``baseTimeNanoseconds``; shifted by that base, its spans lie on the
    tracer's export within 1 ms, so the two files share one timeline."""
    evs, prof = _shared_spans()
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        d = json.load(f)
    base_us = d["baseTimeNanoseconds"] / 1e3
    pev = sorted((e for e in d["traceEvents"]
                  if e.get("name") == "shared" and e.get("ph") == "X"),
                 key=lambda e: float(e["ts"]))
    assert len(pev) == len(evs)
    gaps = _median_gaps_us(
        (e, base_us + float(p["ts"]), base_us + float(p["ts"]) +
         float(p["dur"])) for e, p in zip(evs, pev))
    assert max(gaps) < 1e3, gaps


def test_profiler_alone_span_takes_attributes():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("alone", a=1) as sp:
            sp.set(b=2)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("alone") == 1


def test_export_is_on_the_epoch(tmp_path):
    tracer = tracing.SpanTracer("t")
    before_us = time.time_ns() / 1e3
    with tracer.span("x"):
        pass
    tracer.instant("i")
    after_us = time.time_ns() / 1e3
    path = tracer.export(str(tmp_path / "trace.json"))
    with open(path) as f:
        d = json.load(f)
    assert d["metadata"]["clock"] == "unix_epoch_us"
    stamped = [e for e in d["traceEvents"] if e["ph"] in ("X", "i")]
    assert len(stamped) == 2
    for e in stamped:
        assert before_us - 1e3 <= e["ts"] <= after_us + 1e3


@pytest.mark.parametrize("algo,prox", [("a3po", False), ("recompute", True)])
def test_prox_time_reads_zero_without_a_prox_forward(algo, prox):
    m = _step(algo)
    assert (m["prox_time_s"] > 0.0) is prox
    if not prox:
        assert m["prox_time_s"] == 0.0
