"""The load harness of the PyTorch port (``repro_torch.loadgen``) against the
JAX package's, float32 on the CPU.

The tests of ``tests/test_loadgen.py`` with their own assertions kept:
seeded trace generation (deterministic, JSONL round trip), virtual-clock
replay determinism, the SLO shed / preempt policy against a stub engine,
an overloaded replay, and the CLI. Added: the trace and its JSONL equal
JAX's for the same seed; a replay's lifecycle records and summary equal
JAX's on the same weights (greedy decoding, so the tokens are the
engine's; JAX's paged engine is not deterministic where a slot is
mid-prefill beside a decode step, ROADMAP note e, which could move a
greedy token, and then only the fields the cost model decides would be
compared; on these traces every field agrees); the CLI run twice gives
byte-identical JSONL; a serving fault through the CLI; the cost fit; the
report's load table.
"""
import copy
import dataclasses
import filecmp
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.loadgen import harness as jharness
from repro.loadgen import traces as jtraces
from repro.models import model as jmodel
from repro.obs import report as jreport
from repro.obs.validate import validate_loadgen_jsonl as jvalidate_loadgen
from repro_torch.configs.registry import get_config
from repro_torch.loadgen.costfit import describe, fit_cost_model
from repro_torch.loadgen.harness import CostModel, VirtualClock, run_trace
from repro_torch.loadgen.slo import SLOAwareScheduler, SLOPolicy
from repro_torch.loadgen.traces import (
    DEFAULT_CLASSES,
    SLOClass,
    TraceConfig,
    load_trace,
    prompt_tokens,
    save_trace,
    synthesize,
)
from repro_torch.models.params import from_jax
from repro_torch.obs import report
from repro_torch.obs.validate import validate_loadgen_jsonl
from repro_torch.rollout.continuous import Request
from repro_torch.serving import SchedulerConfig


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def sides():
    """(jax cfg, jax params, torch cfg, torch params): the same weights."""
    jcfg = _f32(jax_get_config("toy-2m"))
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return (jcfg, jparams, _f32(get_config("toy-2m")),
            from_jax(jax.device_get(jparams), device="cpu"))


SMALL = TraceConfig(seed=3, duration_s=0.8, rate_rps=10.0, burstiness=0.6,
                    publish_every_s=0.5)


def _run(sides, trace, **kw):
    _, _, cfg, params = sides
    return run_trace(cfg, params, trace, device="cpu", **kw)


# ------------------------------------------------------------------- traces
def test_synthesize_deterministic_and_roundtrip(tmp_path):
    a = synthesize(SMALL)
    b = synthesize(SMALL)
    assert a.requests == b.requests and a.publishes == b.publishes
    assert len(a.requests) > 0 and a.publishes  # non-trivial workload
    # same request seed -> same tokens; schema roundtrips through JSONL
    t1 = prompt_tokens(a.requests[0], 128)
    t2 = prompt_tokens(b.requests[0], 128)
    np.testing.assert_array_equal(t1, t2)
    path = tmp_path / "trace.jsonl"
    save_trace(str(path), a)
    c = load_trace(str(path))
    assert c.requests == a.requests and c.publishes == a.publishes
    assert c.classes == a.classes
    assert c.meta["seed"] == SMALL.seed


def test_synthesize_seed_changes_workload():
    a = synthesize(SMALL)
    b = synthesize(TraceConfig(**{**SMALL.__dict__, "seed": 4}))
    assert [r.t_arrival_s for r in a.requests] != \
        [r.t_arrival_s for r in b.requests]


@pytest.mark.parametrize("seed", [0, 3])
def test_trace_jsonl_equals_jax(tmp_path, seed):
    """The same seed gives JAX's trace: the same arrivals, classes,
    publishes and prompt tokens, and a byte-identical trace JSONL."""
    cfg = dict(seed=seed, duration_s=2.0, rate_rps=6.0, burstiness=0.6,
               publish_every_s=2.0)
    ours = synthesize(TraceConfig(**cfg))
    ref = jtraces.synthesize(jtraces.TraceConfig(**cfg))
    save_trace(str(tmp_path / "t.jsonl"), ours)
    jtraces.save_trace(str(tmp_path / "j.jsonl"), ref)
    assert filecmp.cmp(tmp_path / "t.jsonl", tmp_path / "j.jsonl",
                       shallow=False)
    for a, b in zip(ours.requests, ref.requests):
        np.testing.assert_array_equal(prompt_tokens(a, 128),
                                      jtraces.prompt_tokens(b, 128))


# ------------------------------------------------------------------ harness
def test_replay_bit_deterministic(sides):
    """Two replays of the same trace produce identical lifecycle records
    and summaries — the acceptance bar for the committed JSONL."""
    trace = synthesize(SMALL)
    r1 = _run(sides, trace, policy="slo", max_seqs=2)
    r2 = _run(sides, trace, policy="slo", max_seqs=2)
    assert r1.records == r2.records
    assert r1.summary == r2.summary
    assert r1.steps == r2.steps
    # every submitted request reached a terminal outcome
    assert len(r1.records) == len(trace.requests)
    assert r1.summary["completed"] + r1.summary["dropped"] \
        == len(trace.requests)
    # lifecycle stamps are virtual and ordered
    for rec in r1.records:
        assert rec["t_submit_s"] >= rec["t_arrival_s"]
        if rec["outcome"] == "done":
            assert rec["t_done_s"] >= rec["t_first_token_s"] >= \
                rec["t_submit_s"] - 1e-9
            assert rec["tokens"] > 0


@pytest.mark.parametrize("policy", ["slo", "fifo"])
def test_replay_equals_jax(sides, policy):
    """The same trace and weights through both packages' harnesses: the
    same lifecycle records (virtual stamps, outcomes, token counts), the
    same summary and step count."""
    jcfg, jparams, _, _ = sides
    trace = synthesize(SMALL)
    jtrace = jtraces.synthesize(jtraces.TraceConfig(**SMALL.__dict__))
    ours = _run(sides, trace, policy=policy, max_seqs=2)
    ref = jharness.run_trace(jcfg, jparams, jtrace, policy=policy,
                             max_seqs=2)
    assert ours.records == ref.records
    assert ours.summary == ref.summary
    assert ours.steps == ref.steps


def test_replay_honors_publish_events(sides):
    """Weight-publish events advance the store version at their virtual
    timestamps; requests decoded after the publish carry fresher stamps."""
    trace = synthesize(SMALL)
    res = _run(sides, trace, policy="priority", max_seqs=2)
    assert res.summary["publishes"] == len(trace.publishes) == 1
    versions = {v for r in res.finished for v in r.token_versions}
    assert 1 in versions  # post-publish tokens stamped at v1


def test_virtual_clock_cost_model():
    clk = VirtualClock()
    cost = CostModel(step_overhead_s=0.01, prefill_chunk_s=0.1,
                     decode_token_s=0.001)
    clk.advance(cost.step_cost(chunks=2, tokens=8))
    assert clk.now == pytest.approx(0.01 + 0.2 + 0.008)
    clk.advance_to(0.1)  # never goes backwards
    assert clk.now == pytest.approx(0.218)


# --------------------------------------------------------------- SLO policy
class _StubEngine:
    """blocks_needed/allocator surface only — no pools."""

    class _Alloc:
        n_free = 1 << 20

    allocator = _Alloc()

    def blocks_needed(self, prompt, max_new):
        return 1


def _policy(**kw):
    base = dict(classes=DEFAULT_CLASSES, est_fixed_s=0.0,
                est_s_per_token=0.0)
    base.update(kw)
    return SLOPolicy(**base)


def _req(rid, *, priority=0, t_submit=0.0, prompt_len=8):
    r = Request(rid, np.arange(4, 4 + prompt_len, dtype=np.int32), 4,
                priority=priority)
    r.t_submit = t_submit
    return r


def test_slo_shed_past_deadline():
    """A queued request whose TTFT deadline has passed is shed (reason
    slo_shed), never admitted; one still inside its deadline pops."""
    sched = SLOAwareScheduler(SchedulerConfig(d_max=100), _policy())
    hopeless = _req(1, priority=0, t_submit=0.0)    # interactive: 0.25s
    viable = _req(2, priority=2, t_submit=0.9)      # bulk: 3.0s
    sched.enqueue(hopeless, now_s=0.0)
    sched.enqueue(viable, now_s=0.9)
    got = sched.pop_admissible(0, engine=_StubEngine(), now_s=1.0)
    assert got is not None and got[0].rid == 2
    assert sched.sheds == 1
    dropped = sched.take_dropped()
    assert [r.rid for r in dropped] == [1]
    assert dropped[0].drop_reason == "slo_shed"


def test_slo_shed_accounts_for_prefill_estimate():
    """Shedding is predictive: a request that would miss its deadline by
    the time prefill finishes is hopeless even before the deadline."""
    pol = _policy(est_fixed_s=0.0, est_s_per_token=0.01)  # 32 tok = 0.32s
    sched = SLOAwareScheduler(SchedulerConfig(d_max=100), pol)
    sched.enqueue(_req(1, priority=0, t_submit=0.0, prompt_len=32),
                  now_s=0.0)
    # now=0.1 < deadline=0.25, but 0.1 + 0.32 > 0.25 -> shed
    assert sched.pop_admissible(0, engine=_StubEngine(), now_s=0.1) is None
    assert sched.take_dropped()[0].drop_reason == "slo_shed"


def test_slo_overload_preemption_picks_lowest_class():
    """With no free slot and an urgent head-of-queue out of slack, the
    least-urgent in-flight slot is preempted with reason slo_overload."""
    sched = SLOAwareScheduler(SchedulerConfig(d_max=100), _policy())
    head = _req(1, priority=0, t_submit=0.0)  # deadline 0.25
    sched.enqueue(head, now_s=0.0)
    slots = {0: _req(10, priority=1, t_submit=0.0),
             1: _req(11, priority=2, t_submit=0.0),
             2: None}
    # slack = 0.25 - 0.2 = 0.05 < 0.25 * 0.25
    out = sched.check_preempt(slots, 0, now_s=0.2, free_slots=0)
    assert out == [1]
    assert sched.preempt_reasons[1] == "slo_overload"
    assert sched.slo_preempts == 1


def test_slo_no_preempt_with_free_slots_or_slack():
    sched = SLOAwareScheduler(SchedulerConfig(d_max=100), _policy())
    sched.enqueue(_req(1, priority=0, t_submit=0.0), now_s=0.0)
    slots = {0: _req(10, priority=2, t_submit=0.0)}
    # free slot available -> admission handles it, no preemption
    assert sched.check_preempt(slots, 0, now_s=0.2, free_slots=1) == []
    # plenty of slack -> no preemption either
    assert sched.check_preempt(slots, 0, now_s=0.01, free_slots=0) == []
    # equal-or-higher class in flight is never a victim
    sched2 = SLOAwareScheduler(SchedulerConfig(d_max=100), _policy())
    sched2.enqueue(_req(1, priority=1, t_submit=0.0), now_s=0.0)
    slots2 = {0: _req(10, priority=0, t_submit=0.0),
              1: _req(11, priority=1, t_submit=0.0)}
    assert sched2.check_preempt(slots2, 0, now_s=0.74,
                                free_slots=0) == []


def test_deadline_preserved_across_requeue():
    """A preempt-requeue keeps the original absolute deadline: the client
    has been waiting since the first submit."""
    sched = SLOAwareScheduler(
        SchedulerConfig(d_max=100, max_preempts=4), _policy())
    req = _req(1, priority=0, t_submit=0.0)
    sched.enqueue(req, now_s=0.0)
    d0 = req.deadline_s
    assert d0 == pytest.approx(0.25)
    got = sched.pop_admissible(0, engine=_StubEngine(), now_s=0.01)
    assert got is not None
    assert sched.handle_preempted(req, 0, now_s=0.05) == "requeue"
    assert req.deadline_s == pytest.approx(d0)


def test_slo_run_sheds_under_overload(sides):
    """End-to-end: an overloaded replay under the slo policy sheds
    hopeless requests (counted per-reason) instead of serving them late;
    fifo on the same trace serves everything late instead."""
    classes = (SLOClass("interactive", 0, ttft_slo_s=0.08, e2e_slo_s=2.0,
                        share=0.5, max_new=4),
               SLOClass("bulk", 2, ttft_slo_s=0.3, e2e_slo_s=8.0,
                        share=0.5, max_new=8))
    trace = synthesize(TraceConfig(seed=1, duration_s=1.0, rate_rps=25.0,
                                   burstiness=0.5), classes)
    cost = CostModel(step_overhead_s=0.01, prefill_chunk_s=0.02,
                     decode_token_s=0.01)
    slo = _run(sides, trace, policy="slo", cost=cost, max_seqs=2)
    fifo = _run(sides, trace, policy="fifo", cost=cost, max_seqs=2)
    assert slo.summary["serving"]["drops_slo_shed"] > 0
    assert slo.summary["serving"]["drops_slo_shed"] == \
        slo.summary["dropped"] == len(slo.dropped)
    assert fifo.summary["serving"]["drops_slo_shed"] == 0
    # shedding is what buys the attainment: the slo policy completes its
    # survivors inside the SLO at a higher rate than fifo completes at all
    s_i = slo.summary["classes"]["interactive"]
    f_i = fifo.summary["classes"]["interactive"]
    assert s_i["slo_attainment"] > f_i["slo_attainment"]


# ---------------------------------------------------------------------- CLI
def _cli(tmp_path, name, *extra):
    from repro_torch.loadgen.__main__ import main
    out = tmp_path / f"{name}.jsonl"
    rc = main(["--device", "cpu", "--trace", "synthetic", "--seed", "0",
               "--quick", "--policy", "slo", "--jsonl", str(out), "--quiet",
               *extra])
    assert rc == 0
    return out


def test_cli_smoke_and_validation(tmp_path):
    """The CLI twice with the same seed: byte-identical lifecycle JSONL,
    valid under the port's and the reference's validators."""
    out = _cli(tmp_path, "a", "--save-trace", str(tmp_path / "trace.jsonl"))
    again = _cli(tmp_path, "b")
    assert filecmp.cmp(out, again, shallow=False)
    assert validate_loadgen_jsonl(str(out), min_requests=5) == []
    assert jvalidate_loadgen(str(out), min_requests=5) == []
    reloaded = load_trace(str(tmp_path / "trace.jsonl"))
    assert len(reloaded.requests) > 0


def test_cli_serving_fault(tmp_path):
    """``--fault kv_exhaust@…`` and ``nan_logits@…`` through the CLI: the
    replay still ends every request, the JSONL stays valid, and the
    summary's counters record what the faults cost."""
    out = _cli(tmp_path, "f", "--fault", "kv_exhaust@2x4:6",
               "--fault", "nan_logits@3")
    assert validate_loadgen_jsonl(str(out), min_requests=5) == []
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    summary = [r for r in recs if r["kind"] == "load_summary"][0]
    assert summary["completed"] + summary["dropped"] == summary["requests"]


def test_cli_refuses_full_scale_on_cpu(tmp_path):
    from repro_torch.loadgen.__main__ import main
    with pytest.raises(SystemExit, match="full-scale"):
        main(["--device", "cpu", "--arch", "qwen2.5-1.5b", "--quick",
              "--jsonl", str(tmp_path / "x.jsonl"), "--quiet"])


def test_render_load_matches_reference(sides):
    res = _run(sides, synthesize(SMALL), policy="slo", max_seqs=2)
    assert report.render_load(res.summary) == \
        jreport.render_load(res.summary)


def test_cost_fit_on_cpu(sides):
    """The fit runs the engine's prefill and two decode horizons and gives
    positive coefficients a replay can run on (a CPU fit prices the CPU,
    never the card)."""
    _, _, cfg, params = sides
    cost = fit_cost_model(cfg, params, max_seqs=2, decode_horizon=2,
                          repeats=2, device="cpu")
    assert min(cost.step_overhead_s, cost.prefill_chunk_s,
               cost.decode_token_s) > 0
    assert all(math.isfinite(v) for v in dataclasses.astuple(cost))
    assert "overhead=" in describe(cost)


# ----------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_loadgen.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replay_on_card_matches_cpu(cuda_device, sides):
    """The replay on the card (paged decode and prefill kernels) gives
    the CPU replay's lifecycle records and summary."""
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.prefill_attn import ops as pops
    _, _, cfg, params = sides
    trace = synthesize(SMALL)
    d0, p0 = dops.LAUNCHES, pops.LAUNCHES
    card = run_trace(cfg, copy.deepcopy(params).to(cuda_device), trace,
                     policy="slo", max_seqs=2, device=cuda_device)
    assert dops.LAUNCHES > d0 and pops.LAUNCHES > p0
    cpu = run_trace(cfg, params, trace, policy="slo", max_seqs=2,
                    device="cpu")
    assert card.records == cpu.records and card.summary == cpu.summary
