"""Virtual-clock trace replay over the serving control plane
(``repro.loadgen.harness``).

The harness is the "millions of users" instrument: it feeds a trace's
arrivals into ``ServingControlPlane.submit`` at their timestamps, drives
``step()`` to completion, and replays weight-publish events — all on a
**virtual clock**, so a run is a deterministic function of (trace, model,
policy): the clock advances by a fixed cost model per control-plane step
(overhead + per-prefill-chunk + per-decoded-token) instead of wall time,
and every request-lifecycle stamp (submit → admit → first token → done,
preempt/drop reasons) is in virtual seconds. Two runs of the same trace
produce byte-identical lifecycle JSONL.

Per-request lifecycle flows out three ways:

* ``obs.tracing`` spans: one ``request`` span per request (real wall
  clock, for Perfetto), inside a ``load_replay`` wrapper;
* per-class labeled ``serving_*`` histograms/counters in the
  ``obs.metrics`` registry (``serving_ttft_seconds{class="..."}``, ...);
* schema-versioned JSONL via ``obs.runlog`` (``kind="request"`` records
  + one ``kind="load_summary"`` with the per-class SLO table that
  ``repro_torch.obs.report`` renders).

TTFT/E2E here are *virtual*: queueing + simulated service time. The
granularity is one control-plane step (the clock advances at step
boundaries), which cancels out in policy comparisons.

The engine runs on ``device`` (the card unless the caller asks for the
CPU) and decodes greedily; every step is handed one ``torch.Generator``
seeded from ``seed``, where the reference splits a JAX key per step.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch.async_rl.weights import WeightStore
from repro_torch.loadgen.traces import (
    TRACE_SCHEMA_VERSION,
    Trace,
    TraceRequest,
    prompt_tokens,
)
from repro_torch.loadgen.slo import SLOAwareScheduler, SLOPolicy
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.runlog import RUNLOG_SCHEMA_VERSION, RunLogger
from repro_torch.obs.tracing import span
from repro_torch.rollout.continuous import ContinuousBatchingEngine, Request
from repro_torch.serving import (
    AdmissionScheduler,
    SchedulerConfig,
    ServingControlPlane,
)

# virtual-seconds bucket ladders for the per-class labeled histograms
TTFT_BOUNDS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0)
E2E_BOUNDS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0)

POLICIES = ("slo", "priority", "fifo")


class VirtualClock:
    """Deterministic replay clock; calling it is the control-plane clock
    protocol (``ServingControlPlane(clock=...)``)."""

    def __init__(self, t0: float = 0.0):
        self.now = t0

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        assert dt >= 0.0
        self.now += dt

    def advance_to(self, t: float) -> None:
        self.now = max(self.now, t)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Virtual cost of one control-plane step: fixed overhead plus what
    the step actually did. Defaults are in the ballpark of the committed
    toy-model CPU benches; absolute values only scale the virtual axis —
    policy comparisons are ratio-invariant."""

    step_overhead_s: float = 0.002
    prefill_chunk_s: float = 0.004
    decode_token_s: float = 0.0015

    def step_cost(self, chunks: int, tokens: int) -> float:
        return (self.step_overhead_s + self.prefill_chunk_s * chunks
                + self.decode_token_s * tokens)


@dataclasses.dataclass
class LoadResult:
    policy: str
    records: List[Dict[str, object]]     # one lifecycle dict per request
    summary: Dict[str, object]           # the kind="load_summary" record
    finished: List[Request]
    dropped: List[Request]
    steps: int
    virtual_time_s: float


def build_control_plane(cfg, params, trace: Trace, *, policy: str = "slo",
                        cost: Optional[CostModel] = None,
                        clock: Optional[VirtualClock] = None,
                        max_seqs: int = 4, block_size: int = 8,
                        decode_horizon: int = 4, prefill_chunk: int = 16,
                        prefill_budget: int = 2, d_max: int = 1_000_000,
                        age_promote_s: float = math.inf,
                        max_preempts: int = 4,
                        preempt_slack_frac: float = 0.25,
                        faults=None, device="cuda"):
    """Engine + scheduler + control plane for a replay run.

    ``policy``: ``"slo"`` = priority classes + SLO shed/preempt;
    ``"priority"`` = priority classes only; ``"fifo"`` = single class in
    arrival order (the no-priority baseline).
    """
    assert policy in POLICIES, policy
    clock = clock or VirtualClock()
    cost = cost or CostModel()
    store = WeightStore(params, 0)
    longest = max((r.prompt_len + r.max_new for r in trace.requests),
                  default=block_size)
    mb = -(-longest // block_size) + 1
    engine = ContinuousBatchingEngine(
        cfg, max_seqs=max_seqs, block_size=block_size,
        n_blocks=max_seqs * mb + 1, max_blocks_per_seq=mb, greedy=True,
        decode_horizon=decode_horizon, prefill_chunk=prefill_chunk,
        device=device)
    sched_cfg = SchedulerConfig(d_max=d_max, max_preempts=max_preempts,
                                age_promote_s=age_promote_s)
    if policy == "slo":
        scheduler = SLOAwareScheduler(sched_cfg, SLOPolicy(
            classes=trace.classes,
            est_fixed_s=cost.step_overhead_s,
            est_s_per_token=cost.prefill_chunk_s / prefill_chunk,
            preempt_slack_frac=preempt_slack_frac))
    else:
        scheduler = AdmissionScheduler(sched_cfg)
    cp = ServingControlPlane(engine, store, scheduler,
                             use_prefix_cache=False,
                             resubmit_dropped=False,
                             prefill_budget=prefill_budget, clock=clock,
                             faults=faults)
    return cp, store, clock, cost


def _round(v: float, unset: float = -1.0) -> Optional[float]:
    return None if v == unset or v < 0 else round(v, 6)


class _ClassStats:
    """Per-class accumulator backed by labeled registry metrics."""

    def __init__(self, name: str, registry):
        labels = {"class": name}
        self.name = name
        self.ttft = registry.histogram("serving_ttft_seconds", TTFT_BOUNDS,
                                       **labels)
        self.e2e = registry.histogram("serving_e2e_seconds", E2E_BOUNDS,
                                      **labels)
        self.attained = registry.counter("serving_slo_attained_total",
                                         **labels)
        self.missed = registry.counter("serving_slo_missed_total", **labels)
        self.submitted = 0
        self.completed = 0
        self.dropped = 0
        self.shed = 0
        self.preempts = 0
        self.tokens = 0
        self.slo_tokens = 0

    def table_row(self, duration_s: float) -> Dict[str, object]:
        dur = max(duration_s, 1e-9)
        attained = int(self.attained.value)
        return {
            "submitted": self.submitted, "completed": self.completed,
            "dropped": self.dropped, "shed": self.shed,
            "preempts": self.preempts, "tokens": self.tokens,
            "ttft_p50_s": round(self.ttft.quantile(0.5), 6),
            "ttft_p99_s": round(self.ttft.quantile(0.99), 6),
            "ttft_mean_s": round(self.ttft.mean, 6),
            "e2e_p50_s": round(self.e2e.quantile(0.5), 6),
            "e2e_p99_s": round(self.e2e.quantile(0.99), 6),
            "slo_attained": attained,
            "slo_attainment": round(attained / max(self.submitted, 1), 6),
            "goodput_rps": round(attained / dur, 6),
            "goodput_tok_s": round(self.slo_tokens / dur, 6),
        }


def run_trace(cfg, params, trace: Trace, *, policy: str = "slo",
              logger: Optional[RunLogger] = None, seed: int = 0,
              max_steps: int = 500_000, **build_kw) -> LoadResult:
    """Replay ``trace`` through a fresh control plane; returns per-request
    lifecycle records + the per-class SLO summary."""
    cp, store, clock, cost = build_control_plane(
        cfg, params, trace, policy=policy, **build_kw)
    registry = get_registry()
    # fresh labeled per-class metrics for this run (the unlabeled
    # serving_* names stay owned by the ServingMetrics facade)
    for prefix in ("serving_ttft_seconds{", "serving_e2e_seconds{",
                   "serving_slo_attained_total{",
                   "serving_slo_missed_total{"):
        registry.unregister_prefix(prefix)
    stats = {c.name: _ClassStats(c.name, registry) for c in trace.classes}

    arrivals = deque(sorted(trace.requests,
                            key=lambda r: (r.t_arrival_s, r.rid)))
    publishes = deque(sorted(trace.publishes, key=lambda p: p.t_s))
    rid_to_trace: Dict[int, TraceRequest] = {}
    req_spans: Dict[int, object] = {}
    records: List[Dict[str, object]] = []
    generator = torch.Generator(device=cp.engine.device).manual_seed(seed)
    steps = 0

    def finalize(req: Request, outcome: str) -> None:
        tr = rid_to_trace[req.rid]
        cls = trace.class_by_name(tr.cls)
        st = stats[tr.cls]
        ttft = (req.t_first_token - req.t_submit
                if req.t_first_token >= 0 else -1.0)
        e2e = req.t_done - req.t_submit if req.t_done >= 0 else -1.0
        done = outcome == "done"
        ttft_ok = done and 0 <= ttft <= cls.ttft_slo_s
        e2e_ok = done and 0 <= e2e <= cls.e2e_slo_s
        if done:
            st.completed += 1
            st.tokens += len(req.generated)
            if ttft >= 0:
                st.ttft.observe(ttft)
            if e2e >= 0:
                st.e2e.observe(e2e)
        else:
            st.dropped += 1
            if req.drop_reason == "slo_shed":
                st.shed += 1
        st.preempts += req.preempt_count
        if ttft_ok and e2e_ok:
            st.attained.inc()
            st.slo_tokens += len(req.generated)
        else:
            st.missed.inc()
        rec = {
            "schema": RUNLOG_SCHEMA_VERSION, "kind": "request",
            "rid": tr.rid, "cls": tr.cls, "tenant": tr.tenant,
            "priority": tr.priority, "prompt_len": tr.prompt_len,
            "max_new": tr.max_new, "outcome": outcome,
            "drop_reason": req.drop_reason or None,
            "preempts": req.preempt_count,
            "tokens": len(req.generated),
            "t_arrival_s": tr.t_arrival_s,
            "t_submit_s": _round(req.t_submit),
            "t_admit_s": _round(req.t_admit),
            "t_first_token_s": _round(req.t_first_token),
            "t_done_s": _round(req.t_done),
            "ttft_s": _round(ttft), "e2e_s": _round(e2e),
            "slo_ttft_ok": ttft_ok, "slo_e2e_ok": e2e_ok,
        }
        records.append(rec)
        if logger is not None:
            # time_unix_s override keeps the JSONL deterministic: the
            # record is stamped with virtual completion time, not wall
            logger.log_event(**dict(rec, kind="request",
                                    time_unix_s=round(clock.now, 6)))
        s = req_spans.pop(req.rid, None)
        if s is not None:
            s.set(outcome=outcome, ttft_s=round(max(ttft, -1.0), 6),
                  preempts=req.preempt_count)
            s.__exit__(None, None, None)

    finished_reqs: List[Request] = []
    dropped_reqs: List[Request] = []
    with span("load_replay", policy=policy, requests=len(trace.requests)):
        while arrivals or cp.n_inflight or len(cp.scheduler):
            while publishes and publishes[0].t_s <= clock.now:
                ev = publishes.popleft()
                store.publish(params, ev.version)
            while arrivals and arrivals[0].t_arrival_s <= clock.now:
                tr = arrivals.popleft()
                prio = 0 if policy == "fifo" else tr.priority
                rid = cp.submit(prompt_tokens(tr, cfg.vocab_size),
                                max_new=tr.max_new, priority=prio,
                                tenant=tr.tenant)
                rid_to_trace[rid] = tr
                stats[tr.cls].submitted += 1
                s = span("request", rid=tr.rid, cls=tr.cls,
                         tenant=tr.tenant, priority=prio)
                s.__enter__()
                req_spans[rid] = s
            if cp.n_inflight or len(cp.scheduler):
                tok0 = cp.metrics.decode_tokens
                ch0 = cp.metrics.prefill_chunks
                finished = cp.step(generator)
                steps += 1
                clock.advance(cost.step_cost(
                    cp.metrics.prefill_chunks - ch0,
                    cp.metrics.decode_tokens - tok0))
                for r in finished:
                    finished_reqs.append(r)
                    finalize(r, "done")
                if cp.dropped_requests:
                    for r in cp.dropped_requests:
                        dropped_reqs.append(r)
                        finalize(r, "dropped")
                    cp.dropped_requests = []
                if steps > max_steps:
                    raise RuntimeError("load replay exceeded max_steps")
            elif arrivals:
                # idle: jump straight to the next arrival
                clock.advance_to(arrivals[0].t_arrival_s)

    duration = clock.now
    snap = cp.metrics.snapshot()
    summary = {
        "schema": RUNLOG_SCHEMA_VERSION, "kind": "load_summary",
        "trace_schema": TRACE_SCHEMA_VERSION, "policy": policy,
        "requests": len(trace.requests),
        "completed": len(finished_reqs), "dropped": len(dropped_reqs),
        "steps": steps, "virtual_time_s": round(duration, 6),
        "publishes": len(trace.publishes),
        "slo": {c.name: {"ttft_slo_s": c.ttft_slo_s,
                         "e2e_slo_s": c.e2e_slo_s}
                for c in trace.classes},
        "classes": {name: st.table_row(duration)
                    for name, st in stats.items()},
        # deterministic counter subset of the serving snapshot (wall-time
        # rates are deliberately excluded from the JSONL)
        "serving": {k: snap[k] for k in (
            "admitted", "completed", "drops", "drops_staleness_budget",
            "drops_max_preempts", "drops_slo_shed", "preemptions",
            "preemptions_staleness", "preemptions_slo", "interrupts",
            "resumed_sequences", "decode_tokens", "prefill_chunks")},
    }
    if logger is not None:
        logger.log_event(**dict(summary, kind="load_summary",
                                time_unix_s=round(duration, 6)))
    return LoadResult(policy=policy, records=records, summary=summary,
                      finished=finished_reqs, dropped=dropped_reqs,
                      steps=steps, virtual_time_s=duration)
