"""Trace generation + the versioned trace schema for the load harness (a
copy of ``repro.loadgen.traces``: the same schema and the same seeded
draws, so either package replays either package's traces).

A *trace* is the full description of a multi-tenant workload: per-class
SLO targets, request arrivals (timestamp, tenant, class, prompt/output
lengths, prompt seed), and the trainer's weight-publish events. Traces
are either synthesized here — seeded, so the same config always yields
the same workload — or replayed from a JSONL file with the same schema,
so real serving traces can be captured once and replayed across PRs.

Everything in this module is numpy-only: the schema constants are
imported by ``repro_torch.obs.validate`` without dragging in the engine.

JSONL schema (``TRACE_SCHEMA_VERSION`` rides in every record):

* one ``kind="trace_header"`` record — classes (with SLO targets) + the
  generator config that produced the trace;
* one ``kind="request"`` record per arrival, sorted by ``t_arrival_s``;
* ``kind="publish"`` records for weight-publish events.

Prompt *tokens* are not stored: each request carries a ``prompt_seed``
and the harness regenerates its tokens deterministically, keeping traces
small and model-vocabulary-agnostic.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TRACE_SCHEMA_VERSION = 1

# Required keys for the harness's lifecycle JSONL output (one record per
# request outcome) and its run summary — the CI schema gate
# (repro_torch.obs.validate --loadgen) keys off these.
LIFECYCLE_REQUIRED_KEYS = (
    "schema", "kind", "rid", "cls", "tenant", "priority", "outcome",
    "t_submit_s", "ttft_s", "e2e_s", "tokens", "preempts",
)
SUMMARY_REQUIRED_KEYS = (
    "schema", "kind", "policy", "requests", "completed", "dropped",
    "virtual_time_s", "classes",
)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A priority class with its latency SLO targets.

    ``priority`` is the admission-scheduler class (lower = more urgent);
    ``share`` is this class's fraction of synthetic arrivals.
    """

    name: str
    priority: int
    ttft_slo_s: float   # time-to-first-token target (submit -> 1st token)
    e2e_slo_s: float    # end-to-end target (submit -> done)
    share: float = 0.0
    max_new: int = 8    # output-length cap for synthetic requests

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


# the default 3-class mix: latency-critical interactive traffic, standard
# API calls, and bulk/batch rollouts (the trainer's own GRPO groups)
DEFAULT_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("interactive", 0, ttft_slo_s=0.25, e2e_slo_s=1.50,
             share=0.25, max_new=8),
    SLOClass("standard", 1, ttft_slo_s=0.75, e2e_slo_s=4.00,
             share=0.45, max_new=12),
    SLOClass("bulk", 2, ttft_slo_s=3.00, e2e_slo_s=15.00,
             share=0.30, max_new=16),
)


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    rid: int
    t_arrival_s: float
    tenant: str
    cls: str
    priority: int
    prompt_len: int
    max_new: int
    prompt_seed: int


@dataclasses.dataclass(frozen=True)
class PublishEvent:
    t_s: float
    version: int


@dataclasses.dataclass
class Trace:
    classes: Tuple[SLOClass, ...]
    requests: List[TraceRequest]
    publishes: List[PublishEvent]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def class_by_name(self, name: str) -> SLOClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(name)

    @property
    def duration_s(self) -> float:
        return float(self.meta.get("duration_s") or (
            self.requests[-1].t_arrival_s if self.requests else 0.0))


@dataclasses.dataclass
class TraceConfig:
    """Synthetic-workload knobs (all distributions seeded).

    Arrivals are a Gamma renewal process with mean rate ``rate_rps``:
    ``burstiness=1`` is Poisson; ``<1`` clumps arrivals into bursts with
    long gaps (heavier-than-exponential inter-arrival tail), which is
    what multi-tenant serving traffic looks like.
    """

    seed: int = 0
    duration_s: float = 6.0
    rate_rps: float = 10.0
    burstiness: float = 1.0        # gamma shape k (1 = Poisson)
    n_tenants: int = 4
    tenant_skew: float = 1.2       # zipf-ish tenant popularity exponent
    prompt_len_min: int = 8
    prompt_len_mean: int = 20
    prompt_len_max: int = 64
    prompt_len_sigma: float = 0.5  # lognormal spread
    publish_every_s: float = 0.0   # 0 = no weight publishes


def synthesize(cfg: TraceConfig,
               classes: Sequence[SLOClass] = DEFAULT_CLASSES) -> Trace:
    """Deterministic synthetic trace: same (cfg, classes) -> same trace."""
    assert cfg.burstiness > 0 and cfg.rate_rps > 0
    rng = np.random.default_rng(cfg.seed)
    shares = np.array([c.share for c in classes], np.float64)
    assert shares.sum() > 0, "classes need arrival shares"
    shares = shares / shares.sum()
    pop = 1.0 / np.arange(1, cfg.n_tenants + 1) ** cfg.tenant_skew
    pop = pop / pop.sum()

    k = cfg.burstiness
    requests: List[TraceRequest] = []
    t = 0.0
    rid = 0
    while True:
        t += float(rng.gamma(k, 1.0 / (k * cfg.rate_rps)))
        if t >= cfg.duration_s:
            break
        rid += 1
        c = classes[int(rng.choice(len(classes), p=shares))]
        tenant = f"tenant{int(rng.choice(cfg.n_tenants, p=pop))}"
        plen = int(np.clip(
            round(rng.lognormal(math.log(cfg.prompt_len_mean),
                                cfg.prompt_len_sigma)),
            cfg.prompt_len_min, cfg.prompt_len_max))
        max_new = int(rng.integers(max(1, c.max_new // 2), c.max_new + 1))
        requests.append(TraceRequest(
            rid=rid, t_arrival_s=round(t, 6), tenant=tenant, cls=c.name,
            priority=c.priority, prompt_len=plen, max_new=max_new,
            prompt_seed=int(rng.integers(0, 2 ** 31 - 1))))

    publishes: List[PublishEvent] = []
    if cfg.publish_every_s > 0:
        n_pubs = int(cfg.duration_s / cfg.publish_every_s)
        publishes = [PublishEvent(round((i + 1) * cfg.publish_every_s, 6),
                                  i + 1) for i in range(n_pubs)]
    return Trace(classes=tuple(classes), requests=requests,
                 publishes=publishes, meta=dataclasses.asdict(cfg))


def prompt_tokens(req: TraceRequest, vocab_size: int) -> np.ndarray:
    """Regenerate the request's prompt tokens from its seed (ids >= 4:
    the toy tokenizer reserves PAD/BOS/EOS/SEP)."""
    rng = np.random.default_rng(req.prompt_seed)
    return rng.integers(4, vocab_size, size=req.prompt_len).astype(np.int32)


# ------------------------------------------------------------------ JSONL io
def save_trace(path: str, trace: Trace) -> str:
    with open(path, "w") as f:
        json.dump({"schema": TRACE_SCHEMA_VERSION, "kind": "trace_header",
                   "classes": [c.to_dict() for c in trace.classes],
                   "meta": trace.meta}, f)
        f.write("\n")
        for r in trace.requests:
            rec = {"schema": TRACE_SCHEMA_VERSION, "kind": "request"}
            rec.update(dataclasses.asdict(r))
            json.dump(rec, f)
            f.write("\n")
        for p in trace.publishes:
            json.dump({"schema": TRACE_SCHEMA_VERSION, "kind": "publish",
                       "t_s": p.t_s, "version": p.version}, f)
            f.write("\n")
    return path


def load_trace(path: str) -> Trace:
    classes: Optional[Tuple[SLOClass, ...]] = None
    meta: Dict[str, object] = {}
    requests: List[TraceRequest] = []
    publishes: List[PublishEvent] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            schema = rec.get("schema")
            assert schema == TRACE_SCHEMA_VERSION, \
                f"trace schema {schema!r} != {TRACE_SCHEMA_VERSION}"
            kind = rec.get("kind")
            if kind == "trace_header":
                classes = tuple(SLOClass(**c) for c in rec["classes"])
                meta = rec.get("meta", {})
            elif kind == "request":
                requests.append(TraceRequest(**{
                    k: rec[k] for k in (
                        "rid", "t_arrival_s", "tenant", "cls", "priority",
                        "prompt_len", "max_new", "prompt_seed")}))
            elif kind == "publish":
                publishes.append(PublishEvent(rec["t_s"], rec["version"]))
    assert classes is not None, f"{path}: no trace_header record"
    requests.sort(key=lambda r: (r.t_arrival_s, r.rid))
    publishes.sort(key=lambda p: p.t_s)
    return Trace(classes=classes, requests=requests, publishes=publishes,
                 meta=meta)
