"""Serving-side observability (a copy of ``repro.serving.metrics``): a thin
facade over the metrics registry of ``repro_torch.obs.metrics``.

``ServingMetrics`` keeps the reference's mutable-dataclass surface (every
control-plane call site: ``metrics.interrupts += 1``,
``metrics.staleness.observe(d)``, ...), and on construction registers its
histograms and callback gauges for its scalar fields under the
``serving_*`` namespace, so ``obs.get_registry().snapshot()`` and the
prometheus dump see live serving state.

``ServingMetrics.snapshot()`` flattens into the plain dict the
orchestrator attaches to ``StepRecord.serving``, with the reference's
keys.

Everything here is host-side and allocation-free on the hot path (fixed
bucket arrays, float adds).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.obs.metrics import Histogram, get_registry

__all__ = ["Histogram", "ServingMetrics"]


def _staleness_hist() -> Histogram:
    return Histogram((0, 1, 2, 4, 8, 16, 32))


def _delay_hist() -> Histogram:
    return Histogram((0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))


def _util_hist() -> Histogram:
    return Histogram((0.1, 0.25, 0.5, 0.75, 0.9, 1.0))


def _ttft_hist() -> Histogram:
    return Histogram((0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                      5.0, 30.0))


# scalar fields mirrored into the registry as callback gauges
_SCALAR_FIELDS = (
    "prefix_hit_tokens", "prefix_prompt_tokens", "prefill_tokens_computed",
    "prefill_chunks", "prefill_time_s",
    "prefill_compiles", "decode_tokens", "decode_host_syncs",
    "decode_launches", "decode_time_s", "interrupts", "resumed_sequences",
    "preemptions", "preemptions_staleness", "preemptions_slo",
    "drops", "drops_staleness_budget", "drops_max_preempts",
    "drops_slo_shed", "admitted", "completed", "cow_forks",
    "oom_sheds", "nan_drops",
)
_DERIVED_FIELDS = ("prefix_hit_rate", "host_syncs_per_token",
                   "decode_tokens_per_s", "prefill_tokens_per_s")


@dataclasses.dataclass
class ServingMetrics:
    """Control-plane counters; one instance per ServingControlPlane.

    A fresh instance re-registers the ``serving_*`` names (latest control
    plane wins — the registry reflects the live serving engine).
    """

    staleness: Histogram = dataclasses.field(default_factory=_staleness_hist)
    queue_delay_s: Histogram = dataclasses.field(default_factory=_delay_hist)
    page_utilization: Histogram = dataclasses.field(
        default_factory=_util_hist)
    # time-to-first-token: submit -> first sampled token, per request
    ttft_seconds: Histogram = dataclasses.field(default_factory=_ttft_hist)
    prefix_hit_tokens: int = 0
    prefix_prompt_tokens: int = 0
    prefill_tokens_computed: int = 0
    # prefill-lane telemetry: chunk launches streamed by the control
    # plane, wall time inside them, and the engine's distinct chunk
    # launch shapes (the reference counts jit compiles; nothing compiles
    # here, the name keeps the schema)
    prefill_chunks: int = 0
    prefill_time_s: float = 0.0
    prefill_compiles: int = 0
    decode_tokens: int = 0
    # fused-horizon serving telemetry: blocking device->host drains on the
    # decode path, decode launches (one per horizon), and wall
    # time spent decoding — host_syncs/token ~2 for the per-token loop,
    # <= 1/decode_launch (i.e. 1 per horizon) for the fused path.
    decode_host_syncs: int = 0
    decode_launches: int = 0
    decode_time_s: float = 0.0
    interrupts: int = 0          # weight publishes observed with work in flight
    resumed_sequences: int = 0   # in-flight seqs carried across a publish
    preemptions: int = 0
    # preemption reasons: staleness budget blown in-flight vs SLO-driven
    # overload eviction of a lower class (an SLO-aware scheduler)
    preemptions_staleness: int = 0
    preemptions_slo: int = 0
    drops: int = 0               # total, all reasons
    # drop reasons (scheduler stamps Request.drop_reason):
    drops_staleness_budget: int = 0  # queued past d_max
    drops_max_preempts: int = 0      # preempted once too often
    drops_slo_shed: int = 0          # deadline-aware admission shed
    admitted: int = 0
    completed: int = 0
    cow_forks: int = 0
    # sequences shed to keep the paged KV pool from hard-OOM (preflight
    # shortfall detection), and finished sequences discarded for
    # non-finite logprobs (NaN logits / numerical blowup)
    oom_sheds: int = 0
    nan_drops: int = 0
    register: dataclasses.InitVar[bool] = True

    def __post_init__(self, register: bool = True) -> None:
        if register:
            self.register_into(get_registry())

    def register_into(self, registry) -> None:
        """Expose this instance's state through a metrics registry:
        histograms are adopted as-is, scalar + derived fields become
        callback gauges reading the live attributes."""
        registry.register("serving_staleness", self.staleness)
        registry.register("serving_queue_delay_s", self.queue_delay_s)
        registry.register("serving_page_utilization", self.page_utilization)
        registry.register("serving_ttft_seconds", self.ttft_seconds)
        for f in _SCALAR_FIELDS + _DERIVED_FIELDS:
            registry.gauge(f"serving_{f}",
                           fn=(lambda self=self, f=f:
                               float(getattr(self, f))))

    @property
    def prefix_hit_rate(self) -> float:
        if not self.prefix_prompt_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_prompt_tokens

    @property
    def host_syncs_per_token(self) -> float:
        return self.decode_host_syncs / max(self.decode_tokens, 1)

    @property
    def decode_tokens_per_s(self) -> float:
        if self.decode_time_s <= 0.0:
            return 0.0
        return self.decode_tokens / self.decode_time_s

    @property
    def prefill_tokens_per_s(self) -> float:
        if self.prefill_time_s <= 0.0:
            return 0.0
        return self.prefill_tokens_computed / self.prefill_time_s

    def observe_request(self, *, prompt_tokens: int, prefix_hit: int,
                        queue_delay_s: float) -> None:
        self.admitted += 1
        self.prefix_prompt_tokens += prompt_tokens
        self.prefix_hit_tokens += prefix_hit
        self.prefill_tokens_computed += prompt_tokens - prefix_hit
        self.queue_delay_s.observe(queue_delay_s)

    def observe_finished(self, *, staleness_values) -> None:
        self.completed += 1
        for d in staleness_values:
            self.staleness.observe(float(d))

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        out.update(self.staleness.snapshot("staleness"))
        out.update(self.queue_delay_s.snapshot("queue_delay_s"))
        out.update(self.page_utilization.snapshot("page_util"))
        out.update(self.ttft_seconds.snapshot("ttft_s"))
        out.update(
            prefix_hit_rate=self.prefix_hit_rate,
            prefix_hit_tokens=float(self.prefix_hit_tokens),
            prefill_tokens_computed=float(self.prefill_tokens_computed),
            prefill_chunks=float(self.prefill_chunks),
            prefill_time_s=self.prefill_time_s,
            prefill_compiles=float(self.prefill_compiles),
            prefill_tokens_per_s=self.prefill_tokens_per_s,
            decode_tokens=float(self.decode_tokens),
            decode_host_syncs=float(self.decode_host_syncs),
            decode_launches=float(self.decode_launches),
            decode_time_s=self.decode_time_s,
            host_syncs_per_token=self.host_syncs_per_token,
            decode_tokens_per_s=self.decode_tokens_per_s,
            interrupts=float(self.interrupts),
            resumed_sequences=float(self.resumed_sequences),
            preemptions=float(self.preemptions),
            preemptions_staleness=float(self.preemptions_staleness),
            preemptions_slo=float(self.preemptions_slo),
            drops=float(self.drops),
            drops_staleness_budget=float(self.drops_staleness_budget),
            drops_max_preempts=float(self.drops_max_preempts),
            drops_slo_shed=float(self.drops_slo_shed),
            admitted=float(self.admitted),
            completed=float(self.completed),
            cow_forks=float(self.cow_forks),
            oom_sheds=float(self.oom_sheds),
            nan_drops=float(self.nan_drops),
        )
        return out
