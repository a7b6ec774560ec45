"""Deterministic seeded fault-injection plane (a copy of
``repro.resilience.faults``, which imports no framework).

A ``FaultPlan`` is a list of ``FaultSpec``s plus a seeded RNG. Components
(the orchestrator, the simulator, the serving control plane, the loadgen
harness) call ``plan.check(kind)`` at well-defined *sites*; the plan keeps
one occurrence counter per site, so "crash the rollout worker at its 2nd
rollout" or "fail the 1st weight publish 3 times" is exactly reproducible
run-to-run. Every fired fault is counted in the ``resilience_*`` metric
family and marked with an instant event in the tracer.

Spec string grammar (the ``--fault`` CLI flag)::

    KIND@AT            fire once, at the AT-th site occurrence (0-based)
    KIND@ATxTIMES      fire on TIMES consecutive occurrences
    KIND@AT:MAG        magnitude (seconds of delay, blocks to steal, ...)
    KIND@ATxTIMES:MAG  both

Kinds and their sites:

==============  ========================================================
rollout_crash   rollout worker, start of each rollout -> raise
train_crash     trainer loop, start of each step -> raise (kill/resume)
publish_fail    weight publish attempt -> simulated failure (retried)
publish_delay   weight publish -> sleep(magnitude) before publishing
queue_stall     rollout worker, before queue push -> sleep(magnitude)
nan_grad        trainer loop, per step -> NaN into one reward (loss and
                grads go non-finite; the on-device guard must catch it)
kv_exhaust      serving step -> hold `magnitude` free KV blocks for the
                spec's TIMES consecutive serving steps
nan_logits      serving step -> NaN row in the decode logits buffer
==============  ========================================================
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.metrics import get_registry
from repro_torch.obs.tracing import instant

FAULT_KINDS = (
    "rollout_crash", "train_crash", "publish_fail", "publish_delay",
    "queue_stall", "nan_grad", "kv_exhaust", "nan_logits",
)


class InjectedFault(RuntimeError):
    """Raised by crash-type faults; carries the spec that fired."""

    def __init__(self, spec: "FaultSpec", occurrence: int):
        super().__init__(
            f"injected fault {spec.kind}@{occurrence}"
            + (f" (magnitude {spec.magnitude:g})" if spec.magnitude else ""))
        self.spec = spec
        self.occurrence = occurrence


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    at: int                 # 0-based site-occurrence index of the first fire
    times: int = 1          # consecutive occurrences to fire on
    magnitude: float = 0.0  # delay seconds / blocks to hold / ...

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if self.at < 0 or self.times < 1:
            raise ValueError(f"bad fault window: at={self.at} "
                             f"times={self.times}")

    def spec_str(self) -> str:
        s = f"{self.kind}@{self.at}"
        if self.times != 1:
            s += f"x{self.times}"
        if self.magnitude:
            s += f":{self.magnitude:g}"
        return s


def parse_fault(text: str) -> FaultSpec:
    """Parse ``KIND@AT[xTIMES][:MAG]`` (the ``--fault`` flag grammar)."""
    if "@" not in text:
        raise ValueError(f"fault spec {text!r}: expected KIND@AT[xN][:MAG]")
    kind, rest = text.split("@", 1)
    magnitude = 0.0
    if ":" in rest:
        rest, mag = rest.split(":", 1)
        magnitude = float(mag)
    times = 1
    if "x" in rest:
        rest, t = rest.split("x", 1)
        times = int(t)
    return FaultSpec(kind=kind.strip(), at=int(rest), times=times,
                     magnitude=magnitude)


class FaultPlan:
    """Seeded, deterministic fault schedule shared across components.

    Thread-safe enough for the async runtime: per-site counters are only
    advanced from the single thread that owns that site (trainer loop,
    rollout worker, serving step), and the fired-event list append is
    protected by the GIL. ``rng`` gives faults that need randomness (which
    NaN row, jitter) a seeded stream independent of the training RNG.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._counts: Dict[str, int] = {}
        self.fired: List[Dict] = []   # {kind, occurrence, magnitude}

    @classmethod
    def from_strings(cls, texts: Sequence[str], seed: int = 0) -> "FaultPlan":
        return cls([parse_fault(t) for t in texts], seed=seed)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def check(self, kind: str) -> Optional[FaultSpec]:
        """Advance the ``kind`` site counter; return the spec that fires
        at this occurrence (None when healthy)."""
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        for spec in self.specs:
            if spec.kind == kind and spec.at <= i < spec.at + spec.times:
                self.fired.append({"kind": kind, "occurrence": i,
                                   "magnitude": spec.magnitude})
                get_registry().counter("resilience_faults_injected_total",
                                       kind=kind).inc()
                instant("fault_injected", kind=kind, occurrence=i,
                        magnitude=spec.magnitude)
                return spec
        return None

    def maybe_crash(self, kind: str) -> None:
        """``check`` + raise ``InjectedFault`` when the fault fires."""
        spec = self.check(kind)
        if spec is not None:
            raise InjectedFault(spec, self._counts[kind] - 1)

    def occurrences(self, kind: str) -> int:
        return self._counts.get(kind, 0)


def resilience_snapshot() -> Dict[str, float]:
    """The ``resilience_*`` slice of the process metrics registry — what
    the orchestrator attaches to ``StepRecord.resilience``."""
    return {k: v for k, v in get_registry().snapshot().items()
            if k.startswith("resilience_")}
