"""Per-class SLO enforcement wired into the admission scheduler (a copy
of ``repro.loadgen.slo`` over the port's ``AdmissionScheduler``).

Two decisions turn SLO targets from passive measurement into scheduling
policy, both counted in ``ServingMetrics``:

* **deadline-aware admission (shedding)** — a queued request whose TTFT
  deadline can no longer be met even if admitted *right now* (estimated
  prefill time included) is shed with ``drop_reason="slo_shed"`` instead
  of burning slots on work the client already counts as failed. Shedding
  hopeless bulk work is what keeps the queue short enough for the
  classes that can still win;
* **overload preemption** — when no slot is free and the most urgent
  waiting request is about to violate its SLO (remaining slack below
  ``preempt_slack_frac`` of the class target), the lowest-priority
  in-flight slot is preempted (``preempt_reasons[slot]="slo_overload"``)
  and requeued under the normal ``max_preempts`` budget.

The scheduler subclasses ``AdmissionScheduler``: the staleness budget,
backpressure gates, and priority aging all still apply — SLO policy is
layered on top, not a replacement.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.loadgen.traces import SLOClass
from repro_torch.rollout.continuous import Request
from repro_torch.serving.scheduler import AdmissionScheduler, SchedulerConfig


@dataclasses.dataclass
class SLOPolicy:
    """Class table + the service-time model the shed/preempt decisions
    use. ``est_ttft_s`` is the optimistic time-to-first-token if a
    request were admitted immediately: fixed per-admission overhead plus
    a per-prompt-token prefill estimate (the harness derives both from
    its virtual cost model; production would fit them from history)."""

    classes: Tuple[SLOClass, ...]
    est_fixed_s: float = 0.0
    est_s_per_token: float = 0.0
    # preempt a lower class when the urgent head-of-queue's remaining
    # slack drops below this fraction of its TTFT target
    preempt_slack_frac: float = 0.25

    def __post_init__(self):
        self._by_prio: Dict[int, SLOClass] = {}
        for c in self.classes:
            self._by_prio.setdefault(c.priority, c)

    def by_priority(self, priority: int) -> Optional[SLOClass]:
        return self._by_prio.get(priority)

    def est_ttft_s(self, prompt_len: int) -> float:
        return self.est_fixed_s + self.est_s_per_token * prompt_len


class SLOAwareScheduler(AdmissionScheduler):
    """AdmissionScheduler + per-class TTFT deadlines.

    Requests are stamped with their class and absolute deadline at
    enqueue (``t_submit + ttft_slo_s``; a preempt-requeue keeps the
    original deadline — the client has been waiting since submit).
    """

    def __init__(self, config: Optional[SchedulerConfig] = None,
                 policy: Optional[SLOPolicy] = None):
        super().__init__(config)
        assert policy is not None, "SLOAwareScheduler needs an SLOPolicy"
        self.policy = policy
        self.sheds = 0
        self.slo_preempts = 0

    # ------------------------------------------------------------- enqueue
    def enqueue(self, req: Request, now_s: float = 0.0) -> None:
        cls = self.policy.by_priority(req.priority)
        if cls is not None:
            req.slo_class = cls.name
            if not math.isfinite(req.deadline_s):
                base = req.t_submit if req.t_submit >= 0.0 else now_s
                req.deadline_s = base + cls.ttft_slo_s
        super().enqueue(req, now_s)

    # ------------------------------------------------------------ shedding
    def _shed_hopeless(self, now_s: float) -> None:
        """Drop queued requests that cannot make their TTFT deadline even
        if admitted immediately."""
        keep: List[Tuple[int, int, float, Request]] = []
        shed = False
        for e in self._heap:
            req = e[3]
            if now_s + self.policy.est_ttft_s(len(req.prompt)) \
                    > req.deadline_s:
                req.drop_reason = "slo_shed"
                self.dropped.append(req)
                self.sheds += 1
                shed = True
            else:
                keep.append(e)
        if shed:
            heapq.heapify(keep)
            self._heap = keep

    def pop_admissible(self, now_version: int, *, engine,
                       queue_frac: float = 0.0, now_s: float = 0.0
                       ) -> Optional[Tuple[Request, float]]:
        self._shed_hopeless(now_s)
        return super().pop_admissible(now_version, engine=engine,
                                      queue_frac=queue_frac, now_s=now_s)

    # ---------------------------------------------------------- preemption
    def check_preempt(self, slots: Dict[int, Optional[Request]],
                      now_version: int, *, now_s: float = 0.0,
                      free_slots: int = 0) -> List[int]:
        out = super().check_preempt(slots, now_version, now_s=now_s,
                                    free_slots=free_slots)
        if free_slots > 0 or not self._heap:
            return out
        self._shed_hopeless(now_s)
        if not self._heap:
            return out
        prio, _, _, head = self._heap[0]
        cls = self.policy.by_priority(head.priority)
        if cls is None:
            return out
        slack = (head.deadline_s - now_s
                 - self.policy.est_ttft_s(len(head.prompt)))
        if slack > self.policy.preempt_slack_frac * cls.ttft_slo_s:
            return out
        # victim: the least-urgent in-flight request strictly below the
        # waiting class (ties broken toward the youngest grant)
        victims = [(r.priority, s) for s, r in slots.items()
                   if r is not None and r.priority > prio
                   and s not in self.preempt_reasons]
        if victims:
            slot = max(victims)[1]
            out.append(slot)
            self.preempt_reasons[slot] = "slo_overload"
            self.slo_preempts += 1
        return out
