"""Admission control over the continuous-batching engine's fixed slots (a
copy of ``repro.serving.scheduler``).

Three gates sit between ``submit`` and a slot (the "Staleness-Learning
Rate Scaling Laws" prescription: enforce the staleness budget in the
scheduler instead of hoping the queue stays shallow):

* **priority classes** — a binary heap keyed on (priority, arrival), so
  urgent traffic (e.g. the trainer's on-policy refresh batch) overtakes
  bulk rollouts; under sustained backpressure, waiting non-urgent
  requests *age*: after ``age_promote_s`` at the gate they are promoted
  to priority 0 so bulk traffic is never starved forever;
* **backpressure** — when the downstream ``RolloutQueue`` is nearly full
  the trainer is the bottleneck, so generating more stale data is pure
  waste: non-urgent admits are held at ``backpressure_high`` and all
  admits at ``backpressure_full``;
* **staleness budget** — a request is never admitted once
  ``now_version - submit_version`` exceeds ``d_max`` (it is dropped, or
  resubmitted fresh by the control plane), and in-flight sequences whose
  oldest token stamp falls behind the budget are preempted, returning all
  their refcounted blocks.

Every drop carries a reason on the request (``staleness_budget``,
``max_preempts``; the SLO-aware subclass in ``repro_torch.loadgen.slo``
adds ``slo_shed``), and every preemption a
reason in ``preempt_reasons`` — the control plane folds both into
per-reason ``ServingMetrics`` counters.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.rollout.continuous import Request

# canonical drop reasons (surfaced as ServingMetrics.drops_<reason>)
DROP_REASONS = ("staleness_budget", "max_preempts", "slo_shed")


@dataclasses.dataclass
class SchedulerConfig:
    d_max: int = 4                   # staleness budget, in weight versions
    backpressure_high: float = 0.75  # queue depth fraction: hold prio > 0
    backpressure_full: float = 1.0   # queue depth fraction: hold everything
    preempt_action: str = "requeue"  # "requeue" (restart fresh) | "drop"
    max_preempts: int = 2            # requeue at most this many times
    # priority aging: a queued request with priority > 0 that has waited
    # this long (scheduler-clock seconds) is promoted to priority 0 — it
    # overtakes the backpressure_high hold and younger urgent arrivals,
    # so sustained backpressure can no longer starve bulk traffic.
    # inf = aging off (the pre-aging behavior).
    age_promote_s: float = math.inf


class AdmissionScheduler:
    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()
        self._heap: List[Tuple[int, int, float, Request]] = []
        self._seq = 0
        self.dropped: List[Request] = []
        # slot -> reason for the slots returned by the last check_preempt
        self.preempt_reasons: Dict[int, str] = {}

    def __len__(self) -> int:
        return len(self._heap)

    def enqueue(self, req: Request, now_s: float = 0.0) -> None:
        heapq.heappush(self._heap, (req.priority, self._seq, now_s, req))
        self._seq += 1

    def _promote_aged(self, now_s: float) -> None:
        """Rebuild the heap with aged non-urgent entries at priority 0.

        O(n) when anything aged, a single scan otherwise; heaps here are
        request queues (hundreds), not token queues.
        """
        age = self.config.age_promote_s
        if not math.isfinite(age) or not self._heap:
            return
        fresh, aged = [], []
        for e in self._heap:
            (aged if e[0] > 0 and now_s - e[2] >= age else fresh).append(e)
        if not aged:
            return
        fresh.extend((0, seq, t_enq, req) for _, seq, t_enq, req in aged)
        heapq.heapify(fresh)
        self._heap = fresh

    def pop_admissible(self, now_version: int, *, engine,
                       queue_frac: float = 0.0, now_s: float = 0.0
                       ) -> Optional[Tuple[Request, float]]:
        """Best admissible request, or None.

        Requests already past the staleness budget are dropped on the spot
        (collected in ``self.dropped`` for the control plane's resubmit
        policy). Block availability is checked against the engine's
        prefix-cache-aware estimate, with cache eviction as the fallback
        before giving up.
        """
        cfg = self.config
        self._promote_aged(now_s)
        while self._heap:
            prio, _, t_enq, req = self._heap[0]
            if now_version - req.submit_version > cfg.d_max:
                heapq.heappop(self._heap)
                req.drop_reason = "staleness_budget"
                self.dropped.append(req)
                continue
            if queue_frac >= cfg.backpressure_full:
                return None
            if prio > 0 and queue_frac >= cfg.backpressure_high:
                return None
            needed = engine.blocks_needed(req.prompt, req.max_new)
            if needed > engine.allocator.n_free:
                cache = getattr(engine, "prefix_cache", None)
                shortfall = needed - engine.allocator.n_free
                # Only evict when eviction can actually cover the
                # shortfall: destroying cached prefixes for a request
                # that still can't be admitted is pure loss.
                if cache is None or cache.evictable_count() < shortfall:
                    return None
                cache.evict(shortfall)
                if needed > engine.allocator.n_free:
                    return None
            heapq.heappop(self._heap)
            return req, t_enq
        return None

    def check_preempt(self, slots: Dict[int, Optional[Request]],
                      now_version: int, *, now_s: float = 0.0,
                      free_slots: int = 0) -> List[int]:
        """Slots to preempt, with reasons in ``self.preempt_reasons``.

        The base policy preempts slots whose oldest token stamp exceeds
        the staleness budget; ``now_s``/``free_slots`` feed subclass
        policies (deadline-aware overload preemption in loadgen.slo).
        """
        out = []
        self.preempt_reasons = {}
        for slot, req in slots.items():
            if req is None:
                continue
            if now_version - req.min_version() > self.config.d_max:
                out.append(slot)
                self.preempt_reasons[slot] = "staleness_budget"
        return out

    def handle_preempted(self, req: Request, now_version: int,
                         now_s: float = 0.0) -> str:
        """Requeue (restarted fresh) or drop a preempted request.

        Returns the action taken. Requeued requests lose their generated
        tokens — their stamps are already over budget, so the KV and
        partial generation are unusable for training anyway.
        """
        req.preempt_count += 1
        if (self.config.preempt_action == "drop"
                or req.preempt_count > self.config.max_preempts):
            req.drop_reason = "max_preempts"
            self.dropped.append(req)
            return "drop"
        req.reset_generation()
        req.submit_version = now_version
        self.enqueue(req, now_s)
        return "requeue"

    def take_dropped(self) -> List[Request]:
        out, self.dropped = self.dropped, []
        return out
