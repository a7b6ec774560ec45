"""The rollout control plane (``repro.serving.control_plane``): scheduler +
interrupts + prefix cache + metrics.

Sits between ``async_rl.orchestrator`` and ``rollout.continuous``:

    trainer ──publish──▶ WeightStore ──interrupt──▶ ServingControlPlane
                                                        │  admit / preempt
                                                        ▼
                                            ContinuousBatchingEngine
                                                        │  finished Requests
                                                        ▼
                              RolloutBatch (per-token logp + version stamps)

Each ``step()``: poll the store (in-flight sequences resume under freshly
published weights, keeping their paged KV), preempt anything past the
staleness budget, admit from the priority queue through the radix prefix
cache, stream prefill chunks, run one decode launch, and fold everything
into metrics.

Sampling draws from an optional ``torch.Generator`` (the engine's
``step`` takes one), where the reference splits a JAX key per step; a
greedy engine needs none. ``faults=`` takes the seeded fault plane
(``repro_torch.resilience.FaultPlan``): ``kv_exhaust`` holds free KV blocks
hostage through the allocator, ``nan_logits`` writes NaN into one row of
the engine's device logits buffer in place.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.async_rl.buffer import QueueClosed, RolloutQueue
from repro_torch.async_rl.weights import WeightStore
from repro_torch.obs.tracing import flow_end, instant, span
from repro_torch.rollout.continuous import ContinuousBatchingEngine, Request
from repro_torch.rollout.engine import RolloutBatch, rollout_batch
from repro_torch.serving.interrupts import InterruptController
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.scheduler import AdmissionScheduler, SchedulerConfig

class ServingControlPlane:
    def __init__(self, engine: ContinuousBatchingEngine, store: WeightStore,
                 scheduler: Optional[AdmissionScheduler] = None,
                 metrics: Optional[ServingMetrics] = None,
                 rollout_queue: Optional[RolloutQueue] = None,
                 use_prefix_cache: bool = True,
                 resubmit_dropped: bool = True,
                 prefill_budget: int = 2,
                 clock: Optional[Callable[[], float]] = None,
                 faults=None):
        self.engine = engine
        self.store = store
        # seeded fault plane (repro_torch.resilience.FaultPlan): kv_exhaust
        # holds free KV blocks hostage, nan_logits poisons a decode row
        self.faults = faults
        self._kv_holds: List[int] = []
        # request-lifecycle clock: wall time by default; a replay harness
        # may inject a virtual clock so submit/admit/TTFT/done stamps are
        # trace-deterministic. Perf telemetry (decode_time_s etc.) always
        # uses wall time.
        self.clock = clock if clock is not None else time.perf_counter
        # prefill lane: at most this many chunk launches per step (horizon
        # boundary), so admissions stream in without a long prompt ever
        # stalling the decode lane for its whole prefill
        self.prefill_budget = prefill_budget
        # explicit None check: an empty AdmissionScheduler is falsy (len 0)
        self.scheduler = AdmissionScheduler(SchedulerConfig()) \
            if scheduler is None else scheduler
        self.metrics = ServingMetrics() if metrics is None else metrics
        self.rollout_queue = rollout_queue
        self.interrupts = InterruptController(store)
        self.resubmit_dropped = resubmit_dropped
        # SSM/hybrid engines carry recurrent state that cannot be shared
        # across sequences, so they opt out of the radix cache entirely
        if use_prefix_cache and engine.prefix_cache is None \
                and engine.supports_prefix_cache:
            engine.prefix_cache = RadixPrefixCache(engine.allocator,
                                                   engine.state.block_size)
        self._rid = 0
        self._finished: Dict[int, Request] = {}
        self.dropped_requests: List[Request] = []
        self._last_seen_version = store.version

    # ------------------------------------------------------------- plumbing
    @property
    def n_inflight(self) -> int:
        return sum(1 for r in self.engine.slots.values() if r is not None)

    def _queue_frac(self) -> float:
        q = self.rollout_queue
        return q.depth_fraction if q is not None else 0.0

    # ------------------------------------------------------------- requests
    def submit(self, prompt, max_new: int = 16, priority: int = 0,
               tenant: str = "") -> int:
        self._rid += 1
        req = Request(self._rid, np.asarray(prompt), max_new,
                      priority=priority,
                      submit_version=self.store.version,
                      t_submit=self.clock(), tenant=tenant)
        self.scheduler.enqueue(req, req.t_submit)
        return self._rid

    # ----------------------------------------------------------------- step
    def step(self, generator: Optional[torch.Generator] = None
             ) -> List[Request]:
        """One serving boundary; ``generator`` drives sampled decoding (a
        greedy engine needs none)."""
        with span("serve_step") as sp:
            return self._step(generator, sp)

    def _step(self, generator, sp) -> List[Request]:
        now = self.clock()
        inflight = self.n_inflight
        params, version, interrupted = self.interrupts.poll(inflight)
        if version != self._last_seen_version:
            # close the publish->resume flow arrow: this serving step is
            # the first to decode under the freshly published weights
            # (whether or not work was in flight when the publish landed)
            flow_end("publish", version, resumed=inflight)
            self._last_seen_version = version
        if interrupted and inflight:
            self.metrics.interrupts += 1
            self.metrics.resumed_sequences += inflight
            sp.set(resumed_under_version=version, resumed=inflight)
        if self.faults is not None:
            self._fault_hooks()

        # preemption of in-flight work: staleness budget (base scheduler)
        # and SLO-overload eviction (an SLO-aware scheduler), with the
        # reason counted per class of decision
        preempt_slots = self.scheduler.check_preempt(
            self.engine.slots, version, now_s=now,
            free_slots=len(self.engine.free_slots()))
        for slot in preempt_slots:
            req = self.engine.release_slot(slot)
            reason = self.scheduler.preempt_reasons.get(
                slot, "staleness_budget")
            self.metrics.preemptions += 1
            if reason == "slo_overload":
                self.metrics.preemptions_slo += 1
            else:
                self.metrics.preemptions_staleness += 1
            self.scheduler.handle_preempted(req, version, now)

        # admission through the priority + backpressure + budget gates
        queue_frac = self._queue_frac()
        for slot in self.engine.free_slots():
            picked = self.scheduler.pop_admissible(
                version, engine=self.engine, queue_frac=queue_frac,
                now_s=now)
            if picked is None:
                break
            req, t_enq = picked
            req.t_admit = now
            # only map pages here; the prefill lane below streams the
            # compute under the per-step chunk budget
            self.engine.admit_request(params, slot, req, version=version,
                                      prefill=False)
            self.metrics.observe_request(
                prompt_tokens=len(req.prompt),
                prefix_hit=req.prefix_hit_tokens,
                queue_delay_s=max(now - t_enq, 0.0))

        # dropped queued requests: resubmit fresh, or surface. SLO sheds
        # are never resubmitted — the deadline they already missed does
        # not reset, so a resubmit would shed again immediately.
        for req in self.scheduler.take_dropped():
            reason = req.drop_reason or "staleness_budget"
            self.metrics.drops += 1
            if reason == "staleness_budget":
                self.metrics.drops_staleness_budget += 1
            elif reason == "max_preempts":
                self.metrics.drops_max_preempts += 1
            elif reason == "slo_shed":
                self.metrics.drops_slo_shed += 1
            if self.resubmit_dropped and reason != "slo_shed":
                # fresh lease: discard any partial generation (its stamps
                # are over budget and its tokens never see the new KV) and
                # restart from the prompt. Churn is self-limiting: versions
                # only advance while the trainer is fed, so a starved
                # trainer stops publishing and the restarts complete.
                req.reset_generation()
                req.preempt_count = 0
                req.drop_reason = ""
                req.submit_version = version
                self.scheduler.enqueue(req, now)
            else:
                req.t_done = now
                self.dropped_requests.append(req)

        # prefill lane: stream up to prefill_budget chunk launches over
        # mid-prefill slots. Slots whose prompt completes here enter the
        # decode lane in this same step (first token with zero extra
        # latency); longer prompts carry their cursor to the next
        # boundary while the decode lane below keeps emitting.
        # A chunk whose writes the pool cannot supply (a radix-shared
        # partial page to fork while the pool is held dry) waits for a
        # later boundary instead of running the allocator out mid-fork;
        # the reference launches it and raises (ROADMAP note f).
        if self.engine.prefilling_slots():
            t0 = time.perf_counter()
            launched = 0
            while (launched < self.prefill_budget
                   and self.engine.prefilling_slots()
                   and not self.engine.prefill_block_shortfall()):
                launched += self.engine.prefill_step(
                    params, version=version, max_chunks=1)
            self.metrics.prefill_time_s += time.perf_counter() - t0
            self.metrics.prefill_chunks += launched
        self.metrics.prefill_compiles = self.engine.prefill_compiles

        # graceful degradation under KV-pool pressure: preflight the next
        # decode launch's block need and shed work through the scheduler
        # (requeue/drop policy included) instead of letting the allocator
        # hard-OOM mid-CoW-fork, which would desync the host mirrors.
        self._shed_for_blocks(version, now)

        finished: List[Request] = []
        if self.engine.decode_ready_slots():
            # one decode launch: a fused horizon (decode_horizon tokens per
            # slot, one host drain) or the per-token step. Admission,
            # preemption, interrupt polling, and prefill chunks above all
            # happen at this boundary — never inside the horizon.
            t0 = time.perf_counter()
            syncs0 = self.engine.host_syncs
            launches0 = self.engine.decode_launches
            if self.engine.decode_horizon > 1:
                finished = self.engine.step_horizon(params, generator,
                                                    version=version)
            else:
                finished = self.engine.step(params, generator,
                                            version=version)
            self.metrics.decode_time_s += time.perf_counter() - t0
            self.metrics.decode_tokens += self.engine.last_emitted
            # deltas, not lifetime counters: the engine may predate this
            # plane (warmup runs, shared engines)
            self.metrics.decode_host_syncs += \
                self.engine.host_syncs - syncs0
            self.metrics.decode_launches += \
                self.engine.decode_launches - launches0
            alloc = self.engine.allocator
            self.metrics.page_utilization.observe(
                1.0 - alloc.n_free / max(alloc.n_blocks, 1))
            self.metrics.cow_forks = alloc.forks
        # sequences that finished with non-finite logprobs (numerical
        # blowup) are never emitted into rollout data — they are discarded
        # and resubmitted fresh under the live version
        if finished:
            finished = self._filter_nonfinite(finished, version, now)
        # time-to-first-token: stamp requests whose first sampled token
        # landed in this step's decode (finished ones already left their
        # slots, so scan both)
        t_now = self.clock()
        for r in list(self.engine.slots.values()) + finished:
            if r is not None and r.generated and r.t_first_token < 0.0:
                r.t_first_token = t_now
                if r.t_submit >= 0.0:
                    self.metrics.ttft_seconds.observe(
                        r.t_first_token - r.t_submit)
        for r in finished:
            r.t_done = t_now
        if finished:
            # per-span staleness attributes: distribution of the batch of
            # sequences that completed inside this serving step
            d_all = [version - v for r in finished
                     for v in r.token_versions]
            sp.set(finished=len(finished), version=version,
                   staleness_max=max(d_all, default=0),
                   staleness_mean=(sum(d_all) / len(d_all)
                                   if d_all else 0.0))
        for req in finished:
            self._finished[req.rid] = req
            self.metrics.observe_finished(
                staleness_values=[version - v for v in req.token_versions])
        return finished

    # ----------------------------------------------------------- resilience
    def _fault_hooks(self) -> None:
        """Per-step fault-plane sites (seeded chaos testing).

        ``kv_exhaust`` holds ``magnitude`` free KV blocks hostage while
        the spec fires (consecutive serving steps) and releases them when
        it stops — the shed path below must absorb the squeeze.
        ``nan_logits`` poisons one slot's row of the decode logits buffer;
        the non-finite filter must keep it out of the rollout data.
        """
        alloc = self.engine.allocator
        spec = self.faults.check("kv_exhaust")
        if spec is not None:
            want = max(int(spec.magnitude), 1)
            grab = min(want - len(self._kv_holds), alloc.n_free)
            if grab > 0:
                self._kv_holds.extend(alloc.alloc(grab))
                instant("kv_exhaust_hold", held=len(self._kv_holds))
        elif self._kv_holds:
            alloc.release(self._kv_holds)
            instant("kv_exhaust_release", released=len(self._kv_holds))
            self._kv_holds = []
        spec = self.faults.check("nan_logits")
        if spec is not None:
            row = int(self.faults.rng.integers(
                self.engine._next_logits.shape[0]))
            self.engine._next_logits[row] = float("nan")

    def _shed_for_blocks(self, version: int, now: float) -> None:
        """Shed decode-ready work until the next launch fits in the pool.

        Victims are the lowest priority class first (largest numeric
        priority), least decode progress within a class (cheapest to
        redo). The scheduler's preemption policy decides requeue vs drop.
        Never sheds the last sequence — headroom reclaim handles it.
        """
        shortfall = self.engine.decode_block_shortfall()
        while shortfall > 0:
            ready = self.engine.decode_ready_slots()
            if len(ready) <= 1:
                break
            victim = max(ready, key=lambda s: (
                self.engine.slots[s].priority,
                -len(self.engine.slots[s].generated)))
            req = self.engine.release_slot(victim)
            self.metrics.oom_sheds += 1
            instant("oom_shed", rid=req.rid, shortfall=shortfall)
            self.scheduler.handle_preempted(req, version, now)
            shortfall = self.engine.decode_block_shortfall()

    def _filter_nonfinite(self, finished: List[Request], version: int,
                          now: float) -> List[Request]:
        clean: List[Request] = []
        for req in finished:
            if np.isfinite(np.asarray(req.gen_logp, np.float64)).all():
                clean.append(req)
                continue
            self.metrics.nan_drops += 1
            instant("nan_drop", rid=req.rid)
            req.reset_generation()
            req.preempt_count = 0
            req.drop_reason = ""
            req.submit_version = version
            self.scheduler.enqueue(req, now)
        return clean

    # ------------------------------------------------------------ batch api
    def generate_batch(self, prompts: np.ndarray,
                       prompt_lengths: np.ndarray,
                       generator: Optional[torch.Generator], max_new: int,
                       priority: int = 0, max_steps: int = 10_000
                       ) -> RolloutBatch:
        """Submit a (padded, ragged) prompt batch; drive steps to completion.

        The drop-in replacement for ``RolloutEngine.generate`` in the async
        loop — but weight publishes landing mid-batch are *absorbed*
        (sequences resume, stamps record the boundary) instead of being
        serialized against generation. Every step draws from the one
        ``generator``.
        """
        B = prompts.shape[0]
        with span("serve_generate", batch=B, max_new=max_new):
            return self._generate_batch(prompts, prompt_lengths, generator,
                                        max_new, priority, max_steps)

    def _generate_batch(self, prompts, prompt_lengths, generator,
                        max_new: int, priority: int,
                        max_steps: int) -> RolloutBatch:
        B = prompts.shape[0]
        rids = []
        for i in range(B):
            L = int(prompt_lengths[i])
            rids.append(self.submit(prompts[i, :L], max_new,
                                    priority=priority))
        pending = set(rids)
        steps = idle = 0
        while pending:
            finished = self.step(generator)
            for req in finished:
                pending.discard(req.rid)
            # non-resubmitted drops never finish; account for them
            if not self.resubmit_dropped:
                pending -= {r.rid for r in self.dropped_requests}
            if not finished and self.n_inflight == 0:
                # admission held (backpressure / staleness budget) with
                # nothing decoding: idle-wait instead of burning max_steps.
                # A closed rollout queue never drains, so a hold on it
                # never lifts: end the wait (the reference waits out
                # 20,000 idle steps, ~100 s, then raises)
                q = self.rollout_queue
                if q is not None and q.closed:
                    raise QueueClosed("rollout queue closed while admission "
                                      "was held")
                idle += 1
                if idle > 20_000:
                    raise RuntimeError(
                        "control plane idle-stalled: admission held with "
                        "no work in flight (backpressure never released?)")
                time.sleep(0.005)
                continue
            idle = 0
            steps += 1
            if steps > max_steps:
                raise RuntimeError("control plane exceeded max_steps")
        reqs = [self._finished.pop(rid) for rid in rids
                if rid in self._finished]
        return self.rollout_batch(reqs, prompts.shape[1], max_new)

    def rollout_batch(self, reqs: List[Request], prompt_pad: int,
                      max_new: int) -> RolloutBatch:
        """Assemble finished requests into a stamped ``RolloutBatch`` (the
        batch's version is its oldest token's, else the store's)."""
        return rollout_batch(reqs, prompt_pad, max_new,
                             version=self.store.version)
