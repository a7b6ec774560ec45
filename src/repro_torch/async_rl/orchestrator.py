"""Async RL orchestration: decoupled rollout + training engines
(``repro.async_rl.orchestrator``).

Two operating modes:

* ``AsyncOrchestrator`` — real threads: a rollout worker continuously pulls
  the latest weights, generates groups, and pushes version-stamped batches;
  the trainer consumes fresh batches and publishes new weights. On one card
  the two threads share the device (and its default stream). With
  ``use_control_plane=True`` the worker generates through the serving
  control plane (``repro_torch.serving``): continuous batching with a radix
  prefix cache, weight publishes absorbed mid-batch and stamped per token.

* ``simulate_async`` — deterministic single-thread simulation with an
  explicit staleness schedule: the behaviour policy of step t is the
  version ``t - staleness`` parameter tree.

Both rely on the trainer returning new parameter tensors every step
(``Trainer(donate_params=False)``, the default): ``simulate_async`` keeps
the trees of earlier versions as behaviour policies, and the weight store
hands the published tree to the rollout thread. An in-place update would
turn every behaviour policy into the current one while the staleness
stamps still read ``d``.

Fault tolerance (``repro_torch.resilience``): both modes accept a
``ResilienceConfig``. The rollout worker runs under a ``SupervisedWorker``
(heartbeats, capture, bounded seeded restarts), queue pops go through
``pop_with_health`` (a dead producer raises instead of deadlocking the
trainer), weight publishes retry with backoff, a ``TrainGuard`` applies
skip/rollback policies to non-finite updates, periodic crash-consistent
checkpoints capture params/opt/step/RNG/weight-version, and a seeded
``FaultPlan`` can inject crashes/stalls/NaNs at any of those sites.
``StepRecord.resilience`` snapshots the ``resilience_*`` counters.
``simulate_async(resume=)`` continues a checkpointed run bit for bit: the
rollout ``torch.Generator``'s state is checkpointed where the reference
keeps its JAX key.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.async_rl.buffer import QueueClosed, RolloutQueue
from repro_torch.async_rl.weights import WeightStore
from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.models.model import require_device
from repro_torch.obs.tracing import (
    flow_end,
    flow_start,
    span,
    step_annotation,
)
from repro_torch.resilience.faults import resilience_snapshot
from repro_torch.resilience.publish import ResilientPublisher
from repro_torch.resilience.supervisor import (
    SupervisedWorker,
    pop_with_health,
)
from repro_torch.rollout.engine import RolloutEngine
from repro_torch.training.trainer import (
    TrainState,
    Trainer,
    assemble_train_batch,
)

# how long the trainer waits for a fresh batch before it gives up without
# a ResilienceConfig (the reference's RolloutQueue.pop_fresh default)
POP_DEADLINE_S = 30.0


@dataclasses.dataclass
class StepRecord:
    step: int
    reward: float
    loss: float
    entropy: float
    iw_max: float
    iw_min: float
    clipped_tokens: float
    staleness_mean: float
    prox_time_s: float
    rollout_time_s: float
    train_time_s: float
    wall_time_s: float
    eval_reward: Optional[float] = None  # held-out eval (when scheduled)
    # serving control-plane snapshot (staleness distribution, prefix-cache
    # hit rate, queue delay, page utilization, interrupt counts)
    serving: Optional[Dict[str, float]] = None
    # training-engine telemetry: response tokens updated this step and
    # device->host transfers the step performed (1; +1 for the explicit
    # prox pass of the 'recompute' baseline)
    train_tokens: float = 0.0
    host_syncs: float = 0.0
    # resilience_* counter snapshot (faults injected, worker restarts,
    # skipped updates, checkpoint saves/restores) when a ResilienceConfig
    # is active
    resilience: Optional[Dict[str, float]] = None


def _rollout_once(engine: RolloutEngine, task: ArithmeticTask, params,
                  version: int, n_prompts: int, group: int,
                  generator: Optional[torch.Generator]):
    batch = task.sample(n_prompts)
    prompts = np.repeat(batch.prompts, group, axis=0)
    lengths = np.repeat(batch.prompt_lengths, group)
    answers = [a for a in batch.answers for _ in range(group)]
    rb = engine.generate(params, prompts, lengths, generator,
                         version=version)
    completions = engine.completions(rb)
    rewards = task.rewards(completions, answers)
    return rb, rewards


def _inject_nan_reward(rewards: np.ndarray, faults) -> np.ndarray:
    """``nan_grad`` fault: poison one reward (seeded choice). Advantages,
    loss, and every gradient leaf go non-finite — exactly what the
    on-device guard must catch."""
    spec = faults.check("nan_grad") if faults is not None else None
    if spec is None:
        return rewards
    rewards = np.asarray(rewards, np.float32).copy()
    rewards[int(faults.rng.integers(len(rewards)))] = np.nan
    return rewards


def _record(step: int, m: Dict[str, float], rollout_t: float,
            train_t: float, t_start: float,
            serving: Optional[Dict[str, float]] = None,
            resilience=None) -> StepRecord:
    return StepRecord(
        step=step, reward=m["reward_mean"], loss=m["loss"],
        entropy=m.get("entropy", 0.0), iw_max=m["iw_max"],
        iw_min=m["iw_min"], clipped_tokens=m["clipped_tokens"],
        staleness_mean=m["staleness_mean"], prox_time_s=m["prox_time_s"],
        rollout_time_s=rollout_t, train_time_s=train_t,
        wall_time_s=time.perf_counter() - t_start, serving=serving,
        train_tokens=m.get("tokens", 0.0),
        host_syncs=m.get("host_syncs", 0.0),
        resilience=(None if resilience is None else resilience_snapshot()))


def _restore_params(resilience, state: TrainState) -> Optional[TrainState]:
    """Rollback: the latest checkpoint's params and Adam state under the
    live version (the version keeps counting, so staleness stamps stay
    monotonic); None without a checkpointer or a usable checkpoint."""
    if resilience is None or resilience.checkpointer is None:
        return None
    info = resilience.checkpointer.restore_latest(state.version.device)
    if info is None:
        return None
    return TrainState(info.state.params, info.state.opt, state.version)


class AsyncOrchestrator:
    """Thread-decoupled rollout/training loop.

    ``algo`` is an ``Algorithm`` instance or registry name
    (``core.algorithms``); dispatch is entirely the Trainer's. The trainer
    waits for batches through ``pop_with_health``: a crashed rollout worker
    raises ``WorkerFailed`` instead of leaving the trainer to time out.
    ``resilience`` is an optional ``repro_torch.resilience.ResilienceConfig``.
    """

    def __init__(self, cfg: ModelConfig, rl: RLConfig, task: ArithmeticTask,
                 algo="a3po", n_prompts: int = 16,
                 max_new_tokens: int = 8, queue_capacity: int = 4,
                 seed: int = 0, use_control_plane: bool = False,
                 serve_kwargs: Optional[Dict] = None,
                 decode_horizon: int = 8,
                 resilience=None):
        self.cfg, self.rl, self.task = cfg, rl, task
        self.n_prompts = n_prompts
        self.max_new_tokens = max_new_tokens
        self.engine = RolloutEngine(cfg, rl, max_new_tokens)
        self.resilience = resilience
        guard = resilience.guard if resilience is not None else None
        self.trainer = Trainer(
            cfg, rl, algo,
            skip_nonfinite=(guard is not None and guard.policy != "off"))
        self.algo = self.trainer.algo
        self.guard = guard
        self.queue = RolloutQueue(queue_capacity, rl.max_staleness)
        self.seed = seed
        self._stop = threading.Event()
        self._rollout_times: List[float] = []
        # serving control plane (interruptible continuous batching with a
        # radix prefix cache) instead of the run-to-completion engine
        self.use_control_plane = use_control_plane
        # decode horizon for the continuous-batching engine: tokens per
        # serving launch (host drains once per horizon). Weight publishes
        # are absorbed at horizon boundaries; per-token version stamps stay
        # truthful (first horizon token carries the version that produced
        # its logits).
        self.decode_horizon = decode_horizon
        self._serve_kwargs = serve_kwargs or {}
        self.control_plane = None
        self.worker = None  # the SupervisedWorker of the last run()

    @property
    def _faults(self):
        return self.resilience.faults if self.resilience is not None \
            else None

    def _build_control_plane(self, store: WeightStore, device):
        # imported here: serving imports async_rl's queue and weight store
        from repro_torch.rollout.continuous import ContinuousBatchingEngine
        from repro_torch.serving import (
            AdmissionScheduler,
            SchedulerConfig,
            ServingControlPlane,
        )
        kw = dict(max_seqs=self.n_prompts * self.rl.group_size,
                  block_size=8, n_blocks=512, max_blocks_per_seq=16,
                  decode_horizon=self.decode_horizon)
        kw.update(self._serve_kwargs)
        srv = ContinuousBatchingEngine(self.cfg, rl=self.rl, device=device,
                                       **kw)
        return ServingControlPlane(
            srv, store,
            AdmissionScheduler(SchedulerConfig(d_max=self.rl.max_staleness)),
            rollout_queue=self.queue, faults=self._faults)

    def _rollout_once_cp(self, generator: torch.Generator):
        """Group rollout through the serving control plane: GRPO members
        share one prefill via the radix cache, and weight publishes landing
        mid-batch are absorbed with per-token version stamps."""
        batch = self.task.sample(self.n_prompts)
        group = self.rl.group_size
        prompts = np.repeat(batch.prompts, group, axis=0)
        lengths = np.repeat(batch.prompt_lengths, group)
        answers = [a for a in batch.answers for _ in range(group)]
        rb = self.control_plane.generate_batch(
            prompts, lengths, generator, max_new=self.max_new_tokens)
        completions = self.engine.completions(rb)
        rewards = self.task.rewards(completions, answers)
        return rb, rewards

    def _rollout_worker(self, ctx, store: WeightStore, device) -> None:
        """Supervised worker body: loops until told to stop, heartbeats
        every iteration, raises on injected crashes (the supervisor
        captures + restarts)."""
        faults = self._faults
        generator = torch.Generator(device=device).manual_seed(self.seed + 1)
        while not ctx.should_stop():
            ctx.heartbeat()
            if faults is not None:
                faults.maybe_crash("rollout_crash")
                stall = faults.check("queue_stall")
                if stall is not None and stall.magnitude > 0:
                    time.sleep(stall.magnitude)
            t0 = time.perf_counter()
            if self.control_plane is not None:
                rb, rewards = self._rollout_once_cp(generator)
            else:
                params, version = store.latest()
                with span("rollout", version=version) as sp:
                    rb, rewards = _rollout_once(
                        self.engine, self.task, params, version,
                        self.n_prompts, self.rl.group_size, generator)
                    sp.set(reward_mean=float(np.mean(rewards)))
                    # close the publish->rollout flow arrow: first rollout
                    # generated under the published version
                    flow_end("publish", version)
            self._rollout_times.append(time.perf_counter() - t0)
            rb.rewards = rewards  # piggyback
            try:
                if not self.queue.push(rb, timeout=1.0):
                    continue  # queue full — back-pressure
            except QueueClosed:
                return  # consumer went away: clean exit

    def _checkpoint(self, step_done: int, state: TrainState) -> None:
        res = self.resilience
        if res is not None and res.maybe_checkpoint(step_done):
            res.checkpointer.save(
                step_done + 1, state,
                task_rng_state=self.task.rng.bit_generator.state,
                extra={"algo": self.algo.name, "mode": "async"})

    def _apply_guard(self, state: TrainState, m: Dict[str, float]
                     ) -> TrainState:
        """Host-side guard policy on the step's (already transferred)
        metrics; a rollback restores the latest checkpoint's params and
        Adam state under the live version."""
        if self.guard is None:
            return state
        if self.guard.after_step(m).action == "rollback":
            state = _restore_params(self.resilience, state) or state
        return state

    def run(self, state: TrainState, num_steps: int,
            run_logger=None, start_step: int = 0
            ) -> (TrainState, List[StepRecord]):
        """Drive training steps ``start_step..num_steps-1`` against the
        live rollout worker. ``run_logger`` (``obs.runlog.RunLogger``)
        gets exactly one JSONL step record per training step."""
        res = self.resilience
        self._stop.clear()
        device = state.version.device
        version = int(state.version)
        store = WeightStore(state.params, version)
        publisher = None
        if res is not None:
            publisher = ResilientPublisher(
                store, faults=res.faults,
                max_retries=res.publish_max_retries, seed=res.seed)
        if self.use_control_plane:
            self.control_plane = self._build_control_plane(store, device)
        self.worker = SupervisedWorker(
            "rollout-worker", self._rollout_worker, args=(store, device),
            max_restarts=(res.max_worker_restarts if res is not None
                          else 0),
            heartbeat_timeout_s=(res.heartbeat_timeout_s if res is not None
                                 else 60.0),
            seed=(res.seed if res is not None else 0),
            stop_event=self._stop)
        deadline = res.pop_deadline_s if res is not None else POP_DEADLINE_S
        t_start = time.perf_counter()
        self.worker.start()
        records: List[StepRecord] = []
        faults = self._faults
        try:
            for step in range(start_step, num_steps):
                if faults is not None:
                    faults.maybe_crash("train_crash")
                with step_annotation(step):
                    batches = pop_with_health(
                        self.queue, self.worker, version, n=1,
                        deadline_s=deadline)
                    rewards = np.concatenate([b.rewards for b in batches])
                    rewards = _inject_nan_reward(rewards, faults)
                    tb = assemble_train_batch(batches, rewards,
                                              device=device)
                    t0 = time.perf_counter()
                    with span("train_step", step=step):
                        state, m = self.trainer.step(state, tb)
                    train_t = time.perf_counter() - t0
                    state = self._apply_guard(state, m)
                    version += 1  # Trainer.step advances it by one
                    with span("weight_publish", version=version):
                        if publisher is not None:
                            publisher.publish(state.params, version)
                        else:
                            store.publish(state.params, version)
                        # open the publish->resume flow arrow (closed by
                        # the first rollout/serving step under `version`)
                        flow_start("publish", version)
                self._checkpoint(step, state)
                serving = (self.control_plane.metrics.snapshot()
                           if self.control_plane is not None else None)
                records.append(_record(
                    step, m, (np.mean(self._rollout_times[-3:])
                              if self._rollout_times else 0.0),
                    train_t, t_start, serving, res))
                if run_logger is not None:
                    run_logger.log_step(records[-1])
        finally:
            self._stop.set()
            self.queue.close()
            self.worker.stop(timeout=60.0)
        return state, records


def simulate_async(cfg: ModelConfig, rl: RLConfig, task: ArithmeticTask,
                   algo, num_steps: int, *,
                   n_prompts: int = 8, max_new_tokens: int = 8,
                   staleness: int = 1, seed: int = 0,
                   init_state: Optional[TrainState] = None,
                   record_hook: Optional[Callable[[int, Dict], None]] = None,
                   eval_every: int = 0,
                   eval_fn: Optional[Callable] = None,
                   num_microbatches: int = 1,
                   run_logger=None,
                   resilience=None,
                   resume=None,
                   device="cuda",
                   ) -> (TrainState, List[StepRecord]):
    """Deterministic async simulation: behavior policy lags ``staleness``
    versions behind (0 == synchronous on-policy). ``algo`` is an
    ``Algorithm`` or registry name. ``eval_fn(params)`` is invoked every
    ``eval_every`` steps (the paper's held-out eval worker, Fig. 3);
    results land in ``StepRecord.eval_reward``. ``run_logger``
    (``obs.runlog.RunLogger``) gets one JSONL step record per step.

    The run lives on ``init_state``'s (or ``resume``'s) device, or on
    ``device`` (default the card) where it initialises the state from
    ``seed + 7``. One ``torch.Generator`` seeded from ``seed`` drives every
    rollout's sampling, where the reference splits a key per step.

    ``resilience`` (``repro_torch.resilience.ResilienceConfig``) enables
    periodic checkpoints, guard policies, and fault injection; ``resume``
    (``repro_torch.resilience.ResumeInfo``, e.g. from
    ``CheckpointManager.restore_latest()``) continues a checkpointed run —
    params, Adam state, weight version, the rollout generator's state,
    staleness history, and the task's RNG stream are all restored, so the
    resumed run is bit-identical to the uninterrupted one from that step.
    """
    guard = resilience.guard if resilience is not None else None
    faults = resilience.faults if resilience is not None else None
    engine = RolloutEngine(cfg, rl, max_new_tokens)
    trainer = Trainer(
        cfg, rl, algo, num_microbatches=num_microbatches,
        skip_nonfinite=(guard is not None and guard.policy != "off"))
    start_step = 0
    if resume is not None:
        state = resume.state
        start_step = resume.step
    elif init_state is None:
        device = require_device(device)
        state = trainer.init_state(
            torch.Generator(device=device).manual_seed(seed + 7),
            device=device)
    else:
        state = init_state
    device = state.version.device
    generator = torch.Generator(device=device).manual_seed(seed)
    version = int(state.version)
    history: deque = deque(maxlen=staleness + 1)
    if resume is not None and resume.history is not None:
        history.extend(resume.history)
    else:
        history.append((state.params, version))
    if resume is not None:
        if resume.generator_state is not None:
            generator.set_state(resume.generator_state)
        if resume.task_rng_state is not None:
            task.rng.bit_generator.state = resume.task_rng_state
    records: List[StepRecord] = []
    t_start = time.perf_counter()
    for step in range(start_step, num_steps):
        if faults is not None:
            faults.maybe_crash("train_crash")
        behav_params, behav_version = history[0]
        t0 = time.perf_counter()
        with span("rollout", step=step, version=behav_version) as sp:
            rb, rewards = _rollout_once(engine, task, behav_params,
                                        behav_version, n_prompts,
                                        rl.group_size, generator)
            sp.set(reward_mean=float(np.mean(rewards)))
            # close the publish->rollout staleness arrow: the simulated
            # behavior policy first acts `staleness` steps after publish
            flow_end("publish", behav_version)
        rollout_t = time.perf_counter() - t0
        rewards = _inject_nan_reward(rewards, faults)
        tb = assemble_train_batch([rb], rewards, device=device)
        t0 = time.perf_counter()
        with step_annotation(step), span("train_step", step=step,
                                         staleness=staleness):
            state, m = trainer.step(state, tb)
        train_t = time.perf_counter() - t0
        if guard is not None and guard.after_step(m).action == "rollback":
            restored = _restore_params(resilience, state)
            if restored is not None:
                state = restored
                history.clear()
        version += 1  # Trainer.step advances it by one
        with span("weight_publish", version=version):
            history.append((state.params, version))
            flow_start("publish", version)
        if resilience is not None and resilience.maybe_checkpoint(step):
            resilience.checkpointer.save(
                step + 1, state, generator_state=generator.get_state(),
                history=list(history),
                task_rng_state=task.rng.bit_generator.state,
                extra={"algo": trainer.algo.name, "mode": "sim",
                       "staleness": staleness})
        rec = _record(step, m, rollout_t, train_t, t_start,
                      resilience=resilience)
        if eval_fn and eval_every and (step + 1) % eval_every == 0:
            rec.eval_reward = float(eval_fn(state.params))
        records.append(rec)
        if run_logger is not None:
            run_logger.log_step(rec)
        if record_hook:
            record_hook(step, m)
    return state, records
