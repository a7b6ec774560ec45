"""The fault-tolerance runtime of the PyTorch port (``repro_torch.resilience``)
against the JAX package's, float32 on the CPU.

The tests of ``tests/test_resilience.py`` in intent, with their own
assertions kept: the fault plane's grammar and its seeded draws (equal to
JAX's), atomic checkpoints and the step-named manager (retention, the
corrupt-newest fallback, bf16 kept exactly, files that either package
reads), the rollout queue's timeouts, the supervised worker, the guards,
crash-then-resume bit for bit in the port, the ``nan_grad`` guard through
``simulate_async`` against JAX's (rtol 2e-4 / atol 1e-5 on the metrics,
rtol 2e-4 / atol 1e-6 on the parameters, Adam eps 1e-4 as
``tests/test_torch_async.py``), the threaded orchestrator under rollout
crashes, publish retries, and ``kv_exhaust`` / ``nan_logits`` through both
packages' control planes (tokens, stamps and counters exact, logps 1e-4).
Also: the zero-token request's version stamp against JAX's
``rollout_batch``, the launcher's fault-tolerance flags on both engines,
and the port's ``obs.report`` / ``obs.validate``.

Not mirrored: ``test_restore_sharded_on_multidevice_mesh`` (sharded
restore arrives with the distribution slice). ``DivergenceDetector`` keeps
the reference's rule that a window with zero spread never trips; its test
here pins that case instead of expecting a trip.
"""
import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_rl import orchestrator as jorch
from repro.async_rl.weights import WeightStore as JaxWeightStore
from repro.configs.base import RLConfig as JaxRLConfig
from repro.configs.registry import get_config as jax_get_config
from repro.data.tasks import ArithmeticTask as JaxTask
from repro.resilience import FaultPlan as JaxFaultPlan
from repro.resilience import ResilienceConfig as JaxResilienceConfig
from repro.resilience import TrainGuard as JaxTrainGuard
from repro.rollout.continuous import ContinuousBatchingEngine as JaxEngine
from repro.rollout.continuous import Request as JaxRequest
from repro.rollout.engine import RolloutEngine as JaxRolloutEngine
from repro.rollout import paged_cache as jpc
from repro.serving import AdmissionScheduler as JaxScheduler
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import ServingControlPlane as JaxControlPlane
from repro.training import checkpoints as jckpt
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch.async_rl import orchestrator as orch
from repro_torch.async_rl.buffer import QueueClosed, RolloutQueue
from repro_torch.async_rl.weights import WeightStore
from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.launch import train as launcher
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_jax, walk
from repro_torch.obs import report, validate
from repro_torch.obs.runlog import read_jsonl
from repro_torch.resilience import (
    CheckpointManager,
    DivergenceDetector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    PublishError,
    ResilienceConfig,
    ResilientPublisher,
    SupervisedWorker,
    TrainGuard,
    WorkerFailed,
    parse_fault,
    pop_with_health,
)
from repro_torch.rollout import paged_cache as pc
from repro_torch.rollout.continuous import ContinuousBatchingEngine, Request
from repro_torch.rollout.engine import RolloutBatch, RolloutEngine
from repro_torch.serving import (
    AdmissionScheduler,
    SchedulerConfig,
    ServingControlPlane,
)
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer as tr
from repro_torch.training.checkpoints import (
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "experiments" / "ckpt" / "toy-2m_loglinear"
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
LOGP_TOL = 1e-4
RECORD_METRICS = ("reward", "loss", "entropy", "iw_max", "iw_min",
                  "clipped_tokens", "staleness_mean", "train_tokens",
                  "host_syncs")


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def toy():
    return _f32(get_config("toy-2m"))


@pytest.fixture(scope="module")
def rl():
    return RLConfig(group_size=2, num_minibatches=1, learning_rate=2e-4,
                    max_staleness=3)


def _task(cls=ArithmeticTask):
    return cls(max_operand=9, n_terms=2, prompt_len=8, seed=0)


def _mk_batch(version):
    return RolloutBatch(np.zeros((1, 4), np.int32), np.array([2]),
                        np.zeros((1, 2), np.float32),
                        np.ones((1, 2), np.float32), version=version)


def _init_state(cfg, rl, seed=0):
    return tr.Trainer(cfg, rl, "loglinear").init_state(
        torch.Generator().manual_seed(seed), device="cpu")


def _leaves(tree):
    return [v for _, v in walk(tree)]


def _assert_trees_equal(a, b):
    fa = opt.flatten(a)
    fb = opt.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k].detach(), fb[k].detach()), k


def _assert_states_equal(a, b):
    _assert_trees_equal(a.params, b.params)
    _assert_trees_equal(a.opt["m"], b.opt["m"])
    _assert_trees_equal(a.opt["v"], b.opt["v"])
    assert int(a.opt["t"]) == int(b.opt["t"])
    assert int(a.version) == int(b.version)


# ------------------------------------------------------------- fault plane
class TestFaultPlan:
    def test_parse_grammar(self):
        s = parse_fault("rollout_crash@3")
        assert (s.kind, s.at, s.times, s.magnitude) == \
            ("rollout_crash", 3, 1, 0.0)
        s = parse_fault("kv_exhaust@5x3:64")
        assert (s.kind, s.at, s.times, s.magnitude) == \
            ("kv_exhaust", 5, 3, 64.0)
        s = parse_fault("queue_stall@2:0.25")
        assert (s.kind, s.at, s.times, s.magnitude) == \
            ("queue_stall", 2, 1, 0.25)
        assert parse_fault(s.spec_str()) == s

    def test_parse_rejects_garbage(self):
        with pytest.raises(ValueError):
            parse_fault("no_at_sign")
        with pytest.raises(ValueError):
            parse_fault("unknown_kind@0")
        with pytest.raises(ValueError):
            FaultSpec("train_crash", at=-1)
        with pytest.raises(ValueError):
            FaultSpec("train_crash", at=0, times=0)

    def test_occurrence_window(self):
        plan = FaultPlan([FaultSpec("train_crash", at=2, times=2)])
        hits = [plan.check("train_crash") is not None for _ in range(6)]
        assert hits == [False, False, True, True, False, False]
        assert plan.occurrences("train_crash") == 6
        assert [f["occurrence"] for f in plan.fired] == [2, 3]

    def test_sites_are_independent(self):
        plan = FaultPlan([FaultSpec("nan_grad", at=0)])
        assert plan.check("rollout_crash") is None  # different site
        assert plan.check("nan_grad") is not None

    def test_maybe_crash_raises(self):
        plan = FaultPlan.from_strings(["train_crash@1"])
        plan.maybe_crash("train_crash")  # occurrence 0: healthy
        with pytest.raises(InjectedFault) as ei:
            plan.maybe_crash("train_crash")
        assert ei.value.occurrence == 1

    def test_seeded_draws_and_fires_equal_jax(self):
        """The same specs and seed fire at the same occurrences and draw
        the same rows as JAX's plan (both are numpy's default_rng)."""
        specs = ["kv_exhaust@1x3:7", "nan_logits@2", "publish_fail@0x2"]
        ours = FaultPlan.from_strings(specs, seed=7)
        ref = JaxFaultPlan.from_strings(specs, seed=7)
        for plan in (ours, ref):
            for _ in range(5):
                for kind in ("kv_exhaust", "nan_logits", "publish_fail"):
                    plan.check(kind)
        assert ours.fired == ref.fired and len(ours.fired) == 6
        np.testing.assert_array_equal(ours.rng.integers(1000, size=5),
                                      ref.rng.integers(1000, size=5))
        a = FaultPlan([], seed=7).rng.integers(1000, size=5)
        b = FaultPlan([], seed=7).rng.integers(1000, size=5)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ atomic checkpoints
class TestAtomicCheckpoint:
    def test_roundtrip_and_checksum(self, tmp_path):
        path = str(tmp_path / "ck")
        tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                "nested": {"b": np.ones((3,), np.float32)}}
        save_checkpoint(path, tree, {"step": 4})
        out, meta = load_checkpoint(path)
        assert meta == {"step": 4}  # format keys stripped
        np.testing.assert_array_equal(out["w"], tree["w"])
        # no staging litter left behind
        assert not [n for n in os.listdir(tmp_path)
                    if n.startswith(".ckpt-tmp")]

    def test_torn_npz_detected(self, tmp_path):
        path = str(tmp_path / "ck")
        save_checkpoint(path, {"w": np.ones((8, 8), np.float32)}, {})
        with open(path + ".npz", "r+b") as f:
            f.seek(60)
            f.write(b"\xde\xad\xbe\xef")
        with pytest.raises(CheckpointError, match="checksum"):
            load_checkpoint(path)

    def test_missing_pieces_detected(self, tmp_path):
        path = str(tmp_path / "ck")
        save_checkpoint(path, {"w": np.ones(3, np.float32)}, {})
        os.unlink(path + ".json")
        with pytest.raises(CheckpointError):
            load_checkpoint(path)
        with pytest.raises(CheckpointError):
            load_checkpoint(str(tmp_path / "never-saved"))


class TestCheckpointManager:
    def test_save_restore_full_capture(self, toy, rl, tmp_path):
        state = _init_state(toy, rl)
        task = _task()
        task.sample(3)  # advance the RNG so the state is non-trivial
        mgr = CheckpointManager(str(tmp_path))
        gen = torch.Generator().manual_seed(42)
        torch.rand(3, generator=gen)
        mgr.save(2, state, generator_state=gen.get_state(),
                 history=[(state.params, 0)],
                 task_rng_state=task.rng.bit_generator.state,
                 extra={"algo": "a3po"})
        info = mgr.restore_latest(device="cpu")
        assert info is not None and info.step == 2
        assert info.metadata["algo"] == "a3po"
        # the restored generator continues the same stream
        fresh = torch.Generator()
        fresh.set_state(info.generator_state)
        assert torch.equal(torch.rand(4, generator=fresh),
                           torch.rand(4, generator=gen))
        assert len(info.history) == 1 and info.history[0][1] == 0
        # restored task RNG continues the same stream
        fresh_task = _task()
        fresh_task.rng.bit_generator.state = info.task_rng_state
        np.testing.assert_array_equal(fresh_task.sample(2).prompts,
                                      task.sample(2).prompts)
        _assert_states_equal(state, info.state)
        _assert_trees_equal(state.params, info.history[0][0])
        assert all(p.requires_grad for p in _leaves(info.state.params))

    def test_bfloat16_leaves_round_trip_exactly(self, tmp_path):
        """bf16 params (written as float32) come back bf16, bit for bit;
        the Adam moments stay float32 and t an int32 tensor."""
        cfg = get_config("toy-2m")
        state = tr.Trainer(cfg, RLConfig(), "a3po").init_state(
            torch.Generator().manual_seed(1), dtype=torch.bfloat16,
            device="cpu")
        with torch.no_grad():
            for m in _leaves(state.opt["m"]):
                m.normal_()
        state.opt["t"].fill_(5)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, state, history=[(state.params, 0)])
        info = mgr.restore(mgr.path_for(1), device="cpu")
        assert {p.dtype for p in _leaves(info.state.params)} == \
            {torch.bfloat16}
        assert {p.dtype for p in _leaves(info.state.opt["m"])} == \
            {torch.float32}
        assert info.state.opt["t"].dtype == torch.int32
        _assert_states_equal(state, info.state)
        _assert_trees_equal(state.params, info.history[0][0])

    def test_latest_pointer_and_retention(self, toy, rl, tmp_path):
        state = _init_state(toy, rl)
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for step in (1, 2, 3, 4):
            mgr.save(step, state)
        assert mgr.latest_step() == 4
        kept = sorted(n for n in os.listdir(tmp_path)
                      if n.endswith(".json") and n != "latest")
        assert kept == ["step_00000003.json", "step_00000004.json"]

    def test_corrupt_newest_falls_back(self, toy, rl, tmp_path):
        state = _init_state(toy, rl)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, state)
        mgr.save(2, state)
        # tear the newest checkpoint's npz (simulated mid-write crash)
        with open(mgr.path_for(2) + ".npz", "r+b") as f:
            f.seek(40)
            f.write(b"\x00" * 16)
        info = mgr.restore_latest(device="cpu")
        assert info is not None and info.step == 1

    def test_empty_dir_returns_none(self, tmp_path):
        assert CheckpointManager(str(tmp_path)).restore_latest(
            device="cpu") is None

    def test_files_are_the_references(self, toy, rl, tmp_path):
        """A port checkpoint loads in JAX's training.checkpoints with the
        reference's keys (params, opt, history); no JAX key is stored, so
        a reference checkpoint cannot resume a port loop's sampling."""
        state = _init_state(toy, rl)
        mgr = CheckpointManager(str(tmp_path))
        path = mgr.save(3, state, history=[(state.params, 2)])
        tree, meta = jckpt.load_checkpoint(path)
        assert set(tree) == {"params", "opt", "history"}
        assert meta["step"] == 3 and meta["version"] == 0
        assert not meta["has_generator_state"]
        assert int(tree["history"][0]["version"]) == 2
        for path_, v in walk(state.params):
            node = tree["params"]
            for p in path_:
                node = node[p]
            np.testing.assert_array_equal(node, v.detach().numpy())


# ------------------------------------------------------------ rollout queue
class TestRolloutQueueTimeouts:
    def test_pop_timeout_raises(self):
        q = RolloutQueue(capacity=2, max_staleness=2)
        with pytest.raises(TimeoutError):
            q.pop(timeout=0.05)
        with pytest.raises(TimeoutError):
            q.pop_fresh(current_version=0, n=1, timeout=0.05)

    def test_close_wakes_blocked_consumer(self):
        q = RolloutQueue(capacity=2, max_staleness=2)
        err = []

        def consumer():
            try:
                q.pop(timeout=30.0)
            except QueueClosed as e:
                err.append(e)

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.05)
        q.close()
        t.join(timeout=5.0)
        assert not t.is_alive() and len(err) == 1

    def test_closed_queue_still_drains_pending(self):
        q = RolloutQueue(capacity=2, max_staleness=2)
        q.push(_mk_batch(0))
        q.close()
        assert q.pop(timeout=0.5).version == 0
        with pytest.raises(QueueClosed):
            q.pop(timeout=0.5)
        with pytest.raises(QueueClosed):
            q.push(_mk_batch(1))

    def test_pop_fresh_deadline_spans_stale_drops(self):
        """Stale batches must not reset the clock: the whole call is
        bounded by one deadline."""
        q = RolloutQueue(capacity=4, max_staleness=1)
        q.push(_mk_batch(0))  # stale at current_version=5
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            q.pop_fresh(current_version=5, n=1, timeout=0.2)
        assert time.perf_counter() - t0 < 5.0
        assert q.dropped == 1


# --------------------------------------------------------------- supervisor
class TestSupervisedWorker:
    def test_crash_restart_then_succeed(self):
        calls = []

        def body(ctx):
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("boom")
            while not ctx.should_stop():
                ctx.heartbeat()
                time.sleep(0.01)

        w = SupervisedWorker("t", body, max_restarts=5,
                             backoff_base_s=0.01, backoff_max_s=0.02)
        w.start()
        deadline = time.time() + 5.0
        while w.restarts < 2 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        assert w.alive and not w.failed
        assert w.restarts == 2 and len(w.crashes) == 2
        assert w.health_error() is None
        assert w.crashes[0].recovery_s >= 0.0  # MTTR sample recorded
        w.stop()
        assert not w.alive

    def test_budget_exhaustion_flags_failed(self):
        def body(ctx):
            raise ValueError("always broken")

        w = SupervisedWorker("t", body, max_restarts=2,
                             backoff_base_s=0.005, backoff_max_s=0.01)
        w.start()
        deadline = time.time() + 5.0
        while not w.failed and time.time() < deadline:
            time.sleep(0.01)
        assert w.failed and w.restarts == 2 and len(w.crashes) == 3
        assert "failed permanently" in w.health_error()
        assert w.last_crash.exc_type == "ValueError"

    def test_pop_with_health_deadline(self):
        q = RolloutQueue(capacity=2, max_staleness=2)
        with pytest.raises(TimeoutError):
            pop_with_health(q, None, current_version=0, poll_s=0.05,
                            deadline_s=0.15)


# ------------------------------------------------------------------- guards
class TestGuards:
    def test_divergence_detector(self):
        """A spike over a window with spread trips, as does a non-finite
        loss; a window of identical losses (std 0) never trips (the
        reference's ``std > 0`` rule, kept), and the spike then joins
        the window."""
        flat = DivergenceDetector(window=8, threshold_sigmas=4.0,
                                  min_window=4)
        for _ in range(8):
            assert not flat.update(1.0)
        assert not flat.update(100.0)
        assert flat.update(float("nan"))
        det = DivergenceDetector(window=8, threshold_sigmas=4.0,
                                 min_window=4)
        rng = np.random.default_rng(0)
        for _ in range(8):
            assert not det.update(1.0 + 0.01 * rng.standard_normal())
        assert det.update(100.0)
        assert det.update(float("nan"))
        assert det.update(float("inf"))

    def test_guard_policies(self):
        g = TrainGuard(policy="skip")
        ok = g.after_step({"loss": 1.0, "nonfinite": 0.0})
        assert ok.action == "ok"
        v = g.after_step({"loss": float("nan"), "nonfinite": 2.0})
        # counts skipped *minibatches*, not steps
        assert v.action == "skip" and g.skipped_updates == 2
        g2 = TrainGuard(policy="rollback")
        v2 = g2.after_step({"loss": float("nan"), "nonfinite": 1.0})
        assert v2.action == "rollback" and g2.rollbacks == 1
        assert TrainGuard(policy="off").after_step(
            {"loss": float("nan"), "nonfinite": 1.0}).action == "ok"

    def test_on_device_skip_keeps_params_bit_identical(self, toy, rl):
        """A NaN reward poisons loss + every grad leaf; with the guard the
        step leaves params and Adam state exactly unchanged and counts the
        skipped minibatch. Without it, params go non-finite."""
        task = _task()
        engine = RolloutEngine(toy, rl, max_new_tokens=3)
        guarded = tr.Trainer(toy, rl, "loglinear", skip_nonfinite=True)
        state = _init_state(toy, rl)
        batch = task.sample(2)
        prompts = np.repeat(batch.prompts, rl.group_size, axis=0)
        lengths = np.repeat(batch.prompt_lengths, rl.group_size)
        rb = engine.generate(state.params, prompts, lengths,
                             torch.Generator().manual_seed(1), version=0)
        rewards = np.full((prompts.shape[0],), np.nan, np.float32)
        tb = tr.assemble_train_batch([rb], rewards, device="cpu")
        before = {k: v.detach().clone()
                  for k, v in opt.flatten(state.params).items()}
        opt_before = {k: v.clone() for k, v in
                      opt.flatten({"m": state.opt["m"], "v": state.opt["v"],
                                   "t": state.opt["t"]}).items()}
        state2, m = guarded.step(state, tb)
        assert m["nonfinite"] >= 1.0
        for k, v in opt.flatten(state2.params).items():
            assert torch.equal(v.detach(), before[k]), k
        for k, v in opt.flatten({"m": state2.opt["m"], "v": state2.opt["v"],
                                 "t": state2.opt["t"]}).items():
            assert torch.equal(v, opt_before[k]), k

        state3, _ = tr.Trainer(toy, rl, "loglinear").step(state, tb)
        assert not all(bool(torch.isfinite(v).all())
                       for v in _leaves(state3.params))


# ------------------------------------------------------------ sim chaos
class _TaskRngCoins(ArithmeticTask):
    """Rewards are Bernoulli(0.5) draws from the task's own RNG (which a
    checkpoint captures): a random model scores 0 on the verifier, which
    would leave every update empty and any resume trivially exact."""

    def rewards(self, completions, answers):
        return self.rng.binomial(1, 0.5, len(answers)).astype(np.float32)


def _scaled_state():
    """toy-2m with the layer weights x8: at init stds the random model
    puts probability ~1 on one token, and sampling would not depend on
    the generator at all."""
    params = from_jax(_seeded_arrays(), device="cpu", requires_grad=True)
    return tr.TrainState(params, opt.adam_init(params),
                         torch.tensor(0, dtype=torch.int32))


def _sim(cfg, rl, steps, res, resume=None):
    return orch.simulate_async(
        cfg, rl, _task(_TaskRngCoins), "loglinear", steps, n_prompts=2,
        max_new_tokens=3, staleness=1, seed=0, resilience=res,
        resume=resume, init_state=None if resume else _scaled_state())


class TestSimulatorChaos:
    def test_crash_resume_bit_exact(self, toy, rl, tmp_path):
        """Kill mid-training at a fault-plan step; ``--resume auto``
        semantics restore params/opt/generator/task RNG/staleness history
        and the run finishes bit-identical to an uninterrupted one. A
        resume that leaves the generator's state behind does not."""
        steps, every, crash_at = 6, 2, 5
        res_a = ResilienceConfig(
            checkpointer=CheckpointManager(str(tmp_path / "a")),
            ckpt_every=every)
        state_a, recs_a = _sim(toy, rl, steps, res_a)
        assert recs_a[-1].resilience[
            "resilience_checkpoint_saves_total"] >= 3

        res_b = ResilienceConfig(
            checkpointer=CheckpointManager(str(tmp_path / "b")),
            ckpt_every=every,
            faults=FaultPlan.from_strings([f"train_crash@{crash_at}"]))
        with pytest.raises(InjectedFault):
            _sim(toy, rl, steps, res_b)

        res_c = ResilienceConfig(
            checkpointer=CheckpointManager(str(tmp_path / "b")),
            ckpt_every=every)
        resume = res_c.checkpointer.restore_latest(device="cpu")
        assert resume is not None and resume.step == 4
        state_c, recs_c = _sim(toy, rl, steps, res_c, resume)
        assert [r.step for r in recs_c] == [4, 5]
        _assert_states_equal(state_a, state_c)
        for a, c in zip(recs_a[4:], recs_c):
            assert (a.loss, a.reward, a.iw_max) == (c.loss, c.reward,
                                                    c.iw_max)

        # teeth: the same resume with a fresh generator diverges
        resume = res_c.checkpointer.restore(
            res_c.checkpointer.path_for(4), device="cpu")
        resume.generator_state = None
        state_d, _ = _sim(toy, rl, steps, None, resume)
        assert any(not torch.equal(a, d) for a, d in zip(
            _leaves(state_a.params), _leaves(state_d.params)))

    def test_nan_grad_fault_with_guard(self, toy, rl):
        res = ResilienceConfig(
            faults=FaultPlan.from_strings(["nan_grad@1"]),
            guard=TrainGuard(policy="skip"))
        state, recs = _sim(toy, rl, 3, res)
        assert res.guard.skipped_updates == 1
        assert all(bool(torch.isfinite(v).all())
                   for v in _leaves(state.params))
        snap = recs[-1].resilience
        assert snap['resilience_faults_injected_total{kind="nan_grad"}'] \
            >= 1.0

    def test_rollback_restores_the_checkpoint(self, toy, rl, tmp_path):
        """``guard=rollback``: the poisoned step's params and Adam state
        are the latest checkpoint's, while the version keeps counting."""
        mgr = CheckpointManager(str(tmp_path))
        res = ResilienceConfig(
            faults=FaultPlan.from_strings(["nan_grad@2"]),
            guard=TrainGuard(policy="rollback"), checkpointer=mgr,
            ckpt_every=1)
        seen = {}
        save = mgr.save

        def spy_save(step, state, **kw):
            seen[step] = {k: v.detach().clone()
                          for k, v in opt.flatten(state.params).items()}
            return save(step, state, **kw)
        mgr.save = spy_save
        state, recs = _sim(toy, rl, 3, res)
        assert res.guard.rollbacks == 1 and int(state.version) == 3
        # step 2 rolled back to the step-2 checkpoint (after step 1)
        for k, v in opt.flatten(state.params).items():
            assert torch.equal(v.detach(), seen[2][k]), k


class _CoinMixin:
    """Rewards are seeded Bernoulli(0.5) draws, the same in both
    packages (as ``tests/test_torch_async.py``)."""

    def rewards(self, completions, answers):
        if not hasattr(self, "_coin"):
            self._coin = np.random.default_rng(123)
        return self._coin.binomial(1, 0.5, len(answers)).astype(np.float32)


class _JaxCoinTask(_CoinMixin, JaxTask):
    pass


class _CoinTask(_CoinMixin, ArithmeticTask):
    pass


def _greedy(monkeypatch):
    """Both packages' RolloutEngine.generate greedy, each row's first digit
    set (``tests/test_torch_async.py::_greedy``)."""
    digits = np.array([tok.CHAR_TO_ID[str(i % 10)] for i in range(64)])
    for cls in (JaxRolloutEngine, RolloutEngine):
        def generate(self, params, prompts, lengths, key, *,
                     _orig=cls.generate, **kw):
            prompts = np.array(prompts)
            prompts[:, 1] = digits[: len(prompts)]
            return _orig(self, params, prompts, lengths, key, greedy=True,
                         **kw)
        monkeypatch.setattr(cls, "generate", generate)


def test_nan_grad_guard_matches_jax(monkeypatch):
    """``nan_grad@1`` with the skip guard through both packages'
    simulate_async from the toy checkpoint (greedy rollouts, seeded
    rewards): the same reward row is poisoned, the same minibatch
    skipped, every record metric and the final parameters agree."""
    tree, _ = jckpt.load_checkpoint(str(CKPT))
    with np.load(str(CKPT) + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    _greedy(monkeypatch)
    base = dict(group_size=4, num_minibatches=2, learning_rate=3e-4,
                adam_eps=1e-4)
    jrl, trl = JaxRLConfig(**base), RLConfig(**base)
    jp = jax.tree.map(jnp.asarray, tree["params"])
    js = jtrainer.TrainState(jp, jopt.adam_init(jp),
                             jnp.asarray(0, jnp.int32))
    tp = from_jax(flat, device="cpu", requires_grad=True)
    ts = tr.TrainState(tp, opt.adam_init(tp),
                       torch.tensor(0, dtype=torch.int32))
    jres = JaxResilienceConfig(
        faults=JaxFaultPlan.from_strings(["nan_grad@1"]),
        guard=JaxTrainGuard(policy="skip"))
    tres = ResilienceConfig(faults=FaultPlan.from_strings(["nan_grad@1"]),
                            guard=TrainGuard(policy="skip"))
    kw = dict(n_prompts=2, max_new_tokens=4, staleness=1, seed=0)
    js, jrecs = jorch.simulate_async(
        _f32(jax_get_config("toy-2m")), jrl, _task(_JaxCoinTask), "a3po",
        3, init_state=js, resilience=jres, **kw)
    ts, trecs = orch.simulate_async(
        _f32(get_config("toy-2m")), trl, _task(_CoinTask), "a3po", 3,
        init_state=ts, resilience=tres, **kw)
    assert tres.guard.skipped_updates == jres.guard.skipped_updates == 1
    assert tres.faults.fired == jres.faults.fired
    for j, t in zip(jrecs, trecs):
        for k in RECORD_METRICS:
            np.testing.assert_allclose(getattr(t, k), getattr(j, k),
                                       err_msg=f"step {t.step} {k}",
                                       **METRIC_TOL)
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(js.params)}
    for path, v in walk(ts.params):
        np.testing.assert_allclose(v.detach().numpy(), jflat["/".join(path)],
                                   err_msg=str(path), **PARAM_TOL)


# ------------------------------------------------------- async orchestrator
class TestAsyncChaos:
    @pytest.mark.parametrize("control_plane", [False, True])
    def test_rollout_crash_restarted_no_deadlock(self, toy, rl,
                                                 control_plane):
        """An injected rollout-worker crash is restarted by the
        supervisor; the trainer never deadlocks and every step completes.
        Fault + restart counters surface in StepRecord.resilience."""
        res = ResilienceConfig(
            faults=FaultPlan.from_strings(["rollout_crash@1",
                                           "publish_fail@1"]),
            max_worker_restarts=3, pop_deadline_s=60.0)
        o = orch.AsyncOrchestrator(toy, rl, _task(), "loglinear",
                                   n_prompts=2, max_new_tokens=3,
                                   queue_capacity=2, resilience=res,
                                   use_control_plane=control_plane)
        state, recs = o.run(_init_state(toy, rl), num_steps=3)
        assert len(recs) == 3 and int(state.version) == 3
        assert len(o.worker.crashes) == 1
        assert o.worker.restarts == 1 and not o.worker.failed
        snap = recs[-1].resilience
        assert snap["resilience_worker_restarts_total"] >= 1.0
        assert snap[
            'resilience_faults_injected_total{kind="rollout_crash"}'] >= 1.0
        assert snap["resilience_publish_retries_total"] >= 1.0
        assert o.queue.closed  # clean shutdown propagated

    def test_dead_producer_surfaces_worker_failed(self, toy, rl):
        """Worker crashes past its restart budget -> the trainer's pop
        raises WorkerFailed promptly instead of hanging."""
        res = ResilienceConfig(
            faults=FaultPlan.from_strings(["rollout_crash@0x16"]),
            max_worker_restarts=1, pop_deadline_s=60.0)
        o = orch.AsyncOrchestrator(toy, rl, _task(), "loglinear",
                                   n_prompts=2, max_new_tokens=3,
                                   queue_capacity=2, resilience=res)
        t0 = time.perf_counter()
        with pytest.raises(WorkerFailed):
            o.run(_init_state(toy, rl), num_steps=2)
        assert time.perf_counter() - t0 < 60.0
        assert o.worker.failed

    def test_guard_skips_in_the_threaded_loop(self, toy, rl, tmp_path):
        """``nan_grad`` with the skip guard and periodic checkpoints in
        the threaded loop: the poisoned step is skipped, params stay
        finite, and a checkpoint of each step is committed."""
        res = ResilienceConfig(
            faults=FaultPlan.from_strings(["nan_grad@1"]),
            guard=TrainGuard(policy="skip"),
            checkpointer=CheckpointManager(str(tmp_path)), ckpt_every=1)
        o = orch.AsyncOrchestrator(toy, rl, _task(), "loglinear",
                                   n_prompts=2, max_new_tokens=3,
                                   queue_capacity=2, resilience=res)
        state, recs = o.run(_init_state(toy, rl), num_steps=3)
        assert res.guard.skipped_updates == 1 and len(recs) == 3
        assert all(bool(torch.isfinite(v).all())
                   for v in _leaves(state.params))
        assert res.checkpointer.latest_step() == 3
        info = res.checkpointer.restore_latest(device="cpu")
        assert info.metadata["mode"] == "async"
        _assert_states_equal(state, info.state)


# ----------------------------------------------------------------- publish
class TestPublishResilience:
    def test_retry_then_recover(self, toy):
        params = tmodel.init_params(toy, torch.Generator().manual_seed(0),
                                    device="cpu")
        store = WeightStore(params, 0)
        pub = ResilientPublisher(
            store, faults=FaultPlan.from_strings(["publish_fail@0x2"]),
            max_retries=5, backoff_base_s=0.001, backoff_max_s=0.002)
        attempts = pub.publish(params, 1)
        assert attempts == 3 and store.version == 1
        assert pub.retries == 2 and pub.failures == 0

    def test_budget_exhausted_raises_store_untouched(self, toy):
        params = tmodel.init_params(toy, torch.Generator().manual_seed(0),
                                    device="cpu")
        store = WeightStore(params, 0)
        pub = ResilientPublisher(
            store, faults=FaultPlan.from_strings(["publish_fail@0x99"]),
            max_retries=2, backoff_base_s=0.001, backoff_max_s=0.002)
        with pytest.raises(PublishError):
            pub.publish(params, 1)
        # old version keeps serving — the store never saw the new one
        assert store.version == 0 and pub.failures == 1


# ---------------------------------------------------- serving degradation
def _seeded_arrays(seed=0, factor=8.0):
    """toy-2m's seeded init as numpy arrays, the layer weights x8 (the
    control-plane tests' weights: greedy tokens decided by the layers)."""
    params = tmodel.init_params(_f32(get_config("toy-2m")),
                                torch.Generator().manual_seed(seed),
                                device="cpu")
    tree = {}
    for path, t in walk(params):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        a = t.numpy().copy()
        scale = path[0] == "blocks" and not path[1].startswith("ln")
        node[path[-1]] = a * np.float32(factor) if scale else a
    return tree


@pytest.fixture(scope="module")
def sides():
    arrays = _seeded_arrays()
    jax_side = SimpleNamespace(
        name="jax", cfg=_f32(jax_get_config("toy-2m")),
        params=jax.tree.map(jnp.asarray, arrays), Engine=JaxEngine,
        Request=JaxRequest, Store=JaxWeightStore, Scheduler=JaxScheduler,
        SchedulerConfig=JaxSchedulerConfig, ControlPlane=JaxControlPlane,
        Plan=JaxFaultPlan, pc=jpc, key=jax.random.PRNGKey(0),
        engine_kw={})
    torch_side = SimpleNamespace(
        name="torch", cfg=_f32(get_config("toy-2m")),
        params=from_jax(arrays, device="cpu"),
        Engine=ContinuousBatchingEngine, Request=Request, Store=WeightStore,
        Scheduler=AdmissionScheduler, SchedulerConfig=SchedulerConfig,
        ControlPlane=ServingControlPlane, Plan=FaultPlan, pc=pc, key=None,
        engine_kw={"device": "cpu"})
    return jax_side, torch_side


def _cp(side, *, faults=None, n_blocks=16, max_seqs=2):
    eng = side.Engine(side.cfg, **side.engine_kw, max_seqs=max_seqs,
                      block_size=4, n_blocks=n_blocks, max_blocks_per_seq=8,
                      greedy=True)
    cp = side.ControlPlane(
        eng, side.Store(side.params, 0),
        side.Scheduler(side.SchedulerConfig(d_max=100, max_preempts=100)),
        use_prefix_cache=False, faults=faults)
    return eng, cp


def _finished(reqs):
    return {int(r.rid): {"generated": [int(t) for t in r.generated],
                         "versions": [int(v) for v in r.token_versions],
                         "logp": [float(x) for x in r.gen_logp]}
            for r in reqs}


def _serving_counters(cp):
    keys = ("oom_sheds", "nan_drops", "preemptions", "completed",
            "decode_tokens", "prefill_chunks", "admitted")
    snap = cp.metrics.snapshot()
    return {k: snap[k] for k in keys}


def _agree(a, b):
    assert set(a) == set(b)
    for rid in a:
        assert a[rid]["generated"] == b[rid]["generated"], rid
        assert a[rid]["versions"] == b[rid]["versions"], rid
        np.testing.assert_allclose(b[rid]["logp"], a[rid]["logp"], rtol=0,
                                   atol=LOGP_TOL)


def _kv_exhaust(side):
    """``tests/test_resilience.py``'s scenario: both sequences mid-decode,
    a radix-style extra reference on slot 0's next write block (its next
    write needs a CoW fork) while kv_exhaust holds the whole free pool."""
    faults = side.Plan.from_strings(["kv_exhaust@3x5:99"])
    eng, cp = _cp(side, faults=faults, n_blocks=13)
    rng = np.random.default_rng(0)
    for _ in range(2):
        cp.submit(rng.integers(4, side.cfg.vocab_size, 12).astype(np.int32),
                  max_new=8)
    done = []
    for _ in range(3):  # warm up: both sequences mid-generation
        done += cp.step(side.key)
    assert not done
    first, _ = side.pc.write_range(int(eng._lens[0]), 1,
                                   eng.state.block_size,
                                   eng.state.max_blocks)
    eng.allocator.incref(int(eng._tables[0, first]))
    for _ in range(200):
        done += cp.step(side.key)
        if len(done) == 2:
            break
    assert len(done) == 2                 # everything still finishes
    assert cp.metrics.oom_sheds >= 1      # via the shed path
    assert cp._kv_holds == []             # fault released its hostages
    return _finished(done), _serving_counters(cp), faults.fired


def test_kv_exhaust_sheds_instead_of_oom(sides):
    """The fault holds the pool through the allocator; the control plane
    sheds and later finishes both requests, as JAX's does: the same
    tokens, stamps, counters and fired faults."""
    (ja, jc, jf), (ta, tc, tf) = (_kv_exhaust(s) for s in sides)
    _agree(ja, ta)
    assert tc == jc and tf == jf


def _nan_logits(side):
    faults = side.Plan.from_strings(["nan_logits@1"])
    eng, cp = _cp(side, faults=faults, n_blocks=32, max_seqs=1)
    prompt = np.random.default_rng(0).integers(
        4, side.cfg.vocab_size, 8).astype(np.int32)
    rid = cp.submit(prompt, max_new=4)
    finished = []
    for _ in range(200):
        finished = cp.step(side.key)
        if finished:
            break
    assert cp.metrics.nan_drops >= 1
    req = finished[0]
    assert req.rid == rid
    assert np.isfinite(np.asarray(req.gen_logp, np.float64)).all()
    rb = cp.rollout_batch([req], prompt_pad=8, max_new=4)
    assert np.isfinite(rb.gen_logp).all()
    return _finished(finished), _serving_counters(cp), faults.fired


def test_nan_logits_quarantined(sides):
    """A poisoned decode row (written into the device logits buffer in
    place) never leaks non-finite logprobs into rollout data: the
    finished request is dropped and resubmitted, as in JAX."""
    (ja, jc, jf), (ta, tc, tf) = (_nan_logits(s) for s in sides)
    _agree(ja, ta)
    assert tc == jc and tf == jf


def _zero_token_stamp(side):
    """A request submitted under version 3 that generated nothing, beside
    one that did, assembled under store version 9."""
    store = side.Store(side.params, 3)
    eng, _ = _cp(side)
    cp = side.ControlPlane(eng, store, use_prefix_cache=False)
    prompt = np.arange(5, 11, dtype=np.int32)
    cp.submit(prompt, max_new=4)
    done = []
    while not done:
        done = cp.step(side.key)
    empty = side.Request(99, prompt[:4], 4, submit_version=3)
    store.publish(side.params, 9)
    rb = cp.rollout_batch([done[0], empty], prompt_pad=6, max_new=4)
    return rb.gen_versions, rb.version, rb.gen_mask


def test_zero_token_request_stamped_with_submit_version(sides):
    """The zero-token request's ``gen_versions`` row is its
    ``submit_version`` ([3, 3, 3, 3]), as JAX's ``rollout_batch``; not the
    store's version 9."""
    (jv, jb, jm), (tv, tb, tm) = (_zero_token_stamp(s) for s in sides)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tm, jm)
    assert tb == jb == 3
    assert list(tv[1]) == [3, 3, 3, 3]


def test_prefill_lane_waits_out_a_held_pool():
    """ROADMAP note f: the threaded loop over the control plane (radix
    cache on, group members resuming a shared partial page) while
    ``kv_exhaust`` holds the whole free pool. The reference's prefill lane
    forks that page from the empty pool and its worker dies on the OOM;
    the port's lane waits until the hold ends, and every step completes."""
    from repro.resilience import WorkerFailed as JaxWorkerFailed
    from repro.training.trainer import Trainer as JaxTrainer
    base = dict(group_size=4, num_minibatches=2, learning_rate=2e-4,
                max_staleness=3)
    kw = dict(n_prompts=8, max_new_tokens=6, use_control_plane=True)

    def res(Config, Plan):
        return Config(faults=Plan.from_strings(["kv_exhaust@2x3:512"]),
                      max_worker_restarts=0)
    jcfg = _f32(jax_get_config("toy-2m"))
    jo = jorch.AsyncOrchestrator(
        jcfg, JaxRLConfig(**base), _task(JaxTask), "a3po",
        resilience=res(JaxResilienceConfig, JaxFaultPlan), **kw)
    with pytest.raises(JaxWorkerFailed):
        jo.run(JaxTrainer(jcfg, JaxRLConfig(**base), "a3po").init_state(
            jax.random.PRNGKey(7)), 4)
    assert "paged cache OOM" in jo.worker.crashes[0].message
    cfg = _f32(get_config("toy-2m"))
    o = orch.AsyncOrchestrator(cfg, RLConfig(**base), _task(), "a3po",
                               resilience=res(ResilienceConfig, FaultPlan),
                               **kw)
    state, recs = o.run(o.trainer.init_state(
        torch.Generator().manual_seed(7), device="cpu"), 4)
    assert len(recs) == 4 and not o.worker.crashes
    assert recs[-1].resilience[
        'resilience_faults_injected_total{kind="kv_exhaust"}'] >= 3
    assert o.control_plane._kv_holds == []


# ---------------------------------------------------------------- launcher
def _launch(tmp_path, *extra, name="run"):
    path = tmp_path / f"{name}.jsonl"
    launcher.main(["--device", "cpu", "--arch", "toy-2m", "--steps", "4",
                   "--staleness", "1", "--log-jsonl", str(path), "--quiet",
                   *extra])
    return read_jsonl(str(path))


def test_launcher_sim_crash_and_resume_auto(tmp_path, monkeypatch):
    """``--ckpt-dir --ckpt-every 2``: uninterrupted, then with
    ``--fault train_crash@3`` (raises), then ``--resume auto`` on that
    directory, which resumes at step 2 and ends at the uninterrupted
    run's parameters, bit for bit."""
    finals = []
    plain = launcher.simulate_async

    def keep(*a, **kw):
        state, recs = plain(*a, **kw)
        finals.append(state)
        return state, recs
    monkeypatch.setattr(launcher, "simulate_async", keep)
    a = _launch(tmp_path, "--ckpt-dir", str(tmp_path / "a"),
                "--ckpt-every", "2", name="a")
    with pytest.raises(InjectedFault):
        _launch(tmp_path, "--ckpt-dir", str(tmp_path / "b"),
                "--ckpt-every", "2", "--fault", "train_crash@3", name="b")
    c = _launch(tmp_path, "--ckpt-dir", str(tmp_path / "b"),
                "--ckpt-every", "2", "--resume", "auto", name="c")
    assert [r["step"] for r in a] == [0, 1, 2, 3]
    assert [r["step"] for r in c] == [2, 3]
    assert [r["loss"] for r in c] == [r["loss"] for r in a[2:]]
    _assert_states_equal(finals[0], finals[1])
    assert c[-1]["resilience"]["resilience_checkpoint_restores_total"] >= 1
    events = read_jsonl(str(tmp_path / "c.jsonl"), kind="resume")
    assert events and events[0]["step"] == 2


def test_launcher_engine_async_under_faults(tmp_path):
    """``--engine async`` with a rollout crash, a failed publish, held KV
    blocks, a poisoned logits row and the skip guard: every step
    completes, each fault fired, the run log valid under the port's
    ``obs.validate`` and rendered by ``obs.report``."""
    recs = _launch(tmp_path, "--engine", "async", "--guard", "skip",
                   "--fault", "rollout_crash@1", "--fault", "publish_fail@1",
                   "--fault", "kv_exhaust@2x3:512", "--fault", "nan_logits@3")
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    snap = recs[-1]["resilience"]
    assert snap["resilience_worker_restarts_total"] >= 1
    for kind in ("rollout_crash", "publish_fail", "kv_exhaust",
                 "nan_logits"):
        assert snap[f'resilience_faults_injected_total{{kind="{kind}"}}'] \
            >= 1, kind
    path = str(tmp_path / "run.jsonl")
    assert validate.validate_jsonl(path, min_steps=4) == []
    text = report.render(report.summarize(read_jsonl(path)))
    assert "steps" in text


def test_launcher_resume_auto_empty_dir_starts_fresh(tmp_path):
    recs = _launch(tmp_path, "--ckpt-dir", str(tmp_path / "empty"),
                   "--resume", "auto")
    assert [r["step"] for r in recs] == [0, 1, 2, 3]


# ------------------------------------------------------------ obs tools
def test_validate_and_report_match_the_references(tmp_path):
    """The port's validator and report give the reference's answers on
    the same files: a good run log, one with a missing key, a trace."""
    from repro.obs import report as jreport
    from repro.obs import validate as jvalidate
    recs = _launch(tmp_path, "--trace", str(tmp_path / "t.json"))
    path, trace = str(tmp_path / "run.jsonl"), str(tmp_path / "t.json")
    bad = tmp_path / "bad.jsonl"
    lines = Path(path).read_text().splitlines()
    rec = json.loads(lines[-1])
    del rec["loss"]
    bad.write_text("\n".join(lines[:-1] + [json.dumps(rec)]) + "\n")
    for p in (path, str(bad)):
        assert validate.validate_jsonl(p, min_steps=4) == \
            jvalidate.validate_jsonl(p, min_steps=4)
    assert validate.validate_jsonl(str(bad), min_steps=4)
    spans = ["rollout_generate", "train_update", "weight_publish"]
    assert validate.validate_trace(trace, expect_spans=spans) == \
        jvalidate.validate_trace(trace, expect_spans=spans) == []
    tr_json = json.loads(Path(trace).read_text())
    ours = report.summarize(recs, tr_json)
    # the reference's tracer stamps microseconds since its install; the
    # port's stamps the Unix epoch and records its install as ``t0_us``
    t0_us = tr_json["metadata"]["t0_us"]
    ref_json = dict(tr_json, traceEvents=[
        dict(ev, ts=ev["ts"] - t0_us) if "ts" in ev else ev
        for ev in tr_json["traceEvents"]])
    ref = jreport.summarize(recs, ref_json)
    assert ours == ref and ours["num_steps"] == 4
    assert 0.0 < ours["publish_timeline_s"][0] < 600.0
    assert report.render(ours) == jreport.render(ref)
    assert validate.main(["--jsonl", path, "--trace", trace,
                          "--min-steps", "4"]) == 0
    assert validate.main(["--jsonl", str(bad)]) == 1


# ----------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_resilience.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_crash_resume_bit_exact_on_card(cuda_device, toy, rl, tmp_path):
    """The sim loop on the card (flash, dense decode, logprob and A-3PO
    kernels): a crash and ``restore_latest`` resume end at the
    uninterrupted run's state bit for bit."""
    def run(directory, faults=None, resume=None):
        res = ResilienceConfig(
            checkpointer=CheckpointManager(str(tmp_path / directory)),
            ckpt_every=2, faults=faults)
        return orch.simulate_async(
            toy, rl, _task(_TaskRngCoins), "a3po", 4, n_prompts=2,
            max_new_tokens=3,
            staleness=1, seed=0, resilience=res, resume=resume,
            device=cuda_device)
    state_a, _ = run("a")
    with pytest.raises(InjectedFault):
        run("b", FaultPlan.from_strings(["train_crash@3"]))
    resume = CheckpointManager(str(tmp_path / "b")).restore_latest(
        cuda_device)
    assert resume.step == 2
    state_c, _ = run("b", resume=resume)
    _assert_states_equal(state_a, state_c)
