"""The async RL loop of the PyTorch port against the JAX package, float32 on
the CPU: the dense ``RolloutEngine``, the task, the rollout queue and
weight store, ``simulate_async``, ``AsyncOrchestrator`` and the launcher.

Weights come from the committed toy-2m checkpoint (flat-key npz, through
``from_jax``). Sampling is not compared across packages (JAX's threefry
bits are not reproduced): parity runs both engines greedy, here by
patching ``generate`` with pytest's ``monkeypatch``. The tests of
``tests/test_system.py`` for the rollout engine and the async runtime are
ported in intent. Tolerances: generated tokens and masks identical,
behaviour logps 1e-4 (``tests/test_torch_model.py``); ``simulate_async``
metrics rtol 2e-4 / atol 1e-5 and parameters rtol 2e-4 / atol 1e-6, with
Adam eps 1e-4 (``tests/test_torch_training.py::_rl``).
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_rl import orchestrator as jorch
from repro.configs.base import RLConfig as JaxRLConfig
from repro.configs.registry import get_config as jax_get_config
from repro.data.tasks import ArithmeticTask as JaxTask
from repro.obs import runlog as jrunlog
from repro.obs.validate import validate_jsonl
from repro.rollout.engine import RolloutEngine as JaxRolloutEngine
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
from repro_torch.obs import validate as port_validate
from repro_torch.resilience.supervisor import (
    SupervisedWorker,
    WorkerFailed,
    pop_with_health,
)
from repro_torch.rollout import engine as tengine
from repro_torch.rollout.engine import RolloutBatch, RolloutEngine
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer as tr

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "experiments" / "ckpt" / "toy-2m_loglinear"
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
RECORD_METRICS = ("reward", "loss", "entropy", "iw_max", "iw_min",
                  "clipped_tokens", "staleness_mean", "train_tokens",
                  "host_syncs")


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def toy():
    """(jax cfg, jax params (numpy), torch cfg, flat npz arrays)."""
    tree, _ = jckpt.load_checkpoint(str(CKPT))
    with np.load(str(CKPT) + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    return (_f32(jax_get_config("toy-2m")), tree["params"],
            _f32(get_config("toy-2m")), flat)


def _task(cls=ArithmeticTask, seed=0):
    return cls(max_operand=9, n_terms=2, prompt_len=8, seed=seed)


def _rl(**kw):
    base = dict(group_size=4, num_minibatches=2, learning_rate=3e-4,
                adam_eps=1e-4)
    base.update(kw)
    return JaxRLConfig(**base), RLConfig(**base)


def _random_params(cfg, seed=0):
    return tmodel.init_params(cfg, torch.Generator().manual_seed(seed),
                              device="cpu", requires_grad=True)


def _greedy(monkeypatch):
    """Both packages' RolloutEngine.generate, greedy, on prompts whose
    first digit is set per row: greedy group members of one prompt would
    generate one sequence, and their group-normalised advantages would
    cancel in the gradient."""
    digits = np.array([tok.CHAR_TO_ID[str(i % 10)] for i in range(64)])
    for cls in (JaxRolloutEngine, RolloutEngine):
        def generate(self, params, prompts, lengths, key, *, _orig=cls.generate,
                     **kw):
            prompts = np.array(prompts)
            prompts[:, 1] = digits[: len(prompts)]
            return _orig(self, params, prompts, lengths, key, greedy=True,
                         **kw)
        monkeypatch.setattr(cls, "generate", generate)


# ------------------------------------------------------------ rollout engine
@pytest.mark.parametrize("n,max_new", [(6, 6), (3, 9)])
def test_rollout_engine_greedy_matches_jax(toy, n, max_new):
    """Greedy generation from the toy checkpoint: the port's tokens and
    masks equal JAX's, behaviour logps within 1e-4, prompts ragged."""
    jcfg, jparams, tcfg, flat = toy
    b = ArithmeticTask(max_operand=30, n_terms=3, prompt_len=12,
                       seed=n).sample(n)
    j = JaxRolloutEngine(jcfg, JaxRLConfig(), max_new).generate(
        jax.tree.map(jnp.asarray, jparams), b.prompts, b.prompt_lengths,
        jax.random.PRNGKey(0), version=3, greedy=True)
    t = RolloutEngine(tcfg, RLConfig(), max_new).generate(
        from_jax(flat, device="cpu"), b.prompts, b.prompt_lengths,
        version=3, greedy=True)
    assert len(set(b.prompt_lengths.tolist())) > 1
    np.testing.assert_array_equal(t.tokens, j.tokens)
    np.testing.assert_array_equal(t.gen_mask, j.gen_mask)
    np.testing.assert_allclose(t.gen_logp, j.gen_logp, rtol=1e-4,
                               atol=1e-4)
    assert t.version == j.version == 3
    assert [list(c) for c in RolloutEngine(tcfg).completions(t)] == \
        [list(np.asarray(c)) for c in
         JaxRolloutEngine(jcfg).completions(j)]


def test_rollout_engine_contract(toy):
    """test_system.py's contract: version stamp, shapes, behaviour logps
    are log-probabilities, the mask is a prefix, PAD after EOS."""
    _, _, cfg, _ = toy
    engine = RolloutEngine(cfg, RLConfig(), max_new_tokens=4)
    b = _task().sample(3)
    rb = engine.generate(_random_params(cfg), b.prompts, b.prompt_lengths,
                         torch.Generator().manual_seed(1), version=5)
    assert rb.version == 5
    assert rb.tokens.shape == (3, 8 + 4)
    assert rb.gen_logp.shape == rb.gen_mask.shape == (3, 4)
    assert rb.tokens.dtype == np.int32 and rb.gen_logp.dtype == np.float32
    assert np.all(rb.gen_logp <= 1e-5)
    for row, mask, L in zip(rb.tokens, rb.gen_mask, b.prompt_lengths):
        assert np.all(np.diff(mask) <= 0)
        gen = row[L: L + 4]
        assert np.all(gen[mask == 0] == tok.PAD)


def test_behavior_logp_matches_scoring(toy):
    """Behaviour logps of a sampled rollout == the trainer's scoring of the
    same tokens (float32, same weights)."""
    _, _, cfg, flat = toy
    params = from_jax(flat, device="cpu")
    engine = RolloutEngine(cfg, RLConfig(), max_new_tokens=5)
    b = _task().sample(4)
    rb = engine.generate(params, b.prompts, b.prompt_lengths,
                         torch.Generator().manual_seed(2))
    tb = tr.assemble_train_batch([rb], np.zeros(4, np.float32),
                                 device="cpu")
    logp, _, _ = tr.score_tokens(params, cfg, tb.tokens)
    sel = tb.response_mask > 0
    torch.testing.assert_close(logp[sel], tb.behav_logp[sel], rtol=1e-4,
                               atol=1e-4)


def test_sampled_generate_is_seeded(toy):
    """Sampling draws from the generator it is given: the same seed gives
    the same batch, another seed another; greedy needs none."""
    _, _, cfg, flat = toy
    params = from_jax(flat, device="cpu")
    engine = RolloutEngine(cfg, RLConfig(temperature=1.5), max_new_tokens=6)
    b = _task().sample(8)

    def run(seed):
        return engine.generate(params, b.prompts, b.prompt_lengths,
                               torch.Generator().manual_seed(seed))
    a, a2, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a.tokens, a2.tokens)
    np.testing.assert_array_equal(a.gen_logp, a2.gen_logp)
    assert not np.array_equal(a.tokens, c.tokens)


def test_tasks_are_copies():
    """The port's task draws the JAX task's prompts, answers, rewards and
    SFT batches from the same seed."""
    tj, tt = _task(JaxTask, 4), _task(ArithmeticTask, 4)
    for _ in range(2):
        bj, bt = tj.sample(5), tt.sample(5)
        np.testing.assert_array_equal(bt.prompts, bj.prompts)
        np.testing.assert_array_equal(bt.prompt_lengths, bj.prompt_lengths)
        assert bt.answers == bj.answers
    comps = np.array([tok.encode(a) + [tok.EOS] for a in ("3", "12")]
                     + [[tok.EOS, tok.PAD]], dtype=object)
    answers = ["3", "1", "7"]
    np.testing.assert_array_equal(tt.rewards(comps, answers),
                                  tj.rewards(comps, answers))
    for a, b in zip(tt.sft_batch(3, 12), tj.sft_batch(3, 12)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- queue, store, worker
def test_rollout_queue_staleness_gate():
    q = RolloutQueue(capacity=4, max_staleness=2)

    def mk(version):
        return RolloutBatch(np.zeros((1, 4), np.int32), np.array([2]),
                            np.zeros((1, 2), np.float32),
                            np.ones((1, 2), np.float32), version=version)

    q.push(mk(0))
    q.push(mk(5))
    fresh = q.pop_fresh(current_version=6, n=1)
    assert fresh[0].version == 5  # version 0 was dropped (staleness 6 > 2)
    assert q.dropped == 1
    q.close()
    with pytest.raises(QueueClosed):
        q.push(mk(6))
    with pytest.raises(QueueClosed):
        q.pop(timeout=0.1)


def test_weight_store_and_supervised_worker():
    """The store hands out what was published, listeners hear each
    publish; a crashed worker with no restart budget makes the trainer's
    pop raise WorkerFailed instead of waiting out its deadline."""
    heard = []
    store = WeightStore({"w": 0}, 0)
    store.subscribe(heard.append)
    store.publish({"w": 1}, 1)
    assert store.latest() == ({"w": 1}, 1) and heard == [1]

    def body(ctx):
        ctx.heartbeat()
        raise RuntimeError("boom")
    worker = SupervisedWorker("w", body, max_restarts=0).start()
    worker._thread.join(5.0)
    assert worker.failed and worker.last_crash.exc_type == "RuntimeError"
    with pytest.raises(WorkerFailed, match="boom"):
        pop_with_health(RolloutQueue(2, 1), worker, 0, poll_s=0.05,
                        deadline_s=5.0)


# ------------------------------------------------------------ simulate_async
class _CoinMixin:
    """Rewards are seeded Bernoulli(0.5) draws (the same in both packages):
    greedy group members are identical, so verifier rewards would make
    every group advantage 0 and the update empty."""

    def rewards(self, completions, answers):
        if not hasattr(self, "_coin"):
            self._coin = np.random.default_rng(123)
        return self._coin.binomial(1, 0.5, len(answers)).astype(np.float32)


class _JaxCoinTask(_CoinMixin, JaxTask):
    pass


class _CoinTask(_CoinMixin, ArithmeticTask):
    pass


def _init_states(jparams, flat):
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jtrainer.TrainState(jp, jopt.adam_init(jp), jnp.asarray(0,
                                                                 jnp.int32))
    tp = from_jax(flat, device="cpu", requires_grad=True)
    ts = tr.TrainState(tp, opt.adam_init(tp),
                       torch.tensor(0, dtype=torch.int32))
    return js, ts


@pytest.mark.parametrize("algo", ["a3po", "recompute"])
def test_simulate_async_matches_jax(toy, monkeypatch, algo):
    """Three steps at staleness 1 from the toy checkpoint, greedy rollouts,
    seeded rewards: every StepRecord metric and the final parameters equal
    JAX's simulate_async."""
    jcfg, jparams, tcfg, flat = toy
    _greedy(monkeypatch)
    jrl, trl = _rl()
    js, ts = _init_states(jparams, flat)
    kw = dict(n_prompts=2, max_new_tokens=4, staleness=1, seed=0)
    js, jrecs = jorch.simulate_async(jcfg, jrl, _task(_JaxCoinTask), algo,
                                     3, init_state=js, **kw)
    ts, trecs = orch.simulate_async(tcfg, trl, _task(_CoinTask), algo, 3,
                                    init_state=ts, **kw)
    assert len(trecs) == len(jrecs) == 3
    for j, t in zip(jrecs, trecs):
        assert t.step == j.step
        for k in RECORD_METRICS:
            np.testing.assert_allclose(getattr(t, k), getattr(j, k),
                                       err_msg=f"step {t.step} {k}",
                                       **METRIC_TOL)
    assert [r.staleness_mean for r in trecs] == [0.0, 1.0, 1.0]
    assert trecs[-1].reward != trecs[0].reward or trecs[0].loss != 0.0
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(js.params)}
    moved = 0.0
    for path, v in walk(ts.params):
        np.testing.assert_allclose(v.detach().numpy(), jflat["/".join(path)],
                                   err_msg=str(path), **PARAM_TOL)
        moved = max(moved, float((v.detach() - torch.from_numpy(
            flat["params/" + "/".join(path)])).abs().max()))
    assert moved > 1e-4  # the updates were not empty
    assert int(ts.version) == int(js.version) == 3


def test_behaviour_params_are_the_stale_version(toy, monkeypatch):
    """At step t the engine generates with the version t - d tree itself
    (not the live one), and that tree still holds its values after later
    updates: no in-place update reached an older version."""
    _, _, cfg, flat = toy
    _, trl = _rl()
    params = from_jax(flat, device="cpu", requires_grad=True)
    ts = tr.TrainState(params, opt.adam_init(params),
                       torch.tensor(0, dtype=torch.int32))
    snapshot = {p: v.detach().clone() for p, v in walk(ts.params)}
    seen, trees = [], [ts.params]
    gen, step = RolloutEngine.generate, tr.Trainer.step

    def spy_generate(self, params, *a, **kw):
        seen.append((params, kw["version"]))
        return gen(self, params, *a, **kw)

    def spy_step(self, state, batch):
        new, m = step(self, state, batch)
        trees.append(new.params)
        return new, m
    monkeypatch.setattr(RolloutEngine, "generate", spy_generate)
    monkeypatch.setattr(tr.Trainer, "step", spy_step)
    d = 2
    orch.simulate_async(cfg, trl, _task(_CoinTask), "a3po", 5,
                        init_state=ts, n_prompts=2, max_new_tokens=3,
                        staleness=d)
    for t, (params, version) in enumerate(seen):
        assert version == max(t - d, 0)
        assert params is trees[max(t - d, 0)]
    assert all(torch.equal(v, snapshot[p]) for p, v in walk(trees[0]))
    assert any(not torch.equal(v, snapshot[p]) for p, v in walk(trees[1]))


def test_async_simulation_staleness(toy):
    _, _, cfg, _ = toy
    _, trl = _rl()
    _, recs = orch.simulate_async(cfg, trl, _task(), "loglinear", 4,
                                  n_prompts=2, max_new_tokens=3, staleness=2,
                                  device="cpu")
    assert [r.staleness_mean for r in recs] == [0.0, 1.0, 2.0, 2.0]
    assert all(r.host_syncs == 1.0 for r in recs)


def test_eval_hook_in_simulation(toy):
    _, _, cfg, _ = toy
    _, trl = _rl()
    calls = []

    def fake_eval(params):
        calls.append(params)
        return 0.25

    _, recs = orch.simulate_async(cfg, trl, _task(), "loglinear", 4,
                                  n_prompts=2, max_new_tokens=3, staleness=1,
                                  eval_every=2, eval_fn=fake_eval,
                                  device="cpu")
    assert [r.eval_reward for r in recs] == [None, 0.25, None, 0.25]
    assert len(calls) == 2


def test_async_threaded_orchestrator(toy):
    """Two threads on one device: one record per step, the version
    advances by one per step, every batch within max_staleness."""
    _, _, cfg, _ = toy
    _, trl = _rl(max_staleness=1)
    o = orch.AsyncOrchestrator(cfg, trl, _task(), "loglinear", n_prompts=2,
                               max_new_tokens=3, queue_capacity=2)
    trainer = tr.Trainer(cfg, trl, "loglinear")
    state = trainer.init_state(torch.Generator().manual_seed(0),
                               device="cpu")
    state, recs = o.run(state, num_steps=3)
    assert [r.step for r in recs] == [0, 1, 2]
    assert int(state.version) == 3
    assert all(np.isfinite(r.loss) for r in recs)
    assert all(0 <= r.staleness_mean <= trl.max_staleness for r in recs)
    assert not o.worker.alive


def test_unported_options_refuse(toy):
    """No option of the loop is refused any longer: ``resilience=`` (once
    refused as ROADMAP queue 1's 'resilience/') is taken by both loops,
    and a ``ResilienceConfig`` that injects nothing leaves every record's
    metrics as they were, adding the ``resilience_*`` snapshot
    (``resume=`` is held in ``tests/test_torch_resilience.py``)."""
    from repro_torch.resilience import ResilienceConfig
    _, _, cfg, _ = toy
    _, trl = _rl()
    o = orch.AsyncOrchestrator(cfg, trl, _task(),
                               resilience=ResilienceConfig())
    assert o.guard is None and not o.trainer.skip_nonfinite
    runs = [orch.simulate_async(cfg, trl, _task(), "a3po", 2, device="cpu",
                                n_prompts=2, max_new_tokens=3, **kw)[1]
            for kw in ({}, {"resilience": ResilienceConfig()})]
    for a, b in zip(*runs):
        assert [getattr(a, k) for k in RECORD_METRICS] \
            == [getattr(b, k) for k in RECORD_METRICS]
        assert a.resilience is None and isinstance(b.resilience, dict)


# ------------------------------------------------------------------ launcher
def test_launcher_cpu_run_log_matches_jax_schema(tmp_path):
    """`--device cpu --arch toy-2m --steps 2 --log-jsonl`: one step record
    per step with the JAX launcher's keys, valid under repro.obs.validate;
    the trace, the prometheus dump and a checkpoint the JAX package loads
    are written."""
    path, trace, prom, ck = (tmp_path / n for n in ("run.jsonl", "t.json",
                                                    "m.prom", "ck"))
    launcher.main(["--device", "cpu", "--arch", "toy-2m", "--steps", "2",
                   "--log-jsonl", str(path), "--trace", str(trace),
                   "--metrics-prom", str(prom), "--checkpoint", str(ck),
                   "--quiet"])
    tree, meta = jckpt.load_checkpoint(str(ck))
    assert meta == {"arch": "toy-2m", "algo": "a3po", "steps": 2}
    assert set(tree["params"]) == {"blocks", "embedding", "final_norm"}
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    steps = [r for r in recs if r["kind"] == "step"]
    assert recs[0]["kind"] == "meta" and len(steps) == 2
    jax_keys = set(jrunlog.step_record_dict(jorch.StepRecord(
        step=0, reward=0.0, loss=0.0, entropy=0.0, iw_max=1.0, iw_min=1.0,
        clipped_tokens=0.0, staleness_mean=0.0, prox_time_s=0.0,
        rollout_time_s=0.0, train_time_s=0.0, wall_time_s=0.0)))
    assert all(set(r) == jax_keys for r in steps)
    assert [r["staleness_mean"] for r in steps] == [0.0, 1.0]
    assert validate_jsonl(str(path), min_steps=2) == []
    assert port_validate.validate_jsonl(str(path), min_steps=2) == []
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"rollout_generate", "train_update", "weight_publish"} <= names
    assert "train_steps_total" in prom.read_text()


def test_launcher_algo_list(capsys):
    launcher.main(["--algo", "list"])
    out = capsys.readouterr().out
    for name in ("a3po", "recompute", "sync", "asympo", "grpo_mu"):
        assert name in out


@pytest.mark.parametrize("argv,match", [
    (["--engine", "async", "--resume", "auto"],
     "--resume requires --ckpt-dir"),
    # `--mesh prod` is ported (its sharded dry-run:
    # tests/test_torch_launch.py); an integer --resume without a directory
    (["--resume", "5"], "--resume requires --ckpt-dir"),
    (["--resume", "auto"], "--resume requires --ckpt-dir"),
    (["--arch", "qwen2.5-1.5b"], "full-scale"),
])
def test_launcher_refuses_what_is_not_ported(argv, match):
    with pytest.raises(SystemExit, match=match) as e:
        launcher.main(["--device", "cpu", "--steps", "1"] + argv)
    assert e.value.code not in (0, None)


# ----------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_async.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_generate_on_card_matches_cpu(cuda_device, toy):
    """The engine on the card (flash and dense decode kernels) gives the
    CPU engine's (plain versions) greedy tokens, logps within 1e-4, and
    launches each kernel once per layer per prefill / generated token."""
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops
    _, _, cfg, flat = toy
    b = _task().sample(6)
    out = {}
    for dev in ("cpu", "cuda"):
        f0, d0 = fops.LAUNCHES, dops.DENSE_LAUNCHES
        out[dev] = RolloutEngine(cfg, RLConfig(), 5).generate(
            from_jax(flat, device=dev), b.prompts, b.prompt_lengths,
            greedy=True)
        launches = (fops.LAUNCHES - f0, dops.DENSE_LAUNCHES - d0)
        assert launches == ((0, 0) if dev == "cpu"
                            else (cfg.num_layers, cfg.num_layers * 5))
    np.testing.assert_array_equal(out["cuda"].tokens, out["cpu"].tokens)
    np.testing.assert_allclose(out["cuda"].gen_logp, out["cpu"].gen_logp,
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_generate_has_no_host_sync(cuda_device, toy):
    """Prefill and the whole sampled decode loop never wait for the device:
    CUDA's sync debug mode turns any synchronising call into an error."""
    _, _, cfg, flat = toy
    params = from_jax(flat, device=cuda_device)
    b = _task().sample(4)
    prompts = torch.as_tensor(b.prompts, dtype=torch.long).to(cuda_device)
    lengths = torch.as_tensor(b.prompt_lengths, dtype=torch.int32).to(
        cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = tengine._generate(params, cfg, prompts, lengths, gen, 6,
                                   temperature=0.8, top_p=0.9, greedy=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert packed.shape == (3, 4, 6)
    assert bool(torch.isfinite(packed).all())
