"""The training step of the PyTorch port against the JAX package, float32 on
the CPU.

Both trainers start from the same weights (the toy-2m checkpoint, or
JAX-initialised qwen2.5-1.5b-reduced carried across with ``from_jax``), the
same zero Adam state and the same numpy-made batch, and take the same
steps: every ``METRIC_KEYS`` value must agree within rtol 2e-4 / atol 1e-5
and every parameter within rtol 2e-4 / atol 1e-6, for each registered
algorithm, [B] and [B, T-1] version stamps, microbatch accumulation, two
chained steps and the non-finite guard. Also: Adam against JAX's, batch
assembly, remat, parameter donation, checkpoints across packages, and the
serving engine's no-autograd guarantee.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RLConfig as JaxRLConfig
from repro.configs.registry import get_config as jax_get_config
from repro.models import model as jmodel
from repro.rollout.engine import RolloutBatch as JaxRolloutBatch
from repro.training import checkpoints as jckpt
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.models.params import ParamTree, from_jax, walk
from repro_torch.obs.metrics import get_registry
from repro_torch.rollout.continuous import ContinuousBatchingEngine
from repro_torch.rollout.engine import RolloutBatch, rollout_batch
from repro_torch.training import checkpoints as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer as tr

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "experiments" / "ckpt" / "toy-2m_loglinear"
B, T = 8, 12
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def toy():
    tree, _ = jckpt.load_checkpoint(str(CKPT))
    return (_f32(jax_get_config("toy-2m")), tree["params"],
            _f32(get_config("toy-2m")))


def _rl(**kw):
    # Adam's first update of an element is lr * g / (|g| + eps): with the
    # default eps 1e-8, an element whose gradient lies within the two
    # frameworks' float32 rounding of each other (~2e-7 here, measured)
    # moves by an arbitrary fraction of lr in each. eps 1e-4 bounds that
    # to lr * 2e-7 / 1e-4 = 6e-7, under atol, while every element with a
    # real gradient still moves by about lr.
    base = dict(group_size=4, num_minibatches=2, learning_rate=3e-4,
                adam_eps=1e-4)
    base.update(kw)
    return JaxRLConfig(**base), RLConfig(**base)


def _batch_arrays(seed, per_token, vocab=64, nan_reward=False,
                  behav_from=None):
    """Tokens, mask, behaviour logps, versions, rewards. ``behav_from``
    (JAX cfg, params) makes the behaviour logps the model's own plus
    noise, so ratios sit near 1 and gradients are not vanishingly small
    (Adam's first step normalises each gradient element, which would turn
    float32 rounding of a near-zero element into a visible update)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, vocab - 4, size=(B, T)).astype(np.int32)
    mask = ((np.arange(T - 1)[None, :] >= 4)
            & (rng.random((B, T - 1)) > 0.2)).astype(np.float32)
    if behav_from is None:
        behav = -rng.random((B, T - 1)) * 2
    else:
        cfg, params = behav_from
        behav = np.asarray(jtrainer.score_tokens(
            jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(tokens))[0])
        behav = behav + 0.2 * rng.standard_normal((B, T - 1))
    behav = (behav * mask).astype(np.float32)
    vshape = (B, T - 1) if per_token else (B,)
    versions = rng.integers(0, 4, size=vshape).astype(np.int32)
    rewards = rng.random(B).astype(np.float32)
    if nan_reward:
        rewards[1] = np.nan
    return tokens, mask, behav, versions, rewards


def _batches(arrays):
    tokens, mask, behav, versions, rewards = arrays
    jb = jtrainer.TrainBatch(tokens=jnp.asarray(tokens),
                             response_mask=jnp.asarray(mask),
                             behav_logp=jnp.asarray(behav),
                             versions=jnp.asarray(versions),
                             rewards=jnp.asarray(rewards))
    tb = tr.TrainBatch(tokens=torch.from_numpy(tokens).long(),
                       response_mask=torch.from_numpy(mask),
                       behav_logp=torch.from_numpy(behav),
                       versions=torch.from_numpy(versions),
                       rewards=torch.from_numpy(rewards))
    return jb, tb


def _states(jparams, version=3):
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jtrainer.TrainState(jp, jopt.adam_init(jp),
                             jnp.asarray(version, jnp.int32))
    tp = from_jax(jax.device_get(jparams), device="cpu", requires_grad=True)
    ts = tr.TrainState(tp, opt.adam_init(tp),
                       torch.tensor(version, dtype=torch.int32))
    return js, ts


def _assert_same(jm, tm, js, ts, label=""):
    for k in tr.METRIC_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=f"{label} {k}",
                                   **METRIC_TOL)
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(js.params)}
    for path, v in walk(ts.params):
        np.testing.assert_allclose(v.detach().numpy(), jflat["/".join(path)],
                                   err_msg=f"{label} {path}", **PARAM_TOL)
    np.testing.assert_allclose(ts.opt["t"].numpy(), np.asarray(js.opt["t"]))
    assert int(ts.version) == int(js.version)


def _run_both(cfgs, jparams, algo, arrays, *, steps=1, nmi=1, rl_kw=None,
              skip_nonfinite=False, version=3):
    jcfg, tcfg = cfgs
    jrl, trl = _rl(**(rl_kw or {}))
    jb, tb = _batches(arrays)
    jt = jtrainer.Trainer(jcfg, jrl, algo, num_microbatches=nmi,
                          skip_nonfinite=skip_nonfinite)
    tt = tr.Trainer(tcfg, trl, algo, num_microbatches=nmi,
                    skip_nonfinite=skip_nonfinite)
    js, ts = _states(jparams, version)
    for i in range(steps):
        js, jm = jt.step(js, jb)
        ts, tm = tt.step(ts, tb)
        _assert_same(jm, tm, js, ts, label=f"{algo} step {i}")
        assert tm["host_syncs"] == jm["host_syncs"]
    return jm, tm, ts, tt


ALGOS = ["sync", "recompute", "a3po", "loglinear", "asympo", "grpo_mu"]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("per_token", [False, True])
def test_step_matches_jax(toy, algo, per_token):
    """Two chained steps of every registered algorithm, [B] or [B, T-1]
    version stamps: metrics and updated params equal JAX's."""
    jcfg, jparams, tcfg = toy
    _run_both((jcfg, tcfg), jparams, algo, _batch_arrays(0, per_token, behav_from=(jcfg, jparams)),
              steps=2)


@pytest.mark.parametrize("algo", ["a3po", "recompute", "grpo_mu"])
def test_microbatched_step_matches_jax(toy, algo):
    """Gradient accumulation over two microbatches, weighted by response
    tokens, with the KL penalty and the entropy bonus in the loss."""
    jcfg, jparams, tcfg = toy
    _run_both((jcfg, tcfg), jparams, algo, _batch_arrays(1, True, behav_from=(jcfg, jparams)), nmi=2,
              rl_kw=dict(kl_coef=0.05, entropy_coef=0.01))


def test_skip_nonfinite_matches_jax(toy):
    """A NaN reward poisons its group's advantages: the guarded step keeps
    params and the whole Adam state where the update was non-finite, and
    counts it, as JAX's."""
    jcfg, jparams, tcfg = toy
    jm, tm, ts, _ = _run_both((jcfg, tcfg), jparams, "a3po",
                              _batch_arrays(2, False, nan_reward=True,
                                            behav_from=(jcfg, jparams)),
                              skip_nonfinite=True)
    assert tm["nonfinite"] == 1.0
    assert all(bool(torch.isfinite(v).all()) for _, v in walk(ts.params))
    # the first minibatch (the NaN row's group) was skipped: t counts one
    assert int(ts.opt["t"]) == 1


def test_reduced_qwen_step_matches_jax():
    """One a3po step on qwen2.5-1.5b-reduced (qkv bias, tied embedding)."""
    jcfg = _f32(jax_get_config("qwen2.5-1.5b-reduced"))
    jparams = jax.device_get(jmodel.init_params(jcfg,
                                                jax.random.PRNGKey(3)))
    _run_both((jcfg, _f32(get_config("qwen2.5-1.5b-reduced"))), jparams,
              "a3po", _batch_arrays(3, False, vocab=jcfg.vocab_size,
                                  behav_from=(jcfg, jparams)))


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((3, 4)).astype(dtype),
                  "b": rng.standard_normal((4,)).astype(dtype)},
            "c": rng.standard_normal((5, 2)).astype(dtype)}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_matches_jax(weight_decay):
    """Three updates with the global-norm clip active (and weight decay):
    params, moments, t and the gradient norm equal JAX's."""
    base = dict(learning_rate=1e-2, max_grad_norm=0.5,
                weight_decay=weight_decay)
    jrl, trl = JaxRLConfig(**base), RLConfig(**base)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = ParamTree(jax.tree.map(torch.from_numpy, _tree(0)))
    js, ts = jopt.adam_init(jp), opt.adam_init(tp)
    for i in range(3):
        g = _tree(10 + i)
        jp, js, jn = jopt.adam_update(jax.tree.map(jnp.asarray, g), js, jp,
                                      jrl)
        tp, ts, tn = opt.adam_update(jax.tree.map(torch.from_numpy, g), ts,
                                     tp, trl)
        assert float(jn) > trl.max_grad_norm  # the clip is active
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for path, v in walk(tp):
            ref = jp
            for p in path:
                ref = ref[p]
            np.testing.assert_allclose(v.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-7)
        for key in ("m", "v"):
            for path, v in walk(ts[key]):
                ref = js[key]
                for p in path:
                    ref = ref[p]
                np.testing.assert_allclose(v.numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=1e-9)
        assert int(ts["t"]) == int(js["t"]) == i + 1


def test_adam_in_place_and_gate():
    """Moments and t are written into the state, with ``donate_params`` the
    params too; ``apply=False`` leaves everything as it was."""
    trl = RLConfig(learning_rate=1e-2)
    tp = ParamTree(jax.tree.map(torch.from_numpy, _tree(1)))
    st = opt.adam_init(tp)
    g = jax.tree.map(torch.from_numpy, _tree(2))
    before = {k: v.clone() for k, v in opt.flatten(tp).items()}
    out, st2, _ = opt.adam_update(g, st, tp, trl, donate_params=True,
                                  apply=torch.tensor(False))
    assert out is tp and st2 is st and int(st["t"]) == 0
    for k, v in opt.flatten(tp).items():
        assert torch.equal(v, before[k])
    assert all(not bool(v.any()) for _, v in walk(st["m"]))
    opt.adam_update(g, st, tp, trl, donate_params=True)
    assert int(st["t"]) == 1
    assert not torch.equal(opt.flatten(tp)["c"], before["c"])


def _rollouts(seed, n, P, N, per_token):
    rng = np.random.default_rng(seed)
    out = []
    for version in (1, 2):
        plen = rng.integers(2, P + 1, size=n).astype(np.int32)
        tokens = rng.integers(4, 60, size=(n, P + N)).astype(np.int32)
        gen_mask = (np.arange(N)[None] < rng.integers(1, N + 1, size=n)[:, None]
                    ).astype(np.float32)
        gen_logp = (-rng.random((n, N)) * gen_mask).astype(np.float32)
        gv = rng.integers(0, 3, size=(n, N)).astype(np.int32) \
            if per_token and version == 2 else None
        out.append((tokens, plen, gen_logp, gen_mask, version, gv))
    return out


@pytest.mark.parametrize("per_token", [False, True])
def test_assemble_train_batch_matches_jax(per_token):
    """The same RolloutBatches give JAX's TrainBatch ([B] versions, or
    [B, T-1] when any rollout carries per-token stamps)."""
    raw = _rollouts(5, 3, 6, 4, per_token)
    rewards = np.random.default_rng(6).random(6).astype(np.float32)
    jb = jtrainer.assemble_train_batch(
        [JaxRolloutBatch(t, p, lp, m, v, gen_versions=g)
         for t, p, lp, m, v, g in raw], rewards)
    tb = tr.assemble_train_batch(
        [RolloutBatch(t, p, lp, m, v, gen_versions=g)
         for t, p, lp, m, v, g in raw], rewards, device="cpu")
    for f in ("tokens", "response_mask", "behav_logp", "versions",
              "rewards"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.versions.dim() == (2 if per_token else 1)


def test_rollout_batch_from_engine_requests(toy):
    """Requests served by the port's engine become a RolloutBatch whose
    per-token stamps and behaviour logps land on the right positions."""
    _, jparams, tcfg = toy
    params = from_jax(jax.device_get(jparams), device="cpu")
    eng = ContinuousBatchingEngine(tcfg, device="cpu", greedy=True,
                                   max_seqs=2, block_size=4, n_blocks=32,
                                   max_blocks_per_seq=8, prefill_chunk=8)
    prompts = [np.arange(5, 5 + n, dtype=np.int32) for n in (3, 6, 4)]
    for p in prompts:
        eng.submit(p, max_new=5)
    done = sorted(eng.run(params), key=lambda r: r.rid)
    rb = rollout_batch(done, prompt_pad=6, max_new=5, version=7)
    assert rb.tokens.shape == (3, 11) and rb.version == 0
    batch = tr.assemble_train_batch([rb], np.zeros(3, np.float32),
                                    device="cpu")
    for i, r in enumerate(done):
        L, n = len(r.prompt), len(r.generated)
        np.testing.assert_array_equal(rb.tokens[i, :L + n],
                                      np.concatenate([r.prompt,
                                                      r.generated]))
        np.testing.assert_allclose(
            batch.behav_logp[i, L - 1: L - 1 + n].numpy(), r.gen_logp)
        assert float(batch.response_mask[i].sum()) == n
    with pytest.raises(ValueError, match="exceed"):
        rollout_batch(done, prompt_pad=3, max_new=5)


def test_remat_gives_the_same_step(toy):
    """``cfg.remat`` recomputes each layer in the backward
    (torch.utils.checkpoint): the step's gradients and updates are the
    same as without it."""
    _, jparams, tcfg = toy
    _, tb = _batches(_batch_arrays(7, False))
    rl = RLConfig(group_size=4, num_minibatches=1, learning_rate=3e-4)
    outs = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        t = tr.Trainer(cfg, rl, "a3po")
        _, ts = _states(jparams)
        ts, m = t.step(ts, tb)
        outs.append((m, opt.flatten(ts.params)))
    assert outs[0][0]["grad_norm"] == pytest.approx(outs[1][0]["grad_norm"],
                                                    rel=1e-6)
    for k, v in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][k], v, rtol=1e-6, atol=1e-7)


def test_donate_params(toy):
    """``donate_params=False`` returns new tensors and leaves the old ones
    intact (an async runtime reads them as behaviour weights); ``True``
    updates them in place. The Adam state is updated in place either way."""
    _, jparams, tcfg = toy
    _, tb = _batches(_batch_arrays(8, False))
    rl = RLConfig(group_size=4, num_minibatches=2, learning_rate=3e-4)
    _, ts = _states(jparams)
    before = {k: v.detach().clone() for k, v in opt.flatten(ts.params).items()}
    m_before = opt.flatten(ts.opt["m"])["embedding/embed"]
    new, _ = tr.Trainer(tcfg, rl, "a3po").step(ts, tb)
    for k, v in opt.flatten(ts.params).items():
        assert torch.equal(v, before[k]), k
    assert new.params is not ts.params
    assert not torch.equal(opt.flatten(new.params)["embedding/embed"],
                           before["embedding/embed"])
    assert opt.flatten(new.opt["m"])["embedding/embed"] is m_before
    assert new.opt is ts.opt and int(ts.opt["t"]) == 2
    assert all(p.requires_grad for _, p in walk(new.params))
    _, ts2 = _states(jparams)
    donated, _ = tr.Trainer(tcfg, rl, "a3po", donate_params=True).step(ts2,
                                                                       tb)
    assert donated.params is ts2.params
    for k, v in opt.flatten(donated.params).items():
        torch.testing.assert_close(v, opt.flatten(new.params)[k], rtol=0,
                                   atol=0)


def test_trainer_shims_and_metrics(toy):
    """The ``method=`` shim warns and resolves; ``init_state`` makes
    trainable params; each step publishes train_* metrics and counts one
    host transfer (recompute: two)."""
    _, jparams, tcfg = toy
    with pytest.warns(DeprecationWarning):
        t = tr.Trainer(tcfg, RLConfig(group_size=4), method="loglinear")
    assert t.method == "a3po"
    st = t.init_state(torch.Generator().manual_seed(0), device="cpu")
    assert all(p.requires_grad for _, p in walk(st.params))
    assert int(st.version) == 0 and int(st.opt["t"]) == 0
    _, tb = _batches(_batch_arrays(9, False))
    reg = get_registry()
    n0 = reg.counter("train_steps_total").value
    _, m = t.step(st, tb)
    assert t.last_host_syncs == 1 and m["host_syncs"] == 1.0
    assert reg.counter("train_steps_total").value == n0 + 1
    assert reg.gauge("train_loss").get() == m["loss"]
    t2 = tr.Trainer(tcfg, RLConfig(group_size=4), "recompute")
    _, m2 = t2.step(t2.init_state(device="cpu"), tb)
    assert t2.last_host_syncs == 2 and m2["prox_time_s"] > 0.0
    with pytest.raises(ValueError, match="num_microbatches"):
        tr.Trainer(tcfg, RLConfig(group_size=4), "a3po",
                   num_microbatches=3).step(st, tb)


def test_sft_update_matches_jax(toy):
    """One SFT step from an Adam state some steps in (second moments
    non-zero, so each update is smooth in its gradient rather than its
    sign; see ``_rl``): loss and params equal JAX's."""
    jcfg, jparams, tcfg = toy
    tokens, mask, *_ = _batch_arrays(10, False)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jopt.adam_init(jp)
    js = dict(js, v=jax.tree.map(lambda x: jnp.full_like(x, 1e-4), js["v"]),
              t=jnp.asarray(5, jnp.int32))
    jp2, _, jl = jtrainer.sft_update(jcfg, jp, js, jnp.asarray(tokens),
                                     jnp.asarray(mask))
    tp = from_jax(jax.device_get(jparams), device="cpu")
    ts = opt.adam_init(tp)
    for _, v in walk(ts["v"]):
        v.fill_(1e-4)
    ts["t"].fill_(5)
    tp2, ts2, tl = tr.sft_update(tcfg, tp, ts,
                                 torch.from_numpy(tokens).long(),
                                 torch.from_numpy(mask))
    assert int(ts2["t"]) == 6
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jp2)}
    for path, v in walk(tp2):
        np.testing.assert_allclose(v.numpy(), jflat["/".join(path)],
                                   **PARAM_TOL)


def test_checkpoints_cross_load(toy, tmp_path):
    """A checkpoint written by the port loads in the JAX package's
    ``load_checkpoint`` and the reverse, with the same flat keys, values,
    metadata and CRC32 commit record."""
    _, jparams, _ = toy
    tp = from_jax(jax.device_get(jparams), device="cpu")
    state = {"params": tp, "opt": opt.adam_init(tp), "version": 5,
             "history": [np.arange(3), np.ones(2)]}
    ckpt.save_checkpoint(str(tmp_path / "port"), state, {"step": 5})
    tree, meta = jckpt.load_checkpoint(str(tmp_path / "port"))
    assert meta == {"step": 5}
    assert int(tree["version"]) == 5 and len(tree["history"]) == 2
    back = from_jax(tree["params"], device="cpu")
    for (path, a), (_, b) in zip(walk(tp), walk(back)):
        assert torch.equal(a, b), path
    jstate = {"params": jparams, "opt": jopt.adam_init(
        jax.tree.map(jnp.asarray, jparams))}
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, {"step": 1})
    tree2, meta2 = ckpt.load_checkpoint(str(tmp_path / "jax"))
    assert meta2 == {"step": 1}
    for path, v in walk(from_jax(tree2["params"], device="cpu")):
        assert torch.equal(v, opt.flatten(tp)["/".join(path)]), path
    assert int(tree2["opt"]["t"]) == 0
    # bf16 leaves are written as float32, exactly
    bf = ParamTree({"w": torch.randn(3, 3).bfloat16()})
    ckpt.save_checkpoint(str(tmp_path / "bf"), {"params": bf})
    tree3, _ = jckpt.load_checkpoint(str(tmp_path / "bf"))
    assert torch.equal(torch.from_numpy(tree3["params"]["w"]).bfloat16(),
                       bf["w"].detach())
    with open(tmp_path / "port.npz", "r+b") as f:
        f.seek(100)
        f.write(b"\0\0\0\0")
    with pytest.raises(ckpt.CheckpointError):
        ckpt.load_checkpoint(str(tmp_path / "port"))


def test_engine_records_no_graph_with_trainable_weights(toy):
    """Serving weights that require gradients (the trainer's) records no
    autograd graph: every engine entry point runs under no_grad."""
    _, jparams, tcfg = toy
    params = from_jax(jax.device_get(jparams), device="cpu",
                      requires_grad=True)
    eng = ContinuousBatchingEngine(tcfg, device="cpu", greedy=True,
                                   max_seqs=2, block_size=4, n_blocks=32,
                                   max_blocks_per_seq=8, prefill_chunk=8,
                                   decode_horizon=2)
    for n in (3, 5, 4):
        eng.submit(np.arange(4, 4 + n, dtype=np.int32), max_new=4)
    done = eng.run(params)
    assert len(done) == 3
    assert not eng._next_logits.requires_grad
    assert not eng.state.pool_k.requires_grad
    eng.submit(np.arange(4, 9, dtype=np.int32), max_new=3)
    eng._admit(params)
    eng.step(params)
    assert not eng._next_logits.requires_grad


# --------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_training.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["a3po", "recompute"])
def test_step_has_no_host_sync_on_card(cuda_device, toy, algo):
    """A step waits for the device only at its one metric transfer (and,
    for recompute, the prox pass's wait): CUDA's sync debug mode turns any
    other synchronising call into an error."""
    _, jparams, tcfg = toy
    params = from_jax(jax.device_get(jparams), device=cuda_device,
                      requires_grad=True)
    _, tb = _batches(_batch_arrays(11, True))
    tb = tr.TrainBatch(*(getattr(tb, f.name).to(cuda_device)
                         for f in dataclasses.fields(tb)))
    state = tr.TrainState(params, opt.adam_init(params),
                          torch.zeros((), dtype=torch.int32,
                                      device=cuda_device))
    t = tr.Trainer(tcfg, RLConfig(group_size=4), algo)
    t.step(state, tb)  # warm-up: kernels built and loaded
    allowed = []

    class Card(tr.Trainer):
        @staticmethod
        def _to_host(packed):
            allowed.append("transfer")
            torch.cuda.set_sync_debug_mode("default")
            try:
                return tr.Trainer._to_host(packed)
            finally:
                torch.cuda.set_sync_debug_mode("error")

        @staticmethod
        def _wait(x):
            allowed.append("wait")
            torch.cuda.set_sync_debug_mode("default")
            try:
                tr.Trainer._wait(x)
            finally:
                torch.cuda.set_sync_debug_mode("error")

    card = Card(tcfg, RLConfig(group_size=4), algo)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, m = card.step(state, tb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert allowed == (["wait", "transfer"] if algo == "recompute"
                       else ["transfer"])
    assert card.last_host_syncs == len(allowed)
    assert np.isfinite(m["loss"])


@pytest.mark.cuda
def test_step_on_card_matches_cpu(cuda_device, toy):
    """One a3po step through the CUDA kernels equals the CPU step (plain
    versions) in float32: metrics and params."""
    _, jparams, tcfg = toy
    arrays = _batch_arrays(12, True)
    outs = []
    for dev in ("cpu", cuda_device):
        params = from_jax(jax.device_get(jparams), device=dev,
                          requires_grad=True)
        _, tb = _batches(arrays)
        tb = tr.TrainBatch(*(getattr(tb, f.name).to(dev)
                             for f in dataclasses.fields(tb)))
        state = tr.TrainState(params, opt.adam_init(params),
                              torch.tensor(3, dtype=torch.int32).to(dev))
        st, m = tr.Trainer(tcfg, RLConfig(group_size=4), "a3po").step(state,
                                                                     tb)
        outs.append((m, {k: v.detach().cpu()
                         for k, v in opt.flatten(st.params).items()}))
    for k in tr.METRIC_KEYS:
        np.testing.assert_allclose(outs[1][0][k], outs[0][0][k], rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    for k, v in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][k], v, rtol=2e-4, atol=1e-6)
