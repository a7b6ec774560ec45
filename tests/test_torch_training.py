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
import json
import os
import subprocess
import sys
import textwrap
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
from repro_torch.kernels.adam import ops as aops
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


def _adam_case(seed, dtype, sizes=((3, 4), (4,), (5, 2), (1,), (37,))):
    """A flat tree of weights, gradients and warmed moments (t = 2)."""
    rng = np.random.default_rng(seed)

    def draw(shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32))
    keys = [f"l{i}" for i in range(len(sizes))]
    p = {k: draw(sh).to(dtype) for k, sh in zip(keys, sizes)}
    g = {k: draw(sh, 0.3).to(dtype) for k, sh in zip(keys, sizes)}
    m = {k: draw(sh, 0.01) for k, sh in zip(keys, sizes)}
    v = {k: draw(sh, 0.01).square() for k, sh in zip(keys, sizes)}
    return p, g, m, v


def _clone(d):
    return {k: x.clone() for k, x in d.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("apply", [True, False])
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_cases_match_jax(weight_decay, clip, apply, donate, dtype):
    """Two updates from a warmed state (t = 2) through ``adam_update``
    (off the card the plain version, ``kernels/adam/ref.py``) against
    JAX's: the norm, moments, t and weights (bf16: within 1 ulp), with
    the clip active or not, weight decay or not, the weights donated or
    not, bf16 or float32 leaves; with the gate shut nothing moves."""
    base = dict(learning_rate=1e-2, weight_decay=weight_decay,
                max_grad_norm=0.5 if clip else 1e3)
    jrl, rl = JaxRLConfig(**base), RLConfig(**base)
    p, g, m, v = _adam_case(7, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def to_jax(d, dt=jnp.float32):
        return {k: jnp.asarray(x.float().numpy()).astype(dt)
                for k, x in d.items()}
    jp, jg = to_jax(p, jdt), to_jax(g, jdt)
    js = {"m": to_jax(m), "v": to_jax(v), "t": jnp.asarray(2, jnp.int32)}
    st = {"m": _clone(m), "v": _clone(v),
          "t": torch.tensor(2, dtype=torch.int32)}
    gate = torch.tensor(apply)
    tp = _clone(p)
    for _ in range(2):
        given = tp
        tp, st, gn = opt.adam_update(g, st, tp, rl, donate_params=donate,
                                     apply=gate)
        assert (tp is given) == donate
        jp, js, jn = jopt.adam_update(jg, js, jp, jrl)
        assert (float(gn) > rl.max_grad_norm) == clip
        np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    assert int(st["t"]) == (int(js["t"]) if apply else 2)
    for k in p:
        assert tp[k].dtype == dtype
        if not apply:
            assert torch.equal(tp[k], p[k]), k
            assert torch.equal(st["m"][k], m[k]), k
            assert torch.equal(st["v"][k], v[k]), k
            continue
        for key in ("m", "v"):
            np.testing.assert_allclose(st[key][k].numpy(),
                                       np.asarray(js[key][k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{key} {k}")
        want = torch.from_numpy(np.array(jp[k].astype(jnp.float32)))
        if dtype == torch.bfloat16:
            assert bool(((tp[k].float() - want).abs()
                         <= _bf16_ulp(want)).all()), k
        else:
            np.testing.assert_allclose(tp[k].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert any(not torch.equal(tp[k], p[k]) for k in p) == apply


def test_adam_counter_reports_the_plain_elements():
    """Off the card every element takes the plain version: the installed
    tracer's ``adam_update`` counter reads them under ``plain_elems``,
    one sample an update, and nothing is launched."""
    from repro_torch.obs.tracing import SpanTracer, install_tracer
    rl = RLConfig(learning_rate=1e-2, max_grad_norm=0.5)
    p, g, _, _ = _adam_case(8, torch.float32)
    total = sum(x.numel() for x in p.values())
    n0 = dict(aops.LAUNCHES)
    tracer = install_tracer(SpanTracer())
    try:
        st = opt.adam_init(p)
        new, st, _ = opt.adam_update(g, st, p, rl)
        opt.adam_update(g, st, new, rl, donate_params=True)
    finally:
        install_tracer(None)
    samples = [e["args"] for e in tracer.events()
               if e["ph"] == "C" and e["name"] == "adam_update"]
    assert samples == [{"fused_elems": 0.0, "plain_elems": float(total)}] * 2
    assert aops.LAUNCHES == n0


_DTENSOR_ADAM = textwrap.dedent("""
    import json, socket, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, port, path):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard, distribute_tensor)
        from repro_torch.configs.base import RLConfig
        from repro_torch.obs.tracing import SpanTracer, install_tracer
        from repro_torch.training import optimizer as opt
        mesh = init_device_mesh("cpu", (2,))
        gen = torch.Generator().manual_seed(5)
        shapes = {"a": (5, 3), "b": (4,), "c": (6, 2)}
        place = {"a": [Shard(0)], "b": [Replicate()], "c": [Shard(1)]}
        full = {n: {k: torch.randn(s, generator=gen) * sc
                    for k, s in shapes.items()}
                for n, sc in (("p", 1.0), ("g", 0.3), ("m", 0.01),
                              ("v", 0.01))}
        full["v"] = {k: x.square() for k, x in full["v"].items()}
        rl = RLConfig(learning_rate=1e-2, weight_decay=0.1,
                      max_grad_norm=0.5)
        want_p = {k: x.clone() for k, x in full["p"].items()}
        want_st = {"m": {k: x.clone() for k, x in full["m"].items()},
                   "v": {k: x.clone() for k, x in full["v"].items()},
                   "t": torch.tensor(1, dtype=torch.int32)}
        for _ in range(2):
            want_p, want_st, want_gn = opt.adam_update(full["g"], want_st,
                                                       want_p, rl)

        def shard(n):
            return {k: distribute_tensor(x.clone(), mesh, place[k])
                    for k, x in full[n].items()}
        p, m, v = shard("p"), shard("m"), shard("v")
        # "a" placed as its weight, "b" a partial sum (halves), "c"
        # replicated where its weight is sharded
        g = {"a": distribute_tensor(full["g"]["a"], mesh, [Shard(0)]),
             "b": DTensor.from_local(full["g"]["b"] / 2, mesh, [Partial()],
                                     run_check=False),
             "c": distribute_tensor(full["g"]["c"], mesh, [Replicate()])}
        st = {"m": m, "v": v, "t": torch.tensor(1, dtype=torch.int32)}
        tracer = install_tracer(SpanTracer())
        for i in range(2):
            p, st, gn = opt.adam_update(g, st, p, rl, donate_params=i == 1)
        install_tracer(None)
        errs = []
        for got, want in ((p, want_p), (st["m"], want_st["m"]),
                          (st["v"], want_st["v"])):
            for k, x in got.items():
                errs.append(float(((x.full_tensor() - want[k]).abs()
                                   / (1e-7 + 1e-6 * want[k].abs())).max()))
        out = {"gn": float(gn), "want_gn": float(want_gn),
               "t": int(st["t"]), "err": max(errs),
               "placed": all(x.placements == tuple(place[k])
                             for k, x in p.items()),
               "counter": [e["args"] for e in tracer.events()
                           if e["ph"] == "C"],
               "local": sum(x.to_local().numel() for x in p.values())}
        with open(f"{path}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(run, args=(port, sys.argv[1]), nprocs=2)
""")


def test_adam_dtensor_leaves_update_their_shards(tmp_path):
    """On two gloo ranks, ``DTensor`` leaves (sharded by rows unevenly, by
    columns, replicated; one gradient a partial sum, one placed otherwise
    than its weight) take the update shard by shard and the norm as the
    sum of the shards' squares: two updates equal the plain tensors'
    within rtol 1e-6 and keep the weights' placements, and the counter
    reads each rank's local elements."""
    script = tmp_path / "dtensor_adam.py"
    script.write_text(_DTENSOR_ADAM)
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    files = sorted(tmp_path.glob("rank*.json"))
    assert len(files) == 2, out.stdout[-2000:] + out.stderr[-4000:]
    ranks = [json.loads(f.read_text()) for f in files]
    # rank 0 holds rows 0-2 of "a" and column 0 of "c", rank 1 the rest
    assert [r["local"] for r in ranks] == [9 + 4 + 6, 6 + 4 + 6]
    for r in ranks:
        assert r["t"] == 3 and r["placed"], r
        assert abs(r["gn"] - r["want_gn"]) <= 1e-6 * r["want_gn"], r
        assert r["err"] <= 1.0, r
        assert r["counter"] == [{"fused_elems": 0.0,
                                 "plain_elems": float(r["local"])}] * 2, r


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


@pytest.mark.cuda
def test_step_on_card_fuses_every_leaf(cuda_device, toy):
    """``Trainer.step`` on the card sends every leaf through the Adam
    kernels: each minibatch one norm (two launches) and one update launch,
    and the tracer's ``adam_update`` counter reads ``plain_elems`` 0."""
    from repro_torch.obs.tracing import SpanTracer, install_tracer
    _, jparams, tcfg = toy
    params = from_jax(jax.device_get(jparams), device=cuda_device,
                      requires_grad=True)
    _, tb = _batches(_batch_arrays(13, True))
    tb = tr.TrainBatch(*(getattr(tb, f.name).to(cuda_device)
                         for f in dataclasses.fields(tb)))
    state = tr.TrainState(params, opt.adam_init(params),
                          torch.zeros((), dtype=torch.int32,
                                      device=cuda_device))
    rl = RLConfig(group_size=4)
    n0 = dict(aops.LAUNCHES)
    tracer = install_tracer(SpanTracer())
    try:
        tr.Trainer(tcfg, rl, "a3po").step(state, tb)
    finally:
        install_tracer(None)
    total = sum(p.numel() for p in opt.flatten(params).values())
    samples = [e["args"] for e in tracer.events()
               if e["ph"] == "C" and e["name"] == "adam_update"]
    assert samples == [{"fused_elems": float(total), "plain_elems": 0.0}
                       ] * rl.num_minibatches
    assert (aops.LAUNCHES["norm"] - n0["norm"],
            aops.LAUNCHES["update"] - n0["update"]) == (
        2 * rl.num_minibatches, rl.num_minibatches)


def _on_card(x, dev, offset=0):
    """``x`` on the card, ``offset`` elements past an allocation's start
    (offset 1 breaks 16-byte alignment: the kernels' scalar loop)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def _bf16_ulp(x):
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


ADAM_RAGGED = (1, 7, 8, 9, 4095, 2 ** 16 + 3, 2 * 2 ** 16 + 13, 300_000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "bf16_f32grad"])
@pytest.mark.parametrize("sizes", [ADAM_RAGGED,
                                   tuple(37 * i % 1000 + 1
                                         for i in range(70))],
                         ids=["ragged", "many"])
def test_adam_kernels_match_plain_on_card(cuda_device, dtype, gdtype,
                                          sizes):
    """The norm and update kernels against their plain version on the card
    over three updates (t and the bias corrections advance): the norm
    within rtol 1e-6 and bit-equal on a second launch, m and v within rtol
    1e-6, weights within 1 bf16 ulp (float32: rtol 1e-6). Weights and
    gradients of one dtype, or float32 gradients of bf16 weights (the step
    programs' accumulators). Sizes that are no multiple of the 8-element
    vector, a 1-element leaf, leaves cut into several chunks, one leaf off
    16-byte alignment, or more leaves than one argument table holds (two
    launches). Then the gate shut: nothing of the state moves, and a
    separate output gets the weights."""
    from repro_torch.kernels.adam import kernel as akernel
    from repro_torch.kernels.adam.ref import adam_update_ref, global_norm_ref
    hp = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              max_norm=1.0)
    gen = torch.Generator().manual_seed(30)

    def draw(n, s, dt):
        return (torch.randn(n, generator=gen) * s).to(dt)
    off = [int(i == 2) for i in range(len(sizes))]
    ps = [_on_card(draw(n, 1.0, dtype), cuda_device, o)
          for n, o in zip(sizes, off)]
    ms = [_on_card(torch.zeros(n), cuda_device, o)
          for n, o in zip(sizes, off)]
    vs = [_on_card(torch.zeros(n), cuda_device, o)
          for n, o in zip(sizes, off)]
    rps, rms, rvs = ([x.clone() for x in xs] for xs in (ps, ms, vs))
    tables = -(-len(sizes) // akernel.max_leaves())
    t = torch.zeros((), dtype=torch.int32, device=cuda_device)
    for step in range(3):
        gs = [_on_card(draw(n, 0.05 * (step + 1), gdtype), cuda_device, o)
              for n, o in zip(sizes, off)]
        n0 = dict(aops.LAUNCHES)
        gn = aops.global_norm(gs)
        assert torch.equal(aops.global_norm(gs), gn)
        torch.testing.assert_close(gn, global_norm_ref(gs), rtol=1e-6,
                                   atol=0)
        t_new = t + 1
        aops.adam_update(ps, gs, ms, vs, ps, gn, t_new, None, **hp)
        adam_update_ref(rps, gs, rms, rvs, rps, gn, t_new, None, **hp)
        assert (aops.LAUNCHES["norm"] - n0["norm"],
                aops.LAUNCHES["update"] - n0["update"]) == (
            2 * (tables + 1), tables)
        t.copy_(t_new)
        for i in range(len(sizes)):
            torch.testing.assert_close(ms[i], rms[i], rtol=1e-6, atol=1e-12)
            torch.testing.assert_close(vs[i], rvs[i], rtol=1e-6, atol=1e-12)
            if dtype == torch.bfloat16:
                gap = (ps[i].float() - rps[i].float()).abs()
                assert bool((gap <= _bf16_ulp(rps[i])).all()), (step, i)
            else:
                torch.testing.assert_close(ps[i], rps[i], rtol=1e-6,
                                           atol=1e-12)
    shut = torch.tensor(False, device=cuda_device)
    before = [[x.clone() for x in xs] for xs in (ps, ms, vs)]
    outs = [torch.full_like(p, float("nan")) for p in ps]
    aops.adam_update(ps, gs, ms, vs, outs, gn, t + 1, shut, **hp)
    aops.adam_update(ps, gs, ms, vs, ps, gn, t + 1, shut, **hp)
    for xs, ys in zip((ps, ms, vs, outs), before + [before[0]]):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))


@pytest.mark.cuda
def test_adam_on_card_copies_or_refuses(cuda_device):
    """On the card there is no plain path: a transposed gradient (the tied
    embedding's, laid out as its weight's transpose) is read through a
    contiguous copy, bit-equal to the contiguous gradient's update; a
    float16 weight and a non-contiguous weight raise. The kernels' writes
    bump the version counters of the moments and the weights."""
    hp = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              max_norm=1.0)
    gen = torch.Generator().manual_seed(31)
    p = torch.randn(48, 40, generator=gen).to(cuda_device, torch.bfloat16)
    gt = (torch.randn(40, 48, generator=gen) * 0.1).to(cuda_device,
                                                       torch.bfloat16).T
    t = torch.ones((), dtype=torch.int32, device=cuda_device)
    res = []
    for g in (gt, gt.contiguous()):
        m, v = torch.zeros_like(p, dtype=torch.float32), torch.zeros_like(
            p, dtype=torch.float32)
        gn = aops.global_norm([g])
        out = torch.empty_like(p)
        versions = (m._version, v._version, out._version)
        assert aops.adam_update([p], [g], [m], [v], [out], gn, t,
                                **hp) == (p.numel(), 0)
        assert all(x._version > n for x, n in zip((m, v, out), versions))
        res.append((gn, out, m, v))
    assert all(torch.equal(a, b) for a, b in zip(*res))
    m, v = res[0][2], res[0][3]
    with pytest.raises(ValueError, match="no kernel"):
        aops.adam_update([p.half()], [gt.half()], [m], [v], [p.half()],
                         res[0][0], t, **hp)
    with pytest.raises(ValueError, match="no kernel"):
        aops.adam_update([p.T], [gt.T], [m.T], [v.T], [p.T], res[0][0], t,
                         **hp)
