"""The MoE, MLA and frontend stacks of the PyTorch port against the JAX
package, float32 on the CPU: qwen3-moe-30b-a3b (MoE), deepseek-v2-lite-16b
(MoE with a shared expert, MLA), llava-next-mistral-7b (vision prefix) and
musicgen-large (audio prefix), each ``-reduced``.

Mirrors ``tests/test_arch_smoke.py`` for the four (reduced limits, forward
shapes with the frontend embeddings, decode against the full forward,
parameter counts from the spec), then holds the port against JAX on
JAX-initialised weights carried across with ``from_jax``:
``forward_logits`` and the aux loss, ``prefill`` + ``decode_step`` (within
2e-5), the dense ``RolloutEngine`` (greedy tokens exact, logps within
1e-4) and ``Trainer.step`` (rtol 2e-4). Also the registry, the refusals
that match the reference's (the paged engine, the control plane and
``--engine async`` refuse MoE and frontend stacks; ``RolloutEngine`` a
frontend stack), the serve launcher, and the initial weights' draw.
"""
import dataclasses
import hashlib
import importlib
import pkgutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.async_rl.orchestrator import AsyncOrchestrator as JaxOrchestrator
from repro.configs.base import RLConfig as JaxRLConfig
from repro.configs import registry as jregistry
from repro.data.tasks import ArithmeticTask as JaxTask
from repro.models import model as jmodel
from repro.rollout.continuous import ContinuousBatchingEngine as JaxPaged
from repro.rollout.engine import RolloutEngine as JaxRolloutEngine
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch.async_rl.orchestrator import AsyncOrchestrator
from repro_torch.configs import registry
from repro_torch.configs.base import RLConfig
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams_mod
from repro_torch.models.params import from_jax, walk
from repro_torch.rollout.continuous import ContinuousBatchingEngine
from repro_torch.rollout.engine import RolloutEngine
from repro_torch.training import optimizer as topt
from repro_torch.training import trainer as ttr

NEW = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "llava-next-mistral-7b",
       "musicgen-large")
MOE = NEW[:2]
FRONTEND = NEW[2:]
TOL = dict(rtol=2e-5, atol=2e-5)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _scaled_blocks(params, factor=4.0):
    """Layer weights (not the norms) x4: at the init stds a random model
    repeats its last token; scaled, the layers decide the tokens. (x8, as
    the dense parity tests scale, takes the float32 rounding of the two
    frameworks past 2e-5 on llava's logits: 2.9e-5, against 8e-6 at x4.)"""
    blocks = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "norm" in jax.tree_util.keystr(path)
        or "ln" in jax.tree_util.keystr(path) else a * factor,
        params["blocks"])
    return dict(params, blocks=blocks)


@pytest.fixture(scope="module")
def models():
    """name -> (jax cfg, jax params, port cfg, port params) of a
    JAX-initialised -reduced architecture, layer weights x4."""
    made = {}

    def get(name):
        if name not in made:
            jcfg = _f32(jregistry.get_config(name + "-reduced"))
            jp = _scaled_blocks(jmodel.init_params(jcfg,
                                                   jax.random.PRNGKey(3)))
            made[name] = (jcfg, jp, _f32(registry.get_config(
                name + "-reduced")), from_jax(jax.device_get(jp),
                                              device="cpu"))
        return made[name]
    return get


def _inputs(cfg, B=2, S=12, seed=0):
    """Seeded numpy tokens [B, S] and, for a frontend stack, embeddings
    [B, F, d]."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = None
    if cfg.frontend:
        emb = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, emb


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ------------------------------------------------ mirrors of arch smoke
@pytest.mark.parametrize("arch", NEW)
def test_configs_match_reference(arch):
    for name in (arch, arch + "-reduced"):
        t, j = registry.get_config(name), jregistry.get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.num_params() == j.num_params()


@pytest.mark.parametrize("arch", NEW)
def test_reduced_config_limits(arch):
    cfg = registry.get_config(arch + "-reduced")
    assert cfg.num_layers <= 6
    assert cfg.d_model <= 512
    if cfg.moe:
        assert cfg.moe.num_experts <= 4


@pytest.mark.parametrize("arch", sorted(registry.ASSIGNED))
def test_param_count_matches_spec(arch):
    """The spec's parameter count (no tensors made) equals the analytic
    ``num_params()``, full size and reduced."""
    for cfg in (registry.get_config(arch),
                registry.get_config(arch + "-reduced")):
        count = sum(int(np.prod(s.shape))
                    for _, s in walk(tmodel.model_spec(cfg)))
        assert count == cfg.num_params(), cfg.name


@pytest.mark.parametrize("arch", NEW)
def test_forward_shapes_no_nan(arch):
    cfg = _f32(registry.get_config(arch + "-reduced"))
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    toks, emb = _inputs(cfg)
    h, aux = tmodel.forward_hidden(params, cfg, _t(toks).long(),
                                   embeds=_t(emb))
    logits = tmodel.forward_logits(params, cfg, _t(toks).long(),
                                   embeds=_t(emb))
    F = cfg.frontend_tokens if cfg.frontend else 0
    assert logits.shape == (2, 12 + F, cfg.vocab_size)
    assert h.shape == (2, 12 + F, cfg.d_model)
    assert bool(torch.isfinite(logits).all())
    assert aux.shape == () and aux.dtype == torch.float32
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", NEW)
def test_decode_matches_full_forward(arch, models):
    _, _, cfg, params = models(arch)
    toks, emb = _inputs(cfg, seed=1)
    full = tmodel.forward_logits(params, cfg, _t(toks).long(),
                                 embeds=_t(emb))
    F = cfg.frontend_tokens if cfg.frontend else 0
    _, cache = tmodel.prefill(params, cfg, _t(toks[:, :-1]).long(),
                              embeds=_t(emb), max_len=F + 16)
    dec, cache2 = tmodel.decode_step(params, cfg, cache,
                                     _t(toks[:, -1]).long())
    ref = full[:, -1]
    assert float((ref - dec).abs().max() / ref.abs().max()) < 2e-3
    assert int(cache2["lengths"][0]) == int(cache["lengths"][0]) + 1 \
        == F + 12


# --------------------------------------------------------- JAX parity
@pytest.mark.parametrize("arch", NEW)
def test_forward_and_aux_match_jax(arch, models):
    jcfg, jp, tcfg, tp = models(arch)
    toks, emb = _inputs(tcfg, seed=2)
    lj, auxj = jmodel.forward_logits(jp, jcfg, _j(toks), embeds=_j(emb))
    h, auxt = tmodel.forward_hidden(tp, tcfg, _t(toks).long(),
                                    embeds=_t(emb))
    lt = tmodel.forward_logits(tp, tcfg, _t(toks).long(), embeds=_t(emb))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(auxt), float(auxj), **TOL)


@pytest.mark.parametrize("arch", NEW)
def test_prefill_decode_match_jax(arch, models):
    """Right-padded ragged prompts: prefill's hidden state and cache at
    the valid positions, then three decode steps' logits and caches."""
    jcfg, jp, tcfg, tp = models(arch)
    toks, emb = _inputs(tcfg, S=10, seed=3)
    lengths = np.array([10, 7], np.int32)
    F = tcfg.frontend_tokens if tcfg.frontend else 0
    hj, cj = jmodel.prefill(jp, jcfg, _j(toks), embeds=_j(emb),
                            lengths=_j(lengths), max_len=F + 16)
    ht, ct = tmodel.prefill(tp, tcfg, _t(toks).long(), embeds=_t(emb),
                            lengths=_t(lengths), max_len=F + 16)
    valid = np.arange(F + 10)[None] < (lengths + F)[:, None]
    np.testing.assert_allclose(ht.numpy()[valid], np.asarray(hj)[valid],
                               **TOL)
    np.testing.assert_array_equal(ct["lengths"].numpy(),
                                  np.asarray(cj["lengths"]))
    rng = np.random.default_rng(4)
    for step in range(3):
        nxt = rng.integers(4, tcfg.vocab_size, (2,)).astype(np.int32)
        lgj, cj = jmodel.decode_step(jp, jcfg, cj, _j(nxt))
        lgt, ct = tmodel.decode_step(tp, tcfg, ct, _t(nxt).long())
        np.testing.assert_allclose(lgt.numpy(), np.asarray(lgj), **TOL)
    written = np.arange(F + 16)[None] < (lengths + F + 3)[:, None]
    for k in ct["attn"]:
        np.testing.assert_allclose(
            ct["attn"][k].numpy()[:, written],
            np.asarray(cj["attn"][k])[:, written], err_msg=k, **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_rollout_engine_greedy_matches_jax(arch, models):
    """The dense RolloutEngine (prefill, then decode) on ragged prompts:
    greedy tokens and masks equal JAX's, behaviour logps within 1e-4."""
    jcfg, jp, tcfg, tp = models(arch)
    rng = np.random.default_rng(5)
    prompts = rng.integers(4, tcfg.vocab_size, (3, 9)).astype(np.int32)
    lengths = np.array([9, 5, 7], np.int32)
    j = JaxRolloutEngine(jcfg, JaxRLConfig(), 6).generate(
        jp, prompts, lengths, jax.random.PRNGKey(0), version=2, greedy=True)
    t = RolloutEngine(tcfg, RLConfig(), 6).generate(
        tp, prompts, lengths, version=2, greedy=True)
    np.testing.assert_array_equal(t.tokens, j.tokens)
    np.testing.assert_array_equal(t.gen_mask, j.gen_mask)
    np.testing.assert_allclose(t.gen_logp, j.gen_logp, rtol=1e-4,
                               atol=1e-4)
    # not one token repeated: the layers decide
    assert len(set(t.tokens[:, 9:].reshape(-1).tolist())) > 3


@pytest.mark.parametrize("arch", MOE + ("mamba2-370m", "zamba2-1.2b"))
def test_train_step_matches_jax(arch):
    """One a3po step from JAX-initialised weights (the MoE load-balance
    loss enters the loss and its gradient; the SSM and hybrid stacks
    differentiate the port's plain chunked scan against JAX's autodiff of
    its jnp scan): every metric and parameter within rtol 2e-4, as
    tests/test_torch_training.py holds the dense stacks."""
    jcfg = _f32(jregistry.get_config(arch + "-reduced"))
    tcfg = _f32(registry.get_config(arch + "-reduced"))
    jparams = jax.device_get(jmodel.init_params(jcfg, jax.random.PRNGKey(3)))
    B, T = 8, 12
    rng = np.random.default_rng(6)
    tokens = rng.integers(4, tcfg.vocab_size - 4, (B, T)).astype(np.int32)
    mask = ((np.arange(T - 1)[None] >= 4)
            & (rng.random((B, T - 1)) > 0.2)).astype(np.float32)
    behav = np.asarray(jtrainer.score_tokens(
        jax.tree.map(jnp.asarray, jparams), jcfg, jnp.asarray(tokens))[0])
    behav = ((behav + 0.2 * rng.standard_normal((B, T - 1))) * mask
             ).astype(np.float32)
    versions = rng.integers(0, 4, (B,)).astype(np.int32)
    rewards = rng.random(B).astype(np.float32)
    # Adam eps 1e-4: see tests/test_torch_training.py's _rl
    kw = dict(group_size=4, num_minibatches=2, learning_rate=3e-4,
              adam_eps=1e-4)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jtrainer.TrainState(jp, jopt.adam_init(jp), jnp.asarray(3))
    tp = from_jax(jparams, device="cpu", requires_grad=True)
    ts = ttr.TrainState(tp, topt.adam_init(tp), torch.tensor(3))
    js, jm = jtrainer.Trainer(jcfg, JaxRLConfig(**kw), "a3po").step(
        js, jtrainer.TrainBatch(*(jnp.asarray(a) for a in (
            tokens, mask, behav, versions, rewards))))
    ts, tm = ttr.Trainer(tcfg, RLConfig(**kw), "a3po").step(
        ts, ttr.TrainBatch(_t(tokens).long(), _t(mask), _t(behav),
                           _t(versions), _t(rewards)))
    for k in ttr.METRIC_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(js.params)}
    for path, v in walk(ts.params):
        np.testing.assert_allclose(v.detach().numpy(), jflat["/".join(path)],
                                   rtol=2e-4, atol=1e-6, err_msg=str(path))
    if arch in MOE:
        # the aux the step adds to the loss is far above the tolerances
        _, _, aux = ttr._score_tokens(tp, tcfg, _t(tokens).long())
        assert float(aux.detach()) > 1e-3


# ------------------------------------------------------------ registry
def test_registry_lists_the_assigned_archs():
    archs = registry.list_archs(assigned_only=True)
    assert archs == jregistry.list_archs(assigned_only=True)
    assert len(archs) == 10
    assert {registry.get_config(a).arch_type for a in archs} == \
        {"dense", "moe", "ssm", "hybrid", "vlm", "audio"}
    assert registry.list_archs() == jregistry.list_archs()
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")


# ------------------------------------------------------------ refusals
def _raises_alike(port_call, jax_call, match):
    """Both packages refuse with the same reason (the port a ValueError,
    the reference an assertion)."""
    with pytest.raises(AssertionError, match=match):
        jax_call()
    with pytest.raises(ValueError, match=match):
        port_call()


@pytest.mark.parametrize("arch", ("qwen3-moe-30b-a3b",) + FRONTEND)
def test_paged_engine_refuses(arch):
    jcfg = _f32(jregistry.get_config(arch + "-reduced"))
    tcfg = _f32(registry.get_config(arch + "-reduced"))
    _raises_alike(lambda: ContinuousBatchingEngine(tcfg, device="cpu"),
                  lambda: JaxPaged(jcfg),
                  f"paged serving: dense/ssm/hybrid archs, got "
                  f"{tcfg.arch_type}")


def test_control_plane_and_engine_async_refuse_moe(monkeypatch):
    """The threaded orchestrator's control plane, and the launcher's
    --engine async, refuse an MoE stack with the paged engine's reason."""
    name = "qwen3-moe-30b-a3b-reduced"
    jcfg = _f32(jregistry.get_config(name))
    tcfg = _f32(registry.get_config(name))
    match = "paged serving: dense/ssm/hybrid archs, got moe"
    jrl, trl = JaxRLConfig(group_size=2), RLConfig(group_size=2)
    jorch = JaxOrchestrator(jcfg, jrl, JaxTask(seed=0), "a3po", n_prompts=1,
                            max_new_tokens=2, use_control_plane=True)
    torch_orch = AsyncOrchestrator(tcfg, trl, ArithmeticTask(seed=0), "a3po",
                                   n_prompts=1, max_new_tokens=2,
                                   use_control_plane=True)
    _raises_alike(
        lambda: torch_orch.run(torch_orch.trainer.init_state(
            torch.Generator().manual_seed(0), device="cpu"), 1),
        lambda: jorch.run(jtrainer.Trainer(jcfg, jrl, "a3po").init_state(
            jax.random.PRNGKey(0)), 1), match)
    from repro.launch import train as jtrain
    monkeypatch.setattr(sys, "argv", ["train", "--arch", name, "--steps",
                                      "1", "--engine", "async", "--quiet"])
    _raises_alike(
        lambda: ttrain.main(["--device", "cpu", "--arch", name, "--steps",
                             "1", "--engine", "async", "--quiet"]),
        jtrain.main, match)


@pytest.mark.parametrize("arch", FRONTEND)
def test_rollout_engine_refuses_frontend_stack(arch, models):
    jcfg, jp, tcfg, tp = models(arch)
    prompts = np.full((2, 4), 5, np.int32)
    lengths = np.array([4, 3], np.int32)
    _raises_alike(
        lambda: RolloutEngine(tcfg, RLConfig(), 2).generate(
            tp, prompts, lengths, greedy=True),
        lambda: JaxRolloutEngine(jcfg, JaxRLConfig(), 2).generate(
            jp, prompts, lengths, jax.random.PRNGKey(0), greedy=True),
        "needs frontend embeds")


def test_launcher_sim_engine_takes_moe_and_refuses_frontend(capsys):
    """``launch/train.py --engine sim`` takes the new archs as far as the
    reference's launcher does: an MoE + MLA stack trains, a frontend stack
    stops at the rollout engine's refusal."""
    ttrain.main(["--device", "cpu", "--arch", "deepseek-v2-lite-16b-reduced",
                 "--steps", "1", "--staleness", "0"])
    assert "step   0" in capsys.readouterr().out
    with pytest.raises(ValueError, match="needs frontend embeds"):
        ttrain.main(["--device", "cpu", "--arch",
                     "musicgen-large-reduced", "--steps", "1", "--quiet"])


# ------------------------------------------------------- serve launcher
def test_serve_launcher_on_the_cpu(capsys):
    """launch/serve.py --device cpu: a toy config as it is, a full-scale
    MoE + MLA config swapped for its -reduced variant; each wave prints
    its tokens and tokens/s."""
    tserve.main(["--device", "cpu", "--arch", "toy-2m", "--batch", "2",
                 "--max-new", "3", "--waves", "2"])
    tserve.main(["--device", "cpu", "--arch", "deepseek-v2-lite-16b",
                 "--batch", "2", "--max-new", "3", "--waves", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("wave 0: 2 seqs x 3 new -> ")
    assert out[1].startswith("wave 1: 2 seqs x 3 new -> ")
    assert out[2] == ("(CPU host: serving reduced variant of "
                      "deepseek-v2-lite-16b)")
    assert out[3].startswith("wave 0: 2 seqs x 3 new -> ")
    assert all(line.endswith(" tok/s") for line in out[:2] + out[3:])


# ---------------------------------------------------------- weight draws
# sha256 (first 32 hex digits) over every leaf's path and bytes, in walk
# order, of init_params(cfg, torch.Generator().manual_seed(0),
# device="cpu", dtype=...), recorded from the code before large leaves
# were drawn in slices
DRAWN = {("toy-2m", torch.float32): "18406b70992fd164db5286d09cf1abd9",
         ("toy-2m", torch.bfloat16): "ccadddf8812931f57c1bddf3e029d1c8",
         ("qwen2.5-1.5b-reduced", torch.float32):
             "541536171e692b20f1cc38cc7de8fae1",
         ("qwen2.5-1.5b-reduced", torch.bfloat16):
             "ed448c480e97e653b909a34eec8506dc"}


def _digest(params):
    h = hashlib.sha256()
    for path, t in walk(params):
        h.update("/".join(path).encode())
        h.update(t.detach().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:32]


@pytest.mark.parametrize("name,dtype", sorted(DRAWN, key=str))
def test_init_draws_are_unchanged(name, dtype):
    """Leaves under the sliced-draw threshold draw what they always drew:
    the recorded digests, and a whole draw of every leaf scaled by its
    std."""
    cfg = registry.get_config(name)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", dtype=dtype)
    assert _digest(params) == DRAWN[(name, dtype)]
    g = torch.Generator().manual_seed(0)
    for path, spec in walk(tmodel.model_spec(cfg)):
        assert int(np.prod(spec.shape)) <= tparams_mod.WHOLE_DRAW_MAX
        leaf = params
        for p in path:
            leaf = leaf[p]
        if spec.init == "normal":
            want = torch.randn(spec.shape, generator=g) * tparams_mod._std(
                spec)
        else:
            want = tparams_mod._init_leaf(spec, g)
        assert torch.equal(leaf, want.to(dtype)), path


def test_large_leaves_are_drawn_in_slices(monkeypatch):
    """A leaf over the threshold is drawn a leading-axis slice at a time
    into its dtype: the same values as drawing each slice in turn, the
    spec's std, and every later leaf drawn from where the slices left the
    generator."""
    monkeypatch.setattr(tparams_mod, "WHOLE_DRAW_MAX", 1000)
    spec = {"a": tparams_mod.ParamSpec((6, 40, 30), ("l", "x", "y")),
            "b": tparams_mod.ParamSpec((5,), ("x",))}
    p = tparams_mod.init_from_specs(spec, torch.Generator().manual_seed(1),
                                    device="cpu", dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    std = (6 * 40) ** -0.5
    want = torch.stack([torch.randn(40, 30, generator=g) * std
                        for _ in range(6)]).to(torch.bfloat16)
    assert p["a"].dtype == torch.bfloat16 and torch.equal(p["a"], want)
    assert torch.equal(p["b"], (torch.randn(5, generator=g) * 5 ** -0.5)
                       .to(torch.bfloat16))
    assert abs(float(p["a"].float().std()) - std) < 0.1 * std


# ------------------------------------------------------ import isolation
def test_isolation_walk_covers_the_new_modules():
    """tests/test_torch_serving.py's import-isolation test walks every
    port module: the new ones are among them, and import."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    new = {"repro_torch.models.moe", "repro_torch.models.mla",
           "repro_torch.launch.serve", "repro_torch.configs.musicgen_large",
           "repro_torch.configs.llava_next_mistral_7b",
           "repro_torch.configs.qwen3_moe_30b_a3b",
           "repro_torch.configs.deepseek_v2_lite_16b"}
    assert new <= names
    for n in new:
        importlib.import_module(n)
