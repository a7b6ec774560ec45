"""The port's step programs, input specs and dry-run against the JAX
package (``repro.launch.steps``, ``repro.launch.dryrun``), float32 on the
CPU, on JAX-initialised weights carried across with ``from_jax``.

Mirrors ``tests/test_launch.py`` and ``tests/test_arch_smoke.py``: the
train step (a3po and loglinear, 1 and 4 microbatches) within rtol 2e-4 of
the reference's, the chunked prefill within 1e-5, the decode step, the
frontend stacks' train step with ``embeds`` for every assigned arch
``-reduced``, ``input_specs`` against the reference's ``ShapeDtypeStruct``s
for every arch and shape (all ``meta``), and the steps traced on a fake
2x4 mesh under the per-device census (in a subprocess: a process group is
global state). The launcher's ``--mesh prod`` runs its sharded dry-run.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import InputShape as JaxInputShape
from repro.configs.base import RLConfig as JaxRLConfig
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.training import optimizer as jopt
from repro_torch.configs.base import SHAPES, InputShape, RLConfig
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import steps
from repro_torch.launch import train as launcher
from repro_torch.models.params import from_jax, walk
from repro_torch.training.optimizer import adam_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=1e-6)
ASSIGNED = list_archs(assigned_only=True)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _jax_params(name, seed=0):
    cfg = _f32(jax_get_config(name))
    return cfg, jmodel.init_params(cfg, jax.random.PRNGKey(seed))


def _port(jparams, requires_grad=False):
    return from_jax(jax.device_get(jparams), device="cpu",
                    requires_grad=requires_grad)


def _leaves(tree):
    return {"/".join(p): np.asarray(v.detach().cpu() if hasattr(v, "detach")
                                    else v, np.float32)
            for p, v in walk(tree)}


def _jleaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v, np.float32) for path, v in flat}


def _train_batch(cfg, B, S, seed=1, embeds=False):
    r = np.random.default_rng(seed)
    F = cfg.frontend_tokens if cfg.frontend else 0
    T = S - F if embeds else S
    b = {"tokens": r.integers(4, cfg.vocab_size, (B, T)).astype(np.int32),
         "behav_logp": (-r.uniform(0.5, 3.0, (B, T - 1))).astype(np.float32),
         "advantages": r.standard_normal((B, T - 1)).astype(np.float32),
         "mask": (r.uniform(size=(B, T - 1)) > 0.2).astype(np.float32),
         "versions": r.integers(1, 4, (B,)).astype(np.int32)}
    if embeds and F:
        b["embeds"] = (r.standard_normal((B, F, cfg.d_model)) * 0.5
                       ).astype(np.float32)
    return b


def _run_train(name, algo, nm, B=8, S=12, embeds=False):
    """(jax out, port out) of one train step on the same weights/batch."""
    jcfg, jparams = _jax_params(name)
    cfg = _f32(get_config(name))
    rl_kw = dict(learning_rate=1e-3, adam_eps=1e-4)
    batch = _train_batch(cfg, B, S, embeds=embeds)
    jstep = jsteps.make_train_step(jcfg, JaxRLConfig(**rl_kw), algo,
                                   num_microbatches=nm)
    jp, _, jl, je, jg = jax.jit(jstep)(
        jparams, jopt.adam_init(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = _port(jparams, requires_grad=True)
    step = steps.make_train_step(cfg, RLConfig(**rl_kw), algo,
                                 num_microbatches=nm)
    tp, _, tl, te, tg = step(params, adam_init(params),
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    return (jp, float(jl), float(je), float(jg)), \
        (tp, float(tl), float(te), float(tg)), jparams


def _assert_train_close(j, t, jparams):
    jp, jl, je, jg = j
    tp, tl, te, tg = t
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(te, je, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    ja, ta = _jleaves(jp), _leaves(tp)
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], err_msg=k, **TOL)
    moved = sum(float(np.abs(ta[k] - v).sum())
                for k, v in _jleaves(jparams).items())
    assert moved > 0


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("algo", ["a3po", "loglinear"])
@pytest.mark.parametrize("nm", [1, 4])
def test_train_step_matches_jax(algo, nm):
    """make_train_step on toy-2m: loss, entropy, gradient norm and every
    parameter within rtol 2e-4 of the reference's."""
    j, t, jparams = _run_train("toy-2m", algo, nm)
    _assert_train_close(j, t, jparams)


def test_train_step_microbatch_equivalence():
    """Gradient accumulation (nm=4) == one batch (nm=1), as the reference's
    ``test_train_step_microbatch_equivalence`` bounds it."""
    cfg = _f32(get_config("toy-2m"))
    _, jparams = _jax_params("toy-2m")
    batch = {k: torch.from_numpy(v) for k, v in
             _train_batch(cfg, 8, 12).items()}
    batch["mask"] = torch.ones_like(batch["mask"])
    outs = {}
    for nm in (1, 4):
        params = _port(jparams, requires_grad=True)
        step = steps.make_train_step(cfg, RLConfig(learning_rate=1e-3),
                                     "loglinear", num_microbatches=nm)
        p2, _, loss, _, _ = step(params, adam_init(params), batch)
        outs[nm] = (_leaves(p2), float(loss))
    np.testing.assert_allclose(outs[1][1], outs[4][1], rtol=1e-5)
    for k, v in outs[1][0].items():
        np.testing.assert_allclose(outs[4][0][k], v, rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_reduced_train_step_with_embeds_matches_jax(arch):
    """One full RL step (fwd + bwd + Adam) on every assigned arch
    ``-reduced``, frontend stacks with their ``embeds`` (the reference's
    ``Trainer`` passes none): finite, entropy >= 0, parameters moved (the
    reference's ``test_train_step_runs``); for the stacks whose path the
    toy-2m parity above does not take (frontend, MoE, MLA, SSM, hybrid)
    also equal to the reference's step within rtol 2e-4."""
    cfg = get_config(arch + "-reduced")
    S = 16 + (cfg.frontend_tokens if cfg.frontend else 0)
    if cfg.arch_type == "dense":
        params = _port(_jax_params(arch + "-reduced")[1], requires_grad=True)
        before = _leaves(params)
        step = steps.make_train_step(_f32(cfg), RLConfig(learning_rate=1e-4),
                                     "loglinear", num_microbatches=1)
        p2, _, tl, te, tg = step(params, adam_init(params), {
            k: torch.from_numpy(v) for k, v in
            _train_batch(_f32(cfg), 2, S, embeds=True).items()})
        assert np.isfinite(float(tl)) and np.isfinite(float(tg))
        assert float(te) >= 0
        assert sum(float(np.abs(v - before[k]).sum())
                   for k, v in _leaves(p2).items()) > 0
        return
    j, t, jparams = _run_train(arch + "-reduced", "loglinear", 1, B=2, S=S,
                               embeds=True)
    _, tl, te, tg = t
    assert np.isfinite(tl) and np.isfinite(tg) and te >= 0
    _assert_train_close(j, t, jparams)


# ------------------------------------------------------- prefill and decode
@pytest.mark.parametrize("nm", [1, 4])
def test_prefill_step_matches_jax(nm):
    """make_prefill_step (1 and 4 microbatches, the cache un-chunked):
    last-token logits and every cache leaf within 1e-5 of the reference's
    unchunked prefill."""
    jcfg, jparams = _jax_params("toy-2m")
    cfg = _f32(get_config("toy-2m"))
    shape = InputShape("t", 16, 8, "prefill")
    toks = np.random.default_rng(2).integers(4, cfg.vocab_size, (8, 16))
    jl, jc = jsteps.make_prefill_step(
        jcfg, JaxInputShape("t", 16, 8, "prefill"), 1)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = steps.make_prefill_step(cfg, shape, nm)(
        _port(jparams), {"tokens": torch.from_numpy(toks).int()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    ja, ta = _jleaves(jc), _leaves(tc)
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_decode_step_matches_jax():
    """make_decode_step on a prefilled cache with room: logits and the
    updated cache within 2e-5 of the reference's."""
    jcfg, jparams = _jax_params("toy-2m")
    cfg = _f32(get_config("toy-2m"))
    r = np.random.default_rng(3)
    toks = r.integers(4, cfg.vocab_size, (4, 12)).astype(np.int32)
    nxt = r.integers(4, cfg.vocab_size, (4,)).astype(np.int32)
    _, jcache = jmodel.prefill(jparams, jcfg, jnp.asarray(toks),
                               max_len=16)
    tcache = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jcache)
    shape = InputShape("t", 16, 4, "decode")
    jl, jc2 = jsteps.make_decode_step(
        jcfg, JaxInputShape("t", 16, 4, "decode"))(
        jparams, {"cache": jcache, "tokens": jnp.asarray(nxt)})
    tl, tc2 = steps.make_decode_step(cfg, shape)(
        _port(jparams), {"cache": tcache, "tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    for k, v in _jleaves(jc2).items():
        np.testing.assert_allclose(_leaves(tc2)[k], v, rtol=2e-5, atol=2e-5,
                                   err_msg=k)


# -------------------------------------------------------------- input specs
_DT = {"int32": torch.int32, "float32": torch.float32,
       "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_jax(arch):
    """Shapes and dtypes of every input of every shape equal the
    reference's ``ShapeDtypeStruct``s; all ``meta``, nothing allocated."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        ref = jsteps.input_specs(jcfg, JAX_SHAPES[name])
        got = steps.input_specs(cfg, SHAPES[name])
        flat_ref = _jleaves(jax.tree.map(
            lambda s: np.zeros((0,), np.float32), ref))
        assert set(flat_ref) == {"/".join(p) for p, _ in walk(got)}, name
        rflat = jax.tree_util.tree_flatten_with_path(ref)[0]
        gflat = {"/".join(p): v for p, v in walk(got)}
        for path, s in rflat:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            t = gflat[key]
            assert t.is_meta and tuple(t.shape) == tuple(s.shape), key
            assert t.dtype == _DT[str(s.dtype)], (key, t.dtype, s.dtype)


def test_input_specs_allocate_nothing():
    """The command-r-plus decode_32k cache would be over 1 TiB if real."""
    specs = steps.input_specs(get_config("command-r-plus-104b"),
                              SHAPES["decode_32k"])
    leaves = [v for _, v in walk(specs)]
    assert all(v.is_meta for v in leaves)
    assert sum(v.numel() * v.element_size() for v in leaves) > 2 ** 40


# ------------------------------------------------------- traced on a mesh
_LOWER = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import dryrun_one
    from repro_torch.launch.mesh import init_fake_process_group
    from torch.distributed.device_mesh import init_device_mesh

    arch, kind = sys.argv[2], sys.argv[3]
    init_fake_process_group(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    shape = (InputShape("tiny_train", 32, 4, "train") if kind == "train"
             else InputShape("tiny_decode", 64, 4, "decode"))
    cfg = dataclasses.replace(get_config(arch + "-reduced"), dtype="float32")
    rec = dryrun_one(arch + "-reduced", shape, mesh=mesh, cfg=cfg,
                     algo="loglinear", num_microbatches=1, save=True,
                     results_dir=sys.argv[1], verbose=False)
    print("RECORD " + json.dumps(rec))
""")
TRACED = {"codeqwen1.5-7b": "train", "mamba2-370m": "train",
          "deepseek-v2-lite-16b": "train", "zamba2-1.2b": "decode",
          "musicgen-large": "decode"}

# the reference's record keys (src/repro/launch/dryrun.py)
RECORD_KEYS = {
    "arch", "shape", "mesh", "n_chips", "kind", "algo", "fsdp", "lower_s",
    "compile_s", "memory", "hlo_flops_per_device", "hlo_bytes_per_device",
    "collective_bytes_per_device", "collective_ops", "xla_cost_analysis_raw",
    "roofline", "n_params", "n_active_params", "model_flops_per_device",
    "useful_flops_ratio"}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The five traces, each in its own process (run side by side)."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {a: subprocess.Popen(
        [sys.executable, "-c", _LOWER, str(d), a, k], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for a, k in TRACED.items()}
    # the launcher's sharded dry-run, beside them
    procs["--mesh prod"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--mesh", "prod",
         "--arch", "toy-2m", "--device", "cpu"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    recs = {}
    for arch, p in procs.items():
        out, err = p.communicate(timeout=300)
        if arch == "--mesh prod":
            recs[arch] = (p.returncode, out, err)
            continue
        line = [ln for ln in out.splitlines() if ln.startswith("RECORD ")]
        assert line, out[-2000:] + err[-3000:]
        recs[arch] = json.loads(line[0][len("RECORD "):])
    return recs, d


@pytest.mark.parametrize("arch", list(TRACED))
def test_reduced_steps_trace_on_fake_mesh(traced, arch):
    """The train step (codeqwen, mamba2, deepseek-v2-lite) and the decode
    step (zamba2, musicgen) of the ``-reduced`` configs run on a fake 2x4
    mesh under the census: per-device flops above zero and below the
    whole step's, collectives counted, a record with the reference's
    keys written."""
    recs, d = traced
    rec = recs[arch]
    assert RECORD_KEYS <= set(rec)
    assert rec["n_chips"] == 8 and rec["mesh"] == "2x4"
    assert rec["hlo_flops_per_device"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert sum(v["count"] for v in rec["collective_ops"].values()) > 0
    shape = "tiny_train" if rec["kind"] == "train" else "tiny_decode"
    with open(os.path.join(d, f"{arch}-reduced_{shape}_2x4.json")) as f:
        assert RECORD_KEYS <= set(json.load(f))


# ----------------------------------------------------------------- launcher
def test_launcher_mesh_prod_runs_the_sharded_dryrun(traced):
    """`--mesh prod --arch toy-2m --device cpu` exits 0 on the fake
    256-rank mesh and prints the placement summary."""
    rc, out, err = traced[0]["--mesh prod"]
    assert rc == 0, out[-2000:] + err[-3000:]
    assert "0 replicated weight matrices" in out
    assert "output params stay sharded" in out
    assert "(256 ranks" in out


def test_launcher_mesh_local_is_unchanged(tmp_path):
    """`--mesh local` trains on the one device with the numbers of a run
    without the flag, and its meta event says one device."""
    runs = []
    for extra in ([], ["--mesh", "local"]):
        path = tmp_path / f"run{len(runs)}.jsonl"
        launcher.main(["--device", "cpu", "--arch", "toy-2m", "--steps",
                       "2", "--log-jsonl", str(path), "--quiet", *extra])
        runs.append([json.loads(ln) for ln in path.read_text().splitlines()])
    assert runs[0][0]["kind"] == "meta" and runs[1][0]["n_devices"] == 1
    keys = ("loss", "reward", "entropy", "iw_max", "iw_min",
            "staleness_mean", "clipped_tokens")
    steps_ = [[r for r in run if r["kind"] == "step"] for run in runs]
    for a, b in zip(*steps_):
        for k in keys:
            assert a[k] == b[k], k


# -------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_launch.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_step_programs_match_cpu(cuda_device):
    """The train, prefill and decode steps on the card (float32: the
    kernels' first designs) against the CPU's plain versions."""
    _, jparams = _jax_params("toy-2m")
    cfg = _f32(get_config("toy-2m"))
    batch = _train_batch(cfg, 8, 12)
    outs = {}
    for dev in ("cpu", cuda_device):
        params = from_jax(jax.device_get(jparams), device=dev,
                          requires_grad=True)
        step = steps.make_train_step(cfg, RLConfig(learning_rate=1e-3),
                                     "a3po", num_microbatches=2)
        p, _, loss, ent, gn = step(params, adam_init(params),
                                   {k: torch.from_numpy(v).to(dev)
                                    for k, v in batch.items()})
        toks = torch.from_numpy(batch["tokens"]).to(dev)
        with torch.no_grad():
            logits, cache = steps.make_prefill_step(
                cfg, InputShape("t", 12, 8, "prefill"), 2)(
                params, {"tokens": toks})
        outs[str(dev)] = (_leaves(p), float(loss), float(gn),
                          logits.cpu().numpy())
    (pc, lc, gc, xc), (pg, lg, gg, xg) = outs.values()
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    np.testing.assert_allclose(gg, gc, rtol=1e-4)
    np.testing.assert_allclose(xg, xc, rtol=1e-3, atol=1e-3)
    for k, v in pc.items():
        np.testing.assert_allclose(pg[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)
