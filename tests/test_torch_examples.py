"""The port's examples (``examples/torch_*.py``) and the two helpers they
import (``repro_torch.training.warmup``), on the CPU at toy-2m in float32.

* ``sft_warmup`` against the reference's (``benchmarks/bench_training.py``)
  over 3 steps from the same initial parameters, JAX's init carried over
  with ``from_jax``: loss within rtol 1e-5 and parameters within rtol 2e-4
  / atol 1e-6, the tolerances of ``test_sft_update_matches_jax``.
* ``eval_reward`` equal to the reference's, exactly, on the same
  parameters (greedy tokens are exact in both engines).
* Each example's ``main`` with ``--device cpu`` and its smallest flags
  ends normally and prints the reference example's summary keys;
  ``torch_loadgen_trace`` prints the reference's trace line letter for
  letter; no run touches the reference checkpoint
  ``experiments/ckpt/toy-2m_loglinear.*``.
"""
import hashlib
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.data.tasks import ArithmeticTask as JaxTask
from repro_torch.configs.registry import get_config
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.models.params import from_jax, walk
from repro_torch.training import warmup
from repro_torch.training.optimizer import adam_init
from repro_torch.training.trainer import Trainer, TrainState

ROOT = Path(__file__).resolve().parents[1]
REF_CKPT = ROOT / "experiments" / "ckpt" / "toy-2m_loglinear"
LOSS_RTOL = 1e-5                           # test_sft_update_matches_jax
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)     # test_torch_training.PARAM_TOL


def _f32(cfg):
    import dataclasses
    return dataclasses.replace(cfg, dtype="float32")


def _reference_bench(monkeypatch):
    """``benchmarks.bench_training`` of the reference (it imports
    ``benchmarks.common``, so the repo root goes on the path)."""
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.bench_training as jbench
    return jbench


def _example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(paths):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in paths}


@pytest.fixture(scope="module")
def reference_files_untouched():
    """The reference checkpoint's files, byte for byte, before and after
    every example run of this module."""
    files = sorted(REF_CKPT.parent.glob(REF_CKPT.name + ".*"))
    assert files, REF_CKPT
    before = _digest(files)
    yield
    assert _digest(files) == before


@pytest.fixture
def in_tmp(monkeypatch, tmp_path, reference_files_untouched):
    monkeypatch.chdir(tmp_path)
    return tmp_path


# ------------------------------------------------------------------ helpers
def test_sft_warmup_matches_the_reference(monkeypatch):
    """Three SFT steps from JAX's own initial parameters (captured from
    the reference's ``Trainer.init_state`` and handed to the port's
    through ``from_jax``) on the same seeded task batches. As in
    ``test_sft_update_matches_jax``, both start from an Adam state some
    steps in (second moments 1e-4, t 5): a fresh state's first update is
    lr * g / (|g| + eps), which moves an element whose gradient lies within
    the two frameworks' float32 rounding of 0 by an arbitrary fraction of
    lr in each."""
    jbench = _reference_bench(monkeypatch)
    jcfg = _f32(jax_get_config("toy-2m"))
    tcfg = _f32(get_config("toy-2m"))
    init = {}
    jinit = jbench.Trainer.init_state

    def capture(self, *a, **kw):
        st = jinit(self, *a, **kw)
        opt = dict(st.opt, t=jax.numpy.asarray(5, jax.numpy.int32),
                   v=jax.tree.map(lambda x: jax.numpy.full_like(x, 1e-4),
                                  st.opt["v"]))
        init["state"] = st._replace(opt=opt)
        return init["state"]

    def carried(self, generator=None, dtype=None, device="cuda"):
        params = from_jax(jax.device_get(init["state"].params),
                          device=device, requires_grad=True)
        opt = adam_init(params)
        for _, v in walk(opt["v"]):
            v.fill_(1e-4)
        opt["t"].fill_(5)
        return TrainState(params, opt, torch.zeros((), dtype=torch.int32))

    monkeypatch.setattr(jbench.Trainer, "init_state", capture)
    monkeypatch.setattr(Trainer, "init_state", carried)
    jp, jl = jbench.sft_warmup(jcfg, JaxTask(max_operand=9, n_terms=2,
                                             prompt_len=8, seed=0), steps=3)
    tp, tl = warmup.sft_warmup(tcfg, ArithmeticTask(
        max_operand=9, n_terms=2, prompt_len=8, seed=0), steps=3,
        device="cpu")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)

    def flat(tree):
        return {"/".join(str(getattr(p, "key", p)) for p in path):
                np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}

    jflat, j0 = flat(jp), flat(jax.device_get(init["state"].params))
    moved = 0
    for path, v in walk(tp):
        key = "/".join(path)
        np.testing.assert_allclose(v.detach().numpy(), jflat[key],
                                   **PARAM_TOL, err_msg=key)
        moved += int((jflat[key] != j0[key]).sum())
    assert moved > 0


@pytest.mark.parametrize("which", ["checkpoint", "sft"])
def test_eval_reward_equals_the_reference(monkeypatch, which):
    """Greedy held-out eval of the same parameters: the reference
    checkpoint's (which scores 0.3125 at n 64), and a 20-step SFT base of
    the reference's (its init folds ``hash()`` into its keys, so its score
    varies between processes); the port's reward equals JAX's exactly."""
    jbench = _reference_bench(monkeypatch)
    jcfg = _f32(jax_get_config("toy-2m"))
    tcfg = _f32(get_config("toy-2m"))
    task_kw = dict(max_operand=9, n_terms=2, prompt_len=8, seed=0)
    if which == "checkpoint":
        from repro.training.checkpoints import load_checkpoint
        tree, _ = load_checkpoint(str(REF_CKPT))
        jp = tree["params"]
    else:
        jp, _ = jbench.sft_warmup(jcfg, JaxTask(**task_kw), steps=20)
    jp = jax.device_get(jp)
    for n in (64, 32):
        want = jbench.eval_reward(jcfg, jax.tree.map(jax.numpy.asarray, jp),
                                  JaxTask(**task_kw), n=n)
        got = warmup.eval_reward(tcfg, from_jax(jp, device="cpu"),
                                 ArithmeticTask(**task_kw), n=n,
                                 device="cpu")
        assert got == want, (n, got, want)
        if which == "checkpoint":  # scores some prompts, not all
            assert 0 < got < 1, (n, got)


# ----------------------------------------------------------------- examples
def test_quickstart_example(in_tmp, capsys):
    _example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "staleness d: [3, 2, 1, 0]" in out
    assert "prox sandwiched between behav/target: True" in out
    for key in ("registered algorithms:", "A-3PO loss:", "iw in [",
                "clipped:", "kl:", "ASymPO loss (behavior-free):"):
        assert key in out, key


@pytest.mark.parametrize("threaded", [False, True])
def test_train_async_rl_example(in_tmp, capsys, threaded):
    argv = ["--device", "cpu", "--steps", "2", "--sft-steps", "5"]
    _example("torch_train_async_rl").main(
        argv + (["--threaded"] if threaded else []))
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-1]
    summary = json.loads(last)
    assert set(summary) == {"algo", "base_eval", "final_eval",
                            "mean_prox_ms"}
    assert summary["algo"] == "a3po"
    assert np.isfinite(summary["mean_prox_ms"])
    for key in ("== SFT warmup (5 steps", "base eval reward:",
                "== async RL: algo=a3po staleness=2 ==", "step   0 reward",
                "final eval reward:",
                "checkpoint: experiments/torch/ckpt/toy-2m_a3po.npz"):
        assert key in out, key
    assert (in_tmp / "experiments" / "torch" / "ckpt"
            / "toy-2m_a3po.npz").is_file()
    assert not (in_tmp / "experiments" / "ckpt").exists()


def test_train_async_rl_refuses_a_full_scale_arch_on_the_cpu(in_tmp):
    with pytest.raises(SystemExit, match="full-scale"):
        _example("torch_train_async_rl").main(
            ["--device", "cpu", "--model", "qwen2.5-1.5b"])


def test_ablate_alpha_example(in_tmp, capsys):
    _example("torch_ablate_alpha").main(["--device", "cpu", "--steps", "1"])
    out = capsys.readouterr().out
    assert "base eval reward" in out
    assert "saved experiments/torch/alpha_ablation.json" in out
    doc = json.loads((in_tmp / "experiments" / "torch"
                      / "alpha_ablation.json").read_text())
    assert set(doc) == {"base_eval", "staleness", "results"}
    assert set(doc["results"]) == {"inverse", "exp", "clipped", "const"}
    for r in doc["results"].values():
        assert set(r) == {"final_eval", "iw_max", "clipped_tokens_mean"}


def test_serve_batch_example(in_tmp, capsys):
    _example("torch_serve_batch").main(["--device", "cpu", "--waves", "2",
                                        "--batch", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "serving toy-2m:" in out and "wave 1: 2 reqs," in out
    assert "   req0: " in out
    assert out.strip().splitlines()[-1].startswith("TOTAL: 16 tokens,")
    with pytest.raises(SystemExit, match="-reduced"):
        _example("torch_serve_batch").main(["--device", "cpu", "--arch",
                                            "qwen2.5-1.5b"])


def test_serve_paged_example(in_tmp, capsys):
    _example("torch_serve_paged").main(["--device", "cpu", "--requests",
                                        "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests through 4 slots (horizon 8): 12 tokens in" in out
    assert "host syncs)" in out and "  req1: " in out
    assert out.strip().splitlines()[-1] == "free pages after drain: 127"


def test_serve_control_plane_example(in_tmp, capsys):
    _example("torch_serve_control_plane").main(
        ["--device", "cpu", "--group", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.startswith("served 5 requests in ")
    assert "weight publishes absorbed mid-flight" in out
    assert "prefix_hit=" in out and "stamps=[" in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("metrics: ")
    metrics = eval(last[len("metrics: "):], {})
    assert set(metrics) == {
        "prefix_hit_rate", "prefill_tokens_computed", "decode_tokens",
        "interrupts", "resumed_sequences", "staleness_mean",
        "staleness_max", "page_util_mean", "completed"}
    assert metrics["completed"] == 5 and metrics["prefix_hit_rate"] > 0


def test_loadgen_trace_example(in_tmp, capsys):
    """The trace line is the reference's, letter for letter (the trace is
    numpy-seeded): the reference's own ``synthesize`` with the example's
    defaults gives the line it prints."""
    from repro.loadgen.traces import SLOClass as JaxClass
    from repro.loadgen.traces import TraceConfig as JaxTraceConfig
    from repro.loadgen.traces import synthesize as jax_synthesize
    classes = (JaxClass("chat", 0, ttft_slo_s=0.5, e2e_slo_s=4.0,
                        share=0.35, max_new=8),
               JaxClass("batch", 2, ttft_slo_s=6.0, e2e_slo_s=30.0,
                        share=0.65, max_new=16))
    jt = jax_synthesize(JaxTraceConfig(seed=0, duration_s=2.5,
                                       rate_rps=14.0, burstiness=0.5,
                                       publish_every_s=1.0), classes)
    want = (f"trace: {len(jt.requests)} requests / "
            f"{jt.duration_s:.1f}s, {len(jt.publishes)} publishes")
    _example("torch_loadgen_trace").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == want == \
        "trace: 26 requests / 2.5s, 2 publishes"
    for policy in ("fifo", "slo"):
        assert f"load harness — policy {policy}: 26 requests" in out
    assert out.strip().splitlines()[-1] == \
        "same trace, same engine — only the admission policy changed."


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_paged"])
def test_examples_refuse_a_missing_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main([])


def test_every_reference_example_has_a_counterpart():
    """Each ``examples/<name>.py`` of the reference has its
    ``examples/torch_<name>.py`` (the fresh-interpreter import check is in
    ``test_torch_serving.py``)."""
    ref = sorted(p.name for p in (ROOT / "examples").glob("*.py")
                 if not p.name.startswith("torch_"))
    assert len(ref) == 7
    for name in ref:
        assert (ROOT / "examples" / f"torch_{name}").is_file(), name
