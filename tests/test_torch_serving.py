"""Paged continuous-batching engine of the PyTorch port against the JAX
engine, float32 on the CPU.

Both engines serve the same numpy-made prompts greedily on the same
weights (the toy-2m checkpoint; JAX-initialised qwen2.5-1.5b-reduced):
generated ids must be identical, behaviour logps within 1e-4, and the
pool drained identically. Sampling is held to seeded determinism within
the port (JAX's threefry draws are not reproduced).
"""
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.data.tasks import ArithmeticTask
from repro.models import model as jmodel
from repro.rollout import paged_cache as jpc
from repro.rollout.continuous import ContinuousBatchingEngine as JaxEngine
from repro.training.checkpoints import load_checkpoint
from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.obs.tracing import SpanTracer, install_tracer
from repro_torch.models.params import from_jax
from repro_torch.rollout import paged_cache as tpc
from repro_torch.rollout.continuous import ContinuousBatchingEngine
from repro_torch.rollout.sampler import fused_sample_step, sample_token

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "experiments" / "ckpt" / "toy-2m_loglinear"

# 6 requests through 3 slots (slot reuse); bs=4 so every sequence crosses
# pages; prompts of 11/17/22 tokens exceed the 8-token prefill chunk; the
# 22-token prompt + 10 new tokens fills its slot to exactly mb*bs = 32.
ENGINE_KW = dict(max_seqs=3, block_size=4, n_blocks=64, max_blocks_per_seq=8,
                 prefill_chunk=8)
PROMPT_LENS = (5, 11, 22, 3, 17, 9)
MAX_NEW = (6, 9, 10, 12, 8, 7)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def toy_ckpt():
    tree, _ = load_checkpoint(str(CKPT))
    with np.load(str(CKPT) + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    return (_f32(jax_get_config("toy-2m")),
            jax.tree.map(jnp.asarray, tree["params"]),
            _f32(get_config("toy-2m")), from_jax(flat, device="cpu"))


def _scaled_blocks(params, factor=8.0):
    """JAX-initialised params with the layer weights (not the norms) scaled
    up: at the reference's init stds the tied embedding dominates and a
    random model only repeats its last token; scaled, the layer stack
    decides the tokens, so parity exercises attention and the FFN."""
    blocks = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "ln" in jax.tree_util.keystr(path)
        else a * factor, params["blocks"])
    return dict(params, blocks=blocks)


@pytest.fixture(scope="module")
def qwen_reduced():
    jcfg = _f32(jax_get_config("qwen2.5-1.5b-reduced"))
    jparams = _scaled_blocks(jmodel.init_params(jcfg, jax.random.PRNGKey(3)))
    return (jcfg, jparams, _f32(get_config("qwen2.5-1.5b-reduced")),
            from_jax(jax.device_get(jparams), device="cpu"))


def _prompts(vocab, seed=0):
    """Prompts of PROMPT_LENS tokens. For the toy vocabulary: the tails of
    a stream of arithmetic problems, each ending at an '=' so the trained
    checkpoint answers (digits, then EOS); otherwise random ids."""
    if vocab > 64:
        rng = np.random.default_rng(seed)
        return [rng.integers(4, vocab, size=n).astype(np.int32)
                for n in PROMPT_LENS]
    batch = ArithmeticTask(max_operand=99, n_terms=2, prompt_len=12,
                           seed=seed).sample(len(PROMPT_LENS) + 8)
    out = []
    for i, n in enumerate(PROMPT_LENS):
        stream = np.concatenate([batch.prompts[j, :batch.prompt_lengths[j]]
                                 for j in range(i, i + 8)])
        out.append(stream[-n:].astype(np.int32))
    return out


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("which", ["toy_ckpt", "qwen_reduced"])
def test_engine_greedy_matches_jax(which, horizon, request):
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(which)
    prompts = _prompts(tcfg.vocab_size)
    kw = dict(ENGINE_KW, greedy=True, decode_horizon=horizon)
    je = JaxEngine(jcfg, **kw)
    te = ContinuousBatchingEngine(tcfg, device="cpu", **kw)
    for p, n in zip(prompts, MAX_NEW):
        je.submit(p, max_new=n)
        te.submit(p, max_new=n)
    jdone = {r.rid: r for r in je.run(jparams, jax.random.PRNGKey(1))}
    tdone = {r.rid: r for r in te.run(tparams)}
    assert sorted(jdone) == sorted(tdone) == list(range(1, 7))
    for rid, a in jdone.items():
        b = tdone[rid]
        assert b.generated == [int(t) for t in a.generated], rid
        np.testing.assert_allclose(b.gen_logp, a.gen_logp, rtol=0,
                                   atol=1e-4)
        assert b.token_versions == a.token_versions
    assert te.allocator.n_free == je.allocator.n_free == 64 - 1
    assert (te.host_syncs, te.decode_launches, te.prefill_launches,
            te.tokens_emitted) == (je.host_syncs, je.decode_launches,
                                   je.prefill_launches, je.tokens_emitted)
    # the slot filled to mb*bs generated its whole budget
    assert len(tdone[3].generated) == 10 or tdone[3].generated[-1] == 2


def test_horizon_matches_per_token_sampled(toy_ckpt):
    """Seeded sampling: one fused horizon == H single steps drawing from
    the same generator, bit-exact in tokens, logps and version stamps."""
    _, _, cfg, params = toy_ckpt
    prompts = _prompts(cfg.vocab_size, seed=4)[:3]
    out = []
    for H in (1, 4):
        eng = ContinuousBatchingEngine(
            cfg, device="cpu", rl=RLConfig(temperature=0.8, top_p=0.9),
            decode_horizon=H, **ENGINE_KW)
        for p in prompts:
            eng.submit(p, max_new=8)
        reqs = list(eng._pending)
        eng._admit(params)
        g = torch.Generator().manual_seed(11)
        if H == 1:
            for _ in range(4):
                eng.step(params, g, version=1)
        else:
            eng.step_horizon(params, g, version=1)
        out.append([(r.generated, r.gen_logp, r.token_versions, r.done)
                    for r in reqs])
    assert out[0] == out[1]


def test_sampled_run_is_seeded(toy_ckpt):
    """The same seed reproduces a whole sampled run; another seed differs."""
    _, _, cfg, params = toy_ckpt
    prompts = _prompts(cfg.vocab_size, seed=5)

    def run(seed):
        eng = ContinuousBatchingEngine(cfg, device="cpu", decode_horizon=4,
                                       **ENGINE_KW)
        for p, n in zip(prompts, MAX_NEW):
            eng.submit(p, max_new=n)
        done = eng.run(params, torch.Generator().manual_seed(seed))
        assert eng.allocator.n_free == 64 - 1
        return {r.rid: (r.generated, r.gen_logp) for r in done}

    a = run(7)
    assert a == run(7)
    assert a != run(8)
    eng = ContinuousBatchingEngine(cfg, device="cpu", **ENGINE_KW)
    eng.submit(prompts[0], max_new=2)
    with pytest.raises(ValueError, match="Generator"):
        eng.run(params)


def test_sample_token_logp_is_tempered_log_softmax():
    """logp == log_softmax(logits / T)[token], and top-p keeps tokens in
    the nucleus."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((64, 50)).astype(
        np.float32) * 3)
    T, top_p = 0.7, 0.8
    tok, logp = sample_token(logits, torch.Generator().manual_seed(0),
                             temperature=T, top_p=top_p)
    full = torch.log_softmax(logits / T, dim=-1)
    torch.testing.assert_close(logp, full.gather(-1, tok[:, None])[:, 0],
                               rtol=0, atol=1e-6)
    probs = torch.softmax(logits / T, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True)
    cum = torch.cumsum(srt.values, dim=-1)
    n_keep = (cum < top_p).sum(dim=-1) + 1
    rank = (srt.indices == tok[:, None]).float().argmax(dim=-1)
    assert bool((rank < n_keep).all())
    # finished rows: PAD, zero logp, zero mask; EOS folds into done
    done = torch.zeros(64, dtype=torch.bool)
    done[:3] = True
    t2, lp2, m2, d2 = fused_sample_step(logits, None, done, greedy=True)
    assert t2[:3].eq(0).all() and lp2[:3].eq(0).all() and m2[:3].eq(0).all()
    assert bool((d2 == (done | (t2 == 2))).all())


def test_paged_cache_ops_match_jax():
    """map / prefixed map / capacity growth / CoW fork / release leave the
    same tables, lengths, pool contents and allocator state as JAX's."""
    jcfg = _f32(jax_get_config("toy-2m"))
    tcfg = _f32(get_config("toy-2m"))
    kw = dict(n_blocks=12, block_size=4, max_seqs=3, max_blocks_per_seq=4)
    js = jpc.init_paged_cache(jcfg, dtype=jnp.float32, **kw)
    ts = tpc.init_paged_cache(tcfg, dtype=torch.float32, device="cpu", **kw)
    pool = np.random.default_rng(0).standard_normal(
        tuple(ts.pool_k.shape)).astype(np.float32)
    js.pool_k, js.pool_v = jnp.asarray(pool), jnp.asarray(-pool)
    ts.pool_k.copy_(torch.from_numpy(pool))
    ts.pool_v.copy_(torch.from_numpy(-pool))
    ja, ta = jpc.BlockAllocator(12), tpc.BlockAllocator(12)

    def same():
        np.testing.assert_array_equal(ts.block_tables.numpy(),
                                      np.asarray(js.block_tables))
        np.testing.assert_array_equal(ts.seq_lens.numpy(),
                                      np.asarray(js.seq_lens))
        np.testing.assert_array_equal(ts.pool_k.numpy(),
                                      np.asarray(js.pool_k))
        np.testing.assert_array_equal(ts.pool_v.numpy(),
                                      np.asarray(js.pool_v))
        assert (ta.free, ta.refcount, ta.forks) == (ja.free, ja.refcount,
                                                    ja.forks)

    js = jpc.map_sequence(js, ja, 0, 6)
    ts = tpc.map_sequence(ts, ta, 0, 6)
    same()
    shared = [int(b) for b in np.asarray(js.block_tables[0, :1])]
    for a in (ja, ta):
        a.incref(shared[0])
    js = jpc.map_sequence_prefixed(js, ja, 1, shared, 3, 9)
    ts = tpc.map_sequence_prefixed(ts, ta, 1, shared, 3, 9)
    same()
    js = jpc.ensure_writable(js, ja, 1)     # shared block -> CoW fork
    ts = tpc.ensure_writable(ts, ta, 1)
    same()
    js = dataclasses.replace(js, seq_lens=js.seq_lens.at[0].set(8))
    ts.seq_lens[0] = 8
    js = jpc.ensure_capacity(js, ja, 0)     # grows slot 0 by one block
    ts = tpc.ensure_capacity(ts, ta, 0)
    same()
    for slot in (0, 1):
        js = jpc.release_sequence(js, ja, slot)
        ts = tpc.release_sequence(ts, ta, slot)
        same()
    assert ta.n_free == 12
    with pytest.raises(RuntimeError):
        tpc.map_sequence(ts, ta, 2, 4 * 5)  # more than max_blocks_per_seq
    assert tpc.write_range(7, 6, 4, 4) == jpc.write_range(7, 6, 4, 4)


def test_engine_emits_spans(toy_ckpt):
    _, _, cfg, params = toy_ckpt
    tracer = install_tracer(SpanTracer("test"))
    try:
        for H in (1, 4):
            eng = ContinuousBatchingEngine(cfg, device="cpu", greedy=True,
                                           decode_horizon=H, **ENGINE_KW)
            for p in _prompts(cfg.vocab_size)[:4]:
                eng.submit(p, max_new=5)
            eng.run(params)
    finally:
        install_tracer(None)
    names = {e["name"] for e in tracer.events() if e.get("ph") == "X"}
    assert {"prefill_chunk", "decode_step", "decode_horizon"} <= names


def test_engine_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(_f32(get_config("toy-2m")), **ENGINE_KW)


def test_port_imports_no_jax_and_no_reference_package():
    """Importing every module of the port (and chip_smoke) in a fresh
    interpreter loads neither jax nor any module of ``repro``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for path in list((ROOT / "src" / "repro_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, line)


# --------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_serving.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [1, 4])
def test_engine_on_card_matches_cpu(cuda_device, toy_ckpt, horizon):
    """The engine on the card (CUDA kernels) gives the CPU engine's (plain
    versions) greedy tokens, logps within 1e-4, and the same drain."""
    _, _, cfg, params = toy_ckpt
    out = []
    for dev in ("cpu", "cuda"):
        eng = ContinuousBatchingEngine(cfg, device=dev, greedy=True,
                                       decode_horizon=horizon, **ENGINE_KW)
        for p, n in zip(_prompts(cfg.vocab_size), MAX_NEW):
            eng.submit(p, max_new=n)
        done = eng.run(copy.deepcopy(params).to(dev))
        assert eng.allocator.n_free == 64 - 1
        out.append({r.rid: r for r in done})
    for rid, a in out[0].items():
        assert out[1][rid].generated == a.generated
        np.testing.assert_allclose(out[1][rid].gen_logp, a.gen_logp,
                                   rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_decode_horizon_has_no_host_sync(cuda_device, toy_ckpt):
    """Inside a fused horizon nothing waits for the device: CUDA's sync
    debug mode turns any synchronising call into an error."""
    from repro_torch.rollout import continuous as C
    _, _, cfg, params = toy_ckpt
    params = copy.deepcopy(params).to(cuda_device)
    eng = ContinuousBatchingEngine(cfg, device=cuda_device,
                                   rl=RLConfig(temperature=0.8, top_p=0.9),
                                   decode_horizon=4, **ENGINE_KW)
    for p in _prompts(cfg.vocab_size)[:3]:
        eng.submit(p, max_new=8)
    eng._admit(params)
    budget = np.zeros((3,), np.int32)
    budget[eng.decode_ready_slots()] = 4
    eng._prepare_decode({s: 4 for s in eng.decode_ready_slots()})
    budget_d = torch.from_numpy(budget).to(cuda_device)
    layers = C._layers(params, cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed, _, _ = C._paged_decode_horizon(
            params, layers, cfg, eng.state, eng._next_logits, budget_d, gen,
            trash_block=eng.trash_block, horizon=4, temperature=0.8,
            top_p=0.9, greedy=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert packed.shape == (3, 4, 3)
