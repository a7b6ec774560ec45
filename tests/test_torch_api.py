"""Public functions of ported modules held against the JAX package's, on
the CPU in float32: ``obs.trace_span``, ``models.params.count_params``,
``rollout.paged_cache.write_token`` / ``gather_kv`` / ``bump_lens``,
``models.attention.decode_attention`` and ``models.ssm.ssd_chunked``.

Each mirrors a reference test (``tests/test_obs.py:198``,
``tests/test_arch_smoke.py:138``, ``tests/test_paged_serving.py:83-86``,
``tests/test_multiarch_serving.py:241``) and runs the same numpy-made
inputs through both packages. Tolerance: 2e-5 (``TOL``) where values are
computed; the cache ops and counts are exact. ``cuda``-marked tests hold
the card's dispatch against the CPU and skip here.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro.obs import tracing as jtracing
from repro.rollout import paged_cache as jpc
from repro_torch import obs as tobs
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.obs import tracing as ttracing
from repro_torch.rollout import paged_cache as tpc

TOL = dict(rtol=2e-5, atol=2e-5)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


# ------------------------------------------------------------ trace_span
def test_trace_span_decorator_matches_the_reference():
    """``tests/test_obs.py:198``: the decorated function runs unchanged and
    leaves one complete span, named as given or by its qualified name, as
    the reference's; with no tracer it is a plain call."""
    assert tobs.trace_span is ttracing.trace_span

    def spans(mod, tracer_cls):
        @mod.trace_span("decorated", kind="x")
        def f(x):
            return x + 1

        @mod.trace_span()
        def g(x):
            return 2 * x
        assert (f(1), g(3)) == (2, 6)     # no tracer installed: a call
        tracer = mod.install_tracer(tracer_cls("t"))
        try:
            assert (f(1), g(3)) == (2, 6)
        finally:
            mod.install_tracer(None)
        return sorted((e["name"], e.get("args", {}).get("kind"))
                      for e in tracer.events() if e["ph"] == "X")

    got = spans(ttracing, ttracing.SpanTracer)
    want = spans(jtracing, jtracing.SpanTracer)
    assert got == want
    assert ("decorated", "x") in got
    assert any(n.endswith(".g") for n, _ in got)


# ---------------------------------------------------------- count_params
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_count_params_matches_the_reference(arch):
    """``tests/test_arch_smoke.py:138``: the spec tree's count equals the
    config's analytic count and the reference's count of its own spec."""
    cfg = get_config(arch)
    got = tparams.count_params(tmodel.model_spec(cfg))
    assert got == cfg.num_params()
    assert got == jparams.count_params(
        jmodel.model_spec(jax_get_config(arch)))


# -------------------------------------------------- paged cache device ops
def _caches(**kw):
    jcfg = _f32(jax_get_config("toy-2m"))
    tcfg = _f32(get_config("toy-2m"))
    js = jpc.init_paged_cache(jcfg, dtype=jnp.float32, **kw)
    ts = tpc.init_paged_cache(tcfg, dtype=torch.float32, device="cpu", **kw)
    return tcfg, js, ts


def _same_state(ts, js):
    for a in ("pool_k", "pool_v", "block_tables", "seq_lens"):
        np.testing.assert_array_equal(getattr(ts, a).numpy(),
                                      np.asarray(getattr(js, a)), err_msg=a)


def test_paged_write_gather_roundtrip_matches_the_reference():
    """``tests/test_paged_serving.py:83-86``: six tokens written with
    ``write_token`` and ``bump_lens`` come back through ``gather_kv``; the
    pools, lengths, views and validity equal JAX's after every step."""
    cfg, js, ts = _caches(n_blocks=8, block_size=4, max_seqs=2,
                          max_blocks_per_seq=4)
    ja, ta = jpc.BlockAllocator(8), tpc.BlockAllocator(8)
    js = jpc.map_sequence(js, ja, slot=0, n_tokens=6)
    ts = tpc.map_sequence(ts, ta, slot=0, n_tokens=6)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(0)
    writes = []
    for t in range(6):
        k = np.full((1, kv, hd), float(t + 1), np.float32)
        v = rng.standard_normal((1, kv, hd)).astype(np.float32)
        for layer in (0, 1):
            js = jpc.write_token(js, layer, jnp.asarray(k), jnp.asarray(v),
                                 jnp.array([0]))
            ts = tpc.write_token(ts, layer, torch.from_numpy(k),
                                 torch.from_numpy(v), torch.tensor([0]))
        js = jpc.bump_lens(js, jnp.array([0]))
        ts = tpc.bump_lens(ts, torch.tensor([0]))
        _same_state(ts, js)
        writes.append(float(t + 1))
    for layer in (0, 1):
        got = tpc.gather_kv(ts, layer, torch.tensor([0, 1]))
        want = jpc.gather_kv(js, layer, jnp.array([0, 1]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kk, vv, valid = tpc.gather_kv(ts, 0, torch.tensor([0]))
    assert int(valid[0].sum()) == 6
    np.testing.assert_allclose(kk[0, :6, 0, 0].numpy(), writes)


def test_write_token_routes_unmapped_to_scratch_as_the_reference():
    """``tests/test_multiarch_serving.py:241``: a write against an
    unmapped (-1) block-table entry lands in the scratch block (the last
    pool block), never in live block 0; pools equal JAX's."""
    cfg, js, ts = _caches(n_blocks=4, block_size=2, max_seqs=2,
                          max_blocks_per_seq=2)
    tables = np.array([[0, -1], [-1, -1]], np.int32)
    lens = np.array([0, 1], np.int32)
    js = dataclasses.replace(js, block_tables=jnp.asarray(tables),
                             seq_lens=jnp.asarray(lens))
    ts.block_tables.copy_(torch.from_numpy(tables))
    ts.seq_lens.copy_(torch.from_numpy(lens))
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = np.ones((2, kv, hd), np.float32)
    js = jpc.write_token(js, 0, jnp.asarray(k), jnp.asarray(2 * k),
                         jnp.asarray([0, 1]))
    ts = tpc.write_token(ts, 0, torch.from_numpy(k),
                         torch.from_numpy(2 * k), torch.tensor([0, 1]))
    _same_state(ts, js)
    pool_k = ts.pool_k.numpy()
    assert pool_k[0, 0, 0].any()          # slot 0's legit write
    assert pool_k[0, 3, 0].any()          # unmapped write -> scratch
    assert not pool_k[0, 0, 1].any()      # block 0 slot-1 offset untouched
    assert not pool_k[0, 1].any() and not pool_k[0, 2].any()


# ------------------------------------------------------- decode_attention
def _decode_inputs(B=3, H=4, KV=2, L=11, hd=64, prefix=False, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    if prefix:
        valid = np.arange(L)[None, :] < np.array([1, 7, L])[:B, None]
    else:
        valid = rng.random((B, L)) < 0.6
        valid[:, 0] = True
    return q, k, v, valid


@pytest.mark.parametrize("scale", [None, 0.05])
@pytest.mark.parametrize("prefix", [False, True])
def test_decode_attention_matches_the_reference(scale, prefix):
    """The masked single-query attention (``models/attention.py:114`` of
    the reference), any mask, with and without ``softmax_scale``."""
    q, k, v, valid = _decode_inputs(prefix=prefix)
    got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v, valid)),
                                 softmax_scale=scale)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v, valid)),
                                  softmax_scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.cuda
def test_decode_attention_on_card_takes_the_kernel():
    """On the card ``decode_attention`` launches the dense decode kernel
    (as ``attention_decode``), agrees with the CPU within the float32
    kernel tolerance, and refuses a mask that is not a prefix."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_api.py`")
    from repro_torch.kernels.decode_attn import ops as dops
    q, k, v, valid = _decode_inputs(prefix=True)
    cpu = tattn.decode_attention(*map(torch.from_numpy, (q, k, v, valid)),
                                 softmax_scale=0.05)
    before = dops.DENSE_LAUNCHES
    out = tattn.decode_attention(
        *(torch.from_numpy(a).cuda() for a in (q, k, v, valid)),
        softmax_scale=0.05)
    assert dops.DENSE_LAUNCHES == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), cpu.numpy(),
                               rtol=1e-4, atol=1e-5)
    q, k, v, valid = _decode_inputs(prefix=False)
    with pytest.raises(ValueError, match="prefix"):
        tattn.decode_attention(*(torch.from_numpy(a).cuda()
                                 for a in (q, k, v, valid)))


# ------------------------------------------------------------- ssd_chunked
@pytest.mark.parametrize("S,chunk,with_state", [
    (16, 8, False), (16, 8, True), (6, 8, False), (20, 8, True)])
def test_ssd_chunked_matches_the_reference(S, chunk, with_state):
    """The chunked SSD scan (``models/ssm.py:69`` of the reference): one
    chunk, whole chunks, and S = 20 over chunks of 8 (the reference takes
    one chunk of 20 there, the port pads to 24: the same values)."""
    B, nh, hd, ds = 2, 4, 8, 16
    rng = np.random.default_rng(S + chunk)
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(
        np.float32)
    a_log = rng.standard_normal(nh).astype(np.float32) * 0.5
    b = rng.standard_normal((B, S, ds)).astype(np.float32)
    c = rng.standard_normal((B, S, ds)).astype(np.float32)
    s0 = (rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
          if with_state else None)
    y, f = tssm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, a_log, b, c)), chunk,
        initial_state=None if s0 is None else torch.from_numpy(s0))
    jy, jf = jssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, a_log, b, c)), chunk,
        initial_state=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **TOL)
    assert f.dtype == torch.float32
