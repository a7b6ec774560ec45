"""MoE routing and dispatch, and MLA, of the PyTorch port against the JAX
package, float32 on the CPU.

The same numpy-made weights and inputs go through ``repro.models.moe`` /
``repro.models.mla`` and their ports: routing, capacity, the
load-balance loss and the capacity dispatch (output, aux, and the
gradients of the input and every weight, ``jax.grad`` against autograd)
drop-free, with dropped pairs, and with right-padded rows whose pad
tokens take capacity; ``mla_full`` and the absorbed ``mla_decode`` after
a prefill (cache contents and outputs). Each within 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_config
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.params import walk

TOL = dict(rtol=2e-5, atol=2e-5)
MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")


def _cfgs(name, **moe_kw):
    """(JAX cfg, port cfg) of ``name``-reduced in float32, MoE fields
    replaced by ``moe_kw``."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = dataclasses.replace(get(name + "-reduced"), dtype="float32")
        if moe_kw:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
        out.append(cfg)
    return out


def _weights(spec, rng, scale=1.0):
    """Nested numpy weights for a port spec tree: N(0, 1) * fan-in
    ** -0.5 * scale (norm scales: 1 + noise)."""
    tree = {}
    for path, s in walk(spec):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if s.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            fan = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 \
                else s.shape[0]
            a = rng.standard_normal(s.shape) * fan ** -0.5 * scale
        node[path[-1]] = a.astype(np.float32)
    return tree


def _torch_tree(tree, grad=False):
    return {k: _torch_tree(v, grad) if isinstance(v, dict)
            else torch.tensor(v, requires_grad=grad) for k, v in tree.items()}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _dropped_tokens(top_i, m, C):
    """The tokens of the pairs the port's dispatch drops."""
    order, slot = tmoe.dispatch_slots(top_i, m, C)
    return (order // m.top_k)[slot == m.num_experts * C]


def _moe_inputs(cfg, B, S, seed, pad_from=None):
    """Weights and x [B, S, d]; with ``pad_from`` every row's positions
    from that index on hold one pad vector (one token id's embedding)."""
    rng = np.random.default_rng(seed)
    # the router scaled up so that routing is decided, not a near tie
    w = _weights(tmoe.moe_spec(cfg), rng)
    w["router"] = w["router"] * 4.0
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if pad_from is not None:
        x[:, pad_from:] = rng.standard_normal(cfg.d_model)
    return w, x


def _moe_both(jcfg, tcfg, w, x):
    """moe_apply on both sides: (y, aux) and the gradients of
    sum(y * cot) + 3 aux by the input and every weight."""
    cot = np.random.default_rng(99).standard_normal(x.shape).astype(
        np.float32)

    def jloss(params, xx):
        y, aux = jmoe.moe_apply(params, xx, jcfg)
        return jnp.sum(y * cot) + 3.0 * aux, (y, aux)

    (_, (yj, auxj)), (gpj, gxj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(_jax_tree(w), jnp.asarray(x))
    tw = _torch_tree(w, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    yt, auxt = tmoe.moe_apply(tw, tx, tcfg)
    ((yt * torch.from_numpy(cot)).sum() + 3.0 * auxt).backward()
    return (yj, auxj, gpj, gxj), (yt, auxt, tw, tx)


def _assert_moe_same(j, t):
    yj, auxj, gpj, gxj = j
    yt, auxt, tw, tx = t
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(auxt.detach()), float(auxj), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gxj), **TOL)
    jg = dict(_flat(jax.device_get(gpj)))
    for path, p in _flat(tw):
        np.testing.assert_allclose(p.grad.numpy(), jg[path],
                                   err_msg=str(path), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_capacity_and_load_balance_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    m = tcfg.moe
    rng = np.random.default_rng(1)
    xf = rng.standard_normal((24, tcfg.d_model)).astype(np.float32)
    rw = (rng.standard_normal((tcfg.d_model, m.num_experts))
          * tcfg.d_model ** -0.5 * 4).astype(np.float32)
    pj, wj, ij = jmoe.route(jnp.asarray(rw), jnp.asarray(xf), jcfg.moe)
    pt, wt, it = tmoe.route(torch.from_numpy(rw), torch.from_numpy(xf), m)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **TOL)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(
        float(tmoe.load_balance_loss(pt, it, m)),
        float(jmoe.load_balance_loss(pj, ij, jcfg.moe)), **TOL)
    for T in (1, 7, 24, 4096):
        assert tmoe.capacity(m, T) == jmoe.capacity(jcfg.moe, T)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", ["drop_free", "dropping", "padded_rows"])
def test_moe_apply_and_grads_match_jax(arch, case):
    """Output, aux and gradients equal JAX's: at capacity_factor 4
    (nothing dropped), at 1.0 (pairs dropped) and at 1.0 with
    right-padded rows, whose pad tokens all route alike and drop real
    tokens of later rows that a batch without them keeps."""
    B, S = 3, 8
    cf = 4.0 if case == "drop_free" else 1.0
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    m = tcfg.moe
    pad_from = 5 if case == "padded_rows" else None
    w, x = _moe_inputs(tcfg, B, S, seed=2, pad_from=pad_from)
    C = tmoe.capacity(m, B * S)
    top_i = tmoe.route(torch.from_numpy(w["router"]),
                       torch.from_numpy(x.reshape(B * S, -1)), m)[2]
    dropped = _dropped_tokens(top_i, m, C)
    if case == "drop_free":
        assert dropped.numel() == 0
    else:
        assert dropped.numel() > 0
    if case == "padded_rows":
        # real tokens (position < pad_from) dropped here ...
        real = (dropped % S < pad_from)
        assert bool(real.any())
        # ... some of which the real tokens alone keep, at this capacity
        keep = torch.arange(B * S).reshape(B, S)[:, :pad_from].reshape(-1)
        top_r = top_i[keep]
        alone = keep[_dropped_tokens(top_r, m, C)]
        assert set(dropped[real].tolist()) - set(alone.tolist())
    _assert_moe_same(*_moe_both(jcfg, tcfg, w, x))


def test_shared_expert_is_in_the_output():
    """deepseek-v2-lite's shared expert adds its SwiGLU of every token."""
    _, tcfg = _cfgs("deepseek-v2-lite-16b")
    assert tcfg.moe.num_shared_experts == 1
    w, x = _moe_inputs(tcfg, 2, 4, seed=3)
    tw = _torch_tree(w)
    y, _ = tmoe.moe_apply(tw, torch.from_numpy(x), tcfg)
    no_shared = dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, num_shared_experts=0))
    y0, _ = tmoe.moe_apply(tw, torch.from_numpy(x), no_shared)
    from repro_torch.models.layers import swiglu
    np.testing.assert_allclose(
        (y - y0).numpy(),
        swiglu(tw["shared"], torch.from_numpy(x)).numpy(), **TOL)


# -------------------------------------------------------------------- MLA
def test_mla_full_and_decode_match_jax():
    """mla_full over right-padded rows (with the pad mask), then three
    absorbed decode steps against the latent cache it filled: outputs and
    cache contents equal JAX's; the decode output equals mla_full's last
    position on the same tokens."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    rng = np.random.default_rng(4)
    w = _weights(tmla.mla_spec(tcfg), rng, scale=2.0)
    B, S, L = 2, 9, 16
    x = rng.standard_normal((B, S + 3, tcfg.d_model)).astype(np.float32)
    lengths = np.array([S, 6], np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    pad = np.arange(S)[None] < lengths[:, None]
    yj, (cj, kj) = jmla.mla_full(_jax_tree(w), jnp.asarray(x[:, :S]), jcfg,
                                 jnp.asarray(pos), jnp.asarray(pad))
    tw = _torch_tree(w)
    yt, (ct, kt) = tmla.mla_full(tw, torch.from_numpy(x[:, :S]), tcfg,
                                 torch.from_numpy(pos).long(),
                                 torch.from_numpy(pad))
    for a, b in ((yt, yj), (ct, cj), (kt, kj)):
        np.testing.assert_allclose(a.numpy()[pad], np.asarray(b)[pad], **TOL)

    jcache = jmla.init_mla_cache(jcfg, B, L, dtype=jnp.float32)
    jcache = {"ckv": jcache["ckv"].at[:, :S].set(cj),
              "krope": jcache["krope"].at[:, :S].set(kj)}
    tcache = tmla.init_mla_cache(tcfg, B, L, dtype=torch.float32,
                                 device="cpu")
    tcache["ckv"][:, :S] = ct
    tcache["krope"][:, :S] = kt
    lj, lt = jnp.asarray(lengths), torch.from_numpy(lengths)
    for step in range(3):
        xt = x[np.arange(B), lengths + step]
        oj, jcache = jmla.mla_decode(_jax_tree(w), jnp.asarray(xt), jcfg,
                                     jcache, lj + step)
        ot, tcache = tmla.mla_decode(tw, torch.from_numpy(xt), tcfg, tcache,
                                     lt + step)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)
    # absorbed decode of row 0's token S == the full path's position S
    y_full, _ = tmla.mla_full(
        tw, torch.from_numpy(x[:1, : S + 1]), tcfg,
        torch.arange(S + 1)[None])
    tcache = tmla.init_mla_cache(tcfg, 1, L, dtype=torch.float32,
                                 device="cpu")
    tcache["ckv"][:, :S] = ct[:1]
    tcache["krope"][:, :S] = kt[:1]
    o, _ = tmla.mla_decode(tw, torch.from_numpy(x[:1, S]), tcfg, tcache,
                           torch.tensor([S], dtype=torch.int32))
    np.testing.assert_allclose(o.numpy(), y_full[:, S].numpy(), **TOL)
