"""Model layers and whole-sequence forward of the PyTorch port against the
JAX package, float32 on the CPU.

Weights come from the JAX side: the committed toy-2m checkpoint
(flat-key npz) and JAX-initialised qwen2.5-1.5b-reduced params (nested
pytree), both through ``repro_torch.models.params.from_jax``.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.training.checkpoints import load_checkpoint
from repro_torch.configs.registry import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.params import ParamTree, from_jax, walk

CKPT = Path(__file__).resolve().parents[1] / "experiments" / "ckpt" / \
    "toy-2m_loglinear"
TOL = 1e-5


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def toy_ckpt():
    """(jax cfg, jax params, torch cfg, torch ParamTree) of the committed
    toy-2m checkpoint: JAX loads the pytree, the port the flat npz keys."""
    tree, _ = load_checkpoint(str(CKPT))
    jparams = jax.tree.map(jnp.asarray, tree["params"])
    with np.load(str(CKPT) + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    return (_f32(jax_get_config("toy-2m")), jparams,
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
    tparams = from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, _f32(get_config("qwen2.5-1.5b-reduced")), tparams


def _np(x):
    return np.asarray(x)


def test_configs_are_copies():
    """The port's registry resolves the same configs, -reduced included."""
    for name in ("qwen2.5-1.5b", "qwen3-8b", "toy-2m", "toy-20m",
                 "qwen2.5-1.5b-reduced", "toy-2m-reduced"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_get_config(name))
    with pytest.raises(KeyError):
        get_config("mamba2-370m")


def test_rmsnorm_rope_swiglu_embed_head_match_jax():
    rng = np.random.default_rng(0)
    cfg_j = _f32(jax_get_config("toy-2m"))
    cfg_t = _f32(get_config("toy-2m"))
    d, ff, V = 128, 512, 64
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    scale = rng.standard_normal((d,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                        torch.from_numpy(x), 1e-5).numpy(),
        _np(jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                            1e-5)), rtol=TOL, atol=TOL)
    # rope at positions up to 1000 with Qwen's theta (f32 angles)
    xr = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos),
                           1e6).numpy(),
        _np(jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e6)),
        rtol=1e-4, atol=1e-4)
    ffn = {k: rng.standard_normal(s).astype(np.float32) * 0.05
           for k, s in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                        ("w_down", (ff, d)))}
    np.testing.assert_allclose(
        tlayers.swiglu({k: torch.from_numpy(v) for k, v in ffn.items()},
                       torch.from_numpy(x)).numpy(),
        _np(jlayers.swiglu({k: jnp.asarray(v) for k, v in ffn.items()},
                           jnp.asarray(x))), rtol=TOL, atol=TOL)
    emb = rng.standard_normal((V, d)).astype(np.float32)
    toks = rng.integers(0, V, size=(2, 6))
    e_t = tlayers.embed_tokens({"embed": torch.from_numpy(emb)},
                               torch.from_numpy(toks), cfg_t)
    e_j = jlayers.embed_tokens({"embed": jnp.asarray(emb)},
                               jnp.asarray(toks), cfg_j)
    np.testing.assert_allclose(e_t.numpy(), _np(e_j), rtol=TOL, atol=TOL)
    lg_t = tlayers.logits_from_hidden({"embed": torch.from_numpy(emb)},
                                      torch.from_numpy(x), cfg_t)
    lg_j = jlayers.logits_from_hidden({"embed": jnp.asarray(emb)},
                                      jnp.asarray(x), cfg_j)
    assert lg_t.dtype == torch.float32 and lg_t.shape == (3, 5, V)
    np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), rtol=1e-4,
                               atol=1e-4)


def test_attention_references_match_jax():
    rng = np.random.default_rng(1)
    B, S, H, KV, hd = 2, 9, 4, 2, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    valid = np.ones((B, S), bool)
    valid[1, 6:] = False
    out_t = tattn.chunked_causal_attention(
        *map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(pos),
        kv_positions=torch.from_numpy(pos),
        kv_valid=torch.from_numpy(valid), q_chunk=4)
    out_j = jattn.chunked_causal_attention(
        *map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(pos),
        kv_positions=jnp.asarray(pos), kv_valid=jnp.asarray(valid))
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=TOL, atol=TOL)
    qd = q[:, 0]
    o_t = tattn.decode_attention(*map(torch.from_numpy, (qd, k, v, valid)))
    o_j = jattn.decode_attention(*map(jnp.asarray, (qd, k, v, valid)))
    np.testing.assert_allclose(o_t.numpy(), _np(o_j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", ["toy_ckpt", "qwen_reduced"])
def test_forward_logits_matches_jax(which, request):
    """Whole-sequence forward_logits of the port == the JAX model's on the
    same weights (toy-2m checkpoint; qwen2.5-1.5b-reduced: qkv bias, tied
    embeddings, G=2), with a right-padded batch row."""
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(which)
    rng = np.random.default_rng(2)
    toks = rng.integers(4, tcfg.vocab_size, size=(2, 21)).astype(np.int32)
    pad = np.ones((2, 21), bool)
    pad[1, 15:] = False
    lg_j, _ = jmodel.forward_logits(jparams, jcfg, jnp.asarray(toks),
                                    pad_mask=jnp.asarray(pad))
    lg_t = tmodel.forward_logits(tparams, tcfg,
                                 torch.from_numpy(toks.astype(np.int64)),
                                 pad_mask=torch.from_numpy(pad))
    assert lg_t.dtype == torch.float32
    np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), rtol=1e-4, atol=1e-4)


def test_from_jax_formats_and_param_tree(qwen_reduced):
    """Flat checkpoint keys and the nested pytree give the same tree; the
    module indexes like the dict and keeps the JAX layouts."""
    jcfg, jparams, tcfg, tparams = qwen_reduced
    nested = jax.device_get(jparams)
    flat = {"params/" + "/".join(p): v for p, v in walk(nested)}
    flat["opt/step"] = np.zeros(())   # non-param keys are ignored
    t2 = from_jax(flat, device="cpu")
    assert isinstance(t2, ParamTree)
    assert [p for p, _ in walk(t2)] == [p for p, _ in walk(tparams)]
    for (_, a), (_, b) in zip(walk(t2), walk(tparams)):
        assert torch.equal(a, b) and not a.requires_grad
    L, d, H, hd = (tcfg.num_layers, tcfg.d_model, tcfg.num_heads,
                   tcfg.resolved_head_dim)
    assert tuple(tparams["blocks"]["attn"]["wq"].shape) == (L, d, H, hd)
    assert tuple(tparams["blocks"]["attn"]["wo"].shape) == (L, H, hd, d)
    assert "bq" in tparams["blocks"]["attn"]


def test_init_params_matches_jax_spec():
    """Seeded init: the JAX spec's shapes, and per-leaf std within 10% of
    the reference's (same fan-in rule, layer axis included)."""
    cfg = _f32(get_config("qwen2.5-1.5b-reduced"))
    jcfg = _f32(jax_get_config("qwen2.5-1.5b-reduced"))
    g = torch.Generator().manual_seed(0)
    tp = tmodel.init_params(cfg, g, device="cpu")
    jp = jax.device_get(jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    tleaves = dict(walk(tp))
    jleaves = dict(walk(jp))
    assert set(tleaves) == set(jleaves)
    for path, jl in jleaves.items():
        tl = tleaves[path]
        assert tuple(tl.shape) == jl.shape and tl.dtype == torch.float32
        if jl.std() == 0:
            np.testing.assert_array_equal(tl.numpy(), jl)
        else:
            assert abs(float(tl.std()) / float(jl.std()) - 1) < 0.1, path
    again = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(walk(tp),
                                                           walk(again)))


def test_entry_points_default_to_cuda():
    """Without a card, entry points refuse the default device instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodel.init_params(_f32(get_config("toy-2m")))
