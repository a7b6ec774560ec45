"""SSM (Mamba2) and hybrid (Zamba2) serving in the PyTorch port against the
JAX package, float32 on the CPU.

The same numpy-made inputs go through the JAX function and the port's
counterpart, on weights from ``repro.models.model.init_params`` carried
over by ``from_jax``. Tolerances: 2e-5 at kernel level (the plain versions
against the Pallas kernels in interpret mode: the same float32 products
summed in another order); 1e-4 where the scan order differs (the port's
chunked scan against JAX's jnp ``ssd_chunked`` or the sequential oracle,
and whole models, where those differences pass through the layers);
greedy tokens exact and behaviour logps within 1e-4 for the engines.

``cuda``-marked tests hold both CUDA kernels against their plain versions
on the card and skip here.
"""
import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.kernels.ssd.kernel import (ssd_decode_step_pallas,
                                      ssd_intra_chunk_pallas)
from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd.ref import ssd_sequential_ref as jax_sequential_ref
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro.models.layers import logits_from_hidden as jlogits_from_hidden
from repro.rollout.continuous import ContinuousBatchingEngine as JaxEngine
from repro.rollout.engine import RolloutEngine as JaxRolloutEngine
from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssd import kernel as sk
from repro_torch.kernels.ssd import ops as sops
from repro_torch.kernels.ssd.ref import (
    ssd_decode_step_ref,
    ssd_intra_chunk_ref,
    ssd_sequential_ref,
)
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as tmodel
from repro_torch.models.layers import logits_from_hidden
from repro_torch.models.params import from_jax, init_from_specs, walk
from repro_torch.rollout import paged_cache as tpc
from repro_torch.rollout.continuous import ContinuousBatchingEngine, Request
from repro_torch.rollout.engine import RolloutEngine

KERNEL_TOL = 2e-5  # plain version vs Pallas (interpret), same products
SCAN_TOL = 1e-4    # another scan order (chunked vs sequential / jnp)
LOGP_TOL = 1e-4    # engines' behaviour logps

ENGINE_KW = dict(max_seqs=2, block_size=4, n_blocks=33,
                 max_blocks_per_seq=16, greedy=True, prefill_chunk=8)


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", **kw)


def _pair(name, key, **kw):
    jcfg = _f32(jax_get_config(name), **kw)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(key))
    return (jcfg, jparams, _f32(get_config(name), **kw),
            from_jax(jax.device_get(jparams), device="cpu"))


@pytest.fixture(scope="module")
def ssm_pair():
    return _pair("mamba2-370m-reduced", 1)


@pytest.fixture(scope="module")
def hybrid_pair():
    # zamba2-style, shrunk: kinds (ssm, ssm, attn) exercise the shared
    # attention layer without the reduced config's 6-layer stack
    pair = _pair("zamba2-1.2b-reduced", 2, num_layers=3, attn_every=3)
    assert pair[2].block_kinds() == ("ssm", "ssm", "attn")
    return pair


def _prompts(vocab, n, seed=0, lo=4, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _ssd_inputs(rng, B, S, nh, hd, ds):
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(B, S, nh)).astype(np.float32)
    a_log = rng.standard_normal((nh,)).astype(np.float32)
    b = rng.standard_normal((B, S, ds)).astype(np.float32)
    c = rng.standard_normal((B, S, ds)).astype(np.float32)
    return x, dt, a_log, b, c


# ----------------------------------------------------------- kernel level
@pytest.mark.parametrize("B,nh,hd,ds", [(3, 2, 8, 16), (2, 4, 32, 64)])
def test_ssd_decode_step_plain_matches_pallas(B, nh, hd, ds):
    rng = np.random.default_rng(1)
    state = rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
    x = rng.standard_normal((B, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, size=(B, nh)).astype(np.float32)
    a_log = rng.standard_normal((nh,)).astype(np.float32)
    b, c = (rng.standard_normal((B, ds)).astype(np.float32)
            for _ in range(2))
    y_j, s_j = ssd_decode_step_pallas(*map(jnp.asarray,
                                           (state, x, dt, a_log, b, c)),
                                      interpret=True)
    y_t, s_t = sops.ssd_decode_step(*_t(state, x, dt, a_log, b, c))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=KERNEL_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0,
                               atol=KERNEL_TOL)


def test_ssd_decode_step_in_place_keeps_masked_rows():
    """``out=state`` with an update mask: updated rows get the new state,
    masked rows keep theirs bit for bit."""
    rng = np.random.default_rng(2)
    B, nh, hd, ds = 3, 2, 4, 8
    state = torch.from_numpy(
        rng.standard_normal((B, nh, hd, ds)).astype(np.float32))
    args = _t(rng.standard_normal((B, nh, hd)).astype(np.float32),
              rng.uniform(0.1, 1.0, size=(B, nh)).astype(np.float32),
              rng.standard_normal((nh,)).astype(np.float32),
              rng.standard_normal((B, ds)).astype(np.float32),
              rng.standard_normal((B, ds)).astype(np.float32))
    y_ref, new_ref = ssd_decode_step_ref(state, *args)
    pool = state.clone()
    update = torch.tensor([True, False, True])
    y, out = sops.ssd_decode_step(pool, *args, out=pool, update=update)
    assert out is pool
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    assert torch.equal(pool[1], state[1])
    torch.testing.assert_close(pool[[0, 2]], new_ref[[0, 2]], rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="update requires out"):
        sops.ssd_decode_step(state, *args, update=update)


@pytest.mark.parametrize("B,S,chunk,nh,hd,ds",
                         [(2, 64, 32, 4, 8, 16), (1, 48, 48, 8, 32, 32)])
def test_ssd_intra_chunk_plain_matches_pallas(B, S, chunk, nh, hd, ds):
    rng = np.random.default_rng(3)
    x, dt, a_log, b, c = _ssd_inputs(rng, B, S, nh, hd, ds)
    xdt = x * dt[..., None]
    la = dt * -np.exp(a_log)
    outs_j = ssd_intra_chunk_pallas(*map(jnp.asarray, (xdt, la, b, c)),
                                    chunk=chunk, interpret=True)
    outs_t = sops.ssd_intra_chunk(*_t(xdt, la, b, c), chunk)
    for got, want in zip(outs_t, outs_j):
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=KERNEL_TOL)


def test_ssd_intra_chunk_masks_before_exp():
    """Steep decay: exp(cum_i - cum_j) overflows for j > i, and the plain
    version must still give finite outputs (masked by select before exp)."""
    rng = np.random.default_rng(4)
    x, dt, a_log, b, c = _ssd_inputs(rng, 1, 32, 4, 8, 16)
    la = np.full(dt.shape, -8.0, np.float32)  # cum reaches -256
    outs = ssd_intra_chunk_ref(*_t(x, la, b, c), 32)
    assert all(bool(torch.isfinite(o).all()) for o in outs)


@pytest.mark.parametrize("S,chunk,with_state", [
    (64, 32, False), (64, 32, True), (70, 32, True), (20, 32, True)])
def test_ssd_scan_matches_jax_and_sequential(S, chunk, with_state):
    """The port's chunked scan against JAX's ``ssd_scan`` (Pallas intra
    chunk in interpret mode) and both sequential oracles, with S a
    multiple of the chunk, S not a multiple (the port pads, JAX falls back
    to one chunk of S), S shorter than a chunk, and a non-zero initial
    state."""
    rng = np.random.default_rng(5)
    B, nh, hd, ds = 2, 4, 8, 16
    x, dt, a_log, b, c = _ssd_inputs(rng, B, S, nh, hd, ds)
    s0 = (rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
          if with_state else None)
    y_t, f_t = sops.ssd_scan(*_t(x, dt, a_log, b, c), chunk=chunk,
                             initial_state=None if s0 is None
                             else torch.from_numpy(s0))
    jargs = list(map(jnp.asarray, (x, dt, a_log, b, c)))
    js0 = None if s0 is None else jnp.asarray(s0)
    y_j, f_j = jax_ssd_scan(*jargs, chunk=chunk, initial_state=js0,
                            interpret=True)
    y_s, f_s = jax_sequential_ref(*jargs, js0)
    y_p, f_p = ssd_sequential_ref(*_t(x, dt, a_log, b, c),
                                  None if s0 is None
                                  else torch.from_numpy(s0))
    for want_y, want_f in ((y_j, f_j), (y_s, f_s)):
        np.testing.assert_allclose(y_t.numpy(), np.asarray(want_y), rtol=0,
                                   atol=SCAN_TOL)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(want_f), rtol=0,
                                   atol=SCAN_TOL)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_s), rtol=0,
                               atol=KERNEL_TOL)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_s), rtol=0,
                               atol=KERNEL_TOL)


def test_ssd_ops_check_inputs_reject_bad_operands():
    rng = np.random.default_rng(6)
    B, nh, hd, ds = 2, 4, 32, 16
    state = torch.zeros(B, nh, hd, ds)
    x, dt = torch.zeros(B, nh, hd), torch.zeros(B, nh)
    a_log, b, c = torch.zeros(nh), torch.zeros(B, ds), torch.zeros(B, ds)
    assert sops.check_decode_inputs(state, x, dt, a_log, b, c) == (0, 0)
    with pytest.raises(ValueError, match="dtypes"):
        sops.check_decode_inputs(state.double(), x, dt, a_log, b, c)
    with pytest.raises(ValueError, match="shapes"):
        sops.check_decode_inputs(state, x[:, :2], dt, a_log, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        sops.check_decode_inputs(state.transpose(2, 3).contiguous()
                                 .transpose(2, 3), x, dt, a_log, b, c)
    with pytest.raises(ValueError, match="contiguous within a row"):
        sops.check_decode_inputs(state, x.transpose(1, 2).contiguous()
                                 .transpose(1, 2), dt, a_log, b, c)
    with pytest.raises(ValueError, match="d_state"):
        sops.check_decode_inputs(torch.zeros(B, nh, hd, 8), x, dt, a_log,
                                 torch.zeros(B, 8), torch.zeros(B, 8))
    S = 64
    xdt = torch.from_numpy(rng.standard_normal((B, S, nh, hd))
                           .astype(np.float32))
    la = torch.zeros(B, S, nh)
    bb = torch.zeros(B, S, ds, dtype=torch.bfloat16)
    assert sops.check_intra_chunk_inputs(xdt, la, bb, bb, 32) == 1
    with pytest.raises(ValueError, match="chunk"):
        sops.check_intra_chunk_inputs(xdt, la, bb, bb, 48)
    with pytest.raises(ValueError, match="chunk"):
        sops.check_intra_chunk_inputs(xdt.repeat(1, 5, 1, 1),
                                      la.repeat(1, 5, 1), bb.repeat(1, 5, 1),
                                      bb.repeat(1, 5, 1), 320)
    # heads: a multiple of 4 for float32 b/c (the FMA kernel's 4 a
    # block), any number for bf16 (the mma kernel's 1)
    with pytest.raises(ValueError, match="head_dim"):
        sops.check_intra_chunk_inputs(xdt[:, :, :3], la[:, :, :3],
                                      bb.float(), bb.float(), 32)
    assert sops.check_intra_chunk_inputs(
        xdt[:, :, :3].contiguous(), la[:, :, :3].contiguous(), bb, bb,
        32) == 1
    with pytest.raises(ValueError, match="dtypes"):
        sops.check_intra_chunk_inputs(xdt.double(), la, bb, bb, 32)
    with pytest.raises(ValueError, match="contiguous"):
        sops.check_intra_chunk_inputs(xdt.transpose(0, 1).contiguous()
                                      .transpose(0, 1), la, bb, bb, 32)
    # a meta tensor (the dry-run's) takes the plain version for shapes
    # only; a device with no kernel and no plain path raises
    meta = sops.ssd_intra_chunk(xdt.to("meta"), la.to("meta"),
                                bb.to("meta"), bb.to("meta"), 32)
    assert all(t.is_meta for t in meta)
    with pytest.raises(ValueError, match="no kernel"):
        sops._on_card("ssd_intra_chunk", types.SimpleNamespace(
            device=torch.device("xpu"), requires_grad=False))


def test_ssd_scan_differentiates_on_the_cpu():
    """On the CPU the plain versions carry gradients (the kernels on the
    card raise instead)."""
    rng = np.random.default_rng(7)
    x, dt, a_log, b, c = _t(*_ssd_inputs(rng, 1, 16, 4, 8, 16))
    x.requires_grad_(True)
    y, _ = sops.ssd_scan(x, dt, a_log, b, c, chunk=8)
    y.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


# ----------------------------------------------------------- params / block
# Mirrors of csrc/ssd.cu's launch geometry, which the CUDA library owns
# (kernel.intra_plan / decode_plan read it from there);
# test_cuda_ssd_plans_match_the_mirrors holds these to it on the card.
# bf16 intra-chunk (namespace tc): 4 warps a block, y tiles of 32 rows (2
# strips of 16) walked in stages of 32 keys (2 halves of 16); an s block
# takes all hd rows of s_local for a slice of d_state. Decode: 4 state rows
# x one float4 column a thread, 128 threads a block.
_TC_THREADS, _Y_ROWS, _KEY_STAGE = 128, 32, 32
_DECODE_THREADS, _DECODE_ROWS = 128, 4


def _intra_plan(B: int, S: int, L: int, nh: int, hd: int, ds: int) -> dict:
    """The bf16 intra-chunk kernel's plan (``tc::plan``)."""
    n_sub = 64 // hd  # warps side by side over d_state
    warp_cols = min(32, ds // n_sub)
    s_cols = warp_cols * n_sub
    n_y, n_s = -(-L // _Y_ROWS), ds // s_cols
    return {"route": "mma", "threads": _TC_THREADS,
            "blocks": B * (S // L) * nh * (n_y + n_s), "y_tiles": n_y,
            "s_blocks": n_s, "y_rows": _Y_ROWS, "key_stage": _KEY_STAGE,
            "s_cols": s_cols, "warp_s_cols": warp_cols}


def _decode_plan(B: int, nh: int, hd: int, ds: int) -> dict:
    """The decode kernel's plan (``decode_plan``)."""
    lanes = ds // 4
    n = B * nh * -(-hd // _DECODE_ROWS) * lanes
    return {"threads": _DECODE_THREADS, "blocks": -(-n // _DECODE_THREADS),
            "units": n, "rows_per_thread": _DECODE_ROWS,
            "lanes_per_row": lanes}


def _intra_block(plan: dict, k: int, nc: int, nh: int) -> dict:
    """What block ``k`` of the bf16 plan computes (csrc/ssd.cu,
    ``tc::intra_kernel``):
    its batch row, chunk and head, and either its y tile (``tile``) or
    its d_state columns (``s_cols``: (first, end))."""
    P = plan["blocks"] // (plan["y_tiles"] + plan["s_blocks"])
    slot, pair = divmod(k, P)
    bc, h = divmod(pair, nh)
    bi, ci = divmod(bc, nc)
    out = {"b": bi, "chunk": ci, "head": h}
    if slot < plan["y_tiles"]:
        out["tile"] = plan["y_tiles"] - 1 - slot
    else:
        c0 = (slot - plan["y_tiles"]) * plan["s_cols"]
        out["s_cols"] = (c0, c0 + plan["s_cols"])
    return out


def _intra_warp_work(plan: dict, blk: dict, warp: int, L: int, hd: int
                     ) -> dict:
    """What warp ``warp`` of a bf16 block computes. A y warp: ``rows``
    (first, end) of its strip and the ``keys`` ranges it multiplies, one a
    stage (the rows' own keys j <= i are kept by the mask); an s warp: its
    s_local ``p`` rows and ``s`` columns (first, end) over all L keys."""
    if "tile" in blk:
        r0 = blk["tile"] * _Y_ROWS
        rs, kh = warp & 1, warp >> 1
        i0 = r0 + 16 * rs
        n_keys = min(L, r0 + _Y_ROWS)
        keys = []
        for st in range(-(-n_keys // _KEY_STAGE)):
            kj0 = st * _KEY_STAGE + 16 * kh
            if kj0 < n_keys and kj0 <= i0 + 15:
                keys.append((kj0, min(kj0 + 16, L)))
        return {"rows": (i0, min(i0 + 16, L)), "keys": keys}
    strips = hd // 16
    p0 = warp % strips * 16
    c0 = blk["s_cols"][0] + warp // strips * plan["warp_s_cols"]
    return {"p": (p0, p0 + 16), "s": (c0, c0 + plan["warp_s_cols"])}


def _decode_unit(t: int, nh: int, hd: int, ds: int) -> dict:
    """What thread ``t`` of the decode kernel updates: slot, head, state
    rows (first, end) and d_state columns (first, end)."""
    lanes = ds // 4
    per_pair = -(-hd // _DECODE_ROWS) * lanes
    pair, u = divmod(t, per_pair)
    p0, q = u // lanes * _DECODE_ROWS, u % lanes
    return {"slot": pair // nh, "head": pair % nh,
            "p": (p0, min(p0 + _DECODE_ROWS, hd)), "s": (4 * q, 4 * q + 4)}


# shapes (B rows, chunk L) of the paged engine's one-row launches, the
# ragged tail of a 1000-token prompt, and dense prefill's 8-row blocks
_PLAN_SHAPES = [(1, 1), (1, 17), (1, 232), (1, 256), (8, 64), (8, 256)]


@pytest.mark.parametrize("B,L", _PLAN_SHAPES)
def test_intra_chunk_plan_covers_every_pair_once(B, L):
    """The bf16 intra-chunk kernel's launch plan, walked as the kernel
    walks it (``_intra_plan``, ``_intra_block`` / ``_intra_warp_work``:
    mirrors of csrc/ssd.cu's tc::plan and tc::intra_kernel): every (batch, head, row i, key j <= i)
    pair of y is multiplied by exactly one warp, every s_local (head, p, s)
    is written by exactly one warp, and cdec by one block, for every (hd,
    ds) the kernel takes and 4, 32 and 64 heads. Rows and keys past L are
    never taken."""
    tril = np.tril(np.ones((L, L), bool))
    for hd in sk.HEAD_DIMS:
        for ds in sk.STATE_DIMS:
            for nh in (4, 32, 64):
                plan = _intra_plan(B, L, L, nh, hd, ds)
                assert plan["y_tiles"] * _Y_ROWS >= L > (
                    plan["y_tiles"] - 1) * _Y_ROWS
                pairs = np.zeros((B, nh, L, L), np.uint8)
                s_seen = np.zeros((B, nh, hd, ds), np.uint8)
                cdec = np.zeros((B, nh), np.int32)
                for k in range(plan["blocks"]):
                    blk = _intra_block(plan, k, 1, nh)
                    bi, h = blk["b"], blk["head"]
                    assert blk["chunk"] == 0
                    if "s_cols" not in blk:
                        for w in range(4):
                            work = _intra_warp_work(plan, blk, w, L, hd)
                            (r0, r1) = work["rows"]
                            for k0, k1 in work["keys"]:
                                assert k0 < L and k0 < r1
                                pairs[bi, h, r0:r1, k0:k1] += 1
                        continue
                    if blk["s_cols"][0] == 0:
                        cdec[bi, h] += 1
                    for w in range(4):
                        work = _intra_warp_work(plan, blk, w, L, hd)
                        (p0, p1), (c0, c1) = work["p"], work["s"]
                        assert p1 <= hd and c1 <= ds
                        s_seen[bi, h, p0:p1, c0:c1] += 1
                assert (pairs[:, :, tril] == 1).all(), (hd, ds, nh)
                assert (s_seen == 1).all(), (hd, ds, nh)
                assert (cdec == 1).all(), (hd, ds, nh)
    # more than one chunk: blocks of every (row, chunk, head) once
    plan = _intra_plan(2, 200, 100, 4, 64, 128)
    seen = np.zeros((2, 2, 4, plan["y_tiles"] + plan["s_blocks"]), np.int32)
    for k in range(plan["blocks"]):
        blk = _intra_block(plan, k, 2, 4)
        role = (blk["tile"] if "tile" in blk else plan["y_tiles"]
                + blk["s_cols"][0] // plan["s_cols"])
        seen[blk["b"], blk["chunk"], blk["head"], role] += 1
    assert (seen == 1).all()


def test_decode_plan_covers_every_state_element_once():
    """The decode kernel's plan, walked as the kernel walks it
    (``_decode_plan`` / ``_decode_unit``, mirrors of csrc/ssd.cu's
    decode_plan and ssd_decode_kernel):
    every (slot, head, p, s) of the state is updated by exactly one
    thread, for d_state 16-128 and head dims 32 and 64; the threads of one
    row are whole segments of lanes (the segmented shuffle), and the plan's
    blocks hold all its threads with less than one block to spare."""
    B, nh = 3, 5
    for hd in (32, 64):
        for ds in sk.STATE_DIMS:
            plan = _decode_plan(B, nh, hd, ds)
            lanes = plan["lanes_per_row"]
            assert 32 % lanes == 0 and plan["units"] % lanes == 0
            assert (plan["blocks"] - 1) * plan["threads"] < plan["units"] \
                <= plan["blocks"] * plan["threads"]
            seen = np.zeros((B, nh, hd, ds), np.int32)
            for t in range(plan["units"]):
                u = _decode_unit(t, nh, hd, ds)
                (p0, p1), (s0, s1) = u["p"], u["s"]
                seen[u["slot"], u["head"], p0:p1, s0:s1] += 1
                # the lanes of one row group are one aligned segment
                assert (t % lanes) * 4 == s0
            assert (seen == 1).all(), (hd, ds)


def test_split_products_reconstruct_float32():
    """The mma intra-chunk kernel's products on split operands (csrc/ssd.cu,
    tc): y = M xdt as hi.hi + hi.lo + lo.hi and s_local = (w xdt)^T B as
    hi.B + lo.B reproduce the float32 products within 2^-15 of the sum of
    the terms' sizes, while hi.hi alone does not (which is why the lo
    products stay)."""
    from repro_torch.kernels.logprob.ref import split_hi_lo
    rng = np.random.default_rng(8)
    m = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    bt = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32)
                          ).to(torch.bfloat16)
    (mh, ml), (xh, xl) = split_hi_lo(m), split_hi_lo(x)
    d = torch.Tensor.double

    def worst(got, a, b):
        exact = d(a) @ d(b)
        return ((got - exact).abs() / (d(a).abs() @ d(b).abs())).max().item()

    three = d(mh) @ d(xh) + d(mh) @ d(xl) + d(ml) @ d(xh)
    assert worst(three, m, x) < 2.0 ** -15
    assert worst(d(mh) @ d(xh), m, x) > 2.0 ** -15
    xt = x.t().contiguous()
    two = d(xh.t()) @ d(bt) + d(xl.t()) @ d(bt)
    assert worst(two, xt, bt) < 2.0 ** -15
    assert worst(d(xh.t()) @ d(bt), xt, bt) > 2.0 ** -15


def test_init_a_log_and_dt_bias_ranges():
    """a_log draws A uniform in [1, 16]; dt_bias is the inverse softplus of
    dt log-uniform in [1e-3, 1e-1]; both from the explicit generator."""
    cfg = get_config("mamba2-370m-reduced")
    spec = tblocks.ssm_block_spec(cfg)["ssm"]
    big = {"a": dataclasses.replace(spec["a_log"], shape=(4096,),
                                    logical=(None,)),
           "d": dataclasses.replace(spec["dt_bias"], shape=(4096,),
                                    logical=(None,))}
    p1 = init_from_specs(big, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    p2 = init_from_specs(big, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    A = torch.exp(p1["a"])
    dt = torch.nn.functional.softplus(p1["d"])
    assert 1.0 - 1e-5 <= A.min() and A.max() <= 16.0 + 1e-4
    assert A.min() < 2.0 and A.max() > 15.0
    assert 1e-3 * (1 - 1e-4) <= dt.min() and dt.max() <= 1e-1 * (1 + 1e-4)
    assert dt.min() < 1.2e-3 and dt.max() > 0.09
    assert torch.equal(p1["a"], p2["a"]) and torch.equal(p1["d"], p2["d"])
    # log-uniform: the median dt is near the geometric mean of the range
    assert 0.007 < float(dt.median()) < 0.014


@pytest.mark.parametrize("which", ["ssm", "hybrid"])
def test_from_jax_carries_ssm_trees(which, ssm_pair, hybrid_pair):
    jcfg, jparams, cfg, params = ssm_pair if which == "ssm" else hybrid_pair
    spec_paths = {p for p, _ in walk(tmodel.model_spec(cfg))}
    got = {p: t for p, t in walk(params)}
    assert set(got) == spec_paths
    flat = {"/".join(p): v for p, v in walk(jax.device_get(jparams))}
    for p, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(flat["/".join(p)]))
    own = tmodel.init_params(cfg, device="cpu")
    assert {p: tuple(t.shape) for p, t in walk(own)} == {
        p: tuple(t.shape) for p, t in got.items()}


def test_ssm_block_full_and_decode_match_jax(ssm_pair):
    """One Mamba2 block, ragged rows resuming from a cache with
    ``valid_lens``, then decode steps, against JAX's."""
    jcfg, jparams, cfg, params = ssm_pair
    rng = np.random.default_rng(8)
    B, S, d = 3, 11, cfg.d_model
    lp_t = tmodel.unstack_model(params, cfg)[1][1]  # layer 1 of the stack
    lp_j = jax.tree.map(lambda a: a[1], jparams["blocks"])
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    lens = np.array([11, 6, 0], np.int32)
    cache0 = jax.tree.map(np.asarray, jmodel.ssm_mod.init_ssm_cache(
        jcfg, B, dtype=jnp.float32))
    cache0["conv"] = rng.standard_normal(cache0["conv"].shape).astype(
        np.float32)
    cache0["state"] = rng.standard_normal(cache0["state"].shape).astype(
        np.float32)
    mask = np.arange(S)[None, :] < lens[:, None]
    y_j, _, c_j = jblocks.ssm_block_full(
        lp_j, jnp.asarray(x), jcfg, pad_mask=jnp.asarray(mask),
        initial_cache=jax.tree.map(jnp.asarray, cache0),
        valid_lens=jnp.asarray(lens))
    y_t, c_t = tblocks.ssm_block_full(
        lp_t, torch.from_numpy(x), cfg, pad_mask=torch.from_numpy(mask),
        initial_cache={k: torch.from_numpy(v) for k, v in cache0.items()},
        valid_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=SCAN_TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(c_t[k].numpy(), np.asarray(c_j[k]),
                                   rtol=0, atol=SCAN_TOL)
    # the row with no valid tokens got its cache back bit for bit
    assert np.array_equal(c_t["conv"][2].numpy(), cache0["conv"][2])
    assert np.array_equal(c_t["state"][2].numpy(), cache0["state"][2])
    jc = c_j
    tc = {k: v.clone() for k, v in c_t.items()}
    for _ in range(3):
        xt = rng.standard_normal((B, d)).astype(np.float32)
        yj, _, jc = jblocks.ssm_block_decode(lp_j, jnp.asarray(xt), jcfg, jc)
        yt, tc = tblocks.ssm_block_decode(lp_t, torch.from_numpy(xt), cfg, tc)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=SCAN_TOL)
        for k in ("conv", "state"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=0, atol=SCAN_TOL)


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("which", ["ssm", "hybrid"])
def test_model_matches_jax(which, ssm_pair, hybrid_pair):
    """forward_logits, prefill and decode_step on equal-length prompts."""
    jcfg, jparams, cfg, params = ssm_pair if which == "ssm" else hybrid_pair
    rng = np.random.default_rng(9)
    toks = rng.integers(4, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    lj = jmodel.forward_logits(jparams, jcfg, jnp.asarray(toks))[0]
    lt = tmodel.forward_logits(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=SCAN_TOL)
    hj, cj = jmodel.prefill(jparams, jcfg, jnp.asarray(toks), max_len=48)
    ht, ct = tmodel.prefill(params, cfg, torch.from_numpy(toks).long(),
                            max_len=48)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=SCAN_TOL)
    for k in ("conv", "state"):
        np.testing.assert_allclose(ct["ssm"][k].numpy(),
                                   np.asarray(cj["ssm"][k]), rtol=0,
                                   atol=SCAN_TOL)
    if which == "hybrid":
        for k in ("k", "v"):
            np.testing.assert_allclose(ct["attn"][k].numpy(),
                                       np.asarray(cj["attn"][k]), rtol=0,
                                       atol=SCAN_TOL)
    for t in ([5, 7], [9, 11], [13, 4]):
        lj, cj = jmodel.decode_step(jparams, jcfg, cj, jnp.asarray(t))
        lt, ct = tmodel.decode_step(params, cfg, ct, torch.tensor(t))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=SCAN_TOL)
    np.testing.assert_array_equal(ct["lengths"].numpy(),
                                  np.asarray(cj["lengths"]))


def _jax_unpadded(jcfg, jparams, prompt, n_decode, tokens):
    """JAX prefill of one unpadded prompt, then decode steps of
    ``tokens``: (next-token logits after prefill, cache, logits after each
    decode step)."""
    h, c = jmodel.prefill(jparams, jcfg, jnp.asarray(prompt[None]),
                          max_len=len(prompt) + n_decode)
    first = np.asarray(jlogits_from_hidden(jparams["embedding"],
                                           h[:, -1], jcfg))[0]
    outs = []
    for t in tokens:
        lg, c = jmodel.decode_step(jparams, jcfg, c, jnp.asarray([t]))
        outs.append(np.asarray(lg)[0])
    return first, c, outs


@pytest.mark.parametrize("which", ["ssm", "hybrid"])
def test_ragged_prefill_matches_unpadded_rows(which, ssm_pair, hybrid_pair):
    """Right-padded ragged prompts: each row's prefill cache and decoded
    logits equal JAX's prefill of that prompt alone (the port passes
    ``valid_lens`` to every SSM block)."""
    jcfg, jparams, cfg, params = ssm_pair if which == "ssm" else hybrid_pair
    prompts = _prompts(cfg.vocab_size, 3, seed=10, lo=3, hi=16)
    P = max(len(p) for p in prompts)
    toks = np.zeros((3, P), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    h, cache = tmodel.prefill(params, cfg, torch.from_numpy(toks),
                              lengths=lens, max_len=P + 3)
    first = logits_from_hidden(params["embedding"],
                               h[torch.arange(3), lens.long() - 1], cfg)
    steps = [[5, 6, 7], [8, 9, 10], [11, 12, 13]]
    got = []
    for t in zip(*steps):
        lg, cache = tmodel.decode_step(params, cfg, cache, torch.tensor(t))
        got.append(lg.numpy())
    for i, p in enumerate(prompts):
        f_j, c_j, outs_j = _jax_unpadded(jcfg, jparams, p, 3, steps[i])
        np.testing.assert_allclose(first[i].numpy(), f_j, rtol=0,
                                   atol=SCAN_TOL)
        for t in range(3):
            np.testing.assert_allclose(got[t][i], outs_j[t], rtol=0,
                                       atol=SCAN_TOL)


def test_reference_prefill_keeps_the_pad_conv_tail(ssm_pair):
    """Pins the reference's ragged-prefill fault the port does not copy:
    JAX's ``model.prefill`` takes the conv window of the last K-1 (pad)
    rows, so a short row's conv cache and next logits differ from its
    unpadded prefill, while its SSM state (frozen on pad steps) agrees."""
    jcfg, jparams, cfg, params = ssm_pair
    rng = np.random.default_rng(0)
    lens = [12, 7]
    toks = np.zeros((2, 12), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(4, cfg.vocab_size, size=n)
    _, c_pad = jmodel.prefill(jparams, jcfg, jnp.asarray(toks),
                              lengths=jnp.asarray(lens, jnp.int32),
                              max_len=16)
    _, c_one, _ = _jax_unpadded(jcfg, jparams, toks[1, :7], 1, [])
    state_gap = np.abs(np.asarray(c_pad["ssm"]["state"][:, 1])
                       - np.asarray(c_one["ssm"]["state"][:, 0])).max()
    conv_gap = np.abs(np.asarray(c_pad["ssm"]["conv"][:, 1])
                      - np.asarray(c_one["ssm"]["conv"][:, 0])).max()
    assert state_gap < 1e-5 and conv_gap > 0.5
    # the port's prefill of the same batch matches the unpadded row
    _, c_t = tmodel.prefill(params, cfg, torch.from_numpy(toks).long(),
                            lengths=torch.tensor(lens, dtype=torch.int32),
                            max_len=16)
    np.testing.assert_allclose(c_t["ssm"]["conv"][:, 1].numpy(),
                               np.asarray(c_one["ssm"]["conv"][:, 0]),
                               rtol=0, atol=SCAN_TOL)


# ---------------------------------------------------------------- engine
def _serve_both(pair, prompts, max_new, **kw):
    jcfg, jparams, cfg, params = pair
    ekw = dict(ENGINE_KW, **kw)
    jeng = JaxEngine(jcfg, **ekw)
    teng = ContinuousBatchingEngine(cfg, device="cpu", **ekw)
    for p in prompts:
        jeng.submit(p, max_new=max_new)
        teng.submit(p, max_new=max_new)
    jdone = {r.rid: r for r in jeng.run(jparams, jax.random.PRNGKey(0))}
    tdone = {r.rid: r for r in teng.run(params)}
    assert set(jdone) == set(tdone) and len(tdone) == len(prompts)
    for rid, jr in jdone.items():
        assert tdone[rid].generated == jr.generated
        np.testing.assert_allclose(tdone[rid].gen_logp, jr.gen_logp, rtol=0,
                                   atol=LOGP_TOL)
    assert teng.allocator.n_free == jeng.allocator.n_free \
        == ENGINE_KW["n_blocks"] - 1
    assert teng.ssm_pool.n_free == jeng.ssm_pool.n_free == kw.get(
        "max_seqs", ENGINE_KW["max_seqs"])
    assert teng.supports_prefix_cache is False
    return teng


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("which", ["ssm", "hybrid"])
def test_engine_matches_jax_engine(which, horizon, ssm_pair, hybrid_pair):
    """5 prompts (3-15 tokens, longer than the 8-token prefill chunk)
    through 2 slots (slot reuse, SSM state re-zeroed): greedy tokens
    exact, behaviour logps within 1e-4, pools drained."""
    pair = ssm_pair if which == "ssm" else hybrid_pair
    prompts = _prompts(pair[2].vocab_size, 5, seed=11, lo=3, hi=16)
    _serve_both(pair, prompts, 10, decode_horizon=horizon)


def test_hybrid_engine_two_attention_layers():
    """attn_every=2 over 4 layers: two applications of the shared block,
    so the attention-layer index into the KV pool goes beyond 0."""
    pair = _pair("zamba2-1.2b-reduced", 5, num_layers=4, attn_every=2)
    assert pair[2].block_kinds() == ("ssm", "attn", "ssm", "attn")
    prompts = _prompts(pair[2].vocab_size, 3, seed=12)
    _serve_both(pair, prompts, 8, decode_horizon=4, max_seqs=3)


def test_preemption_and_slot_reuse_no_stale_state(ssm_pair):
    """Preempting a mid-decode sequence and reusing its SSM slot leaks no
    recurrent state into the next occupant, and the preempted prompt
    resubmitted fresh regenerates exactly."""
    jcfg, jparams, cfg, params = ssm_pair
    eng = ContinuousBatchingEngine(cfg, device="cpu", decode_horizon=4,
                                   **ENGINE_KW)
    p0, p1 = _prompts(cfg.vocab_size, 2, seed=6)
    eng.submit(p0, max_new=12)
    eng._admit(params)
    while eng.prefilling_slots():
        eng.prefill_step(params)
    eng.step_horizon(params)
    [slot] = [s for s, r in eng.slots.items() if r is not None]
    assert eng.release_slot(slot) is not None
    assert eng.ssm_pool.n_free == 2
    rid = eng.submit(p1, max_new=10)
    done = {r.rid: r.generated for r in eng.run(params)}
    rid2 = eng.submit(p0, max_new=12)
    done2 = {r.rid: r.generated for r in eng.run(params)}
    for prompt, n, gen in ((p1, 10, done[rid]), (p0, 12, done2[rid2])):
        jeng = JaxEngine(jcfg, decode_horizon=4, **ENGINE_KW)
        jrid = jeng.submit(prompt, max_new=n)
        jdone = {r.rid: r.generated
                 for r in jeng.run(jparams, jax.random.PRNGKey(0))}
        assert gen == jdone[jrid]


def test_ssm_engine_masked_slot_keeps_state_bit_exact(ssm_pair):
    """A decode step with one slot masked out (mid-prefill) leaves that
    slot's conv window and state untouched bit for bit."""
    _, _, cfg, params = ssm_pair
    eng = ContinuousBatchingEngine(cfg, device="cpu", **ENGINE_KW)
    p0, p1 = _prompts(cfg.vocab_size, 2, seed=13, lo=20, hi=21)
    eng.submit(p0, max_new=4)
    eng._admit(params)                      # slot 0 prefilled
    eng.start_prefill(1, Request(99, p1, 4))
    eng.prefill_step(params, max_chunks=1)  # slot 1 mid-prefill
    assert eng.prefilling_slots() == [1]
    conv = eng.ssm_cache.conv[:, 1].clone()
    state = eng.ssm_cache.state[:, 1].clone()
    eng.step(params)
    assert torch.equal(eng.ssm_cache.conv[:, 1], conv)
    assert torch.equal(eng.ssm_cache.state[:, 1], state)


def test_engine_refuses_prefix_cache_for_ssm(ssm_pair):
    cfg = ssm_pair[2]
    with pytest.raises(ValueError, match="prefix cache"):
        ContinuousBatchingEngine(cfg, device="cpu", prefix_cache=object(),
                                 **ENGINE_KW)


def test_ssm_slot_pool_lifecycle():
    pool = tpc.SSMSlotPool(2)
    pool.map(0)
    with pytest.raises(AssertionError, match="double map"):
        pool.map(0)
    pool.fork(0, 1)
    assert pool.forks == 1 and pool.n_free == 0
    pool.release(1)
    with pytest.raises(AssertionError, match="unmapped"):
        pool.release(1)
    with pytest.raises(AssertionError, match="fork from unmapped"):
        pool.fork(1, 0)
    with pytest.raises(AssertionError, match="out of range"):
        pool.map(2)
    assert pool.is_mapped(0) and not pool.is_mapped(1)


def test_ssm_state_cache_reset_and_fork(hybrid_pair):
    cfg = hybrid_pair[2]
    cache = tpc.init_ssm_state_cache(cfg, max_seqs=3, dtype=torch.float32,
                                     device="cpu")
    assert cache.n_layers == 2 and cache.max_seqs == 3
    cache.conv.normal_()
    cache.state.normal_()
    tpc.ssm_fork_slot(cache, 0, 2)
    assert torch.equal(cache.state[:, 2], cache.state[:, 0])
    assert torch.equal(cache.conv[:, 2], cache.conv[:, 0])
    tpc.ssm_reset_slots(cache, [0])
    assert not cache.state[:, 0].any() and not cache.conv[:, 0].any()
    assert cache.state[:, 1].any()
    pool = tpc.init_paged_cache(cfg, n_blocks=4, block_size=2, max_seqs=3,
                                max_blocks_per_seq=2, dtype=torch.float32,
                                device="cpu")
    assert pool.pool_k.shape[0] == 1  # one pool layer per attention layer
    ssm_only = tpc.init_paged_cache(get_config("mamba2-370m-reduced"),
                                    n_blocks=4, block_size=2, max_seqs=3,
                                    max_blocks_per_seq=2,
                                    dtype=torch.float32, device="cpu")
    assert ssm_only.pool_k.shape[0] == 0


# ------------------------------------------------------- rollout engine
def test_rollout_engine_generate_mamba2(ssm_pair):
    """``RolloutEngine.generate`` through the ported prefill / decode_step:
    equal-length prompts against JAX's generate (tokens exact, logps within
    1e-4), and ragged prompts row by row against JAX's generate of that
    prompt alone (JAX's padded prefill keeps the pad conv tail)."""
    jcfg, jparams, cfg, params = ssm_pair
    rng = np.random.default_rng(14)
    prompts = rng.integers(4, cfg.vocab_size, size=(3, 9)).astype(np.int32)
    lens = np.full((3,), 9, np.int32)
    tb = RolloutEngine(cfg, max_new_tokens=6).generate(
        params, prompts, lens, greedy=True)
    jb = JaxRolloutEngine(jcfg, max_new_tokens=6).generate(
        jparams, prompts, lens, jax.random.PRNGKey(0), greedy=True)
    np.testing.assert_array_equal(tb.tokens, jb.tokens)
    np.testing.assert_allclose(tb.gen_logp, jb.gen_logp, rtol=0,
                               atol=LOGP_TOL)
    ragged = np.array([9, 4, 6], np.int32)
    tb = RolloutEngine(cfg, max_new_tokens=6).generate(
        params, prompts, ragged, greedy=True)
    for i, n in enumerate(ragged):
        jb = JaxRolloutEngine(jcfg, max_new_tokens=6).generate(
            jparams, prompts[i:i + 1, :n], ragged[i:i + 1],
            jax.random.PRNGKey(0), greedy=True)
        np.testing.assert_array_equal(tb.tokens[i, :n + 6], jb.tokens[0])
        np.testing.assert_allclose(tb.gen_logp[i], jb.gen_logp[0], rtol=0,
                                   atol=LOGP_TOL)


# --------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_ssm.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,ds,hd", [(32, 128, 64), (64, 64, 64),
                                      (4, 16, 64), (8, 32, 32),
                                      (4, 128, 32)])
def test_cuda_ssd_decode_vs_plain(cuda_device, dtype, nh, ds, hd):
    """The decode kernel against its plain version in float32 on the same
    values: the state update elementwise (1e-6), y summed in another order
    (float32: 1e-5 relative; bf16 y rounds once, 2^-9)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B = 8

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device)
    state = rnd(B, nh, hd, ds)
    x, b, c = rnd(B, nh, hd).to(dtype), rnd(B, ds).to(dtype), \
        rnd(B, ds).to(dtype)
    dt = torch.rand(B, nh, generator=g, device=cuda_device) * 0.5
    a_log = rnd(nh).to(dtype)
    y, new = sops.ssd_decode_step(state, x, dt, a_log, b, c)
    y_ref, new_ref = ssd_decode_step_ref(state, x.float(), dt,
                                         a_log.float(), b.float(), c.float())
    torch.testing.assert_close(new, new_ref, rtol=1e-6, atol=1e-6)
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), y_ref, rtol=rtol, atol=1e-4)
    # in place under a mask
    pool = state.clone()
    update = torch.arange(B, device=cuda_device) % 3 != 1
    sops.ssd_decode_step(pool, x, dt, a_log, b, c, out=pool, update=update)
    assert torch.equal(pool[~update], state[~update])
    torch.testing.assert_close(pool[update], new_ref[update], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,L,nh,hd,ds", [
    (8, 256, 256, 32, 64, 128), (8, 64, 64, 64, 64, 64),
    (2, 200, 100, 8, 32, 16), (1, 70, 35, 4, 64, 32),
    (1, 1, 1, 32, 64, 128), (1, 17, 17, 32, 64, 128),
    (1, 232, 232, 32, 64, 128), (1, 256, 256, 64, 64, 64),
    (1, 232, 232, 64, 64, 64), (2, 34, 17, 64, 64, 64),
    (1, 17, 17, 4, 32, 16), (3, 232, 232, 4, 32, 128),
    (16, 1024, 256, 32, 64, 128), (16, 1024, 256, 64, 64, 64)])
def test_cuda_ssd_intra_chunk_vs_plain(cuda_device, dtype, B, S, L, nh, hd,
                                       ds):
    """The intra-chunk kernel against its plain version in float32 on the
    same values (b/c in ``dtype``: bf16 the mma kernel, float32 the FMA
    kernel): float32 sums in another order, within 1e-4 of the output's
    scale; ragged chunks (1, 17, 232) and zamba2's 64 heads of d_state 64
    included, and the dense path's 16 rows of 4 chunks of 256."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    xdt = torch.randn(B, S, nh, hd, generator=g, device=cuda_device) * 0.1
    la = -torch.rand(B, S, nh, generator=g, device=cuda_device) * 0.2
    b, c = (torch.randn(B, S, ds, generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    outs = sops.ssd_intra_chunk(xdt, la, b, c, L)
    refs = ssd_intra_chunk_ref(xdt, la, b.float(), c.float(), L)
    for got, want in zip(outs, refs):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 3])
def test_cuda_ssd_intra_chunk_cum_and_strided_rows(cuda_device, dtype,
                                                   offset):
    """b/c as slices of one conv output (strided rows, as the engines
    pass them; offset 3 leaves bf16 rows unaligned, which the wrapper
    copies): the outputs match the plain version and the kernel's cum
    matches torch.cumsum per chunk."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    B, S, L, nh, hd, ds = 2, 464, 232, 8, 64, 64
    xdt = torch.randn(B, S, nh, hd, generator=g, device=cuda_device) * 0.1
    la = -torch.rand(B, S, nh, generator=g, device=cuda_device) * 0.2
    xbc = torch.randn(B, S, 2 * ds + 16, generator=g,
                      device=cuda_device).to(dtype)
    b, c = xbc[..., offset:offset + ds], xbc[..., offset + ds:offset + 2 * ds]
    outs = sops.ssd_intra_chunk_cum(xdt, la, b, c, L)
    refs = ssd_intra_chunk_ref(xdt, la, b.float(), c.float(), L)
    cum = torch.cumsum(la.reshape(B, S // L, L, nh), dim=2).reshape(B, S, nh)
    for got, want in zip(outs, (*refs, cum)):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert sops.PLANS["ssd_intra_chunk"]["route"] == (
        "mma" if dtype == torch.bfloat16 else "fma")


@pytest.mark.cuda
def test_cuda_ssd_plans_match_the_mirrors(cuda_device):
    """The plans the CUDA library launches are the ones the coverage tests
    above walk: the bf16 intra-chunk plan at their shapes, dense prefill's
    and the dense path's, and the decode plan at theirs."""
    shapes = [(B, L, L) for B, L in _PLAN_SHAPES] + [(2, 200, 100),
                                                      (16, 1024, 256)]
    for B, S, L in shapes:
        for hd in sk.HEAD_DIMS:
            for ds in sk.STATE_DIMS:
                for nh in (4, 32, 64):
                    assert sk.intra_plan(1, B, S, L, nh, hd, ds) == \
                        _intra_plan(B, S, L, nh, hd, ds), (B, S, L, hd, ds)
    for B, nh in ((3, 5), (8, 32), (8, 64)):
        for hd in (32, 64):
            for ds in sk.STATE_DIMS:
                assert sk.decode_plan(B, nh, hd, ds) == \
                    _decode_plan(B, nh, hd, ds), (B, nh, hd, ds)


@pytest.mark.cuda
def test_cuda_ssd_ops_raise_under_autograd(cuda_device):
    x = torch.randn(1, 64, 4, 32, device=cuda_device, requires_grad=True)
    dt = torch.rand(1, 64, 4, device=cuda_device)
    a_log = torch.zeros(4, device=cuda_device)
    b = torch.randn(1, 64, 16, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        sops.ssd_scan(x, dt, a_log, b, b, chunk=32)
    state = torch.zeros(1, 4, 32, 16, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        sops.ssd_decode_step(state, x[:, 0], dt[:, 0], a_log, b[:, 0],
                             b[:, 0])
    with torch.no_grad():
        sops.ssd_scan(x, dt, a_log, b, b, chunk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["ssm", "hybrid"])
def test_cuda_engine_matches_cpu(cuda_device, which, ssm_pair, hybrid_pair):
    """The engine on the card (SSD and paged kernels) gives the CPU
    engine's greedy tokens, logps within 1e-4, and drains the same."""
    pair = ssm_pair if which == "ssm" else hybrid_pair
    cfg, params = pair[2], pair[3]
    prompts = _prompts(cfg.vocab_size, 5, seed=11, lo=3, hi=16)
    out = []
    launches0 = dict(sops.LAUNCHES)
    for dev in ("cpu", "cuda"):
        eng = ContinuousBatchingEngine(cfg, device=dev, decode_horizon=4,
                                       **ENGINE_KW)
        for p in prompts:
            eng.submit(p, max_new=10)
        done = eng.run(copy.deepcopy(params).to(dev))
        assert eng.allocator.n_free == ENGINE_KW["n_blocks"] - 1
        assert eng.ssm_pool.n_free == ENGINE_KW["max_seqs"]
        out.append({r.rid: r for r in done})
    assert all(sops.LAUNCHES[k] > launches0[k] for k in launches0)
    for rid, a in out[0].items():
        assert out[1][rid].generated == a.generated
        np.testing.assert_allclose(out[1][rid].gen_logp, a.gen_logp,
                                   rtol=0, atol=LOGP_TOL)


@pytest.mark.cuda
def test_cuda_ssm_decode_horizon_has_no_host_sync(cuda_device, ssm_pair):
    """Inside a fused SSM horizon nothing waits for the device."""
    from repro_torch.rollout import continuous as C
    cfg, params = ssm_pair[2], copy.deepcopy(ssm_pair[3]).to(cuda_device)
    eng = ContinuousBatchingEngine(cfg, device=cuda_device, decode_horizon=4,
                                   **ENGINE_KW)
    for p in _prompts(cfg.vocab_size, 2, seed=15):
        eng.submit(p, max_new=8)
    eng._admit(params)
    budget = np.zeros((2,), np.int32)
    budget[eng.decode_ready_slots()] = 4
    eng._prepare_decode({s: 4 for s in eng.decode_ready_slots()})
    budget_d = torch.from_numpy(budget).to(cuda_device)
    layers = C._layers(params, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed, _, _ = C._paged_decode_horizon(
            params, layers, cfg, eng.state, eng._next_logits, budget_d, None,
            trash_block=eng.trash_block, horizon=4, temperature=1.0,
            top_p=1.0, greedy=True, ssm=eng.ssm_cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert packed.shape == (3, 4, 2)
