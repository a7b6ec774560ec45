"""SSM (Mamba2) and hybrid (Zamba2) training in the PyTorch port: the
model's differentiable chunked scan against ``jax.grad`` of the
reference's jnp ``ssd_chunked``, float32 on the CPU, and the route
``ssm_full`` takes (the plain scan while a gradient is recorded, the
kernel op otherwise).

Tolerances: 2e-5 of the largest reference entry against the reference
(the same float32 products summed in another order); 1e-4 against the
float32 step-by-step recurrence at a chunk whose decay passes ~88, where
the chunked form takes exp of differences of cumulative decays up to
~400 (their ulp is ~3e-5). ``Trainer.step`` on the ``-reduced`` stacks is
held against JAX's in ``tests/test_torch_arch.py``.

The ``cuda``-marked test trains on the card and skips here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssd import ops as sops
from repro_torch.kernels.ssd.ref import ssd_sequential_ref
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.training import trainer as ttr
from repro_torch.training.optimizer import adam_init, flatten

GRAD_TOL = 2e-5       # against jax.grad of the reference, float32
SEQUENTIAL_TOL = 1e-4  # against the step-by-step recurrence
NAMES = ("y", "state", "dx", "ddt", "da_log", "db", "dc", "dinit")
SSM_LEAVES = ("a_log", "dt_bias", "conv_w", "conv_b", "d_skip", "norm",
              "in_proj", "out_proj")


def _scan_inputs(B, S, nh, hd, ds, seed, dt=None, A=None):
    """x, dt (softplus'd: log-uniform in [1e-3, 0.1], mamba2's init range,
    or the constant ``dt``), a_log (A uniform in [1, 16], or ``A``), b, c,
    an initial state and the cotangents of y and the final state."""
    r = np.random.default_rng(seed)

    def n(*shape):
        return r.standard_normal(shape).astype(np.float32)
    dts = (np.full((B, S, nh), dt) if dt is not None else
           np.exp(r.uniform(np.log(1e-3), np.log(0.1), (B, S, nh))))
    a = np.asarray(A) if A is not None else r.uniform(1.0, 16.0, nh)
    return (n(B, S, nh, hd), dts.astype(np.float32),
            np.log(a).astype(np.float32), n(B, S, ds), n(B, S, ds),
            n(B, nh, hd, ds), n(B, S, nh, hd), n(B, nh, hd, ds))


def _jax_values_and_grads(args, chunk, with_init):
    x, dt, a_log, b, c, s0, gy, gs = (jnp.asarray(a) for a in args)

    def loss(x, dt, a_log, b, c, s0):
        y, st = jax_ssd_chunked(x, dt, a_log, b, c, chunk,
                                initial_state=s0 if with_init else None)
        return jnp.sum(y * gy) + jnp.sum(st * gs), (y, st)
    (_, (y, st)), g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True))(x, dt, a_log, b, c, s0)
    out = [np.asarray(t) for t in (y, st) + g]
    return out if with_init else out[:-1]


def _port_values_and_grads(args, chunk, with_init, scan):
    x, dt, a_log, b, c, s0, gy, gs = (torch.from_numpy(a) for a in args)
    leaves = [t.requires_grad_(True) for t in (x, dt, a_log, b, c, s0)]
    y, st = scan(x, dt, a_log, b, c, chunk, s0 if with_init else None)
    ((y * gy).sum() + (st * gs).sum()).backward()
    out = [y.detach().numpy(), st.detach().numpy()] + [
        t.grad.numpy() for t in leaves[:5]]
    return out + [leaves[5].grad.numpy()] if with_init else out


def _close(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("B,S,chunk,with_init", [
    (2, 96, 32, False),   # three whole chunks
    (2, 64, 32, True),    # an initial state carried in
    (2, 80, 32, True),    # S not a multiple of the chunk (the port pads)
])
def test_autograd_scan_matches_jax_grad(B, S, chunk, with_init):
    """y, the final state and the gradients of every operand agree with
    jax.grad of the reference's ssd_chunked."""
    args = _scan_inputs(B, S, 4, 8, 16, seed=S + chunk)
    _close(_port_values_and_grads(args, chunk, with_init, tssm.ssd_chunked),
           _jax_values_and_grads(args, chunk, with_init), GRAD_TOL)


def test_autograd_scan_past_the_exp_range():
    """One chunk of 256 at dt 0.1 and A 8 / 16: the chunk's cumulative
    log decay reaches 205 / 410. The port masks before exp: every
    gradient is finite and agrees with autograd through the float32
    step-by-step recurrence. The reference exponentiates before it
    masks; its gradients with respect to dt and a_log are not finite
    there (0 * inf), while its forward is."""
    args = _scan_inputs(1, 256, 2, 8, 8, seed=1, dt=0.1, A=[8.0, 16.0])

    def sequential(x, dt, a_log, b, c, chunk, init):
        return ssd_sequential_ref(x, dt, a_log, b, c, init)
    port = _port_values_and_grads(args, 256, False, tssm.ssd_chunked)
    assert all(np.isfinite(t).all() for t in port)
    _close(port, _port_values_and_grads(args, 256, False, sequential),
           SEQUENTIAL_TOL)
    ref = dict(zip(NAMES, _jax_values_and_grads(args, 256, False)))
    assert np.isfinite(ref["y"]).all() and np.isfinite(ref["state"]).all()
    assert not np.isfinite(ref["ddt"]).all()
    assert not np.isfinite(ref["da_log"]).all()


@pytest.mark.parametrize("requires_grad", [True, False])
def test_public_ssd_chunked_routes(monkeypatch, requires_grad):
    """models.ssm.ssd_chunked runs ssd_scan with the differentiable
    intra-chunk block while a gradient is recorded and with the
    intra-chunk op otherwise, and both give the same values."""
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 80, 4, 8, 16, 3)]
    x, dt, a_log, b, c = args[:5]
    with torch.no_grad():
        want = tssm.ssd_chunked(x, dt, a_log, b, c, 32)
    taken = []
    block, op = tssm._intra_chunk_autograd, sops.ssd_intra_chunk_cum
    monkeypatch.setattr(tssm, "_intra_chunk_autograd",
                        lambda *a: taken.append("autograd") or block(*a))
    monkeypatch.setattr(sops, "ssd_intra_chunk_cum",
                        lambda *a: taken.append("op") or op(*a))
    y, st = tssm.ssd_chunked(x.requires_grad_(requires_grad), dt, a_log, b,
                             c, 32)
    assert taken == ["autograd" if requires_grad else "op"]
    for got, ref in zip((y, st), want):
        torch.testing.assert_close(got.detach(), ref, rtol=1e-5, atol=1e-5)


def _remat_stack(arch):
    cfg = dataclasses.replace(get_config(arch + "-reduced"), dtype="float32",
                              remat=True)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", requires_grad=True)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        4, cfg.vocab_size - 4, (2, 45)))
    return cfg, params, tokens


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_grad_forward_skips_the_kernel_op(monkeypatch, arch):
    """With the intra-chunk op made to raise, a grad-enabled forward_hidden
    under remat runs, and so does its backward: the remat recompute takes
    the differentiable block again (each SSM layer's block runs twice), and
    every SSM leaf gets a finite, nonzero gradient. Under no_grad the
    forward takes the kernel op, which raises."""
    cfg, params, tokens = _remat_stack(arch)

    def kernel_route(*args, **kw):
        raise RuntimeError("the intra-chunk kernel op was called")
    monkeypatch.setattr(sops, "ssd_intra_chunk_cum", kernel_route)
    calls = []
    block = tssm._intra_chunk_autograd
    monkeypatch.setattr(tssm, "_intra_chunk_autograd",
                        lambda *a: calls.append(1) or block(*a))
    n_ssm = cfg.block_kinds().count("ssm")
    h, _ = tmodel.forward_hidden(params, cfg, tokens)
    assert len(calls) == n_ssm
    h.float().square().mean().backward()
    assert len(calls) == 2 * n_ssm
    ssm = params["blocks" if cfg.arch_type == "ssm" else "ssm_blocks"]["ssm"]
    for name in SSM_LEAVES:
        g = ssm[name].grad
        assert g is not None and bool(torch.isfinite(g).all()), name
        assert bool((g != 0).any()), name
    with torch.no_grad(), pytest.raises(RuntimeError, match="intra-chunk"):
        tmodel.forward_hidden(params, cfg, tokens)


# --------------------------------------------------------------- on a card
@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["a3po", "recompute"])
def test_cuda_trainer_step_on_ssm_stack(algo):
    """Trainer.step on mamba2-370m-reduced on the card: the training
    forward takes the differentiable block (the SSD ops raise under
    autograd on the card), recompute's prox forward the intra-chunk
    kernel; every metric finite, every SSM leaf moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_ssm_training.py`")
    cfg = dataclasses.replace(get_config("mamba2-370m-reduced"),
                              dtype="float32")
    params = tmodel.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
        requires_grad=True)
    rng = np.random.default_rng(6)
    B, T = 8, 80
    tokens = rng.integers(4, cfg.vocab_size - 4, (B, T))
    mask = (np.arange(T - 1)[None] >= 16) & (rng.random((B, T - 1)) > 0.2)

    def dev(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device="cuda")
    behav = -2.0 - rng.random((B, T - 1))
    batch = ttr.TrainBatch(dev(tokens, torch.long), dev(mask, torch.float32),
                           dev(behav * mask, torch.float32),
                           dev(rng.integers(0, 3, B), torch.int32),
                           dev(rng.random(B), torch.float32))
    state = ttr.TrainState(params, adam_init(params),
                           torch.tensor(3, device="cuda"))
    before = {k: v.detach().clone() for k, v in flatten(params).items()}
    n0 = sops.LAUNCHES["ssd_intra_chunk"]
    new, m = ttr.Trainer(cfg, RLConfig(group_size=4, num_minibatches=2),
                         algo).step(state, batch)
    assert all(np.isfinite(m[k]) for k in ttr.METRIC_KEYS)
    assert (sops.LAUNCHES["ssd_intra_chunk"] > n0) == (algo == "recompute")
    after = flatten(new.params)
    for k, v in before.items():
        if "/ssm/" in f"/{k}/":
            assert not torch.equal(after[k], v), k
