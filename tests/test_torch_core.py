"""The A-3PO objective and the algorithm registry of the PyTorch port against
the JAX package, float32 on the CPU.

Both sides take the same numpy-made inputs: staleness and every alpha
schedule (kl_adaptive included), the proximal approximations, group
advantages, and for every registered algorithm its loss, each of its
metrics and its gradient w.r.t. the live logp (``jax.grad`` against torch
autograd through the fused ``Function``), with [B] and [B, T] version
stamps; then the registry's table, requires-flags and plugin hygiene.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RLConfig as JaxRLConfig
from repro.core import a3po as ja3po
from repro.core import advantages as jadv
from repro.core import algorithms as jalgos
from repro.core import objective as jobj
from repro_torch.configs.base import RLConfig
from repro_torch.core import a3po, advantages, algorithms, objective
from repro_torch.core.losses import policy_loss

B, T = 8, 13
TOL = dict(rtol=2e-5, atol=1e-6)


def _batch(seed, per_token=False, staleness_spread=4):
    rng = np.random.default_rng(seed)
    logp = (-rng.random((B, T)) * 3).astype(np.float32)
    behav = (-rng.random((B, T)) * 3).astype(np.float32)
    adv = rng.standard_normal((B, T)).astype(np.float32)
    mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    shape = (B, T) if per_token else (B,)
    versions = rng.integers(0, staleness_spread, size=shape).astype(np.int32)
    entropy = rng.random((B, T)).astype(np.float32)
    return dict(logp=logp, behav=behav, adv=adv, mask=mask,
                versions=versions, entropy=entropy)


def _close(ours, theirs, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               **(tol or TOL))


@pytest.mark.parametrize("per_token", [False, True])
def test_staleness_and_prox(per_token):
    b = _batch(0, per_token)
    d = a3po.staleness(torch.from_numpy(b["versions"]), 3)
    _close(d, ja3po.staleness(jnp.asarray(b["versions"]), 3))
    # a 0-d tensor version gives the same staleness as a Python int
    _close(a3po.staleness(torch.from_numpy(b["versions"]),
                          torch.tensor(3, dtype=torch.int32)),
           ja3po.staleness(jnp.asarray(b["versions"]), 3))
    prox = a3po.compute_prox_logp_approximation(
        torch.from_numpy(b["behav"]), torch.from_numpy(b["logp"]),
        torch.from_numpy(b["versions"]), 3, RLConfig())
    _close(prox, ja3po.compute_prox_logp_approximation(
        jnp.asarray(b["behav"]), jnp.asarray(b["logp"]),
        jnp.asarray(b["versions"]), 3, JaxRLConfig()))
    assert not prox.requires_grad


@pytest.mark.parametrize("schedule", ["inverse", "exp", "clipped", "const",
                                      "kl_adaptive"])
def test_alpha_schedules(schedule):
    cfg = RLConfig(alpha_schedule=schedule, alpha_gamma=0.7,
                   alpha_clip=(0.2, 0.6), alpha_const=0.3)
    jcfg = JaxRLConfig(alpha_schedule=schedule, alpha_gamma=0.7,
                       alpha_clip=(0.2, 0.6), alpha_const=0.3)
    d = np.array([0.0, 0.5, 1.0, 2.0, 3.0, 7.0], np.float32)
    _close(a3po.alpha_from_staleness(torch.from_numpy(d), cfg),
           ja3po.alpha_from_staleness(jnp.asarray(d), jcfg))
    b = _batch(1)
    kw = dict(versions=b["versions"], current_version=4, logp=b["logp"],
              behav_logp=b["behav"], mask=b["mask"])
    ours = objective.resolve_alpha(cfg, **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    theirs = jobj.resolve_alpha(jcfg, **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    _close(ours, theirs)


def test_kl_adaptive_prox():
    b = _batch(2)
    args = [torch.from_numpy(b[k]) for k in ("behav", "logp", "mask")]
    jargs = [jnp.asarray(b[k]) for k in ("behav", "logp", "mask")]
    _close(a3po.kl_adaptive_alpha(*args, target_kl=0.02),
           ja3po.kl_adaptive_alpha(*jargs, target_kl=0.02))
    _close(a3po.compute_prox_logp_kl_adaptive(*args),
           ja3po.compute_prox_logp_kl_adaptive(*jargs))


def test_advantages():
    rng = np.random.default_rng(3)
    r = rng.random(12).astype(np.float32)
    r[4:8] = 0.5  # a group with zero spread
    ours = advantages.group_normalized_advantages(torch.from_numpy(r), 4)
    _close(ours, jadv.group_normalized_advantages(jnp.asarray(r), 4))
    mask = (rng.random((12, 5)) > 0.5).astype(np.float32)
    _close(advantages.broadcast_over_tokens(ours, torch.from_numpy(mask)),
           jadv.broadcast_over_tokens(
               jadv.group_normalized_advantages(jnp.asarray(r), 4),
               jnp.asarray(mask)))


ALGOS = ["sync", "recompute", "a3po", "loglinear", "asympo", "grpo_mu"]


def _loss_inputs(mod, b, arr, prox, version):
    return mod.LossInputs(
        advantages=arr(b["adv"]), mask=arr(b["mask"]),
        behav_logp=arr(b["behav"]), versions=arr(b["versions"]),
        current_version=version, prox_logp=arr(prox),
        entropy=arr(b["entropy"]))


@pytest.mark.parametrize("name", ALGOS)
@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("kl_coef", [0.0, 0.1])
def test_algorithm_loss_metrics_and_grad(name, per_token, kl_coef):
    """Loss, every metric and d loss / d logp of each registered algorithm
    equal the JAX package's on the same inputs (the a3po gradient runs the
    port's fused Function against JAX's custom_vjp)."""
    b = _batch(4, per_token)
    prox = (b["logp"] + 0.1 * np.random.default_rng(5).standard_normal(
        (B, T))).astype(np.float32)
    cfg = RLConfig(kl_coef=kl_coef, entropy_coef=0.01)
    jcfg = JaxRLConfig(kl_coef=kl_coef, entropy_coef=0.01)
    algo = algorithms.get_algorithm(name)
    jalgo = jalgos.get_algorithm(name)

    x = torch.from_numpy(b["logp"].copy()).requires_grad_(True)
    loss, m = algo.loss(x, _loss_inputs(algorithms, b, torch.from_numpy,
                                        prox, 3), cfg)
    loss.backward()

    def jloss(lp):
        return jalgo.loss(lp, _loss_inputs(jalgos, b, jnp.asarray, prox, 3),
                          jcfg)

    (jl, jm), g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(b["logp"]))
    _close(loss, jl)
    assert set(m) == set(jm)
    for k in m:
        _close(m[k], jm[k])
    _close(x.grad, g, rtol=1e-5, atol=1e-7)


def test_registry_table_and_flags():
    """The same algorithms, aliases, requires-flags and hyperparameter
    defaults as the JAX registry."""
    assert algorithms.available() == jalgos.available()
    assert algorithms.BUILTINS == jalgos.BUILTINS
    ours = algorithms.registry_table()
    theirs = jalgos.registry_table()
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a == b
    assert algorithms.get_algorithm("loglinear") == \
        algorithms.get_algorithm("a3po")
    assert algorithms.get_algorithm("recompute").needs_prox_forward
    assert not algorithms.get_algorithm("asympo").needs_behav_logp
    assert algorithms.resolve_algorithm(None, RLConfig(method="sync")).name \
        == "sync"
    with pytest.raises(ValueError, match="unknown algorithm"):
        algorithms.get_algorithm("nope")


def test_register_custom_algorithm_and_unregister():
    @algorithms.register("half_sync", aliases=("hs",))
    @dataclasses.dataclass(frozen=True)
    class HalfSync(algorithms.SyncPPO):
        """Sync loss at half weight."""

        def loss(self, logp, batch, cfg):
            loss, m = super().loss(logp, batch, cfg)
            return 0.5 * loss, m

    try:
        assert "half_sync" in algorithms.available()
        assert algorithms.get_algorithm("hs").name == "half_sync"
        with pytest.raises(ValueError, match="already registered"):
            algorithms.register("hs")(HalfSync)
    finally:
        algorithms.unregister("hs")
    assert "half_sync" not in algorithms.available()
    assert "hs" not in algorithms._REGISTRY


def test_stringly_typed_dispatch_warns_and_matches():
    b = _batch(6)
    args = [torch.from_numpy(b[k]) for k in ("logp", "behav", "adv",
                                             "mask")]
    with pytest.warns(DeprecationWarning):
        l1, _ = objective.policy_objective(
            "a3po", *args, RLConfig(), versions=torch.from_numpy(
                b["versions"]), current_version=3)
    with pytest.warns(DeprecationWarning):
        l2, _ = policy_loss("loglinear", *args, RLConfig(),
                            versions=torch.from_numpy(b["versions"]),
                            current_version=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        l3, _ = objective.policy_objective(
            algorithms.get_algorithm("a3po"), *args, RLConfig(),
            versions=torch.from_numpy(b["versions"]), current_version=3)
    assert float(l1) == float(l2) == float(l3)


def test_fused_equals_modular_decoupled_loss():
    """The fused A-3PO loss equals the plain decoupled loss over the
    log-linear anchor, in value and in gradient."""
    b = _batch(7)
    cfg = RLConfig()
    ver = torch.from_numpy(b["versions"])
    behav, adv, mask = (torch.from_numpy(b[k]) for k in ("behav", "adv",
                                                         "mask"))
    x1 = torch.from_numpy(b["logp"].copy()).requires_grad_(True)
    x2 = torch.from_numpy(b["logp"].copy()).requires_grad_(True)
    alpha = objective.resolve_alpha(cfg, versions=ver, current_version=3)
    l1, m1 = objective.fused_a3po_loss(x1, behav, alpha, adv, mask, cfg)
    prox = a3po.compute_prox_logp_approximation(behav, x2, ver, 3, cfg)
    l2, m2 = objective.decoupled_ppo_loss(x2, behav, prox, adv, mask, cfg)
    l1.backward()
    l2.backward()
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-5, atol=1e-7)
    for k in m1:
        torch.testing.assert_close(m1[k], m2[k], rtol=1e-5, atol=1e-6)


def _eager_a3po_loss(logp, behav_logp, alpha, adv, mask, cfg, entropy):
    """The fused A-3PO loss as an eager sequence: the per-token
    ``Function``, then each masked reduction and the regularizers as ops of
    their own (the loss path before its reductions moved into the reduced
    kernel)."""
    from repro_torch.kernels.a3po_loss import a3po_objective
    logp = logp.float()
    behav_logp = behav_logp.float()
    if alpha.dim() == logp.dim() - 1:
        alpha = alpha[..., None]
    alpha = torch.broadcast_to(alpha, logp.shape).float().detach()
    loss_tok, clip_tok, iw, ratio = a3po_objective(
        logp, behav_logp, alpha, adv, mask, clip_eps=cfg.clip_eps,
        iw_cap=cfg.behav_weight_cap)
    denom = torch.clamp_min(mask.sum(), 1.0)
    metrics = {
        "iw_max": objective._masked_max(iw, mask),
        "iw_min": objective._masked_min(iw, mask),
        "iw_mean": objective.masked_mean(iw, mask),
        "ratio_mean": objective.masked_mean(ratio, mask),
        "clipped_tokens": clip_tok.sum(),
        "clipped_frac": clip_tok.sum() / denom,
    }
    if entropy is not None:
        metrics["entropy"] = objective.masked_mean(entropy, mask)
    anchor = alpha * behav_logp + (1.0 - alpha) * logp
    return objective.apply_regularizers(loss_tok.sum() / denom, metrics,
                                        logp, anchor, mask, cfg, entropy)


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("kl_coef,entropy_coef", [(0.0, 0.0), (0.1, 0.0),
                                                  (0.0, 0.01), (0.1, 0.01)])
@pytest.mark.parametrize("with_entropy", [False, True])
def test_reduced_a3po_plain_equals_eager_sequence(per_token, kl_coef,
                                                  entropy_coef,
                                                  with_entropy):
    """On the CPU the reduced op's plain version gives the eager
    sequence's loss and metrics bit for bit, and its analytic backward
    autograd's gradients w.r.t. logp and entropy bit for bit."""
    b = _batch(11, per_token)
    cfg = RLConfig(kl_coef=kl_coef, entropy_coef=entropy_coef)
    behav, adv, mask = (torch.from_numpy(b[k]) for k in ("behav", "adv",
                                                         "mask"))
    alpha = objective.resolve_alpha(cfg, versions=torch.from_numpy(
        b["versions"]), current_version=3)
    ct = torch.tensor(0.7)
    out = []
    for loss_fn in (objective.fused_a3po_loss, _eager_a3po_loss):
        x = torch.from_numpy(b["logp"].copy()).requires_grad_(True)
        ent = (torch.from_numpy(b["entropy"].copy()).requires_grad_(True)
               if with_entropy else None)
        loss, m = loss_fn(x, behav, alpha, adv, mask, cfg, ent)
        loss.backward(ct)
        out.append((loss, m, x.grad, None if ent is None else ent.grad))
    (l1, m1, g1, e1), (l2, m2, g2, e2) = out
    assert torch.equal(l1, l2)
    assert m1.keys() == m2.keys()
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert torch.equal(g1, g2)
    assert (e1 is None) == (e2 is None)
    if e1 is not None:
        assert torch.equal(e1, e2)


def test_a3po_loss_dispatches_at_most_16_ops():
    """``A3PO.loss`` + its backward at one minibatch of the training step
    (B 4 x T 575, per-token version stamps, an entropy that carries a
    gradient) dispatch at most 16 ops that are not aliases (view, detach,
    expand, select, unbind launch no device kernel), the reduced op's
    forward and backward counted as one each: the alpha schedule's ~10,
    the op, the root cotangent and the op's backward. The eager sequence
    dispatched 58."""
    from torch.utils._python_dispatch import (
        TorchDispatchMode,
        _disable_current_modes,
    )

    from repro_torch.kernels.a3po_loss import ops as aops

    seen = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                seen.append(str(func))
            return func(*args, **(kwargs or {}))

    def as_one(fn, name):
        def run(*args, **kw):
            seen.append(name)
            with _disable_current_modes():
                return fn(*args, **kw)
        return run

    rng = np.random.default_rng(12)
    shape = (4, 575)
    x = torch.from_numpy((-rng.random(shape) * 3).astype(np.float32))
    x.requires_grad_(True)
    ent = torch.from_numpy(rng.random(shape).astype(np.float32))
    ent.requires_grad_(True)
    batch = algorithms.LossInputs(
        advantages=torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)),
        mask=torch.from_numpy((rng.random(shape) > 0.3).astype(np.float32)),
        behav_logp=torch.from_numpy(
            (-rng.random(shape) * 3).astype(np.float32)),
        versions=torch.from_numpy(
            rng.integers(0, 3, size=shape).astype(np.int32)),
        current_version=torch.tensor(3, dtype=torch.int32), entropy=ent)
    saved = aops.a3po_reduced_ref, aops.a3po_reduced_bwd_ref
    aops.a3po_reduced_ref = as_one(saved[0], "reduced_forward")
    aops.a3po_reduced_bwd_ref = as_one(saved[1], "reduced_backward")
    try:
        with Count():
            loss, _ = algorithms.get_algorithm("a3po").loss(
                x, batch, RLConfig(entropy_coef=0.01))
            loss.backward()
    finally:
        aops.a3po_reduced_ref, aops.a3po_reduced_bwd_ref = saved
    assert seen.count("reduced_forward") == 1
    assert seen.count("reduced_backward") == 1
    assert len(seen) <= 16, seen
    assert x.grad is not None and ent.grad is not None
