"""RL training engine: one update per training step
(``repro.training.trainer``).

Matches the paper's procedure (§4.1): a *training step* consumes a rollout
batch, optionally recomputes the proximal policy with an extra forward pass
(the ``recompute`` baseline, the cost A-3PO deletes), then performs
``num_minibatches`` gradient updates with the frozen anchor.

The step runs eagerly on the device: advantages, the minibatch loop (each
minibatch optionally accumulated over microbatches, weighted by response
tokens), Adam and the metrics. Every metric of the step is packed into one
float32 vector, so a step costs exactly one device-to-host transfer (plus
the explicit prox forward's wait for ``recompute``, which is the point of
the comparison). Nothing else in a step reads a device value on the host:
the non-finite guard and the Adam bias corrections select and scale on the
device.

Scoring runs the fused ``kernels/logprob`` op (the [T, V] logits never
reach device memory on the card) and the ``a3po`` loss the fused
``kernels/a3po_loss`` op, each with its backward.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.core.algorithms import Algorithm, LossInputs, resolve_algorithm
from repro_torch.distributed.sharding import (
    constrain,
    current_env,
    shard_tensor,
    shard_tree,
)
from repro_torch.kernels.logprob import token_logprob_entropy
from repro_torch.models import model as M
from repro_torch.models.layers import output_head_weight
from repro_torch.models.params import ParamTree
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.tracing import span
from repro_torch.rollout.engine import RolloutBatch
from repro_torch.training.optimizer import (
    adam_init,
    adam_update,
    flatten,
    global_norm,
    unflatten,
)


class TrainState(NamedTuple):
    params: Any          # ParamTree
    opt: Any             # {"m": tree, "v": tree, "t": 0-d int32 tensor}
    version: torch.Tensor  # 0-d int32: the target-policy version v(pi_theta)


@dataclasses.dataclass
class TrainBatch:
    """Device-ready training batch assembled from rollouts."""

    tokens: torch.Tensor         # [B, T] int64
    response_mask: torch.Tensor  # [B, T-1] (1 on generated-token predictions)
    behav_logp: torch.Tensor     # [B, T-1] (0 outside mask)
    # behavior policy versions: [B] (one per sequence) or [B, T-1]
    # (per-token stamps from the serving engine)
    versions: torch.Tensor
    rewards: torch.Tensor        # [B]


def assemble_train_batch(rollouts: List[RolloutBatch], rewards: np.ndarray,
                         device="cuda") -> TrainBatch:
    """Scatter ragged generation logps into [B, T-1] aligned tensors.

    If any rollout carries per-token version stamps (``gen_versions``),
    ``versions`` is [B, T-1] so staleness sees the true per-token ``d``;
    otherwise it is [B]. Position t predicts tokens[t+1], so row b's
    generated span starts at column prompt_lengths[b] - 1: one vectorised
    write per rollout. The tensors land on ``device`` here, so a step
    copies nothing from the host.
    """
    device = M.require_device(device)
    tokens = np.concatenate([r.tokens for r in rollouts], axis=0)
    B, T = tokens.shape
    behav = np.zeros((B, T - 1), np.float32)
    mask = np.zeros((B, T - 1), np.float32)
    per_token = any(r.gen_versions is not None for r in rollouts)
    versions = np.zeros((B, T - 1) if per_token else (B,), np.int32)
    row = 0
    for r in rollouts:
        N = r.gen_logp.shape[1]
        rows = slice(row, row + r.batch_size)
        cols = (np.asarray(r.prompt_lengths, np.int64) - 1)[:, None] \
            + np.arange(N)[None, :]
        np.put_along_axis(behav[rows], cols,
                          np.asarray(r.gen_logp, np.float32), axis=1)
        np.put_along_axis(mask[rows], cols,
                          np.asarray(r.gen_mask, np.float32), axis=1)
        versions[rows] = r.version
        if per_token and r.gen_versions is not None:
            stamped = np.where(r.gen_mask > 0, r.gen_versions,
                               r.version).astype(np.int32)
            np.put_along_axis(versions[rows], cols, stamped, axis=1)
        row += r.batch_size

    def dev(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return TrainBatch(tokens=dev(tokens, torch.long),
                      response_mask=dev(mask, torch.float32),
                      behav_logp=dev(behav, torch.float32),
                      versions=dev(versions, torch.int32),
                      rewards=dev(np.asarray(rewards, np.float32),
                                  torch.float32))


# --------------------------------------------------------------------- score
def _score_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logp, entropy) [B, T-1] of tokens[:, 1:] and the model's
    auxiliary loss (the MoE load-balance loss; zero without MoE)."""
    tokens = constrain(tokens, "batch", None)
    hidden, aux = M.forward_hidden(params, cfg, tokens[:, :-1])
    w = output_head_weight(params["embedding"], cfg)
    logp, entropy = token_logprob_entropy(hidden, w, tokens[:, 1:])
    return (constrain(logp, "batch", None), constrain(entropy, "batch", None),
            aux)


@torch.no_grad()
def score_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-position logp of tokens[t+1] + entropy, no gradient. Returns
    ([B,T-1] x 2, aux) through the fused logprob op: the computation the
    ``recompute`` baseline pays for every training step."""
    return _score_tokens(params, cfg, tokens)


@torch.no_grad()
def recompute_prox_logp(params, cfg: ModelConfig,
                        tokens: torch.Tensor) -> torch.Tensor:
    """The explicit proximal forward pass of decoupled PPO (Hilton 2022):
    the per-step cost A-3PO eliminates (paper Fig. 1)."""
    return _score_tokens(params, cfg, tokens)[0]


# ---------------------------------------------------------------- the step
# Fixed pack order of the metrics vector: the step's one device->host
# transfer.
METRIC_KEYS: Tuple[str, ...] = (
    "clipped_frac", "clipped_tokens", "entropy", "grad_norm", "iw_max",
    "iw_mean", "iw_min", "kl", "loss", "nonfinite", "ratio_mean",
    "reward_mean", "staleness_mean", "tokens",
)


def _reduce_metrics(stacked: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Fold [n]-stacked per-minibatch metrics: means, except the extremes
    and the sums."""
    out = {k: v.mean(dim=0) for k, v in stacked.items()}
    if "iw_max" in stacked:
        out["iw_max"] = stacked["iw_max"].max(dim=0).values
    if "iw_min" in stacked:
        out["iw_min"] = stacked["iw_min"].min(dim=0).values
    if "clipped_tokens" in stacked:
        out["clipped_tokens"] = stacked["clipped_tokens"].sum(dim=0)
    if "nonfinite" in stacked:
        # minibatches whose update was non-finite: a count, not a mean
        out["nonfinite"] = stacked["nonfinite"].sum(dim=0)
    return out


def _stack(ms: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def _slice(t: Dict[str, torch.Tensor], i: int, n: int):
    return {k: v[i * n: (i + 1) * n] for k, v in t.items()}


def _constrain_batch(t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: constrain(v, *(("batch",) + (None,) * (v.dim() - 1)))
            for k, v in t.items()}


def _trainable_views(flat_p: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Detached views of the parameters that require gradients: the
    forward runs on them, so the caller's tensors record nothing."""
    return {k: p.detach().requires_grad_(True) for k, p in flat_p.items()}


def _grads(loss: torch.Tensor, views: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    grads = torch.autograd.grad(loss, list(views.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(views[k]) if g is None else g
            for k, g in zip(views, grads)}


def _loss_and_grads(flat_p: Dict[str, torch.Tensor], t, *, cfg, rl, algo,
                    version):
    """(loss, detached metrics, grads by path) of one (micro)batch, in
    three spans: the model's forward, the objective and the backward."""
    views = _trainable_views(flat_p)
    with span("train_forward"):
        logp, entropy, aux = _score_tokens(unflatten(views), cfg,
                                           t["tokens"])
    with span("train_objective"):
        loss, metrics = algo.loss(logp, LossInputs(
            advantages=t["advantages"], mask=t["mask"],
            behav_logp=t.get("behav_logp"), versions=t.get("versions"),
            current_version=version, prox_logp=t.get("prox"),
            entropy=entropy), rl)
        loss = loss + aux
    with span("train_backward"):
        grads = _grads(loss, views)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _grads_of(flat_p, t, nmi: int, **kw):
    if nmi == 1:
        return _loss_and_grads(flat_p, t, **kw)
    # Accumulate weighted by each microbatch's response-token count: the
    # losses are masked means, so an equal average would over-weight
    # tokens in sparse microbatches against the one-pass minibatch.
    n = t["tokens"].shape[0] // nmi
    g_acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in flat_p.items()}
    loss_acc = w_acc = 0.0
    ms = []
    for j in range(nmi):
        mi = _slice(t, j, n)
        w = mi["mask"].sum()
        loss, metrics, grads = _loss_and_grads(flat_p, mi, **kw)
        for k, g in grads.items():
            g_acc[k] += w * g.float()
        loss_acc = loss_acc + w * loss
        w_acc = w_acc + w
        ms.append(metrics)
    w_tot = torch.clamp_min(w_acc, 1.0)
    grads = {k: g / w_tot for k, g in g_acc.items()}
    return loss_acc / w_tot, _reduce_metrics(_stack(ms)), grads


def _train_step(params, opt, version, batch: TrainBatch,
                prox: Optional[torch.Tensor], *, cfg: ModelConfig,
                rl: RLConfig, algo: Algorithm, num_minibatches: int,
                num_microbatches: int, skip_nonfinite: bool,
                donate_params: bool):
    """One training step: advantages -> minibatch updates (optionally
    accumulated over microbatches) -> packed metrics [len(METRIC_KEYS)].
    The Adam state is updated in place; the parameters in place only with
    ``donate_params``, else new tensors are returned and the old ones stay
    intact. The algorithm's requires-flags decide which batch tensors its
    loss sees."""
    tokens, mask, versions = batch.tokens, batch.response_mask, batch.versions
    rewards = batch.rewards
    B = tokens.shape[0]
    nmb = num_minibatches
    mb_size = B // nmb
    nmi = (num_microbatches
           if num_microbatches > 1 and mb_size % num_microbatches == 0
           else 1)

    advantages = algo.advantages(rewards, mask, rl)
    # full-batch staleness telemetry
    d = version.float() - versions.float()
    if versions.dim() == 2:
        # per-token stamps: response tokens only (prompt positions carry a
        # filler version, not behavior staleness)
        staleness_mean = (d * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    else:
        staleness_mean = d.mean()

    mbt = dict(tokens=tokens, advantages=advantages, mask=mask)
    if algo.needs_behav_logp:
        mbt["behav_logp"] = batch.behav_logp
    if algo.needs_versions:
        mbt["versions"] = versions
    if prox is not None:
        mbt["prox"] = prox
    mbt = _constrain_batch(mbt)

    flat_p = flatten(params)
    kw = dict(cfg=cfg, rl=rl, algo=algo, version=version)
    stacked = []
    # rows beyond nmb * mb_size are dropped from updates (they still count
    # toward reward/staleness telemetry above)
    for i in range(nmb):
        loss, metrics, grads = _grads_of(
            flat_p, _constrain_batch(_slice(mbt, i, mb_size)), nmi, **kw)
        with span("train_optimizer"):
            gnorm = global_norm(grads)
            # non-finite guard on the device: grad_norm is a global
            # reduction, so one flag covers the loss and every gradient;
            # with skip_nonfinite a poisoned minibatch leaves params and
            # the whole Adam state (moments and t) as they were
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            flat_p = flatten(adam_update(
                grads, opt, flat_p, rl, donate_params=donate_params,
                gnorm=gnorm, apply=ok if skip_nonfinite else None)[0])
        stacked.append(dict(metrics, loss=loss, grad_norm=gnorm,
                            nonfinite=(~ok).float()))
    out = _reduce_metrics(_stack(stacked))
    out["reward_mean"] = rewards.mean()
    out["staleness_mean"] = staleness_mean
    # response tokens that received a gradient
    out["tokens"] = mask[: nmb * mb_size].sum()
    assert set(out) == set(METRIC_KEYS), sorted(out)
    packed = torch.stack([out[k].float() for k in METRIC_KEYS])
    if not donate_params:
        grad = any(p.requires_grad for p in flatten(params).values())
        params = ParamTree(unflatten(flat_p), requires_grad=grad)
    return params, opt, packed


# -------------------------------------------------------------------- driver
class Trainer:
    """One training engine. ``step`` = the paper's 'training step'.

    ``algo`` selects the policy-optimization algorithm: an ``Algorithm``
    from ``core.algorithms``, a registry name, or None (falls back to
    ``rl.algo`` / the deprecated ``rl.method``). The legacy ``method=``
    keyword still works but emits a ``DeprecationWarning``.

    ``num_microbatches`` > 1 accumulates gradients over microbatches inside
    each minibatch. ``donate_params=False`` (the default) returns new
    parameter tensors and leaves the old ones intact (an async runtime
    reads them as behaviour weights); ``True`` updates them in place. The
    Adam state is always updated in place. ``skip_nonfinite`` drops a
    non-finite minibatch update on the device; the ``nonfinite`` metric
    counts them.
    """

    def __init__(self, cfg: ModelConfig, rl: Optional[RLConfig] = None,
                 algo=None, *, method: Optional[str] = None,
                 num_microbatches: int = 1, donate_params: bool = False,
                 skip_nonfinite: bool = False):
        if method is not None:
            warnings.warn(
                "Trainer(..., method=...) is deprecated; pass an Algorithm "
                "or registry name as `algo` (repro_torch.core.algorithms)",
                DeprecationWarning, stacklevel=2)
            if algo is None:
                algo = method
        self.cfg = cfg
        self.rl = rl or RLConfig()
        self.algo = resolve_algorithm(algo, self.rl)
        self.num_microbatches = num_microbatches
        self.donate_params = donate_params
        self.skip_nonfinite = skip_nonfinite
        self.last_host_syncs = 0  # host transfers in the most recent step

    @property
    def method(self) -> str:
        """Legacy spelling: the resolved algorithm's registry name."""
        return self.algo.name

    def init_state(self, generator: Optional[torch.Generator] = None,
                   dtype: Optional[torch.dtype] = None,
                   device="cuda") -> TrainState:
        """Seeded trainable params, zero Adam moments, version 0; placed
        with the active ``ShardingEnv``'s logical-axis rules when one is
        installed (DTensors on a mesh of more than one device)."""
        params = M.init_params(self.cfg, generator, device=device,
                               dtype=dtype, requires_grad=True)
        opt = adam_init(params)
        env = current_env()
        if env is not None:
            psh = M.param_shardings(self.cfg, env)
            params = ParamTree(shard_tree(params, psh), requires_grad=True)
            opt = {"m": shard_tree(opt["m"], psh),
                   "v": shard_tree(opt["v"], psh),
                   "t": shard_tensor(opt["t"], env.sharding((), ()))}
        return TrainState(params, opt,
                          torch.zeros((), dtype=torch.int32,
                                      device=M.require_device(device)))

    def step(self, state: TrainState, batch: TrainBatch
             ) -> Tuple[TrainState, Dict[str, float]]:
        rl = self.rl
        B = batch.tokens.shape[0]
        nmb = min(rl.num_minibatches, B)
        if self.num_microbatches > 1 \
                and (B // nmb) % self.num_microbatches != 0:
            raise ValueError(
                f"num_microbatches={self.num_microbatches} does not divide "
                f"the minibatch size {B // nmb} (B={B}, nmb={nmb}); the "
                "memory-saving accumulation would be silently skipped")
        host_syncs = 0

        # explicit prox forward pass, paid only by algorithms that declare
        # needs_prox_forward (the recompute baseline)
        prox, prox_time = None, 0.0
        if self.algo.needs_prox_forward:
            t0 = time.perf_counter()
            with span("prox_forward", algo=self.algo.name):
                prox = recompute_prox_logp(state.params, self.cfg,
                                           batch.tokens)
                self._wait(prox)
            host_syncs += 1
            prox_time = time.perf_counter() - t0

        with span("train_update", algo=self.algo.name, batch=int(B),
                  minibatches=int(nmb)):
            params, opt, packed = _train_step(
                state.params, state.opt, state.version, batch, prox,
                cfg=self.cfg, rl=rl, algo=self.algo, num_minibatches=nmb,
                num_microbatches=self.num_microbatches,
                skip_nonfinite=self.skip_nonfinite,
                donate_params=self.donate_params)
            values = self._to_host(packed)  # the step's one transfer
        host_syncs += 1
        out = {k: float(v) for k, v in zip(METRIC_KEYS, values)}
        out["prox_time_s"] = prox_time
        out["host_syncs"] = float(host_syncs)
        self.last_host_syncs = host_syncs
        self._publish_metrics(out)
        return TrainState(params, opt, state.version + 1), out

    @staticmethod
    def _to_host(packed: torch.Tensor) -> np.ndarray:
        """The one device-to-host transfer of a step."""
        return packed.cpu().numpy()

    @staticmethod
    def _wait(t: torch.Tensor) -> None:
        """Wait for the device to finish ``t`` (the prox pass's timing)."""
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()

    # training-side metrics mirrored into the process-wide obs registry
    # (gauges: latest step's value; counters: lifetime accumulation)
    _GAUGE_KEYS = ("loss", "reward_mean", "entropy", "grad_norm",
                   "iw_max", "iw_min", "iw_mean", "kl", "clipped_frac",
                   "ratio_mean", "staleness_mean", "prox_time_s")
    _COUNTER_KEYS = ("tokens", "clipped_tokens", "host_syncs", "nonfinite")

    def _publish_metrics(self, out: Dict[str, float]) -> None:
        reg = get_registry()
        for k in self._GAUGE_KEYS:
            if k in out:
                reg.gauge(f"train_{k}").set(out[k])
        for k in self._COUNTER_KEYS:
            if k in out:
                reg.counter(f"train_{k}_total").inc(out[k])
        reg.counter("train_steps_total").inc()


# ----------------------------------------------------------------- SFT warmup
def sft_update(cfg: ModelConfig, params, opt, tokens: torch.Tensor,
               mask: torch.Tensor, lr: float = 1e-3):
    """One supervised step on masked token cross-entropy: returns (new
    params, opt (updated in place), loss)."""
    rl = RLConfig(learning_rate=lr, max_grad_norm=1.0)
    views = _trainable_views(flatten(params))
    logp, _, aux = _score_tokens(unflatten(views), cfg, tokens)
    loss = -(logp * mask).sum() / torch.clamp_min(mask.sum(), 1.0) + aux
    params, opt, _ = adam_update(_grads(loss, views), opt, params, rl)
    return params, opt, loss.detach()
