"""First-class Algorithm API: pluggable policy-optimization algorithms
(``repro.core.algorithms``).

An ``Algorithm`` is a frozen, hashable dataclass that declares

* its **data requirements** as class-level flags: ``needs_behav_logp``,
  ``needs_prox_forward``, ``needs_versions``, ``needs_group_rewards``,
  which the trainer reads to decide what a step computes at all (only
  ``recompute`` pays the extra prox forward pass);
* its **loss**: ``loss(logp, batch, cfg) -> (loss, Metrics)`` over a
  ``LossInputs`` bundle; every loss emits the full shared metric set
  (``common_metrics`` + ``kl``), so the trainer's packed metric vector is
  algorithm-independent;
* optional **hooks**: ``advantages`` (default GRPO group normalization)
  and ``alpha`` (default ``resolve_alpha``).

Built-ins: the paper's three methods (``sync``, ``recompute``, ``a3po``
with alias ``loglinear``, routed through the fused ``kernels/a3po_loss``
kernel) and two beyond-paper ones: ``asympo`` (behavior-free
asymmetric-scale correction) and ``grpo_mu`` (staleness-gated
importance-weight truncation).

Registering a new algorithm:

    @register("my_algo")
    @dataclasses.dataclass(frozen=True)
    class MyAlgo(Algorithm):
        my_knob: float = 1.0
        def loss(self, logp, batch, cfg):
            ...
            return loss, metrics
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, ClassVar, Dict, List, NamedTuple,
                    Optional, Tuple, Type)

import torch

from repro_torch.configs.base import AlgoConfig, RLConfig
from repro_torch.core.a3po import staleness
from repro_torch.core.advantages import group_normalized_advantages
from repro_torch.core.objective import (
    Metrics,
    apply_regularizers,
    clip_objective,
    common_metrics,
    coupled_ppo_loss,
    decoupled_ppo_loss,
    fused_a3po_loss,
    masked_mean,
    resolve_alpha,
)


class LossInputs(NamedTuple):
    """Everything an algorithm may see besides the live ``logp``. Fields an
    algorithm did not request through its requires-flags may be None."""

    advantages: torch.Tensor = None            # [B, T] token advantages
    mask: torch.Tensor = None                  # [B, T] response mask
    behav_logp: Optional[torch.Tensor] = None  # log pi_behav [B, T]
    versions: Optional[torch.Tensor] = None    # behavior versions [B] | [B,T]
    current_version: Any = None                # v(pi_theta), int or 0-d
    prox_logp: Optional[torch.Tensor] = None   # recomputed prox anchor [B,T]
    entropy: Optional[torch.Tensor] = None     # per-token entropy [B, T]


@dataclasses.dataclass(frozen=True)
class Algorithm(AlgoConfig):
    """A policy-optimization algorithm: requires-flags + loss + hooks.

    Subclasses are frozen dataclasses whose fields are the algorithm's
    hyperparameters; the class-level flags are static metadata the trainer
    branches on in Python, never on a device value.
    """

    name: ClassVar[str] = "abstract"
    # ---- data requirements (static; read by the trainer) ----
    needs_behav_logp: ClassVar[bool] = True
    needs_prox_forward: ClassVar[bool] = False
    needs_versions: ClassVar[bool] = True
    needs_group_rewards: ClassVar[bool] = True
    # on-policy algorithms get staleness-0 schedules from drivers
    on_policy: ClassVar[bool] = False

    def loss(self, logp: torch.Tensor, batch: LossInputs, cfg: RLConfig
             ) -> Tuple[torch.Tensor, Metrics]:
        raise NotImplementedError

    # ---- optional hooks ----
    def advantages(self, rewards: torch.Tensor, mask: torch.Tensor,
                   cfg: RLConfig) -> torch.Tensor:
        """[B] rewards -> [B, T] token advantages. Default: GRPO group
        normalization; without a group layout, batch-level normalization
        (population std, as ``jnp.std``)."""
        if self.needs_group_rewards:
            adv = group_normalized_advantages(rewards, cfg.group_size)
        else:
            r = rewards.float()
            adv = (r - r.mean()) / (r.std(unbiased=False) + 1e-6)
        return adv[:, None] * mask

    def alpha(self, cfg: RLConfig, **kw) -> torch.Tensor:
        """Prox-interpolation weight; default the unified schedule
        dispatch (staleness schedules + the kl_adaptive controller)."""
        return resolve_alpha(cfg, **kw)


# ------------------------------------------------------------------ registry
_REGISTRY: Dict[str, Type[Algorithm]] = {}
_ALIASES: Dict[str, str] = {}


def register(name: str, *, aliases: Tuple[str, ...] = ()
             ) -> Callable[[Type[Algorithm]], Type[Algorithm]]:
    """Class decorator: ``@register("name")`` adds an Algorithm subclass
    to the registry (and stamps ``cls.name``)."""
    def deco(cls: Type[Algorithm]) -> Type[Algorithm]:
        assert issubclass(cls, Algorithm), cls
        names = (name,) + tuple(aliases)
        # a collision leaves the registry untouched, not half-registered
        for n in names:
            if n in _REGISTRY:
                raise ValueError(f"algorithm {n!r} already registered "
                                 f"({_REGISTRY[n].__name__})")
        cls.name = name
        for n in names:
            _REGISTRY[n] = cls
        for a in aliases:
            _ALIASES[a] = name
        return cls
    return deco


def unregister(name: str) -> None:
    """Remove an algorithm (by name or alias) and all its aliases."""
    canonical = _ALIASES.get(name, name)
    cls = _REGISTRY.pop(canonical, None)
    if cls is None:
        return
    for n in [k for k, v in _REGISTRY.items() if v is cls]:
        del _REGISTRY[n]
    for a in [a for a, c in _ALIASES.items() if c == canonical]:
        del _ALIASES[a]


def available() -> List[str]:
    """Canonical registered names (aliases folded in)."""
    return sorted({cls.name for cls in _REGISTRY.values()})


def get_algorithm(name: str, **overrides) -> Algorithm:
    """Instantiate a registered algorithm by name (or alias); keyword
    overrides become hyperparameter fields of the frozen instance."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; available: {available()} "
            f"(aliases: {sorted(_ALIASES)})") from None
    return cls(**overrides)


def resolve_algorithm(spec=None, rl: Optional[RLConfig] = None) -> Algorithm:
    """Algorithm instance | registry name | None (falls back to
    ``rl.algo``, then the deprecated ``rl.method`` string, then ``a3po``)."""
    if isinstance(spec, Algorithm):
        return spec
    if isinstance(spec, str):
        return get_algorithm(spec)
    if spec is not None:
        raise TypeError(f"algo must be an Algorithm or registry name, "
                        f"got {type(spec).__name__}")
    if rl is not None:
        if rl.algo is not None:
            assert isinstance(rl.algo, Algorithm), rl.algo
            return rl.algo
        return get_algorithm(rl.method)
    return get_algorithm("a3po")


def registry_table() -> List[Dict[str, Any]]:
    """One row per registered algorithm: name, aliases, requires-flags,
    hyperparameter fields, first docstring line."""
    rows = []
    for name in available():
        cls = _REGISTRY[name]
        rows.append({
            "name": name,
            "aliases": sorted(a for a, c in _ALIASES.items() if c == name),
            "needs_behav_logp": cls.needs_behav_logp,
            "needs_prox_forward": cls.needs_prox_forward,
            "needs_versions": cls.needs_versions,
            "needs_group_rewards": cls.needs_group_rewards,
            "on_policy": cls.on_policy,
            "fields": {f.name: f.default
                       for f in dataclasses.fields(cls)},
            "doc": ((cls.__doc__ or "").strip().splitlines() or [""])[0],
        })
    return rows


# ----------------------------------------------------------------- built-ins
@register("sync")
@dataclasses.dataclass(frozen=True)
class SyncPPO(Algorithm):
    """Coupled PPO/GRPO (paper Eq. 1): pi_old is IS weight + anchor."""

    needs_versions: ClassVar[bool] = False
    on_policy: ClassVar[bool] = True

    def loss(self, logp, batch, cfg):
        return coupled_ppo_loss(logp, batch.behav_logp, batch.advantages,
                                batch.mask, cfg, batch.entropy)


@register("recompute")
@dataclasses.dataclass(frozen=True)
class RecomputePPO(Algorithm):
    """Decoupled PPO (paper Eq. 2) with the explicitly recomputed proximal
    anchor — the per-step forward pass A-3PO deletes."""

    needs_prox_forward: ClassVar[bool] = True
    needs_versions: ClassVar[bool] = False

    def loss(self, logp, batch, cfg):
        assert batch.prox_logp is not None, \
            "recompute needs the explicit prox forward pass"
        return decoupled_ppo_loss(logp, batch.behav_logp, batch.prox_logp,
                                  batch.advantages, batch.mask, cfg,
                                  batch.entropy)


@register("a3po", aliases=("loglinear",))
@dataclasses.dataclass(frozen=True)
class A3PO(Algorithm):
    """A-3PO (paper Eq. 3-4): log-linear prox approximation through the
    fused kernel, alpha from the staleness-aware schedule."""

    # overrides cfg.alpha_schedule when set (nested per-algorithm config)
    schedule: Optional[str] = None

    def loss(self, logp, batch, cfg):
        alpha = self.alpha(
            cfg, versions=batch.versions,
            current_version=batch.current_version, logp=logp,
            behav_logp=batch.behav_logp, mask=batch.mask,
            schedule=self.schedule)
        return fused_a3po_loss(logp, batch.behav_logp, alpha,
                               batch.advantages, batch.mask, cfg,
                               batch.entropy)


@register("asympo")
@dataclasses.dataclass(frozen=True)
class ASymPO(Algorithm):
    """Behavior-free asymmetric-scale correction (after ASymPO).

    The surrogate ratio is taken against the detached live policy
    (identically 1 in value, the policy gradient in derivative), and
    staleness-induced over-optimism is countered by scaling negative-
    advantage tokens harder than positive ones, so rollout workers never
    ship ``behav_logp`` (``needs_behav_logp = False``).
    """

    pos_scale: float = 1.0
    neg_scale: float = 1.5

    needs_behav_logp: ClassVar[bool] = False
    needs_versions: ClassVar[bool] = False

    def loss(self, logp, batch, cfg):
        logp = logp.float()
        anchor = logp.detach()
        ratio = torch.exp(logp - anchor)  # == 1; gradient = d logp
        scale = torch.where(batch.advantages >= 0.0, self.pos_scale,
                            self.neg_scale).float()
        obj, was_clipped = clip_objective(ratio, scale * batch.advantages,
                                          cfg.clip_eps)
        loss = -masked_mean(obj, batch.mask)
        metrics = common_metrics(torch.ones_like(ratio), ratio, was_clipped,
                                 batch.mask, batch.entropy)
        return apply_regularizers(loss, metrics, logp, anchor, batch.mask,
                                  cfg, batch.entropy)


@register("grpo_mu")
@dataclasses.dataclass(frozen=True)
class MuGRPO(Algorithm):
    """Staleness-gated importance-weight truncation (after mu-GRPO).

    Coupled GRPO ratios, but the importance weight of a token generated
    ``d`` versions ago is truncated at ``1 + clip_eps * mu**d``: fresh
    tokens keep the full PPO clip range, stale ones cannot be up-weighted.
    """

    mu: float = 0.7

    def loss(self, logp, batch, cfg):
        logp = logp.float()
        behav = batch.behav_logp.float()
        d = staleness(batch.versions, batch.current_version)
        if d.dim() == logp.dim() - 1:
            d = d[..., None]
        cap = 1.0 + cfg.clip_eps * torch.pow(self.mu, d)
        ratio = torch.exp(logp - behav)
        trunc = torch.minimum(ratio, cap.detach())
        obj, was_clipped = clip_objective(trunc, batch.advantages,
                                          cfg.clip_eps)
        loss = -masked_mean(obj, batch.mask)
        metrics = common_metrics(trunc, ratio, was_clipped, batch.mask,
                                 batch.entropy)
        return apply_regularizers(loss, metrics, logp, behav, batch.mask,
                                  cfg, batch.entropy)


BUILTINS: Tuple[str, ...] = ("sync", "recompute", "a3po", "asympo",
                             "grpo_mu")
