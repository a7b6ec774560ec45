"""Config dataclasses for models, input shapes, and RL training.

Every assigned architecture is expressed as a ``ModelConfig``; the A-3PO
algorithm settings live in ``RLConfig``. Configs are frozen dataclasses so
they can be hashed into jit static args.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (capacity-based top-k routing)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 style Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-style LM. ``arch_type`` selects the block wiring."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // num_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid wiring: an attention(+MLP) block every `attn_every` layers
    # (0 => attention-free / pure SSM; 1 => every layer is attention).
    attn_every: int = 1
    share_attn_params: bool = False  # Zamba2-style shared attention block
    parallel_block: bool = False  # Cohere-style parallel attn+FFN
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # static window; None = full causal
    # Window applied only at the long-context decode shape for full-attention
    # archs (the documented sub-quadratic variant). SSM archs ignore it.
    long_context_window: int = 8192
    tie_embeddings: bool = False
    frontend: Optional[str] = None  # audio | vision (embedding stubs)
    frontend_tokens: int = 0  # patch/frame embeddings prepended to the text
    dtype: str = "bfloat16"
    remat: bool = True  # activation checkpointing across the layer scan

    # ----- derived helpers -------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.attn_every == 0

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn' (attention [+FFN]) or 'ssm'."""
        if self.arch_type in ("ssm",):
            return ("ssm",) * self.num_layers
        if self.arch_type == "hybrid":
            kinds = []
            for i in range(self.num_layers):
                if self.attn_every > 0 and (i % self.attn_every) == (self.attn_every - 1):
                    kinds.append("attn")
                else:
                    kinds.append("ssm")
            return tuple(kinds)
        return ("attn",) * self.num_layers

    def num_params(self) -> int:
        """Analytic parameter count (matches init; used for rooflines)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_attn = sum(1 for k in self.block_kinds() if k == "attn")
        n_ssm = self.num_layers - n_attn
        if self.share_attn_params and n_attn > 0:
            n_attn_unique = 1
        else:
            n_attn_unique = n_attn
        p = 0
        # embeddings (+ output head unless tied) + final norm
        p += self.vocab_size * d
        if not self.tie_embeddings:
            p += self.vocab_size * d
        p += d
        if self.frontend is not None:
            p += d * d  # frontend projector
        # attention blocks
        if n_attn_unique:
            if self.mla is not None:
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                per = (
                    d * self.num_heads * qk_dim  # q proj
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)  # down proj
                    + m.kv_lora_rank  # latent norm
                    + m.kv_lora_rank
                    * self.num_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)  # up proj
                    + self.num_heads * m.v_head_dim * d  # out proj
                )
            else:
                per = (
                    d * self.num_heads * hd
                    + 2 * d * self.num_kv_heads * hd
                    + self.num_heads * hd * d
                )
                if self.qkv_bias:
                    per += (self.num_heads + 2 * self.num_kv_heads) * hd
            ffn_per = self._ffn_params()
            n_norms = 1 if self.parallel_block else 2
            p += n_attn_unique * (per + ffn_per + n_norms * d)
        # ssm blocks
        if n_ssm:
            s = self.ssm or SSMConfig()
            din = s.d_inner(d)
            nh = s.num_heads(d)
            conv_dim = din + 2 * s.d_state
            per = (
                d * (2 * din + 2 * s.d_state + nh)  # in_proj -> x,z,B,C,dt
                + s.d_conv * conv_dim + conv_dim  # conv w + b
                + 3 * nh  # A_log, D, dt_bias
                + din  # gated RMSNorm
                + din * d  # out proj
                + d  # block norm
            )
            p += n_ssm * per
        return p

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            routed = m.num_experts * 3 * d * m.d_ff_expert
            shared = m.num_shared_experts * 3 * d * m.d_ff_expert
            router = d * m.num_experts
            return routed + shared + router
        return 3 * d * self.d_ff  # SwiGLU

    def num_active_params(self) -> int:
        """Active params/token (MoE counts only top_k + shared experts)."""
        if self.moe is None:
            return self.num_params()
        m = self.moe
        d = self.d_model
        inactive = (m.num_experts - m.top_k) * 3 * d * m.d_ff_expert
        n_moe_layers = sum(1 for k in self.block_kinds() if k == "attn")
        return self.num_params() - n_moe_layers * inactive


@dataclass(frozen=True)
class InputShape:
    """A (seq_len, global_batch, kind) workload point."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class AlgoConfig:
    """Base for per-algorithm hyperparameter blocks.

    Frozen (hashable) so an algorithm rides into jit static args together
    with ``RLConfig``. Concrete policy-optimization algorithms subclass
    this in ``repro.core.algorithms`` and add behavior (loss, hooks) on
    top of their hyperparameter fields; ``RLConfig.algo`` nests one.
    """


@dataclass(frozen=True)
class RLConfig:
    """A-3PO / decoupled-PPO algorithm settings (paper §4.1 defaults).

    Algorithm selection lives in ``algo`` (an ``Algorithm`` instance from
    ``repro.core.algorithms``); the stringly-typed ``method`` field is the
    deprecated pre-registry spelling, kept as a fallback the registry shim
    resolves (``resolve_algorithm``).
    """

    algo: Optional[AlgoConfig] = None  # nested per-algorithm config
    method: str = "loglinear"  # DEPRECATED: a3po/loglinear | recompute | sync
    alpha_schedule: str = "inverse"  # inverse (paper 1/d) | exp | clipped | const
    alpha_const: float = 0.5
    alpha_gamma: float = 0.5  # for exp schedule: alpha = gamma ** d
    alpha_clip: Tuple[float, float] = (0.1, 1.0)
    clip_eps: float = 0.2
    # behavior-weight clipping used by decoupled losses to bound pi_prox/pi_b
    behav_weight_cap: float = 5.0
    entropy_coef: float = 0.0
    # weight of the k1 KL(pi_theta || anchor) penalty added to every
    # algorithm's loss (the anchor is each algorithm's trust-region
    # reference: behavior, recomputed prox, or the log-linear prox)
    kl_coef: float = 0.0
    group_size: int = 4  # samples per prompt (group reward normalization)
    num_minibatches: int = 4  # gradient updates per training step
    learning_rate: float = 8.5e-6
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    max_staleness: int = 4  # AReaL-style bounded staleness gate
    temperature: float = 1.0
    top_p: float = 1.0


def reduced(cfg: ModelConfig, *, num_layers: int = 2, d_model: int = 256,
            vocab_size: int = 512) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    head_dim = 64
    num_heads = max(d_model // head_dim, 1)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    # keep the kv:q ratio flavour (MQA stays MQA, MHA stays MHA)
    if cfg.num_kv_heads == cfg.num_heads:
        num_kv = num_heads
    elif cfg.num_kv_heads == 1:
        num_kv = 1
    else:
        num_kv = max(1, num_heads // 2)
    changes = dict(
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=4 * d_model,
        vocab_size=vocab_size,
        remat=False,
    )
    if cfg.moe is not None:
        # capacity_factor 4.0: drop-free routing at smoke scale so the
        # decode-vs-full consistency check is exact
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff_expert=2 * d_model,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            capacity_factor=4.0)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32,
                                   qk_rope_head_dim=16, v_head_dim=32)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32,
                                             chunk_size=32)
    if cfg.arch_type == "hybrid":
        changes["num_layers"] = max(num_layers, cfg.attn_every)
    if cfg.frontend is not None:
        changes["frontend_tokens"] = 8
    return dataclasses.replace(cfg, **changes)
