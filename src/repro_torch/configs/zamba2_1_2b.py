"""Zamba2-1.2B [arXiv:2411.15242].

Hybrid Mamba2 backbone with a *shared* attention(+MLP) block applied
periodically: 38L, d_model=2048, attn 32 heads (MHA kv=32), d_ff=8192,
ssm_state=64, vocab=32000. We wire the shared block every 6th layer
(6 applications, one parameter set), matching Zamba2's shared-block design.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    attn_every=6,
    share_attn_params=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    tie_embeddings=True,
)
