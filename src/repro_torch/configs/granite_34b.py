"""Granite 34B code model [arXiv:2405.04324].

Llama-arch dense decoder with MQA: 88L, d_model=6144, 48 heads (kv=1),
d_ff=24576, vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    arch_type="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,  # granite code models use attention biases
    rope_theta=10_000_000.0,
)
