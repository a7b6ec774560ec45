"""Mamba2-370m [arXiv:2405.21060].

Attention-free SSD (state-space duality) stack: 48L, d_model=1024,
d_state=128, expand=2 (d_inner=2048, 32 SSD heads of dim 64), vocab=50280.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_every=0,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    tie_embeddings=True,
)
