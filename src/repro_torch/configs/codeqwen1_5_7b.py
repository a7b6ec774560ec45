"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B].

Qwen1.5-arch dense decoder (MHA + qkv bias): 32L, d_model=4096, 32 heads
(kv=32), d_ff=13440, vocab=92416.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
