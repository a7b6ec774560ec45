"""The paper's own experiment models (§4.1) plus toy models for CPU runs.

Setup 1: Qwen2.5-1.5B-Instruct on GSM8K.
Setup 2: Qwen3-8B on DAPO-Math-17k.

``toy-*`` configs drive the end-to-end CPU examples / integration tests.
"""
from repro_torch.configs.base import ModelConfig

QWEN25_1_5B = ModelConfig(
    name="qwen2.5-1.5b",
    arch_type="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

QWEN3_8B = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    rope_theta=1_000_000.0,
)

# ~20M params: the end-to-end RL example model (trainable on CPU).
TOY_20M = ModelConfig(
    name="toy-20m",
    arch_type="dense",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=1024,
    vocab_size=64,
    tie_embeddings=True,
    remat=False,
)

# ~2M params: fast integration-test model.
TOY_2M = ModelConfig(
    name="toy-2m",
    arch_type="dense",
    num_layers=2,
    d_model=128,
    num_heads=2,
    num_kv_heads=1,
    head_dim=64,
    d_ff=512,
    vocab_size=64,
    tie_embeddings=True,
    remat=False,
)
