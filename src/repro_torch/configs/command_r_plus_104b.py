"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01 family].

Dense GQA decoder: 64L, d_model=12288, 96 heads (kv=8), d_ff=33792,
vocab=256000. Cohere-style parallel attention+FFN block, no biases,
tied embeddings (Cohere ties input/output embeddings).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    parallel_block=True,
    qkv_bias=False,
    tie_embeddings=True,
    rope_theta=75_000_000.0,
)
