"""MusicGen-large decoder [arXiv:2306.05284].

Decoder-only transformer over EnCodec tokens: 48L, d_model=2048, 32 heads
(MHA: kv=32), d_ff=8192, vocab=2048 (codebook size). The EnCodec conv
frontend is stubbed per assignment: ``input_specs`` supplies precomputed
frame embeddings which are prepended as the conditioning prefix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    frontend_tokens=512,  # conditioning frames (text/melody embedding stub)
    qkv_bias=False,
)
