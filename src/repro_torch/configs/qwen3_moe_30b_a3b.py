"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

MoE decoder: 48L, d_model=2048, 32 heads (kv=4, head_dim=128), 128 experts
top-8 with per-expert d_ff=768, vocab=151936. No shared experts.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per-expert width (kept for reference; MoEConfig governs)
    vocab_size=151936,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    rope_theta=1_000_000.0,
)
