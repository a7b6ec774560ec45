"""DeepSeek-V2-Lite 16B [arXiv:2405.04434].

MoE decoder with Multi-head Latent Attention: 27L, d_model=2048, 16 heads,
MLA kv_lora_rank=512 (qk_nope=128, qk_rope=64, v=128), 64 routed experts
top-6 + 2 shared experts with per-expert d_ff=1408, vocab=102400.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: all heads read the shared latent; kept for spec
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
)
