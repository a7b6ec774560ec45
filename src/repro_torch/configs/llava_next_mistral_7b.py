"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

VLM whose language model is Mistral-7B: 32L, d_model=4096, 32 heads (kv=8),
d_ff=14336, vocab=32000. The ViT/CLIP vision tower + projector are stubbed
per assignment; anyres tiling yields up to 2880 patch embeddings which
``input_specs`` provides precomputed and the model prepends to the text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    frontend="vision",
    frontend_tokens=2880,  # anyres: 576 base + 4 x 576 tiles
    rope_theta=1_000_000.0,
)
