"""A dense decoder (Qwen2: pre-norm RMSNorm blocks of GQA attention with
q/k/v biases and rotary embeddings, a SwiGLU MLP, a tied head), in the
port's weight layout: ``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``, the
layer axis first.

Departure from the published Qwen2, the port's: the tied input
embedding is scaled by sqrt(d). RMSNorm's epsilon is the
configuration's (Qwen2.5's 1e-6).
"""
from __future__ import annotations

import torch

from perfbench.reference.common import (
    Precision,
    attention_block,
    embed,
    layer_views,
    rmsnorm,
    run_layer,
)


def param_specs(m: dict) -> dict:
    """{path: (shape, init)}: init "normal" (std fan_in^-0.5 with fan_in
    the product of all axes but the last, the layer axis included, as the
    port's and the JAX package's initialisers take it), "normal_d" (std
    d^-0.5: the tied table), "ones" or "zeros"."""
    L, d, H, KV = m["num_layers"], m["d_model"], m["num_heads"], \
        m["num_kv_heads"]
    hd, f, V = m["head_dim"], m["d_ff"], m["vocab_size"]
    s = {"embedding/embed": ((V, d), "normal_d"),
         "final_norm/scale": ((d,), "ones"),
         "blocks/ln1/scale": ((L, d), "ones"),
         "blocks/ln2/scale": ((L, d), "ones"),
         "blocks/attn/wq": ((L, d, H, hd), "normal"),
         "blocks/attn/wk": ((L, d, KV, hd), "normal"),
         "blocks/attn/wv": ((L, d, KV, hd), "normal"),
         "blocks/attn/wo": ((L, H, hd, d), "normal"),
         "blocks/ffn/w_gate": ((L, d, f), "normal"),
         "blocks/ffn/w_up": ((L, d, f), "normal"),
         "blocks/ffn/w_down": ((L, f, d), "normal")}
    if m["qkv_bias"]:
        s.update({"blocks/attn/bq": ((L, H, hd), "zeros"),
                  "blocks/attn/bk": ((L, KV, hd), "zeros"),
                  "blocks/attn/bv": ((L, KV, hd), "zeros")})
    return s


def forward_hidden(params: dict, m: dict, tokens: torch.Tensor,
                   pr: Precision) -> torch.Tensor:
    """tokens [B, S] -> final-normed hidden [B, S, d] in ``pr.dtype``."""
    kw = dict(heads=m["num_heads"], kv_heads=m["num_kv_heads"],
              head_dim=m["head_dim"], theta=m["rope_theta"],
              eps=m["norm_eps"], bias=m["qkv_bias"])
    x = embed(pr, params["embedding/embed"], tokens)
    for p in layer_views(params, "blocks", m["num_layers"]):
        x = run_layer(lambda xx, pp: attention_block(pr, xx, pp, **kw), x, p)
    return rmsnorm(x, params["final_norm/scale"], m["norm_eps"])
