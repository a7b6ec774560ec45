"""train_mfu's and logprob_roofline's operation and byte counts against a
count by hand at one shape."""
import pytest

from perfbench import counts

DENSE = {"arch": "dense", "num_layers": 2, "d_model": 8, "num_heads": 2,
         "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 10,
         "qkv_bias": True}


def test_dense_forward_by_hand():
    # per layer: q 8x(2*4), k 8x4, v 8x4, o (2*4)x8, SwiGLU 3 x 8x16
    per_layer = 64 + 32 + 32 + 64 + 3 * 128
    head = 8 * 10
    per_pos = 2 * (2 * per_layer + head)
    # causal attention: 2 layers x 2 products of H * hd = 8 multiply-adds
    # a (query, key) pair, over 1 + 2 + 3 pairs for 3 positions
    attn = 2 * (2 * 2 * 8) * 6
    assert counts.forward_flops(DENSE, [3]) == per_pos * 3 + attn


def test_train_step_is_three_forwards_plus_prox():
    f = counts.forward_flops(DENSE, [4, 6])
    assert counts.train_step_flops(DENSE, [5, 7], "a3po") == 3 * f
    assert counts.train_step_flops(DENSE, [5, 7], "recompute") == 4 * f


def test_logprob_least_time_by_hand():
    T, d, V = 8192, 1536, 151936
    fwd = counts.logprob_least_s(T, d, V, backward=False)
    assert fwd == pytest.approx(2 * T * d * V / 989e12)
    bwd = counts.logprob_least_s(T, d, V, backward=True)
    assert bwd == pytest.approx(4 * T * d * V / 989e12)
    # a short T is bound by reading the head once
    small = counts.logprob_least_s(1, d, V, backward=False)
    assert small == pytest.approx((2 * (d + d * V) + 4 + 8) / 3.35e12)
