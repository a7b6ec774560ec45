"""Paged-attention kernels of the PyTorch port against the JAX package.

The port's plain versions (``repro_torch.kernels.*.ref``) run the same
numpy-made inputs as the JAX Pallas kernels (interpret mode) and the JAX
references, over sweeps that mirror ``tests/test_kernels.py``: GQA / MHA /
MQA, shuffled block tables with unmapped (-1) entries, packed prefill
chunks with padding rows. float32, tolerance 2e-5. The CUDA kernels
themselves run only on a card (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attn.paged_kernel import (
    paged_decode_attention_pallas,
)
from repro.kernels.decode_attn.ref import (
    paged_decode_attention_ref as jax_decode_ref,
)
from repro.kernels.prefill_attn.kernel import paged_prefill_attention_pallas
from repro.kernels.prefill_attn.ref import (
    paged_prefill_attention_ref as jax_prefill_ref,
)
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import ops as dops
from repro_torch.kernels.decode_attn.ref import paged_decode_attention_ref
from repro_torch.kernels.prefill_attn import ops as pops
from repro_torch.kernels.prefill_attn.ref import paged_prefill_attention_ref

TOL = 2e-5


def _paged_pool(seed, S, KV, n_blocks, bs, mb, hd, full_slot=False):
    """Random pool, disjoint shuffled tables, lengths in [1, mb*bs];
    table entries past each slot's length are -1, as the engine leaves
    them. ``full_slot`` fills slot 0 to the whole table."""
    rng = np.random.default_rng(seed)
    pool_k = rng.standard_normal((n_blocks, bs, KV, hd)).astype(np.float32)
    pool_v = rng.standard_normal((n_blocks, bs, KV, hd)).astype(np.float32)
    tables = rng.permutation(n_blocks)[: S * mb].reshape(S, mb)
    tables = tables.astype(np.int32)
    lengths = rng.integers(1, mb * bs + 1, size=S).astype(np.int32)
    if full_slot:
        lengths[0] = mb * bs
    for s in range(S):
        tables[s, -(-int(lengths[s]) // bs):] = -1
    return pool_k, pool_v, tables, lengths


def _prefill_rows(seed, C, lengths, pad_rows):
    """Rows round-robin the segments, each taking that segment's next
    positions up to its length; the last ``pad_rows`` rows are padding."""
    rng = np.random.default_rng(seed + 100)
    S = len(lengths)
    seg = np.full((C,), -1, np.int32)
    pos = np.zeros((C,), np.int32)
    cursor = {s: max(int(lengths[s]) - int(rng.integers(1, 4)), 0)
              for s in range(S)}
    for i in range(C - pad_rows):
        s = i % S
        if cursor[s] >= int(lengths[s]):
            continue
        seg[i], pos[i] = s, cursor[s]
        cursor[s] += 1
    return seg, pos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


DECODE_SWEEP = [
    # S, H, KV, n_blocks, bs, mb, hd
    (2, 4, 2, 16, 8, 4, 32),    # GQA
    (3, 4, 4, 32, 16, 2, 16),   # MHA
    (1, 8, 1, 8, 4, 6, 32),     # MQA
    (4, 12, 2, 64, 16, 8, 128),  # Qwen2.5-1.5B heads (G=6)
    (3, 2, 1, 32, 8, 4, 64),    # toy-2m heads
]


@pytest.mark.parametrize("S,H,KV,n_blocks,bs,mb,hd", DECODE_SWEEP)
def test_paged_decode_ref_vs_jax(S, H, KV, n_blocks, bs, mb, hd):
    """Port plain version == JAX Pallas kernel (interpret) == JAX ref."""
    pk, pv, tables, lengths = _paged_pool(0, S, KV, n_blocks, bs, mb, hd,
                                          full_slot=True)
    q = np.random.default_rng(1).standard_normal((S, H, hd)).astype(
        np.float32)
    out = paged_decode_attention_ref(*_t(q, pk, pv, tables, lengths))
    o_pallas = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lengths), interpret=True)
    o_ref = jax_decode_ref(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                           jnp.asarray(tables), jnp.asarray(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(o_pallas), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_ref), rtol=TOL,
                               atol=TOL)


PREFILL_SWEEP = [
    # C, S, H, KV, n_blocks, bs, mb, hd
    (8, 2, 8, 2, 16, 8, 4, 32),     # GQA, packed 2 segments
    (16, 3, 8, 4, 32, 16, 2, 16),   # MHA-ish, 3-way packing
    (4, 1, 8, 1, 8, 4, 6, 32),      # MQA, single segment
    (24, 3, 12, 2, 64, 16, 8, 128),  # Qwen2.5-1.5B heads
]


@pytest.mark.parametrize("C,S,H,KV,n_blocks,bs,mb,hd", PREFILL_SWEEP)
def test_paged_prefill_ref_vs_jax(C, S, H, KV, n_blocks, bs, mb, hd):
    """Port plain version == JAX Pallas kernel (interpret) == JAX ref;
    padding rows are exactly zero."""
    pk, pv, tables, lengths = _paged_pool(2, S, KV, n_blocks, bs, mb, hd)
    seg, pos = _prefill_rows(2, C, lengths, pad_rows=1)
    q = np.random.default_rng(3).standard_normal((C, H, hd)).astype(
        np.float32)
    out = paged_prefill_attention_ref(*_t(q, pk, pv, tables, seg, pos))
    j = [jnp.asarray(a) for a in (q, pk, pv, tables, seg, pos)]
    o_pallas = paged_prefill_attention_pallas(*j, jnp.asarray(lengths),
                                              interpret=True)
    o_ref = jax_prefill_ref(*j)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_pallas), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_ref), rtol=TOL,
                               atol=TOL)
    assert (seg < 0).any()
    assert np.all(out.numpy()[seg < 0] == 0.0)


def test_prefill_row_equals_decode_query():
    """Each chunk row equals one decode query at its position, bit for bit
    (the invariant that lets the chunk lane replace per-token replay)."""
    pk, pv, tables, lengths = _paged_pool(4, 2, 2, 16, 8, 4, 32)
    seg, pos = _prefill_rows(4, 8, lengths, pad_rows=0)
    q = np.random.default_rng(5).standard_normal((8, 4, 32)).astype(
        np.float32)
    tq, tk, tv, tt, ts, tp = _t(q, pk, pv, tables, seg, pos)
    out = paged_prefill_attention_ref(tq, tk, tv, tt, ts, tp)
    for i in range(8):
        s = int(seg[i])
        if s < 0:
            continue
        one = paged_decode_attention_ref(tq[i: i + 1], tk, tv,
                                         tt[s: s + 1], tp[i: i + 1] + 1)
        torch.testing.assert_close(out[i], one[0], rtol=0, atol=0)


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    """On CPU tensors the ops return the plain version's result and never
    touch the kernel or its launch counter."""
    pk, pv, tables, lengths = _paged_pool(6, 3, 2, 32, 8, 4, 64)
    seg, pos = _prefill_rows(6, 12, lengths, pad_rows=2)
    q = np.random.default_rng(7).standard_normal((3, 4, 64)).astype(
        np.float32)
    qc = np.random.default_rng(8).standard_normal((12, 4, 64)).astype(
        np.float32)
    d0, p0 = dops.LAUNCHES, pops.LAUNCHES
    tq, tk, tv, tt, tl = _t(q, pk, pv, tables, lengths)
    torch.testing.assert_close(
        dops.paged_decode_attention_op(tq, tk, tv, tt, tl),
        paged_decode_attention_ref(tq, tk, tv, tt, tl), rtol=0, atol=0)
    tqc, ts, tp = _t(qc, seg, pos)
    torch.testing.assert_close(
        pops.paged_prefill_attention_op(tqc, tk, tv, tt, ts, tp, tl),
        paged_prefill_attention_ref(tqc, tk, tv, tt, ts, tp), rtol=0,
        atol=0)
    assert (dops.LAUNCHES, pops.LAUNCHES) == (d0, p0)


@pytest.mark.parametrize("case", ["noncontig", "int64_tables", "hd32",
                                  "mixed_dtype", "group_too_large"])
def test_kernel_input_checks(case):
    """The wrapper's operand checks reject what the CUDA kernel does not
    take (they run before any launch, so they are testable on the CPU)."""
    q = torch.zeros(2, 4, 64)
    pool = torch.zeros(8, 4, 2, 64)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    if case == "noncontig":
        q = torch.zeros(4, 2, 64).transpose(0, 1)
    elif case == "int64_tables":
        tables = tables.long()
    elif case == "hd32":
        q, pool = torch.zeros(2, 4, 32), torch.zeros(8, 4, 2, 32)
    elif case == "mixed_dtype":
        q = q.to(torch.bfloat16)
    elif case == "group_too_large":
        q, pool = torch.zeros(2, 66, 64), torch.zeros(8, 4, 2, 64)
    with pytest.raises(ValueError):
        dops.check_paged_inputs(q, pool, pool, tables, lens)
    # well-formed operands pass and report (dtype code, H, KV, hd, bs, mb)
    good = dops.check_paged_inputs(torch.zeros(2, 4, 64),
                                   torch.zeros(8, 4, 2, 64),
                                   torch.zeros(8, 4, 2, 64),
                                   torch.zeros(2, 3, dtype=torch.int32),
                                   torch.ones(2, dtype=torch.int32))
    assert good == (0, 4, 2, 64, 4, 3)


def test_build_lists_sources_and_needs_nvcc(monkeypatch, tmp_path):
    """Both kernel sources are found; the library name carries a digest of
    sources and flags; without nvcc the build raises instead of falling
    back to anything."""
    srcs = _build.sources()
    assert set(srcs) == {"paged_decode_attn", "paged_prefill_attn"}
    targets = {_build._target(n).name for n in srcs}
    assert len(targets) == 2
    assert all(t.startswith("lib") and t.endswith(".so") for t in targets)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def _chip_smoke():
    """The card-run script as a module (it imports only the standard
    library at module level)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_bf16_tolerance_sees_a_missing_key(kernel):
    """chip_smoke.py's bf16 check (kernel vs its plain version in float32
    on the same bf16 values, relative tolerance) passes an output that is
    exact up to the kernel's bf16 output rounding, and fails an output one
    key or one page short at the longest row."""
    cs = _chip_smoke()
    S, H, KV, hd, bs, mb, n_blocks, C = 8, 12, 2, 128, 16, 32, 512, 64
    pk, pv, tables, lengths = _paged_pool(11, S, KV, n_blocks, bs, mb, hd,
                                          full_slot=True)
    seg, pos = _prefill_rows(11, C, lengths, pad_rows=3)
    rng = np.random.default_rng(12)
    rows = S if kernel == "decode" else C
    q = rng.standard_normal((rows, H, hd)).astype(np.float32)
    tq, tk, tv = (t.to(torch.bfloat16).float() for t in _t(q, pk, pv))
    tt, tl, ts, tp = _t(tables, lengths, seg, pos)
    if kernel == "decode":
        def plain(lens):
            return paged_decode_attention_ref(tq, tk, tv, tt, lens)
        meta, longest = tl, 0
    else:
        def plain(p):
            return paged_prefill_attention_ref(tq, tk, tv, tt, ts, p)
        meta = tp
        longest = int(torch.argmax(torch.where(ts < 0, -1, tp)))
    ref = plain(meta)
    wrong = {}
    for label, cut in (("one_key_short", 1), ("one_page_short", bs)):
        m = meta.clone()
        m[longest] -= cut
        wrong[label] = plain(m)
    rec = {"name": kernel}
    cs._hold(torch, rec, ref.to(torch.bfloat16), ref, cs.TOL["bfloat16"],
             wrong)
    assert rec["worst_err_over_tol"] < 0.5
    assert min(rec["wrong_kernel_err_over_tol"].values()) > 2.0
    with pytest.raises(AssertionError, match="kernel vs plain"):
        cs._hold(torch, {"name": kernel}, wrong["one_key_short"].to(
            torch.bfloat16), ref, cs.TOL["bfloat16"], {})


# --------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_kernels.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-2, 1e-4)])
@pytest.mark.parametrize("H,KV,hd,bs", [(12, 2, 128, 16), (2, 1, 64, 8),
                                        (8, 8, 64, 4)])
def test_cuda_kernels_vs_plain(cuda_device, dtype, rtol, atol, H, KV, hd,
                               bs):
    """Both CUDA kernels against their plain versions in float32 on the
    same input values (the kernels accumulate in float32 and round only
    their output: bf16 gets a relative tolerance, as chip_smoke.py); each
    launch counts once."""
    S, mb, n_blocks, C = 5, 6, 64, 20
    pk, pv, tables, lengths = _paged_pool(9, S, KV, n_blocks, bs, mb, hd,
                                          full_slot=True)
    seg, pos = _prefill_rows(9, C, lengths, pad_rows=3)
    rng = np.random.default_rng(10)
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    qc = rng.standard_normal((C, H, hd)).astype(np.float32)
    tq, tqc, tk, tv = (t.to(cuda_device, dtype) for t in _t(q, qc, pk, pv))
    tt, tl, ts, tp = (t.to(cuda_device) for t in _t(tables, lengths, seg,
                                                    pos))
    d0, p0 = dops.LAUNCHES, pops.LAUNCHES
    q32, qc32, k32, v32 = (t.float() for t in (tq, tqc, tk, tv))
    out = dops.paged_decode_attention_op(tq, tk, tv, tt, tl)
    ref = paged_decode_attention_ref(q32, k32, v32, tt, tl)
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    out = pops.paged_prefill_attention_op(tqc, tk, tv, tt, ts, tp)
    ref = paged_prefill_attention_ref(qc32, k32, v32, tt, ts, tp)
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    assert bool((out[ts < 0] == 0).all())
    assert (dops.LAUNCHES - d0, pops.LAUNCHES - p0) == (1, 1)
