"""Kernels of the PyTorch port against the JAX package.

The port's plain versions (``repro_torch.kernels.*.ref``) run the same
numpy-made inputs as the JAX Pallas kernels (interpret mode) and the JAX
references, over sweeps that mirror ``tests/test_kernels.py``: for paged
attention GQA / MHA / MQA, shuffled block tables with unmapped (-1)
entries, packed prefill chunks with padding rows; for dense decode and
causal flash attention ragged lengths, windows and ragged sequence
lengths; for the training kernels
(fused A-3PO loss, token logprob + entropy) their forwards, and their
backwards through the autograd ``Function``s against ``jax.grad``.
float32, tolerance 2e-5 unless stated. The CUDA kernels themselves run
only on a card (``cuda`` marker).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.a3po_loss.kernel import a3po_loss_pallas
from repro.kernels.a3po_loss.ops import a3po_objective as jax_a3po_objective
from repro.kernels.a3po_loss.ref import a3po_loss_ref as jax_a3po_ref
from repro.kernels.decode_attn.kernel import decode_attention_pallas
from repro.kernels.decode_attn.ops import (
    decode_attention_op as jax_decode_op,
)
from repro.kernels.decode_attn.paged_kernel import (
    paged_decode_attention_pallas,
)
from repro.kernels.decode_attn.ref import (
    paged_decode_attention_ref as jax_decode_ref,
)
from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.kernels.flash_attn.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.logprob.kernel import token_logprob_entropy_pallas
from repro.kernels.logprob.ref import (
    token_logprob_entropy_ref as jax_logprob_ref,
)
from repro.kernels.prefill_attn.kernel import paged_prefill_attention_pallas
from repro.kernels.prefill_attn.ref import (
    paged_prefill_attention_ref as jax_prefill_ref,
)
from repro_torch.kernels import _build
from repro_torch.kernels.a3po_loss import kernel as akernel
from repro_torch.kernels.a3po_loss import ops as aops
from repro_torch.kernels.a3po_loss.ref import (
    REDUCED_KEYS,
    a3po_loss_bwd_ref,
    a3po_loss_ref,
    a3po_reduced_bwd_ref,
    a3po_reduced_ref,
    a3po_reduced_scale,
)
from repro_torch.kernels.decode_attn import kernel as dense_kernel
from repro_torch.kernels.decode_attn import ops as dops
from repro_torch.kernels.decode_attn import paged_kernel
from repro_torch.kernels.decode_attn.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)
from repro_torch.kernels.flash_attn import ops as fops
from repro_torch.kernels.flash_attn.ref import flash_attention_ref
from repro_torch.kernels.logprob import ops as lops
from repro_torch.kernels.logprob.ref import (
    dlogits_ref,
    split_hi_lo,
    token_logprob_entropy_bwd_ref,
    token_logprob_entropy_ref,
    token_logprob_entropy_stats_ref,
)
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
    (2, 12, 1, 16, 8, 4, 32),   # a group of 12 (command-r-plus's size)
    (2, 48, 1, 16, 8, 4, 16),   # a group of 48 (granite-34b's MQA)
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
    (8, 2, 12, 1, 16, 8, 4, 32),     # a group of 12
    (6, 2, 48, 1, 16, 8, 4, 16),     # a group of 48
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
                                  "mixed_dtype", "heads_not_a_multiple"])
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
    elif case == "heads_not_a_multiple":  # H = 5 query heads over KV = 2
        q = torch.zeros(2, 5, 64)
    with pytest.raises(ValueError):
        dops.check_paged_inputs(q, pool, pool, tables, lens)
    # well-formed operands pass and report (dtype code, H, KV, hd, bs, mb)
    good = dops.check_paged_inputs(torch.zeros(2, 4, 64),
                                   torch.zeros(8, 4, 2, 64),
                                   torch.zeros(8, 4, 2, 64),
                                   torch.zeros(2, 3, dtype=torch.int32),
                                   torch.ones(2, dtype=torch.int32))
    assert good == (0, 4, 2, 64, 4, 3)


@pytest.mark.parametrize("G", [12, 33, 48])
def test_any_group_size_is_taken(G):
    """The attention wrappers take every group size G = H / KV that the
    Pallas kernels take (command-r-plus's 12, granite-34b's 48, an odd 33):
    the paged checks, the dense decode check and flash's, in both dtypes."""
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for KV in (1, 2):
            H = G * KV
            pool = torch.zeros(8, 4, KV, 128, dtype=dtype)
            assert dops.check_paged_inputs(
                torch.zeros(3, H, 128, dtype=dtype), pool, pool,
                torch.zeros(3, 2, dtype=torch.int32),
                torch.ones(3, dtype=torch.int32)) == (code, H, KV, 128, 4, 2)
            kc = torch.zeros(3, 16, KV, 64, dtype=dtype)
            assert dops.check_dense_inputs(
                torch.zeros(3, H, 64, dtype=dtype), kc, kc,
                torch.ones(3, dtype=torch.int32)) == (code, 3, H, KV, 16, 64)
            q = torch.zeros(2, 24, H, 128, dtype=dtype).transpose(1, 2)
            k = torch.zeros(2, 24, KV, 128, dtype=dtype).transpose(1, 2)
            assert fops.check_inputs(q, k, k, None) == code


def test_build_lists_sources_and_needs_nvcc(monkeypatch, tmp_path):
    """Every kernel source is found; the library name carries a digest of
    sources and flags; without nvcc the build raises instead of falling
    back to anything."""
    srcs = _build.sources()
    assert set(srcs) == {"paged_decode_attn", "paged_prefill_attn",
                         "a3po_loss", "token_logprob_entropy",
                         "decode_attn", "flash_attn", "ssd", "adam"}
    targets = {_build._target(n).name for n in srcs}
    assert len(targets) == 8
    assert all(t.startswith("lib") and t.endswith(".so") for t in targets)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("S,KV", [(1, 1), (8, 2), (8, 32), (3, 1),
                                  (64, 8)])
def test_decode_split_plan_covers_every_key_once(S, KV):
    """The paged decode wrapper's split plan: for any table size, page
    size and SM count, its splits are runs of whole pages that cover key
    positions 0 .. mb*bs - 1 exactly once, none empty, and it reads only
    host-known sizes (no lengths: the decode horizon must not wait for the
    device)."""
    import inspect
    assert list(inspect.signature(paged_kernel.split_plan).parameters) == [
        "mb", "bs", "S", "KV", "n_sm"]
    rng = np.random.default_rng(S * 100 + KV)
    cases = [(128, 16, 132), (1, 1, 132), (6, 4, 132), (40, 16, 8),
             (128, 16, 1)] + [
        (int(rng.integers(1, 300)), int(rng.integers(1, 65)),
         int(rng.integers(1, 200))) for _ in range(40)]
    for mb, bs, n_sm in cases:
        pps, n = paged_kernel.split_plan(mb, bs, S, KV, n_sm)
        assert 1 <= pps <= mb and 1 <= n <= paged_kernel.MAX_SPLITS
        covered = np.zeros(mb * bs, np.int32)
        for i in range(n):  # split i as the kernel walks it
            start, end = i * pps * bs, min((i + 1) * pps * bs, mb * bs)
            assert start < end and start % bs == 0
            covered[start:end] += 1
        assert (covered == 1).all(), (mb, bs, n_sm, pps, n)
        # no split shorter than MIN_SPLIT_KEYS unless the table is
        assert pps * bs >= min(paged_kernel.MIN_SPLIT_KEYS, mb * bs) or pps == mb


def _prefill_walk(C, G, KV, mb, bs, n_sm, seg, pos):
    """How many times the bf16 paged prefill kernel visits each (query
    vector, key position) pair of one KV head, under the wrapper's split
    plan: blocks of BLOCK_VECTORS vectors (row t, head g -> t * G + g) x
    splits; a block walks each distinct segment of its rows up to that
    segment's largest position in the block, within its split's keys, and
    a vector takes the keys j < min(pos + 1, split end) of its own
    segment (csrc/paged_prefill_attn.cu, tc::prefill_split_kernel)."""
    from repro_torch.kernels.prefill_attn import kernel as pk
    pps, n_splits = pk.split_plan(C, G, KV, mb, bs, n_sm)
    assert 1 <= pps <= mb and 1 <= n_splits <= pk.MAX_SPLITS
    assert pps * n_splits >= mb and pps * bs >= min(pk.MIN_SPLIT_KEYS,
                                                    mb * bs) or pps == mb
    seen = np.zeros((C * G, mb * bs), np.int32)
    lim = np.where(seg >= 0, pos, -1)
    for v0 in range(0, C * G, pk.BLOCK_VECTORS):
        vs = np.arange(v0, min(v0 + pk.BLOCK_VECTORS, C * G))
        rows = np.unique(vs // G)
        for split in range(n_splits):
            ks0 = split * pps * bs
            ks1 = min(ks0 + pps * bs, mb * bs)
            for sg in np.unique(seg[rows]):
                if sg < 0:
                    continue
                k_end = min(ks1, int(lim[rows][seg[rows] == sg].max()) + 1)
                for v in vs:
                    t = v // G
                    if seg[t] != sg:
                        continue
                    end = min(k_end, int(lim[t]) + 1)
                    if end > ks0:
                        seen[v, ks0:end] += 1
    return seen, lim


@pytest.mark.parametrize("C,G,KV,n_sm", [(256, 6, 2, 132), (64, 1, 32, 132),
                                         (40, 12, 1, 8), (33, 48, 1, 132),
                                         (100, 6, 2, 1)])
def test_prefill_split_plan_covers_every_key_once(C, G, KV, n_sm):
    """The paged prefill wrapper's split plan and the kernel's walk: for
    ragged packed chunks (several segments, runs ending on page and split
    boundaries and one key past them, padding rows, rows of one segment
    split across vector tiles), every row's keys 0 .. q_pos are visited
    exactly once per query head and no other key is; the plan reads only
    host-known sizes."""
    import inspect
    from repro_torch.kernels.prefill_attn import kernel as pk
    assert list(inspect.signature(pk.split_plan).parameters) == [
        "C", "G", "KV", "mb", "bs", "n_sm"]
    rng = np.random.default_rng(C * G + KV)
    for mb, bs in ((128, 16), (6, 4), (9, 8), (3, 1)):
        pps, _ = pk.split_plan(C, G, KV, mb, bs, n_sm)
        sk, full = pps * bs, mb * bs
        ends = [full, sk, sk + 1, sk - 1, bs, bs + 1, 1] + [
            int(x) for x in rng.integers(1, full + 1, size=4)]
        seg, pos = [], []
        for s, end in enumerate(ends):  # a run of the segment's last keys
            end = max(1, min(end, full))
            n = min(int(rng.integers(1, 2 * G + 3)), end, C - len(seg))
            seg += [s] * n
            pos += list(range(end - n, end))
        seg += [-1] * (C - len(seg))
        pos += [0] * (C - len(pos))
        seg, pos = np.array(seg, np.int32), np.array(pos, np.int32)
        seen, lim = _prefill_walk(C, G, KV, mb, bs, n_sm, seg, pos)
        want = (np.arange(full)[None, :] <= lim[:, None]).astype(np.int32)
        assert (seen == np.repeat(want, G, axis=0)).all(), (mb, bs, pps)


@pytest.mark.parametrize("rows,vocab,n_sm", [(2300, 151936, 132),
                                             (512, 151936, 132),
                                             (300, 1000, 132), (7, 22, 132),
                                             (4096, 50280, 114), (1, 1, 1)])
def test_logprob_wgmma_plan_covers_the_vocabulary_once(rows, vocab, n_sm):
    """The wgmma forward's plan: its vocab ranges cover the vocabulary's
    tiles exactly once, none empty, and at the training step's shape it
    fills the card's SMs in whole waves."""
    from repro_torch.kernels.logprob import kernel as lk
    splits, per = lk.wgmma_plan(rows, vocab, n_sm)
    n_vt = -(-vocab // lk.WG_BN)
    covered = np.zeros(n_vt, np.int32)
    for s in range(splits):  # range s as the kernel walks it
        t0, t1 = s * per, min((s + 1) * per, n_vt)
        assert t0 < t1
        covered[t0:t1] += 1
    assert (covered == 1).all()
    if (rows, vocab, n_sm) == (2300, 151936, 132):
        assert -(-rows // lk.WG_BM) * splits % n_sm == 0


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


def test_chip_smoke_prefill_cases_hit_their_boundaries():
    """chip_smoke.py's paged prefill cases are what they claim: packed
    chunks of at most 256 rows within the 128-page tables, the engine's
    first chunk from position 0 filling the 256 rows shortest prompt
    first, and the split-boundary case's short row (one key past a split)
    the last row of its slot at position split_keys."""
    from repro_torch.kernels.prefill_attn import kernel as pk
    cs = _chip_smoke()
    cases = {c["label"]: c for c in cs._prefill_cases(torch, n_sm=132)}
    assert set(cases) == {"last_chunk_of_1024", "engine_first_chunk",
                          "zamba2_heads", "group_12", "group_48",
                          "split_boundaries"}
    for c in cases.values():
        rows = sum(n for _, _, n in c["runs"]) + c["pad"]
        assert rows <= 256 and all(0 <= st and st + n <= 128 * 16
                                   for _, st, n in c["runs"])
    first = cases["engine_first_chunk"]["runs"]
    assert sum(n for _, _, n in first) == 256 and len(first) >= 2
    assert all(st == 0 for _, st, _ in first)
    c = cases["split_boundaries"]
    C = sum(n for _, _, n in c["runs"]) + c["pad"]
    pps, _ = pk.split_plan(C, 6, 2, 128, 16, 132)
    (row, _), = [(r, k) for k, r in c["short_rows"].items()]
    pos = [st + i for _, st, n in c["runs"] for i in range(n)]
    seg = [s_ for s_, _, n in c["runs"] for _ in range(n)]
    assert pos[row] == pps * 16 and seg[row + 1] != seg[row]


# ------------------------------------------------ dense decode, flash attention
def _flash_inputs(seed, B, H, KV, S, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    return q, k, v


FLASH_SWEEP = [
    # B, H, KV, S, hd, window, Pallas block
    (2, 4, 2, 64, 64, None, 32),     # GQA, two query/key blocks
    (1, 6, 2, 64, 128, 16, 16),      # Qwen2.5-1.5B group (G=3), window 16
    (2, 4, 1, 96, 64, None, 96),     # MQA, S 96
    (1, 2, 1, 96, 64, 40, 32),       # toy-2m heads, window over blocks
    (1, 12, 1, 64, 64, None, 32),    # a group of 12
    (1, 48, 1, 32, 64, 16, 16),      # a group of 48, window 16
]


@pytest.mark.parametrize("B,H,KV,S,hd,window,blk", FLASH_SWEEP)
def test_flash_ref_vs_jax(B, H, KV, S, hd, window, blk):
    """Port plain version == JAX Pallas kernel (interpret) == JAX ref."""
    q, k, v = _flash_inputs(S + hd, B, H, KV, S, hd)
    out = flash_attention_ref(*_t(q, k, v), window=window)
    o_pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), bq=blk, bk=blk,
                                      window=window, interpret=True)
    o_ref = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_pallas), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_ref), rtol=TOL,
                               atol=TOL)


def _dense_cache(seed, B, L, KV, hd):
    """Random caches, lengths in [1, L] with one row at L and one at 1."""
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    lengths = rng.integers(1, L + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = L, 1
    return kc, vc, lengths


DENSE_DECODE_SWEEP = [
    # B, H, KV, L, hd
    (3, 4, 2, 48, 64),     # GQA
    (4, 12, 2, 64, 128),   # Qwen2.5-1.5B heads (G=6)
    (2, 2, 1, 32, 64),     # toy-2m heads
    (3, 8, 8, 40, 64),     # MHA
    (2, 12, 1, 32, 64),    # a group of 12
    (2, 48, 1, 24, 64),    # a group of 48
]


@pytest.mark.parametrize("B,H,KV,L,hd", DENSE_DECODE_SWEEP)
def test_dense_decode_ref_vs_jax(B, H, KV, L, hd):
    """Port plain version == JAX Pallas kernel (interpret) == JAX op."""
    kc, vc, lengths = _dense_cache(B * L, B, L, KV, hd)
    q = np.random.default_rng(L).standard_normal((B, H, hd)).astype(
        np.float32)
    out = decode_attention_ref(*_t(q, kc, vc, lengths))
    o_pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(lengths),
                                       interpret=True)
    o_op = jax_decode_op(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(o_pallas), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_op), rtol=TOL,
                               atol=TOL)


def test_dense_ops_on_cpu_take_plain_version_and_count_nothing():
    """On CPU tensors flash attention and dense decode return their plain
    versions' results and never touch a kernel or its launch counter."""
    q, k, v = _t(*_flash_inputs(3, 2, 4, 2, 40, 64))
    kc, vc, lengths = _t(*_dense_cache(4, 2, 40, 2, 64))
    f0, d0 = fops.LAUNCHES, dops.DENSE_LAUNCHES
    torch.testing.assert_close(fops.flash_attention(q, k, v, window=8),
                               flash_attention_ref(q, k, v, window=8),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        dops.decode_attention_op(q[:, :, 0], kc, vc, lengths),
        decode_attention_ref(q[:, :, 0], kc, vc, lengths), rtol=0, atol=0)
    assert (fops.LAUNCHES, dops.DENSE_LAUNCHES) == (f0, d0)


def test_dense_kernel_input_checks():
    """The flash and dense decode wrappers' checks reject what their
    kernels do not take; flash takes strided [B,S,H,hd] activations."""
    act = torch.zeros(2, 24, 4, 64, dtype=torch.bfloat16)  # [B,S,H,hd]
    kv = torch.zeros(2, 24, 2, 64, dtype=torch.bfloat16)
    q, k = act.transpose(1, 2), kv.transpose(1, 2)
    assert fops.check_inputs(q, k, k, None) == 1
    assert fops.check_inputs(q.float(), k.float(), k.float(), 5) == 0
    bad_flash = [
        (q, k.float(), k, None),                       # mixed dtypes
        (q[..., :32], k[..., :32], k[..., :32], None),  # head_dim 32
        (q.transpose(2, 3), k, k, None),               # hd not contiguous
        (torch.zeros(2, 24, 3, 64).transpose(1, 2), k.float(), k.float(),
         None),                                        # H % KV
        (torch.zeros(2, 24, 4, 72, dtype=torch.bfloat16)[..., 4:68]
         .transpose(1, 2), k, k, None),                # unaligned bf16 rows
        (q, k, k, 0),                                  # window < 1
        (q, k[:, :, :20], k[:, :, :20], None),          # S mismatch
        (q, kv[:1].expand(2, -1, -1, -1).transpose(1, 2),
         kv[:1].expand(2, -1, -1, -1).transpose(1, 2), None),  # stride 0
    ]
    for args in bad_flash:
        with pytest.raises(ValueError):
            fops.check_inputs(*args)
    qd = torch.zeros(3, 4, 64)
    kc = torch.zeros(3, 16, 2, 64)
    lens = torch.ones(3, dtype=torch.int32)
    assert dops.check_dense_inputs(qd, kc, kc, lens) == (0, 3, 4, 2, 16, 64)
    bad_decode = [
        (qd, kc, kc, lens.long()),                     # int64 lengths
        (qd, kc.transpose(1, 2), kc.transpose(1, 2), lens),  # strided
        (qd.bfloat16(), kc, kc, lens),                 # mixed dtypes
        (torch.zeros(3, 5, 64), kc, kc, lens),         # H % KV
        (qd, kc, kc, lens[:2]),                        # B mismatch
    ]
    for args in bad_decode:
        with pytest.raises(ValueError):
            dops.check_dense_inputs(*args)


@pytest.mark.parametrize("kernel", ["flash", "dense_decode"])
def test_bf16_tolerance_sees_a_missing_key_dense(kernel):
    """chip_smoke.py's bf16 check passes the plain version rounded to bf16
    and fails the wrong references it holds each dense kernel against: a
    flash attention that masks the diagonal, a decode of lengths - 1."""
    cs = _chip_smoke()
    if kernel == "flash":
        q, k, v = (t.to(torch.bfloat16).float()
                   for t in _t(*_flash_inputs(5, 2, 12, 2, 200, 128)))
        ref = flash_attention_ref(q, k, v)
        wrong = {"diagonal_masked": cs._masked_diagonal_ref(torch, q, k, v)}
    else:
        kc, vc, lengths = _t(*_dense_cache(6, 4, 300, 2, 128))
        kc, vc = kc.to(torch.bfloat16).float(), vc.to(torch.bfloat16).float()
        q = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (4, 12, 128)).astype(np.float32)).to(torch.bfloat16).float()
        ref = decode_attention_ref(q, kc, vc, lengths)
        wrong = {"lengths_minus_one": decode_attention_ref(
            q, kc, vc, (lengths - 1).clamp_min(1))}
    rec = {"name": kernel}
    cs._hold(torch, rec, ref.to(torch.bfloat16), ref, cs.TOL["bfloat16"],
             wrong)
    assert rec["worst_err_over_tol"] < 0.5
    assert min(rec["wrong_kernel_err_over_tol"].values()) > 2.0


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("B,KV,L", [(16, 2, 1056), (16, 1, 1056),
                                    (16, 2, 1000), (4, 2, 40), (1, 1, 1),
                                    (3, 8, 300), (64, 2, 4096),
                                    (2, 1, 17)])
def test_dense_decode_split_plan_covers_every_key_once(B, KV, L, n_sm):
    """The dense decode wrapper's split plan: from host-known sizes only
    (B, KV, L, the SM count; never the lengths), splits of whole 16-key
    tiles that cover positions 0 .. L - 1 exactly once, none empty, at
    most 8 (one cluster), none shorter than 64 keys unless the cache is;
    at the rollout's B 16 and KV 2 it puts 8 splits of 144 keys (256
    blocks) on the card. For any lengths the blocks that hold keys of a
    row are its first splits, as the kernel's merge assumes."""
    import inspect
    assert list(inspect.signature(dense_kernel.split_plan).parameters) == [
        "B", "KV", "L", "n_sm"]
    sk, n = dense_kernel.split_plan(B, KV, L, n_sm)
    tile = dense_kernel.TILE
    assert sk % tile == 0 and 1 <= n <= paged_kernel.MAX_SPLITS
    assert sk >= min(paged_kernel.MIN_SPLIT_KEYS, -(-L // tile) * tile)
    covered = np.zeros(L, np.int32)
    for i in range(n):  # split i as the kernel walks it
        s0, s1 = i * sk, min((i + 1) * sk, L)
        assert s0 < s1
        covered[s0:s1] += 1
    assert (covered == 1).all()
    for length in range(L + 1):
        busy = [i for i in range(n) if i * sk < length]
        assert busy == list(range(-(-length // sk)))
    if (B, KV, L) == (16, 2, 1056) and n_sm == 132:
        assert (sk, n) == (144, 8)


def test_chip_smoke_dense_cases_hit_their_boundaries():
    """chip_smoke.py's dense decode boundary cases are what they claim:
    16 lengths within the cache, on the plan's split boundaries and one
    key past them, on 16-key tiles, at L 1056 and at an L that is not a
    multiple of the tile; the short row is one key past a split
    boundary."""
    cs = _chip_smoke()
    cases = cs._dense_boundary_cases(torch, n_sm=132)
    assert [c["L"] for c in cases] == [1056, 1000]
    assert cases[1]["L"] % dense_kernel.TILE
    for c in cases:
        sk = cs._dense_splits(torch, 16, 2, c["L"], n_sm=132)["split_keys"]
        lens = c["lengths"]
        assert len(lens) == c["B"] == 16
        assert all(1 <= n <= c["L"] for n in lens) and c["L"] in lens
        assert {sk, sk + 1, 2 * sk + 1, 16, 17} <= set(lens)
        (row,) = c["short_rows"].values()
        assert lens[row] % sk == 1 and lens[row] > sk


@pytest.mark.parametrize("name,ours", [
    ("void (anonymous namespace)::wg::walk<0, (anonymous namespace)::wg::"
     "Cotangent>(CUtensorMap_st", True),
    ("void (anonymous namespace)::tc::split_kernel<128, (anonymous "
     "namespace)::DenseKeys>((anony", True),
    ("(anonymous namespace)::forward_merge(float const*, int, int", True),
    ("void (anonymous namespace)::decode_attn<128>(float const*", True),
    ("void (anonymous namespace)::softmax_warp_forward<float, float", False),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized"
     "<at::native", False),
    ("nvjet_tst_128x16_64x11_4x1_v_bz_NNT", False),
])
def test_chip_smoke_profile_tells_the_port_kernels(name, ours):
    """chip_smoke.py's device profile lists the port's own kernels (the
    ``__global__`` functions of ``kernels/csrc``, in anonymous namespaces)
    and not PyTorch's kernels that also live in anonymous namespaces."""
    cs = _chip_smoke()
    assert {"walk", "split_kernel", "decode_attn", "forward_merge"} <= \
        cs._port_kernel_names()
    assert cs._is_port_kernel(name) == ours


def test_split_hi_lo_reconstructs_float32():
    """The plain version of the wgmma cotangent kernel's storage: a bf16
    high part and the bf16 rounding of the remainder give back float32 dl
    within 2^-16 |dl| (each rounding keeps 8 significant bits), where the
    high part alone is off by up to 2^-8 |dl|."""
    h, w, t = _logprob_inputs(21, 40, 64, 777)
    th, tw, tt = _t(h, w, t)
    _, _, logz, mu = token_logprob_entropy_stats_ref(th, tw, tt)
    rng = np.random.default_rng(22)
    g_lp, g_en = (torch.from_numpy(rng.standard_normal(40).astype(
        np.float32)) for _ in range(2))
    dl = dlogits_ref(th @ tw, tt, logz, mu, g_lp, g_en)
    hi, lo = split_hi_lo(dl)
    assert hi.dtype == lo.dtype == torch.bfloat16
    x = dl.double()
    err = (hi.double() + lo.double() - x).abs()
    assert bool((err <= 2.0 ** -16 * x.abs()).all())
    err_hi = (hi.double() - x).abs()
    assert bool((err_hi <= 2.0 ** -8 * x.abs()).all())
    assert float((err_hi / x.abs().clamp_min(1e-30)).max()) > 2.0 ** -12


# ------------------------------------------------------------ training kernels
def _a3po_inputs(seed, T):
    """Tokens where the clip is active on both sides, the iw cap is active
    and the mask is partial (logp, behav in [-3, 0], alpha in [0, 1] with
    some zeros, advantages of both signs)."""
    rng = np.random.default_rng(seed)
    lp = (-rng.random(T) * 3).astype(np.float32)
    bl = (-rng.random(T) * 3).astype(np.float32)
    al = rng.random(T).astype(np.float32)
    al[rng.random(T) < 0.2] = 0.0
    adv = rng.standard_normal(T).astype(np.float32)
    mask = (rng.random(T) > 0.3).astype(np.float32)
    return lp, bl, al, adv, mask


@pytest.mark.parametrize("T", [64, 1000, 4096])
def test_a3po_loss_ref_vs_jax(T):
    """Port plain version == JAX Pallas kernel (interpret) == JAX ref."""
    args = _a3po_inputs(T, T)
    out = a3po_loss_ref(*_t(*args), clip_eps=0.2, iw_cap=5.0)
    j = [jnp.asarray(a) for a in args]
    o_pallas = a3po_loss_pallas(*j, bt=128, interpret=True)
    o_ref = jax_a3po_ref(*j, clip_eps=0.2, iw_cap=5.0)
    for a, b, c in zip(out, o_pallas, o_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(o_pallas[1]))


@pytest.mark.parametrize("shape", [(1000,), (4, 33)])
def test_a3po_objective_grad_vs_jax(shape):
    """The port's ``Function`` (analytic backward, plain version on the CPU)
    against ``jax.grad`` of the JAX ``a3po_objective`` (custom_vjp over the
    Pallas kernel in interpret mode), with a random cotangent."""
    n = int(np.prod(shape))
    lp, bl, al, adv, mask = (a.reshape(shape)
                             for a in _a3po_inputs(7, n))
    ct = np.random.default_rng(8).standard_normal(shape).astype(np.float32)

    def jloss(x):
        return jnp.sum(jax_a3po_objective(x, bl, al, adv, mask)[0] * ct)

    g_jax = jax.grad(jloss)(jnp.asarray(lp))
    x = torch.from_numpy(lp.copy()).requires_grad_(True)
    outs = aops.a3po_objective(x, *_t(bl, al, adv, mask))
    (outs[0] * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_jax), rtol=1e-5,
                               atol=1e-7)
    assert not any(o.requires_grad for o in outs[1:])
    # the analytic backward is the gradient of the differentiable ref
    x2 = torch.from_numpy(lp.copy()).requires_grad_(True)
    ref = a3po_loss_ref(x2.reshape(-1), *(t.reshape(-1) for t in _t(
        bl, al, adv, mask)), clip_eps=0.2, iw_cap=5.0)
    (ref[0] * torch.from_numpy(ct).reshape(-1)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.reshape(shape).numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("T,n_sm,blocks", [(0, 132, 1), (1001, 132, 1),
                                          (2300, 132, 1), (4096, 132, 1),
                                          (4097, 132, 2), (2 ** 20, 132, 256),
                                          (2 ** 24, 132, 264)])
def test_reduced_plan_and_walk_cover_every_token_once(T, n_sm, blocks):
    """The reduced forward's grid (one block up to 4096 tokens, at most two
    an SM) and its walk: every token falls to one block and one pass, and
    every block takes tokens, in passes of 4 x 512 a block."""
    assert akernel.reduced_blocks(T, n_sm) == blocks
    n = min(T, 3 * 2 ** 20)
    block, pas = akernel.reduced_walk(n, blocks)
    if n == 0:
        return
    assert 0 <= int(block.min()) and int(block.max()) < blocks
    counts = torch.bincount(block * (int(pas.max()) + 1) + pas)
    assert int(counts.max()) <= akernel.REDUCED_THREADS \
        * akernel.REDUCED_UNROLL
    if n == T:
        assert len(torch.unique(block)) == min(blocks, -(-T // 512))


LOGPROB_SHAPES = [(16, 32, 50), (300, 130, 1000), (64, 512, 513),
                  (7, 48, 22), (128, 64, 4096)]


def _logprob_inputs(seed, T, d, V):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.05).astype(np.float32)
    t = rng.integers(0, V, size=T).astype(np.int32)
    return h, w, t


@pytest.mark.parametrize("T,d,V", LOGPROB_SHAPES)
def test_logprob_ref_vs_jax(T, d, V):
    """Port plain version == JAX Pallas kernel (interpret) == JAX ref."""
    h, w, t = _logprob_inputs(T + V, T, d, V)
    lp, en = token_logprob_entropy_ref(*_t(h, w, t))
    j = [jnp.asarray(a) for a in (h, w, t)]
    lp_k, en_k = token_logprob_entropy_pallas(*j, bt=64, bv=128, bd=64,
                                              interpret=True)
    lp_r, en_r = jax_logprob_ref(*j)
    for ours, theirs in ((lp, lp_k), (en, en_k), (lp, lp_r), (en, en_r)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,d,V", LOGPROB_SHAPES[:3])
@pytest.mark.parametrize("cotangents", ["both", "logp_only"])
def test_logprob_grad_vs_jax(T, d, V, cotangents):
    """The ``Function``'s analytic backward (``token_logprob_entropy_bwd_ref``
    on the CPU) against ``jax.grad`` of the JAX ref w.r.t. hidden and w,
    with random cotangents on both outputs (or on logp alone: the entropy
    cotangent is then None and counts as zero). w enters as the transposed
    view a tied embedding gives."""
    h, w, t = _logprob_inputs(3 * T, T, d, V)
    rng = np.random.default_rng(4)
    g_lp = rng.standard_normal(T).astype(np.float32)
    g_en = rng.standard_normal(T).astype(np.float32) \
        if cotangents == "both" else np.zeros(T, np.float32)

    def jloss(hh, ww):
        lp, en = jax_logprob_ref(hh, ww, jnp.asarray(t))
        return jnp.sum(lp * g_lp) + jnp.sum(en * g_en)

    gh, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    emb = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
    lp, en = lops.token_logprob_entropy(th, emb.T, torch.from_numpy(t))
    loss = (lp * torch.from_numpy(g_lp)).sum()
    if cotangents == "both":
        loss = loss + (en * torch.from_numpy(g_en)).sum()
    loss.backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(emb.grad.numpy().T, np.asarray(gw),
                               rtol=TOL, atol=TOL)


def test_logprob_bwd_ref_is_autograd_of_ref():
    """The analytic backward equals autograd of the differentiable plain
    version (float32 and bf16 operands; cotangents cast back to each)."""
    h, w, t = _logprob_inputs(5, 24, 40, 77)
    rng = np.random.default_rng(6)
    g_lp, g_en = (torch.from_numpy(rng.standard_normal(24).astype(np.float32))
                  for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        th, tw = (x.to(dtype).requires_grad_(True) for x in _t(h, w))
        lp, en = token_logprob_entropy_ref(th, tw, torch.from_numpy(t))
        ((lp * g_lp).sum() + (en * g_en).sum()).backward()
        _, _, logz, mu = token_logprob_entropy_stats_ref(th, tw,
                                                         torch.from_numpy(t))
        dh, dw = token_logprob_entropy_bwd_ref(th.detach(), tw.detach(),
                                               torch.from_numpy(t), logz,
                                               mu, g_lp, g_en)
        assert dh.dtype == dtype and dw.dtype == dtype
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(dh.float(), th.grad.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(dw.float(), tw.grad.float(), rtol=tol,
                                   atol=tol)


def test_training_ops_on_cpu_count_no_launches():
    """On CPU tensors both training ops take their plain versions, forward
    and backward, and never touch a kernel or its launch counter."""
    a0, l0 = dict(aops.LAUNCHES), dict(lops.LAUNCHES)
    lp, bl, al, adv, mask = _t(*_a3po_inputs(9, 50))
    lp.requires_grad_(True)
    out = aops.a3po_objective(lp, bl, al, adv, mask)
    out[0].sum().backward()
    aops.a3po_loss_fused(lp.detach(), bl, al, adv, mask)
    loss, _ = aops.a3po_objective_reduced(lp, bl, al, adv, mask, kl_coef=0.1)
    loss.backward()
    h, w, t = _t(*_logprob_inputs(10, 9, 16, 30))
    h.requires_grad_(True)
    lpv, en = lops.token_logprob_entropy(h, w, t)
    (lpv.sum() + en.sum()).backward()
    assert (aops.LAUNCHES, lops.LAUNCHES) == (a0, l0)


def test_logprob_input_checks():
    """The logprob wrapper's checks reject what the kernel does not take
    (run before any launch, so testable on the CPU) and report the layout
    of a tied embedding's transposed view and of a [d, V] matrix."""
    h = torch.zeros(5, 16)
    t = torch.zeros(5, dtype=torch.int32)
    emb = torch.zeros(30, 16)
    assert lops.check_inputs(h, emb.T, t) == (0, 1, 16, 0)
    assert lops.check_inputs(h, torch.zeros(16, 30), t) == (0, 30, 1, 0)
    assert lops.check_inputs(h.bfloat16(), emb.bfloat16().T, t)[3] == 1
    for bad in [(h, emb.T.bfloat16(), t),            # mixed dtypes
                (h, emb.T, t.long()),                # int64 targets
                (h, emb[:, ::2].T, t),               # no unit stride
                (h, emb.T[:8], t),                   # depth mismatch
                (h.T.contiguous().T, emb.T, t)]:     # non-contiguous hidden
        with pytest.raises(ValueError):
            lops.check_inputs(*bad)


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
                                        (8, 8, 64, 4), (12, 1, 128, 16),
                                        (48, 1, 128, 16)])
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

    # decode over a 128-page table (many key splits): lengths on split and
    # page boundaries and one past them, a full row, and a row of length 0
    # (which gives 0 on the card); one launch
    S, mb = 8, 128
    pk_, pv_, tables, _ = _paged_pool(19, S, KV, S * mb, bs, mb, hd)
    pps, n_splits = paged_kernel.split_plan(mb, bs, S, KV, paged_kernel.sm_count(
        cuda_device.index or 0))
    sk = pps * bs
    lens = np.minimum([mb * bs, sk, sk + 1, sk - 1, bs, bs + 1, 1, 0],
                      mb * bs).astype(np.int32)
    for s_ in range(S):
        tables[s_, -(-int(lens[s_]) // bs):] = -1
    q = np.random.default_rng(20).standard_normal((S, H, hd)).astype(
        np.float32)
    tq, tk, tv = (t.to(cuda_device, dtype) for t in _t(q, pk_, pv_))
    tt, tl = (t.to(cuda_device) for t in _t(tables, lens))
    d0 = dops.LAUNCHES
    out = dops.paged_decode_attention_op(tq, tk, tv, tt, tl)
    assert dops.LAUNCHES - d0 == 1
    ref = paged_decode_attention_ref(tq.float(), tk.float(), tv.float(), tt,
                                     tl)
    live = tl > 0
    torch.testing.assert_close(out[live].float(), ref[live], rtol=rtol,
                               atol=atol)
    assert bool((out[~live] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2300, 1001])
def test_cuda_a3po_loss_vs_plain(cuda_device, T):
    """Fused A-3PO loss forward and backward kernels against their plain
    versions on the card, float32: within 1e-6 relative, clip_tok exact,
    with the clip active on both sides, the iw cap active and the mask
    partial; one launch each."""
    args = [x.to(cuda_device) for x in _t(*_a3po_inputs(T, T))]
    f0, b0 = aops.LAUNCHES["forward"], aops.LAUNCHES["backward"]
    outs = aops.a3po_loss_fused(*args)
    refs = a3po_loss_ref(*args, clip_eps=0.2, iw_cap=5.0)
    loss, clip, iw, ratio = refs
    adv, mask = args[3], args[4]
    assert bool((iw == 5.0).any()) and 0 < int(mask.sum()) < T
    assert bool(((clip > 0) & (adv > 0)).any())
    assert bool(((clip > 0) & (adv < 0)).any())
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o, r, rtol=1e-6, atol=0)
    assert torch.equal(outs[1], clip)
    g = torch.randn(T, device=cuda_device)
    gk = aops._backward_kernel(g, clip, iw, ratio, adv, mask)
    torch.testing.assert_close(gk, a3po_loss_bwd_ref(g, clip, iw, ratio, adv,
                                                     mask),
                               rtol=1e-6, atol=0)
    assert (aops.LAUNCHES["forward"] - f0, aops.LAUNCHES["backward"] - b0) \
        == (1, 1)


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("regularized", [False, True])
@pytest.mark.parametrize("T", [2300, 1001, 2 ** 20])
def test_cuda_a3po_reduced_vs_plain(cuda_device, T, regularized):
    """The reduced A-3PO forward and backward kernels against their plain
    versions on the card, with chip_smoke.py's tolerances: c and the
    clipped count and iw extremes bit for bit, every other sum within
    1e-5 sum(|terms|) / denom, the backward within 1e-6 relative; the
    clip active on both sides, the iw cap active, the mask partial, and
    with the KL and entropy terms set; two launches bit-equal."""
    arrays = list(_a3po_inputs(T, T)) + [
        np.random.default_rng(T + 1).random(T).astype(np.float32)
        if regularized else None]
    args = [None if a is None else torch.from_numpy(a).to(cuda_device)
            for a in arrays]
    kw = dict(clip_eps=0.2, iw_cap=5.0, kl_coef=0.1 if regularized else 0.0,
              entropy_coef=0.01 if regularized else 0.0)
    mask = args[4]
    f0, b0 = aops.LAUNCHES["forward"], aops.LAUNCHES["backward"]
    loss, metrics, coef = aops._reduced_forward_kernel(*args, **kw)
    r_loss, r_metrics, r_coef = a3po_reduced_ref(*args, **kw)
    s_loss, s_metrics = a3po_reduced_scale(*args, **kw)
    _, clip, iw, _ = a3po_loss_ref(*args[:5], clip_eps=0.2, iw_cap=5.0)
    assert bool((iw[mask > 0] == 5.0).any()) and 0 < int(mask.sum()) < T
    assert bool(((clip > 0) & (args[3] > 0)).any())
    assert bool(((clip > 0) & (args[3] < 0)).any())
    assert torch.equal(coef, r_coef)
    err = (metrics - r_metrics).abs()
    err = torch.where(torch.isnan(metrics) & torch.isnan(r_metrics), 0.0,
                      err)
    assert bool((err <= 1e-5 * s_metrics).all()), dict(
        zip(REDUCED_KEYS, err.tolist()))
    assert abs(float(loss - r_loss)) <= 1e-5 * float(s_loss)
    again = aops._reduced_forward_kernel(*args, **kw)
    for a, b in zip((loss, metrics, coef), again):
        assert torch.equal(_bits(a), _bits(b))
    g = torch.tensor(0.7, device=cuda_device)
    bkw = dict(kl_coef=kw["kl_coef"], entropy_coef=kw["entropy_coef"],
               with_entropy=regularized)
    g_logp, g_ent = aops._reduced_backward_kernel(g.reshape(1), metrics,
                                                  coef, mask, **bkw)
    r_logp, r_ent = a3po_reduced_bwd_ref(g, r_metrics[aops.DENOM], r_coef,
                                         mask, **bkw)
    torch.testing.assert_close(g_logp, r_logp, rtol=1e-6, atol=0)
    assert (g_ent is None) == (not regularized)
    if regularized:
        torch.testing.assert_close(g_ent, r_ent, rtol=1e-6, atol=0)
    assert (aops.LAUNCHES["forward"] - f0, aops.LAUNCHES["backward"] - b0) \
        == (2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,V,dtype,layout,wgmma", [
    (300, 130, 1000, torch.float32, "tied", False),
    (7, 48, 22, torch.float32, "dv", False),
    (64, 512, 513, torch.bfloat16, "tied", True),
    (129, 64, 4096, torch.bfloat16, "dv", True),
    (100, 128, 1000, torch.bfloat16, "tied", True),
    (300, 1536, 1000, torch.bfloat16, "tied", True),  # d of Qwen2.5-1.5B
    (300, 1536, 1000, torch.bfloat16, "dv", True),
    (1100, 256, 1000, torch.bfloat16, "tied", True),  # two backward chunks
    (40, 100, 777, torch.bfloat16, "dv", False),  # rows not 16-byte aligned
])
def test_cuda_logprob_vs_plain(cuda_device, T, d, V, dtype, layout, wgmma):
    """Token logprob + entropy kernel, forward and backward, against its
    plain version in float32 on the same input values (the kernel
    accumulates in float32; bf16 products are exact in float32), for both
    layouts of w, odd vocabularies and depths that are not a multiple of
    the tile depth; T and V not multiples of the wgmma kernel's tiles (128
    tokens, 128 vocab entries). bf16 operands with 16-byte aligned rows
    take the wgmma forward and backward, others the first design: LAUNCHES
    says which. Tolerances: forward 1e-4 + 1e-5 |ref|; backward 1e-5
    max|ref| + (1e-4 float32, 1e-2 bf16 output rounding) |ref|."""
    h, w, t = _logprob_inputs(T * 7 + d, T, d, V)
    th = torch.from_numpy(h).to(cuda_device, dtype)
    if layout == "tied":
        tw = torch.from_numpy(np.ascontiguousarray(w.T)).to(
            cuda_device, dtype).T
    else:
        tw = torch.from_numpy(w).to(cuda_device, dtype)
    tt = torch.from_numpy(t).to(cuda_device)
    f0, b0 = lops.LAUNCHES["forward"], lops.LAUNCHES["backward"]
    w0, bw0 = lops.LAUNCHES["forward_wgmma"], lops.LAUNCHES["backward_wgmma"]
    hk = th.clone().requires_grad_(True)
    wk = tw.detach().clone().requires_grad_(True) if layout == "dv" else \
        tw.detach().T.clone().requires_grad_(True)
    lp, en = lops.token_logprob_entropy(hk, wk if layout == "dv" else wk.T,
                                        tt)
    h32 = th.float().requires_grad_(True)
    w32 = tw.float().detach().requires_grad_(True)
    lp_r, en_r = token_logprob_entropy_ref(h32, w32, tt)
    for o, r in ((lp, lp_r), (en, en_r)):
        torch.testing.assert_close(o, r.detach(), rtol=1e-5, atol=1e-4)
    g = torch.randn(2, T, device=cuda_device)
    ((lp * g[0]).sum() + (en * g[1]).sum()).backward()
    ((lp_r * g[0]).sum() + (en_r * g[1]).sum()).backward()
    dwk = wk.grad if layout == "dv" else wk.grad.T
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    for o, r in ((hk.grad, h32.grad), (dwk, w32.grad)):
        assert o.dtype == dtype
        torch.testing.assert_close(o.float(), r, rtol=rtol,
                                   atol=1e-5 * float(r.abs().max()))
    assert lops.LAUNCHES["forward"] - f0 == 1
    assert lops.LAUNCHES["forward_wgmma"] - w0 == int(wgmma)
    assert lops.takes_wgmma(hk, wk if layout == "dv" else wk.T) == wgmma
    assert lops.LAUNCHES["backward"] - b0 == -(-T // lops.CHUNK)
    assert lops.LAUNCHES["backward_wgmma"] - bw0 == \
        int(wgmma) * -(-T // lops.CHUNK)
    # dw is laid out as w: the tied embedding's gradient comes back in the
    # embedding's own (contiguous) layout
    lp, _ = lops.token_logprob_entropy(hk, wk if layout == "dv" else wk.T,
                                       tt)
    (gw,) = torch.autograd.grad(lp.sum(), [wk])
    assert gw.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("cotangents", ["both", "logp_only"])
@pytest.mark.parametrize("T,d,V,layout", [(300, 1536, 1000, "tied"),
                                          (129, 64, 4096, "dv"),
                                          (64, 512, 513, "tied"),
                                          (7, 48, 40, "dv")])
def test_cuda_logprob_dlogits_parts_vs_plain(cuda_device, T, d, V, layout,
                                             cotangents):
    """The wgmma cotangent kernel's dl, a bf16 high part over a bf16
    remainder in rows padded to a multiple of 8, against its plain version:
    the float32 dl of the plain logits (``dlogits_ref``; ``split_hi_lo``
    gives the parts). The kernel's logits differ by float32 summation
    order, so the parts are held as the value they carry, within 1e-5
    max|dl| + 1e-4 |dl|; T and V not multiples of the 128-wide tiles, both
    layouts of w, the entropy's cotangent absent (a null pointer)."""
    h, w, t = _logprob_inputs(T + V, T, d, V)
    th = torch.from_numpy(h).to(cuda_device, torch.bfloat16)
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).to(
        cuda_device, torch.bfloat16).T if layout == "tied" else \
        torch.from_numpy(w).to(cuda_device, torch.bfloat16)
    tt = torch.from_numpy(t).to(cuda_device)
    assert lops.takes_wgmma(th, tw)
    _, _, logz, mu = lops._forward_kernel(th, tw, tt)
    g = torch.randn(2, T, device=cuda_device)
    g_ent = g[1].contiguous() if cotangents == "both" else None
    ldv = -(-V // 8) * 8
    buf = torch.full((2 * T * ldv,), float("nan"), dtype=torch.bfloat16,
                     device=cuda_device)
    b0 = lops.LAUNCHES["backward_wgmma"]
    dl = lops.dlogits_parts(th, tw, tt, logz, mu, g[0], g_ent, 0, T, buf)
    assert dl.shape == (2 * T, ldv) and dl.data_ptr() == buf.data_ptr()
    assert lops.LAUNCHES["backward_wgmma"] - b0 == 1
    ref = dlogits_ref(th.float() @ tw.float(), tt, logz, mu, g[0], g_ent)
    got = dl[:T, :V].double() + dl[T:, :V].double()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref.double(), rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))
    hi, _ = split_hi_lo(ref)
    assert float((dl[:T, :V] == hi).float().mean()) > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("T,layout", [(1100, "tied"), (2300, "dv")])
def test_cuda_logprob_backward_reads_no_stale_memory(cuda_device, monkeypatch,
                                                     T, layout):
    """The wgmma backward over several token chunks with every buffer it
    allocates filled with NaN first: dw's float32 accumulator starts from a
    product with beta 0, so nothing stale reaches dh or dw; both against
    the plain float32 backward on the same logz, mu and cotangents, within
    1e-5 max|ref| + 1e-2 |ref| (bf16 output rounding)."""
    d, V = 256, 1000
    h, w, t = _logprob_inputs(T + 3, T, d, V)
    th = torch.from_numpy(h).to(cuda_device, torch.bfloat16)
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).to(
        cuda_device, torch.bfloat16).T if layout == "tied" else \
        torch.from_numpy(w).to(cuda_device, torch.bfloat16)
    tt = torch.from_numpy(t).to(cuda_device)
    _, _, logz, mu = lops._forward_kernel(th, tw, tt)
    g = torch.randn(2, T, device=cuda_device)
    empty = torch.empty

    def poisoned(*args, **kw):
        x = empty(*args, **kw)
        return x.fill_(float("nan")) if x.is_floating_point() else x
    monkeypatch.setattr(torch, "empty", poisoned)
    b0 = lops.LAUNCHES["backward_wgmma"]
    dh, dw = lops._backward_kernel(th, tw, tt, logz, mu, g[0], g[1], True,
                                   True)
    monkeypatch.undo()
    assert lops.LAUNCHES["backward_wgmma"] - b0 == -(-T // lops.CHUNK) > 1
    ref = token_logprob_entropy_bwd_ref(th.float(), tw.float(), tt, logz,
                                        mu, g[0], g[1])
    for o, r in zip((dh, dw), ref):
        assert o.dtype == torch.bfloat16
        torch.testing.assert_close(o.float(), r, rtol=1e-2,
                                   atol=1e-5 * float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,L,hd", [(12, 2, 1056, 128), (12, 2, 1000, 128),
                                       (12, 1, 300, 128), (48, 1, 300, 128),
                                       (16, 2, 40, 64), (6, 1, 2000, 64)])
def test_cuda_dense_decode_split_boundaries(cuda_device, H, KV, L, hd):
    """The bf16 split-KV dense decode against its plain version in float32
    at 16 rows whose lengths lie on the wrapper's split boundaries, on
    16-key tiles and one key past them (L and 1 included; L not always a
    multiple of the tile; one split when L is short), at groups of 6, 12,
    48 and 8; a row of length 0 gives 0; one launch."""
    B = 16
    sk, n = dense_kernel.split_plan(B, KV, L, paged_kernel.sm_count(
        cuda_device.index or 0))
    want = [L, sk + 1, sk, sk - 1, 2 * sk + 1, 16, 17, 1, L - 1,
            (n - 1) * sk + 1, (n - 1) * sk, 15, 33, 2 * sk, 0, L // 2]
    lens = np.clip(want, 0, L).astype(np.int32)
    kc, vc, _ = _dense_cache(L + H, B, L, KV, hd)
    kc, vc = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
              for a in (kc, vc))
    tl = torch.from_numpy(lens).to(cuda_device)
    q = torch.randn(B, H, hd, device=cuda_device).to(torch.bfloat16)
    d0 = dops.DENSE_LAUNCHES
    out = dops.decode_attention_op(q, kc, vc, tl)
    assert dops.DENSE_LAUNCHES - d0 == 1
    assert dops.DENSE_PLAN == (sk, n)
    ref = decode_attention_ref(q.float(), kc.float(), vc.float(), tl)
    live = tl > 0
    torch.testing.assert_close(out[live].float(), ref[live], rtol=1e-2,
                               atol=1e-4)
    assert bool((out[~live] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-2, 1e-4)])
@pytest.mark.parametrize("B,H,KV,S,hd,window,layout", [
    (2, 12, 2, 200, 128, None, "bshd"),   # Qwen heads, ragged S, strided
    (2, 12, 2, 256, 128, 64, "bhsd"),     # window across key tiles
    (3, 2, 1, 37, 64, None, "bhsd"),      # toy-2m heads, S < one key tile
    (1, 16, 2, 130, 64, None, "bshd"),    # group of 8
    (2, 12, 2, 1000, 128, 16, "bshd"),    # window smaller than a tile
    (1, 12, 1, 200, 128, None, "bshd"),   # a group of 12
    (1, 48, 1, 130, 128, 64, "bhsd"),     # a group of 48 (six chunks)
])
def test_cuda_flash_vs_plain(cuda_device, dtype, rtol, atol, B, H, KV, S,
                             hd, window, layout):
    """Flash attention kernel against its plain version in float32 on the
    same input values (bf16: relative tolerance for the output rounding,
    as chip_smoke.py), with [B,S,H,hd] activations read and written in
    place through their strides; one launch each."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _flash_inputs(S * hd, B, H, KV, S, hd))
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    f0 = fops.LAUNCHES
    out = fops.flash_attention(q, k, v, window=window)
    assert out.stride() == q.stride()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), window=window)
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    assert fops.LAUNCHES - f0 == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-2, 1e-4)])
@pytest.mark.parametrize("B,H,KV,L,hd", [(5, 12, 2, 1056, 128),
                                         (3, 2, 1, 40, 64),
                                         (2, 16, 2, 300, 64),
                                         (2, 12, 1, 300, 128),
                                         (2, 48, 1, 300, 128)])
def test_cuda_dense_decode_vs_plain(cuda_device, dtype, rtol, atol, B, H,
                                    KV, L, hd):
    """Dense decode kernel against its plain version in float32 on the same
    input values, lengths 1 and L included; a row of length 0 gives 0; one
    launch per call."""
    kc, vc, lengths = (torch.from_numpy(a).to(cuda_device)
                       for a in _dense_cache(B + L, B, L, KV, hd))
    kc, vc = kc.to(dtype), vc.to(dtype)
    q = torch.randn(B, H, hd, device=cuda_device).to(dtype)
    d0 = dops.DENSE_LAUNCHES
    out = dops.decode_attention_op(q, kc, vc, lengths)
    ref = decode_attention_ref(q.float(), kc.float(), vc.float(), lengths)
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    lengths[1] = 0
    assert bool((dops.decode_attention_op(q, kc, vc, lengths)[1] == 0).all())
    assert dops.DENSE_LAUNCHES - d0 == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-2, 1e-4)])
@pytest.mark.parametrize("case", ["last_chunk", "first_chunk", "zamba2",
                                  "split_boundaries", "round_robin"])
def test_cuda_prefill_cases(cuda_device, dtype, rtol, atol, case):
    """Paged prefill against its plain version in float32 on the same
    input values at the chunks the engine packs: the last chunk of a
    1024-token prompt (one segment of 256 rows at 768 .. 1023), a first
    chunk of several prompts from position 0, zamba2's heads (H = KV = 32,
    hd 64), rows ending on page and split boundaries and one key past
    them, and rows of segments taken in turn (a tile of many segments);
    padding rows give 0; one launch each."""
    from repro_torch.kernels.prefill_attn import kernel as pk
    H, KV, hd, bs, mb = 12, 2, 128, 16, 128
    rng = np.random.default_rng(31)
    if case == "zamba2":
        H, KV, hd = 32, 32, 64
    S = 8
    pool_k, pool_v, _, _ = _paged_pool(32, S, KV, S * mb, bs, mb, hd)
    tables = rng.permutation(S * mb).reshape(S, mb).astype(np.int32)
    pps, _ = pk.split_plan(256, H // KV, KV, mb, bs, 132)
    sk = pps * bs
    if case == "last_chunk":
        seg, pos = [0] * 256, list(range(768, 1024))
    elif case == "round_robin":
        lengths = rng.integers(300, mb * bs + 1, size=S)
        seg, pos = (list(a) for a in _prefill_rows(33, 252, lengths, 0))
    else:
        if case == "split_boundaries":
            ends = [sk, sk + 1, sk - 1, 2 * sk + 1, bs, bs + 1, 1, mb * bs]
        else:  # prompts from position 0, shortest remaining first
            ends = sorted(int(x) for x in rng.integers(20, 120, size=S))
        seg, pos = [], []
        for s_, end in enumerate(ends):
            n = min(end, 31, 248 - len(seg))
            seg += [s_] * n
            pos += list(range(end - n, end))
    seg += [-1] * 8
    pos += [0] * 8
    seg, pos = np.array(seg, np.int32), np.array(pos, np.int32)
    lens = np.zeros(S, np.int64)
    for s_ in range(S):
        if (seg == s_).any():
            lens[s_] = pos[seg == s_].max() + 1
        tables[s_, -(-int(max(lens[s_], 1)) // bs):] = -1
    C = len(seg)
    q = rng.standard_normal((C, H, hd)).astype(np.float32)
    tq, tk, tv = (t.to(cuda_device, dtype) for t in _t(q, pool_k, pool_v))
    tt, ts, tp = (t.to(cuda_device) for t in _t(tables, seg, pos))
    p0 = pops.LAUNCHES
    out = pops.paged_prefill_attention_op(tq, tk, tv, tt, ts, tp)
    assert pops.LAUNCHES - p0 == 1
    ref = paged_prefill_attention_ref(tq.float(), tk.float(), tv.float(), tt,
                                      ts, tp)
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    assert bool((out[ts < 0] == 0).all())
