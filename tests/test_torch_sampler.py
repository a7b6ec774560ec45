"""The port's top-p sampler against the reference's: the set of tokens each
keeps for a row, including rows whose cumulative mass never reaches
``top_p`` in float32 (the cutoff index would be V: the port clamps it to
the smallest logit, the reference's out-of-range take fills NaN; neither
masks anything).

Sets are compared, not draws: the port draws from a ``torch.Generator``,
the reference from a JAX key. The reference's kept set is read from the
logits it hands ``jax.random.categorical``. At a ``top_p`` this close to
1 the cutoff sits in the row's flat tail, where the two packages' float32
cumsums round apart by a few ulps of 1 and move it by tens of tokens of
probability ~1e-9: the kept sets are compared on rows whose mass stays
below ``top_p`` in both (every token kept) and at cutoffs mid-vocabulary.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rollout import sampler as jsampler
from repro_torch.rollout.sampler import sample_token, top_p_filter

# float32 rounds it to 1 - 2^-24: a cumsum of 1000 softmax terms that
# ends a few ulps below 1 never reaches it, and the cutoff index counts
# all V entries
FULL_TOP_P = 0.99999995
V = 1000


def _seeded_rows():
    torch.manual_seed(0)
    return torch.randn(4, V) * 3


def _rows_past_the_mass_in_both():
    """Rows (seed, row of ``torch.randn(4, V) * 3``) whose float32 mass
    stays below FULL_TOP_P under both packages' cumsums."""
    rows = []
    for seed, row in ((13, 0), (2, 1), (7, 1), (8, 3)):
        torch.manual_seed(seed)
        rows.append((torch.randn(4, V) * 3)[row])
    return torch.stack(rows)


def _reference_kept(logits: np.ndarray, top_p: float) -> np.ndarray:
    """The reference's kept set: the entries of the logits its sampler
    hands ``jax.random.categorical`` that are not -inf."""
    seen = {}

    def categorical(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    fake = types.SimpleNamespace(
        nn=jax.nn, random=types.SimpleNamespace(categorical=categorical))
    real = jsampler.jax
    jsampler.jax = fake
    try:
        jsampler.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                              top_p=top_p)
    finally:
        jsampler.jax = real
    return np.isfinite(seen["logits"])


def _port_kept(logits: torch.Tensor, top_p: float) -> np.ndarray:
    return torch.isfinite(top_p_filter(logits.float(), top_p)).cpu().numpy()


def _mass_below(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """[B] bool: the port's float32 cumsum of the row's sorted softmax
    never reaches ``top_p``."""
    srt = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    return cum[:, -1] < top_p


def _draws_from_kept(logits, kept, top_p, device="cpu"):
    """sample_token's draws lie in the kept set and its logp is the full
    log_softmax at the token."""
    for seed in range(8):
        tok, logp = sample_token(
            logits, torch.Generator(device=device).manual_seed(seed),
            top_p=top_p)
        tok = tok.cpu().numpy()
        assert ((tok >= 0) & (tok < V)).all()
        assert kept[np.arange(len(tok)), tok].all()
        ref = torch.log_softmax(logits, -1).gather(
            -1, torch.as_tensor(tok, device=logits.device)[:, None])[:, 0]
        torch.testing.assert_close(logp, ref, rtol=0, atol=1e-6)


def test_top_p_row_past_the_mass_samples():
    """``torch.manual_seed(0); torch.randn(4, 1000) * 3`` at top_p
    0.99999995: row 0's mass stays below top_p, so the cutoff index was V
    and the gather raised (index 1000 out of bounds). It now samples, and
    row 0 keeps all V tokens."""
    logits = _seeded_rows()
    below = _mass_below(logits, FULL_TOP_P)
    assert bool(below[0])
    kept = _port_kept(logits, FULL_TOP_P)
    assert kept[below.numpy()].all()
    assert (kept.sum(-1) >= 900).all()
    _draws_from_kept(logits, kept, FULL_TOP_P)


@pytest.mark.parametrize("rows,top_p", [("past_the_mass", FULL_TOP_P),
                                        ("seeded", 0.9), ("seeded", 0.5)])
def test_top_p_kept_set_matches_reference(rows, top_p):
    """Rows whose mass stays below top_p in both packages keep all V
    tokens in both; at 0.9 and 0.5 the cutoff falls mid-vocabulary and
    both keep the same strict subset. sample_token draws from it."""
    logits = (_rows_past_the_mass_in_both() if rows == "past_the_mass"
              else _seeded_rows())
    kept = _port_kept(logits, top_p)
    np.testing.assert_array_equal(kept, _reference_kept(logits.numpy(),
                                                        top_p))
    if rows == "past_the_mass":
        assert bool(_mass_below(logits, top_p).all()) and kept.all()
    else:
        assert 0 < kept.sum(-1).min() and kept.sum(-1).max() < V
    _draws_from_kept(logits, kept, top_p)


@pytest.mark.cuda
def test_cuda_top_p_row_past_the_mass_samples():
    """On the card the rows sample without a device-side assert; a row
    whose mass stays below top_p under the card's cumsum keeps all V
    tokens, and the cutoffs at 0.9 keep what the reference keeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run `PYTHONPATH=src "
                    "python -m pytest -m cuda tests/test_torch_sampler.py`")
    for rows in (_seeded_rows(), _rows_past_the_mass_in_both()):
        logits = rows.cuda()
        kept = _port_kept(logits, FULL_TOP_P)
        assert kept[_mass_below(logits, FULL_TOP_P).cpu().numpy()].all()
        _draws_from_kept(logits, kept, FULL_TOP_P, device="cuda")
        torch.cuda.synchronize()
    logits = _seeded_rows()
    np.testing.assert_array_equal(_port_kept(logits.cuda(), 0.9),
                                  _reference_kept(logits.numpy(), 0.9))
