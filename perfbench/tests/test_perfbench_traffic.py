"""The traffic generator: seeded, within each cell's ranges, and the same
work for every seed."""
import numpy as np
import pytest

from perfbench import harness, traffic

CELLS = [w for w in harness.spec()["workloads"]]


@pytest.mark.parametrize("wl", CELLS, ids=[w["name"] for w in CELLS])
def test_same_seed_same_batches(wl):
    tr = harness.traffic_file(wl["traffic"])
    vocab = harness.config_file(harness.spec(), wl["config"])["model"][
        "vocab_size"]
    a = traffic.generate(tr, vocab, 2 ** 31 + 11)
    b = traffic.generate(tr, vocab, 2 ** 31 + 11)
    c = traffic.generate(tr, vocab, 2 ** 31 + 12)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["tokens"], c[0]["tokens"])


@pytest.mark.parametrize("wl", CELLS, ids=[w["name"] for w in CELLS])
def test_ranges_and_padding(wl):
    tr = harness.traffic_file(wl["traffic"])
    vocab = harness.config_file(harness.spec(), wl["config"])["model"][
        "vocab_size"]
    T = tr["row_len"]
    for seed in (0, 2 ** 31 + 5, 2 ** 33 + 1):
        pool = traffic.generate(tr, vocab, seed)
        assert len(pool) == tr["pool"]
        for b in pool:
            B = tr["prompts"] * tr["group"]
            assert b["tokens"].shape == (B, T)
            p, n = b["prompt"], b["lengths"]
            assert (p >= tr["prompt_len"]["low"]).all()
            assert (p <= tr["prompt_len"]["high"]).all()
            assert (n > p).all() and (n <= T).all()
            lo, hi = tr["staleness"]["low"], tr["staleness"]["high"]
            assert (b["stale"] >= lo).all() and (b["stale"] <= hi).all()
            for r in range(B):
                assert (b["tokens"][r, :n[r]] > 0).all()
                assert (b["tokens"][r, n[r]:] == 0).all()
                want = np.zeros(T - 1)
                want[p[r] - 1:n[r] - 1] = 1
                np.testing.assert_array_equal(b["mask"][r], want)
            # a group shares its prompt
            g = tr["group"]
            for j in range(0, B, g):
                for r in range(j + 1, j + g):
                    assert p[r] == p[j]
                    np.testing.assert_array_equal(b["tokens"][r, :p[r]],
                                                  b["tokens"][j, :p[j]])
            assert set(np.unique(b["rewards"])) <= {0.0, 1.0}


@pytest.mark.parametrize("wl", CELLS, ids=[w["name"] for w in CELLS])
def test_every_seed_and_batch_does_the_same_work(wl):
    tr = harness.traffic_file(wl["traffic"])
    totals = {traffic.real_tokens(b) for s in (1, 2, 3 ** 20)
              for b in traffic.generate(tr, 1000, s)}
    assert len(totals) == 1
    sizes = traffic.sizes(tr)
    assert len(sizes) == tr["prompts"]
    assert all(len(r) == tr["group"] for _, r in sizes)


def test_lognormal_quantiles_have_the_stated_median():
    q = traffic._quantiles({"dist": "lognormal", "median": 256,
                            "sigma": 0.8}, 31)
    assert q[15] == 256
    assert (np.diff(q) >= 0).all()
