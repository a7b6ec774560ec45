"""The paged engine's dense prefill mode (``prefill_mode="dense"``) of the
PyTorch port against the JAX package's, float32 on the CPU.

The scenarios are those of ``tests/test_prefill_pipeline.py`` that use the
dense mode (greedy tokens and sampling logits with slot reuse, the dense
bucket ladder), plus a radix hit whose tail runs through
``_prefill_suffix`` (with a copy-on-write fork), one the dense rule
refuses, and a run through the serving control plane. Each runs once
through each package on the same numpy-made prompts and the same weights:
generated tokens, version stamps, prefix hits, block accounting and
counters must be equal, behaviour logps and logits within 1e-4
(``tests/test_torch_serving.py``).

Weights: toy-2m drawn from a seeded ``torch.Generator`` with the layer
weights x8 (at init stds a random model repeats its last token), handed to
JAX as numpy arrays and to the port by ``from_jax``, as
``tests/test_torch_control_plane.py`` does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.async_rl.weights import WeightStore as JaxWeightStore
from repro.configs.registry import get_config as jax_get_config
from repro.rollout.continuous import ContinuousBatchingEngine as JaxEngine
from repro.rollout.continuous import Request as JaxRequest
from repro.serving import AdmissionScheduler as JaxScheduler
from repro.serving import RadixPrefixCache as JaxRadix
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import ServingControlPlane as JaxControlPlane
from repro_torch.async_rl.weights import WeightStore
from repro_torch.configs.registry import get_config
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_jax, walk
from repro_torch.rollout.continuous import ContinuousBatchingEngine, Request
from repro_torch.serving import (
    AdmissionScheduler,
    RadixPrefixCache,
    SchedulerConfig,
    ServingControlPlane,
)

TOL = 1e-4
# the reference's own dense-against-chunked tolerance on sampling logits
# (tests/test_prefill_pipeline.py)
MODE_TOL = 1e-5


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def sides():
    """(jax, torch) sides: config, weights, classes, and what ``run`` /
    ``step`` take for sampling (a key; the port greedy takes none)."""
    params = tmodel.init_params(_f32(get_config("toy-2m")),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    tree = {}
    for path, t in walk(params):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        a = t.numpy().copy()
        scale = path[0] == "blocks" and not path[1].startswith("ln")
        node[path[-1]] = a * np.float32(8.0) if scale else a
    jax_side = dict(
        name="jax", cfg=_f32(jax_get_config("toy-2m")),
        params=jax.tree.map(jnp.asarray, tree), Engine=JaxEngine,
        Request=JaxRequest, Radix=JaxRadix, Store=JaxWeightStore,
        Scheduler=JaxScheduler, SchedulerConfig=JaxSchedulerConfig,
        ControlPlane=JaxControlPlane, key=jax.random.PRNGKey(0), kw={})
    torch_side = dict(
        name="torch", cfg=_f32(get_config("toy-2m")),
        params=from_jax(tree, device="cpu"), Engine=ContinuousBatchingEngine,
        Request=Request, Radix=RadixPrefixCache, Store=WeightStore,
        Scheduler=AdmissionScheduler, SchedulerConfig=SchedulerConfig,
        ControlPlane=ServingControlPlane, key=None, kw={"device": "cpu"})
    return jax_side, torch_side


def _engine(side, **kw):
    base = dict(max_seqs=2, block_size=4, n_blocks=64, max_blocks_per_seq=16,
                greedy=True, prefill_chunk=8, prefill_mode="dense")
    base.update(kw)
    return side["Engine"](side["cfg"], **side["kw"], **base)


def _prompt(n, seed):
    """n token ids of toy-2m's vocabulary (64), none of them special."""
    return np.random.default_rng(seed).integers(4, 64, size=n).astype(
        np.int32)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _reqs(reqs):
    return {int(r.rid): {"generated": [int(t) for t in r.generated],
                         "versions": [int(v) for v in r.token_versions],
                         "prefix_hit_tokens": int(r.prefix_hit_tokens),
                         "logp": list(map(float, r.gen_logp))}
            for r in reqs}


def _agree(a, b, key=""):
    """Exact equality, except for logps and logits: within 1e-4."""
    if isinstance(a, dict):
        assert set(a) == set(b), (key, set(a) ^ set(b))
        for k in a:
            _agree(a[k], b[k], k)
    elif key.endswith(("logp", "logits")):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=0,
                                   atol=TOL, err_msg=key)
    else:
        assert a == b, (key, a, b)


def _drain(side, eng, n):
    done, steps = [], 0
    while len(done) < n:
        done += eng.step(side["params"], side["key"])
        steps += 1
        assert steps < 200, "engine did not finish"
    return done


def _slot_reuse(side, mode):
    prompts = [_prompt(n, seed=n) for n in (5, 9, 13, 24)]
    eng = _engine(side, prefill_mode=mode)
    for p in prompts:
        eng.submit(p, max_new=6)
    done = eng.run(side["params"], side["key"])
    solo = _engine(side, prefill_mode=mode)
    solo.admit_request(side["params"], 0, side["Request"](1, prompts[3], 6))
    return {"reqs": _reqs(done), "n_free": eng.allocator.n_free,
            "shapes": sorted(map(str, eng._prefill_shapes)),
            "logits": _np(solo._next_logits[0])}


def test_dense_matches_jax_with_slot_reuse(sides):
    """Four prompts (5 / 9 / 13 / 24 tokens) through two slots: the port's
    dense mode gives JAX's dense greedy tokens, logps within 1e-4, the
    same launch shapes, and the pool drains to n_blocks - 1; its sampling
    logits agree with JAX's within 1e-4 and with its own chunk lane's
    within the reference's 1e-5, whose tokens are the same."""
    j, t = (_slot_reuse(side, "dense") for side in sides)
    _agree(j, t)
    assert t["n_free"] == 63 and len(t["reqs"]) == 4
    assert t["shapes"] == ["('dense', 16)", "('dense', 24)", "('dense', 8)"]
    c = _slot_reuse(sides[1], "chunked")
    assert {r: v["generated"] for r, v in c["reqs"].items()} \
        == {r: v["generated"] for r, v in t["reqs"].items()}
    np.testing.assert_allclose(c["logits"], t["logits"], rtol=MODE_TOL,
                               atol=MODE_TOL)


def test_dense_bucket_ladder_one_shape(sides):
    """Lengths 9-15 pad to one bucket (16): one launch shape in both
    packages; and the ladder (C/4, C/2, C, then whole chunks) is the
    reference's for every length up to 4 chunks."""
    out = []
    for side in sides:
        eng = _engine(side, max_seqs=4)
        for i, n in enumerate((9, 11, 13, 15)):
            eng.admit_request(side["params"], i,
                              side["Request"](i + 1, _prompt(n, seed=n), 2))
        assert eng.prefill_compiles == 1, eng._prefill_shapes
        big = _engine(side, prefill_chunk=32)
        out.append([big._dense_bucket(n) for n in range(1, 129)])
    assert out[0] == out[1]
    assert out[1][:9] == [8] * 8 + [16] and out[1][32:34] == [64, 64]


def _radix(side):
    """A 16-token prompt, then one sharing its first 10 tokens (the tail
    of 6 runs through _prefill_suffix and forks the shared third page),
    then a 32-token prompt sharing 4 (a tail of 27 > max(8, 15): the
    dense rule refuses the hit and the prompt is prefilled whole)."""
    a = _prompt(16, seed=1)
    b = np.concatenate([a[:10], _prompt(6, seed=2)])
    c = np.concatenate([a[:4], _prompt(28, seed=3)])
    eng = _engine(side, max_seqs=3)
    eng.prefix_cache = side["Radix"](eng.allocator, eng.state.block_size)
    rec = {"needed": [], "n_free": [], "logits": []}
    for slot, p in enumerate((a, b, c)):
        rec["needed"].append(int(eng.blocks_needed(p, 4)))
        eng.admit_request(side["params"], slot,
                          side["Request"](slot + 1, p, 4))
        rec["n_free"].append(eng.allocator.n_free)
        rec["logits"].append(_np(eng._next_logits[slot]))
    rec["hits"] = [eng.slots[s].prefix_hit_tokens for s in range(3)]
    rec["forks"] = eng.allocator.forks
    rec["shapes"] = sorted(map(str, eng._prefill_shapes))
    rec["reqs"] = _reqs(_drain(side, eng, 3))
    eng.prefix_cache.clear()
    rec["drained"] = eng.allocator.n_free
    return rec


def test_radix_hit_through_prefill_suffix_matches_jax(sides):
    """A radix hit whose tail runs token by token through the paged decode
    step (copy-on-write fork included) and a hit the dense rule refuses:
    hits, blocks needed, free counts, forks, logits and tokens as JAX's,
    and the port's logps equal its whole-sequence forward_logits."""
    j, t = (_radix(side) for side in sides)
    _agree(j, t)
    assert t["hits"] == [0, 10, 0] and t["forks"] == 1
    assert t["shapes"] == ["('dense', 16)", "('dense', 32)"]
    assert t["drained"] == 63
    params, cfg = sides[1]["params"], sides[1]["cfg"]
    a = _prompt(16, seed=1)
    prompts = {1: a, 2: np.concatenate([a[:10], _prompt(6, seed=2)]),
               3: np.concatenate([a[:4], _prompt(28, seed=3)])}
    for rid, r in t["reqs"].items():
        seq = np.concatenate([prompts[rid], r["generated"][:-1]])
        lp = torch.log_softmax(tmodel.forward_logits(
            params, cfg, torch.from_numpy(seq[None].astype(np.int64)))[0],
            -1)
        P = len(prompts[rid])
        ref = lp[P - 1:].gather(-1, torch.tensor(r["generated"])[:, None])
        np.testing.assert_allclose(r["logp"], ref[:, 0].numpy(), rtol=0,
                                   atol=TOL)


def _control_plane(side):
    """A warm wave of two prompts, then each twice more (radix hits at
    P - 1) with a pure-stamp publish after the first step, through a
    dense-mode control plane."""
    store = side["Store"](side["params"], 0)
    eng = _engine(side, max_seqs=4, decode_horizon=4)
    cp = side["ControlPlane"](eng, store, side["Scheduler"](
        side["SchedulerConfig"](d_max=100)))
    warm = [_prompt(n, seed=n) for n in (13, 22)]
    for p in warm:
        cp.submit(p, max_new=6)
    done = []
    while len(done) < 2:
        done += cp.step(side["key"])
    for p in warm:
        for _ in range(2):
            cp.submit(p, max_new=6)
    steps = 0
    while len(done) < 6:
        done += cp.step(side["key"])
        steps += 1
        if steps == 1:
            store.publish(side["params"], 1)
        assert steps < 100
    # every counter of the snapshot (none read from a host clock)
    counters = {k: v for k, v in cp.metrics.snapshot().items()
                if not k.startswith(("queue_delay_s", "ttft_s"))
                and "time_s" not in k and not k.endswith("per_s")}
    eng.prefix_cache.clear()
    return {"reqs": _reqs(done), "counters": counters,
            "forks": eng.allocator.forks, "n_free": eng.allocator.n_free}


def test_control_plane_dense_matches_jax(sides):
    """Through the serving control plane (which admits with
    prefill=False; dense mode prefills inline all the same): tokens,
    version stamps, prefix hits, prefill counters (the launch shapes
    included) and forks as JAX's; the pool drains to n_blocks - 1."""
    j, t = (_control_plane(side) for side in sides)
    _agree(j, t)
    hits = [r["prefix_hit_tokens"] for r in t["reqs"].values()]
    assert hits == [0, 0, 12, 12, 21, 21] and t["n_free"] == 63
    assert t["counters"]["prefill_chunks"] == 0
    assert t["counters"]["prefill_compiles"] == 2
    stamps = [v["versions"] for v in t["reqs"].values()]
    assert all(s == sorted(s) for s in stamps) and stamps[-1][-1] == 1


@pytest.mark.parametrize("arch, kw, message", [
    ("toy-2m", {"prefill_mode": "whole"}, "whole"),
    ("mamba2-370m-reduced", {"prefill_mode": "dense"},
     "requires the chunked prefill lane")])
def test_bad_prefill_mode_raises(arch, kw, message):
    with pytest.raises(ValueError, match=message):
        ContinuousBatchingEngine(_f32(get_config(arch)), device="cpu", **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_prefill_pipeline.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dense_mode_on_card_matches_cpu(cuda_device, sides):
    """Dense mode on the card (flash for the whole prompt, paged decode
    for a radix hit's tail and the decode lane) gives the CPU's tokens,
    hits, forks and free counts, logps and logits within 1e-4."""
    import copy
    side = dict(sides[1])
    out = []
    for dev in ("cpu", "cuda"):
        side["params"] = copy.deepcopy(sides[1]["params"]).to(dev)
        side["kw"] = {"device": dev}
        out.append(_radix(side))
    _agree(*out)
