"""The serving control plane of the PyTorch port (``repro_torch.serving``)
against the JAX package's, float32 on the CPU.

Each scenario runs once through each package on the same numpy-made
prompts and the same weights, and the two runs must agree: generated
tokens, version stamps, prefix hits, block accounting and metric counters
exactly, behaviour logps and logits within 1e-4. The scenarios are those
of ``tests/test_serving_control_plane.py``, ``tests/test_prefill_pipeline.py``
(those of the chunk lane that apply: the port compiles nothing; the dense
prefill mode's are in ``tests/test_torch_prefill_pipeline.py``) and
``tests/test_scheduler_properties.py``, with their own
assertions kept, plus the KV-pressure shed path, an SSM stack (no radix
cache), the threaded orchestrator and the launcher's ``--engine async``.

Weights: toy-2m at its init stds, drawn from a seeded ``torch.Generator``
(the JAX init folds ``hash()`` of each leaf's path into its key, so its
draws change with the interpreter's hash seed), with the layer weights x8
so that greedy decoding is decided by the layers (at init stds a random
model repeats its last token); the same numpy arrays go to JAX and, by
``from_jax``, to the port. The committed checkpoint
(``experiments/ckpt/toy-2m_loglinear``) answers these random prompts with
EOS at once, which leaves no generation to stamp across a publish; it
serves the prefix-sharing scenario, where a short answer suffices.
Tolerances: logps and logits 1e-4 (``tests/test_torch_serving.py``).
"""
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.async_rl.orchestrator import StepRecord as JaxStepRecord
from repro.async_rl.weights import WeightStore as JaxWeightStore
from repro.configs.base import RLConfig as JaxRLConfig
from repro.configs.registry import get_config as jax_get_config
from repro.core import a3po as ja3po
from repro.obs import runlog as jrunlog
from repro.obs.validate import validate_jsonl
from repro.rollout.continuous import ContinuousBatchingEngine as JaxEngine
from repro.rollout.continuous import Request as JaxRequest
from repro.rollout.paged_cache import BlockAllocator as JaxAllocator
from repro.serving import AdmissionScheduler as JaxScheduler
from repro.serving import RadixPrefixCache as JaxRadix
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import ServingControlPlane as JaxControlPlane
from repro.serving import ServingMetrics as JaxServingMetrics
from repro.training import trainer as jtrainer
from repro.training.checkpoints import load_checkpoint
from repro_torch.async_rl import orchestrator as orch
from repro_torch.async_rl.weights import WeightStore
from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import a3po as ta3po
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.launch import train as launcher
from repro_torch.models import model as tmodel
from repro_torch.models.params import from_jax, walk
from repro_torch.obs import validate as port_validate
from repro_torch.rollout.continuous import ContinuousBatchingEngine, Request
from repro_torch.rollout.paged_cache import BlockAllocator
from repro_torch.serving import (
    AdmissionScheduler,
    RadixPrefixCache,
    SchedulerConfig,
    ServingControlPlane,
    ServingMetrics,
)
from repro_torch.training import trainer as ttrainer

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "experiments" / "ckpt" / "toy-2m_loglinear"
LOGP_TOL = 1e-4
# metric keys read from host clocks (or, prefill_compiles, counted in
# another unit: the reference's jit compiles, the port's launch shapes)
_TIMED = ("queue_delay_s", "ttft_s")


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _seeded_params(name, seed, factor=1.0):
    """Seeded init of ``name`` as a nested dict of numpy arrays, the layer
    weights (not the norms) scaled by ``factor``."""
    params = tmodel.init_params(_f32(get_config(name)),
                                torch.Generator().manual_seed(seed),
                                device="cpu")
    tree = {}
    for path, t in walk(params):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        a = t.numpy().copy()
        scale = path[0] == "blocks" and not path[1].startswith("ln")
        node[path[-1]] = a * np.float32(factor) if scale else a
    return tree


def _sides(name, arrays):
    """(jax side, torch side) of one config and one nested dict of numpy
    weights: each names its package's classes, its weights and what its
    ``step`` calls take for sampling (a key; the port's generator, None
    greedy)."""
    jcfg = _f32(jax_get_config(name))
    jax_side = SimpleNamespace(
        name="jax", cfg=jcfg, params=jax.tree.map(jnp.asarray, arrays),
        Engine=JaxEngine,
        Request=JaxRequest, Store=JaxWeightStore, Radix=JaxRadix,
        Scheduler=JaxScheduler, SchedulerConfig=JaxSchedulerConfig,
        ControlPlane=JaxControlPlane, Allocator=JaxAllocator,
        key=jax.random.PRNGKey(0), engine_kw={})
    torch_side = SimpleNamespace(
        name="torch", cfg=_f32(get_config(name)),
        params=from_jax(arrays, device="cpu"),
        Engine=ContinuousBatchingEngine, Request=Request, Store=WeightStore,
        Radix=RadixPrefixCache, Scheduler=AdmissionScheduler,
        SchedulerConfig=SchedulerConfig, ControlPlane=ServingControlPlane,
        Allocator=BlockAllocator, key=None, engine_kw={"device": "cpu"})
    return jax_side, torch_side


@pytest.fixture(scope="module")
def toy():
    return _sides("toy-2m", _seeded_params("toy-2m", 0, 8.0))


@pytest.fixture(scope="module")
def toy_ckpt():
    tree, _ = load_checkpoint(str(CKPT))
    return _sides("toy-2m", tree["params"])


def _engine(side, **kw):
    base = dict(max_seqs=2, block_size=4, n_blocks=64, max_blocks_per_seq=8,
                greedy=True)
    base.update(kw)
    return side.Engine(side.cfg, **side.engine_kw, **base)


def _prompt(cfg, n=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(4, cfg.vocab_size, size=n).astype(np.int32)


def _reqs(reqs, logp=True):
    """Per-request record of what both packages must agree on."""
    out = {int(r.rid): {"generated": [int(t) for t in r.generated],
                        "versions": [int(v) for v in r.token_versions],
                        "prefix_hit_tokens": int(r.prefix_hit_tokens)}
           for r in reqs}
    if logp:
        for r in reqs:
            out[int(r.rid)]["logp"] = list(r.gen_logp)
    return out


def _hold_to_forward(side, reqs):
    """The port's behaviour logps against its whole-sequence
    forward_logits of prompt + generation."""
    for r in reqs:
        seq = np.concatenate([r.prompt, r.generated[:-1]]).astype(np.int64)
        lp = torch.log_softmax(tmodel.forward_logits(
            side.params, side.cfg, torch.from_numpy(seq[None]))[0], -1)
        P, n = len(r.prompt), len(r.generated)
        ref = lp[P - 1: P - 1 + n].gather(
            -1, torch.tensor(r.generated)[:, None])[:, 0]
        np.testing.assert_allclose(r.gen_logp, ref.numpy(), rtol=0,
                                   atol=LOGP_TOL)


def _counters(metrics):
    """The snapshot's keys that count (no host-clock reading)."""
    return {k: v for k, v in metrics.snapshot().items()
            if not k.startswith(_TIMED) and "time_s" not in k
            and not k.endswith("per_s") and k != "prefill_compiles"}


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    return x


def _agree(a, b, key=""):
    """Exact equality, except for logps, logits and alphas: 1e-4."""
    if isinstance(a, dict):
        assert set(a) == set(b), (key, set(a) ^ set(b))
        for k in a:
            _agree(a[k], b[k], k)
    elif key.endswith(("logp", "logits", "alpha")):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=0,
                                   atol=LOGP_TOL, err_msg=key)
    else:
        assert _plain(a) == _plain(b), (key, _plain(a), _plain(b))


def _both(scenario, sides, **kw):
    """Run ``scenario(side)`` through both packages; they must agree."""
    out = [scenario(side, **kw) for side in sides]
    _agree(*out)
    return out


# ------------------------------------------------------------ radix cache
def _radix_script(side):
    """One scripted life of a radix cache over a 32-block allocator."""
    alloc = side.Allocator(32)
    cache = side.Radix(alloc, 4)
    rng = np.random.default_rng(0)
    base = rng.integers(4, 64, size=13)
    div = np.concatenate([base[:6], rng.integers(4, 64, size=7)])
    log = []

    def state(label):
        log.append({"at": label, "n_free": alloc.n_free,
                    "refcount": {int(k): int(v)
                                 for k, v in alloc.refcount.items()},
                    "hits": cache.hits, "misses": cache.misses,
                    "evicted": cache.evicted_blocks,
                    "cached": cache.n_cached_blocks,
                    "evictable": cache.evictable_count()})

    a = alloc.alloc(4)                         # 13 tokens: 3 full + 1
    log.append(("insert", cache.insert(base, a)))
    alloc.release(a)                           # the sequence finished
    state("inserted")
    log.append(("lookup", cache.lookup(base, max_tokens=12)))
    log.append(("lookup_div", cache.lookup(div)))
    m1 = cache.match(base, max_tokens=12)      # 3 full + partial tail
    m2 = cache.match(div)                      # 1 full + 2 of the next
    log.append(("match", m1, m2))
    state("matched")
    fresh = alloc.alloc(3)
    # div's own blocks: the shared first block, then private copies
    log.append(("insert_div", cache.insert(div, m2[0][:1] + fresh)))
    alloc.release(fresh)
    log.append(("miss", cache.match(rng.integers(4, 64, size=9))))
    state("diverged")
    log.append(("evict_2", cache.evict(2)))
    state("evicted")
    alloc.release(m1[0])
    alloc.release(m2[0])
    log.append(("evict_all", cache.evict(100)))
    state("released")
    b = alloc.alloc(4)
    cache.insert(base, b)
    log.append(("clear", cache.clear()))
    alloc.release(b)
    state("cleared")
    return {"log": log}


def test_radix_cache_matches_jax(toy):
    """insert / lookup / match / evict / clear on both caches: the same
    block ids, hit counts, refcounts, evictions and free counts; the pool
    is whole again at the end."""
    j, t = _both(_radix_script, toy)
    assert t["log"][-1]["n_free"] == 32 and t["log"][-1]["refcount"] == {}
    assert t["log"][-1]["cached"] == 0


# -------------------------------------------------------------- scheduler
class _StubEngine:
    """Just the admission surface: unlimited blocks."""

    class _Alloc:
        n_free = 1 << 20

    allocator = _Alloc()

    def blocks_needed(self, prompt, max_new):
        return 1


def _sreq(rid, *, priority=0, submit_version=0, cls=Request):
    return cls(rid, np.arange(4, 12, dtype=np.int32), 4,
               priority=priority, submit_version=submit_version)


def _sdrain(sched, now_version=0, now_s=0.0):
    out = []
    while True:
        got = sched.pop_admissible(now_version, engine=_StubEngine(),
                                   now_s=now_s)
        if got is None:
            break
        out.append(got[0])
    return out


priorities = st.lists(st.integers(min_value=0, max_value=3),
                      min_size=1, max_size=32)


@settings(max_examples=60, deadline=None)
@given(priorities)
def test_pop_order_is_priority_then_arrival(prios):
    sched = AdmissionScheduler(SchedulerConfig(d_max=1 << 30))
    for i, p in enumerate(prios):
        sched.enqueue(_sreq(i, priority=p))
    popped = _sdrain(sched)
    assert len(popped) == len(prios)
    keys = [(r.priority, r.rid) for r in popped]
    assert keys == sorted(keys)


@settings(max_examples=60, deadline=None)
@given(priorities, st.floats(min_value=0.1, max_value=10.0))
def test_aging_promotes_but_never_loses_requests(prios, age):
    sched = AdmissionScheduler(
        SchedulerConfig(d_max=1 << 30, age_promote_s=age))
    for i, p in enumerate(prios):
        sched.enqueue(_sreq(i, priority=p), now_s=0.0)
    late = _sreq(len(prios), priority=3)
    sched.enqueue(late, now_s=age)  # too young to age at drain time
    popped = _sdrain(sched, now_s=age)  # originals all aged to prio 0
    assert sorted(r.rid for r in popped) == list(range(len(prios) + 1))
    if late.priority > 0:
        assert popped[-1].rid == late.rid
    aged_rids = [r.rid for r in popped[:-1]]
    assert aged_rids == sorted(aged_rids)


versions = st.lists(st.integers(min_value=0, max_value=20),
                    min_size=1, max_size=32)


@settings(max_examples=60, deadline=None)
@given(versions, st.integers(min_value=0, max_value=20),
       st.integers(min_value=0, max_value=8))
def test_never_admits_past_staleness_budget(subs, now_version, d_max):
    sched = AdmissionScheduler(SchedulerConfig(d_max=d_max))
    for i, v in enumerate(subs):
        sched.enqueue(_sreq(i, submit_version=v))
    popped = _sdrain(sched, now_version=now_version)
    dropped = sched.take_dropped()
    assert len(popped) + len(dropped) == len(subs)
    for r in popped:
        assert now_version - r.submit_version <= d_max
    for r in dropped:
        assert now_version - r.submit_version > d_max
        assert r.drop_reason == "staleness_budget"


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=0, max_value=5))
def test_max_preempts_is_a_hard_cap(max_preempts):
    sched = AdmissionScheduler(
        SchedulerConfig(d_max=1 << 30, max_preempts=max_preempts))
    sched.enqueue(_sreq(0))
    requeues = 0
    while True:
        got = sched.pop_admissible(0, engine=_StubEngine())
        assert got is not None
        action = sched.handle_preempted(got[0], 0)
        if action == "drop":
            break
        requeues += 1
        assert requeues <= max_preempts
    assert requeues == max_preempts
    dropped = sched.take_dropped()
    assert dropped[0].drop_reason == "max_preempts"
    assert dropped[0].preempt_count == max_preempts + 1


programs = st.lists(
    st.tuples(st.integers(min_value=1, max_value=4),   # blocks to alloc
              st.booleans()),                          # share one block?
    min_size=1, max_size=16)


@settings(max_examples=60, deadline=None)
@given(programs, st.randoms(use_true_random=False))
def test_allocator_roundtrip_under_sharing(prog, rnd):
    alloc = BlockAllocator(n_blocks=128)
    free0 = alloc.n_free
    held = []
    for n, share in prog:
        blocks = alloc.alloc(n)
        if share and held:
            b = rnd.choice(held)[0]
            alloc.incref(b)
            blocks = blocks + [b]
        held.append(blocks)
    assert alloc.n_free < free0
    rnd.shuffle(held)  # preemptions land in arbitrary order
    for blocks in held:
        for b in blocks:
            alloc.decref(b)
    assert alloc.n_free == free0
    assert alloc.refcount == {}


def _scheduler_script(side):
    """Enqueue / pop / preempt / age through one scheduler."""
    sched = side.Scheduler(side.SchedulerConfig(
        d_max=2, max_preempts=1, backpressure_high=0.5, age_promote_s=3.0))
    log = []
    for rid, (prio, sv, t) in enumerate([(1, 0, 0.0), (0, 0, 0.5),
                                         (2, 1, 1.0), (0, 3, 1.5),
                                         (1, 4, 2.0), (0, 0, 2.5)]):
        sched.enqueue(_sreq(rid, priority=prio, submit_version=sv,
                            cls=side.Request), now_s=t)
    for version, frac, now in ((3, 0.0, 2.6), (4, 0.6, 2.7), (4, 0.6, 4.0),
                               (4, 1.0, 4.1), (5, 0.0, 4.2)):
        got = sched.pop_admissible(version, engine=_StubEngine(),
                                   queue_frac=frac, now_s=now)
        log.append(("pop", version, None if got is None else
                    (got[0].rid, got[1])))
        if got is not None and got[0].rid % 2:
            log.append(("preempt", got[0].rid,
                        sched.handle_preempted(got[0], version, now)))
    slots = {0: _sreq(10, submit_version=1, cls=side.Request),
             1: None, 2: _sreq(11, submit_version=5, cls=side.Request)}
    slots[0].token_versions = [1, 2]
    log.append(("check_preempt", sched.check_preempt(slots, 4),
                dict(sched.preempt_reasons)))
    log.append(("drain", [r.rid for r in _sdrain(sched, 5, 9.0)]))
    log.append(("dropped", [(r.rid, r.drop_reason, r.preempt_count)
                            for r in sched.take_dropped()]))
    return {"log": log}


def test_scheduler_script_matches_jax(toy):
    """A scripted enqueue / pop / preempt / age sequence gives the same
    pop order, requeue actions, preemptions and drop reasons."""
    _, t = _both(_scheduler_script, toy)
    reasons = {r for _, r, _ in t["log"][-1][1]}
    assert reasons == {"staleness_budget", "max_preempts"}


# ---------------------------------------------- the seven control-plane tests
def _publish_mid_generation(side):
    store = side.Store(side.params, 0)
    eng = _engine(side)
    cp = side.ControlPlane(eng, store, side.Scheduler(
        side.SchedulerConfig(d_max=100)))
    prompt = _prompt(side.cfg)
    max_new = 8
    cp.submit(prompt, max_new=max_new)
    done, steps = [], 0
    while not done:
        done = cp.step(side.key)
        steps += 1
        if steps == 4:
            store.publish(side.params, 2)  # same params: a pure stamp
        assert steps < 50
    req = done[0]
    stamps = req.token_versions
    assert len(stamps) == len(req.generated) == len(req.gen_logp)
    assert stamps[0] == 0 and stamps[-1] == 2 and stamps == sorted(stamps)
    assert set(stamps) == {0, 2} and cp.metrics.interrupts == 1
    rb = cp.rollout_batch([req], prompt_pad=len(prompt), max_new=max_new)
    assert rb.gen_versions is not None and rb.min_version() == 0
    zeros = np.zeros((1,), np.float32)
    if side.name == "jax":
        tb = jtrainer.assemble_train_batch([rb], zeros)
        d = ja3po.staleness(tb.versions, current_version=3)
        alpha = ja3po.alpha_from_staleness(d, JaxRLConfig())
    else:
        tb = ttrainer.assemble_train_batch([rb], zeros, device="cpu")
        d = ta3po.staleness(tb.versions, current_version=3)
        alpha = ta3po.alpha_from_staleness(d, RLConfig())
    T = rb.tokens.shape[1]
    assert tuple(tb.versions.shape) == (1, T - 1) \
        == tuple(tb.behav_logp.shape) == tuple(alpha.shape)
    resp = np.asarray(tb.response_mask[0]) > 0
    np.testing.assert_allclose(sorted(np.unique(np.asarray(alpha[0])[resp])),
                               [1.0 / 3.0, 1.0], rtol=1e-6)
    assert np.all(np.asarray(tb.behav_logp[0])[resp] != 0.0)
    return {"reqs": _reqs(done), "steps": steps,
            "versions": np.asarray(tb.versions),
            "alpha": np.asarray(alpha),
            "behav_logp": np.asarray(tb.behav_logp),
            "metrics": _counters(cp.metrics)}


def test_publish_mid_generation_stamps_and_roundtrip(toy):
    """A publish mid-decode leaves a visible per-token version boundary,
    and the stamped batch flows through assemble_train_batch ->
    staleness -> alpha as [B, T], identically in both packages."""
    _both(_publish_mid_generation, toy)


def _prefix_sharing(side):
    prompt = _prompt(side.cfg, n=12)
    max_new = 4
    eng_nc = _engine(side)
    free0 = eng_nc.allocator.n_free
    eng_nc.admit_request(side.params, 0, side.Request(1, prompt, max_new))
    used_first = free0 - eng_nc.allocator.n_free
    eng_nc.admit_request(side.params, 1, side.Request(2, prompt, max_new))
    used_nc = (free0 - used_first) - eng_nc.allocator.n_free
    assert used_nc == used_first == 4
    eng_c = _engine(side)
    eng_c.prefix_cache = side.Radix(eng_c.allocator, eng_c.state.block_size)
    cfree0 = eng_c.allocator.n_free
    eng_c.admit_request(side.params, 0, side.Request(1, prompt, max_new))
    cused_first = cfree0 - eng_c.allocator.n_free
    eng_c.admit_request(side.params, 1, side.Request(2, prompt, max_new))
    cused_second = (cfree0 - cused_first) - eng_c.allocator.n_free
    assert eng_c.slots[1].prefix_hit_tokens == 11
    assert cused_second < used_nc
    logits_c = np.asarray(eng_c._next_logits[1])
    np.testing.assert_allclose(logits_c, np.asarray(eng_nc._next_logits[1]),
                               rtol=2e-4, atol=2e-4)
    done_nc, done_c = [], []
    while len(done_c) < 2 or len(done_nc) < 2:
        done_nc += eng_nc.step(side.params, side.key)
        done_c += eng_c.step(side.params, side.key)
    assert {r.rid: r.generated for r in done_c} \
        == {r.rid: r.generated for r in done_nc}
    return {"used": [used_first, used_nc, cused_first, cused_second],
            "logits": logits_c, "reqs": _reqs(done_c),
            "forks": eng_c.allocator.forks,
            "n_free": [eng_c.allocator.n_free, eng_nc.allocator.n_free]}


@pytest.mark.parametrize("weights", ["toy", "toy_ckpt"])
def test_prefix_cache_shares_blocks_and_matches_uncached(weights, request):
    """The second of two prefix-sharing requests allocates fewer fresh
    blocks, hits 11 of 12 prompt tokens and gives the uncached engine's
    logits and greedy tokens, in both packages alike."""
    _both(_prefix_sharing, request.getfixturevalue(weights))


def _eviction(side):
    eng = _engine(side)
    eng.prefix_cache = side.Radix(eng.allocator, eng.state.block_size)
    free0 = eng.allocator.n_free
    eng.admit_request(side.params, 0, side.Request(1, _prompt(side.cfg), 4))
    eng.release_slot(0)
    held = eng.prefix_cache.n_cached_blocks
    assert eng.allocator.n_free == free0 - held
    freed = eng.prefix_cache.evict(held)
    assert freed == held and eng.allocator.n_free == free0
    assert eng.allocator.refcount == {}
    return {"held": held, "freed": freed, "n_free": eng.allocator.n_free}


def test_prefix_cache_eviction_restores_allocator(toy):
    _both(_eviction, toy)


def _budget(side):
    store = side.Store(side.params, 0)
    eng = _engine(side)
    sched = side.Scheduler(side.SchedulerConfig(d_max=2,
                                                preempt_action="drop"))
    cp = side.ControlPlane(eng, store, sched, use_prefix_cache=False,
                           resubmit_dropped=False)
    free0 = eng.allocator.n_free
    cp.submit(_prompt(side.cfg), max_new=4)
    store.publish(side.params, 5)
    assert cp.step(side.key) == []
    assert cp.metrics.admitted == 0 and cp.metrics.drops == 1
    assert cp.n_inflight == 0 and eng.allocator.n_free == free0
    assert eng.allocator.refcount == {}
    cp.submit(_prompt(side.cfg), max_new=16)
    cp.step(side.key)
    assert cp.n_inflight == 1 and cp.metrics.admitted == 1
    mid_free = eng.allocator.n_free
    assert mid_free < free0
    store.publish(side.params, 20)
    cp.step(side.key)
    assert cp.metrics.preemptions == 1 and cp.n_inflight == 0
    assert eng.allocator.n_free == free0 and eng.allocator.refcount == {}
    return {"mid_free": mid_free, "metrics": _counters(cp.metrics),
            "dropped": [(r.rid, r.drop_reason)
                        for r in cp.dropped_requests]}


def test_scheduler_staleness_budget_and_block_release(toy):
    """Nothing is admitted past the staleness budget, and a preempted
    sequence returns every block, alike in both packages."""
    _both(_budget, toy)


def _aging(side):
    eng = _engine(side)
    bulk = side.Request(1, _prompt(side.cfg, seed=1), 2, priority=1)
    urgent = side.Request(2, _prompt(side.cfg, seed=2), 2, priority=0)
    sched = side.Scheduler(side.SchedulerConfig(d_max=100,
                                                backpressure_high=0.5))
    sched.enqueue(bulk, now_s=0.0)
    held = [sched.pop_admissible(0, engine=eng, queue_frac=0.8, now_s=t)
            for t in (0.0, 10.0, 1000.0)]
    assert held == [None] * 3
    sched = side.Scheduler(side.SchedulerConfig(
        d_max=100, backpressure_high=0.5, age_promote_s=1.0))
    sched.enqueue(bulk, now_s=0.0)
    assert sched.pop_admissible(0, engine=eng, queue_frac=0.8,
                                now_s=0.5) is None
    sched.enqueue(urgent, now_s=1.5)
    order = [sched.pop_admissible(0, engine=eng, queue_frac=0.8,
                                  now_s=1.5)[0].rid for _ in range(2)]
    assert order == [1, 2]
    return {"order": order}


def test_scheduler_aging_beats_backpressure_starvation(toy):
    _both(_aging, toy)


def _drop_reasons(side):
    store = side.Store(side.params, 0)
    eng = _engine(side)
    sched = side.Scheduler(side.SchedulerConfig(
        d_max=2, preempt_action="requeue", max_preempts=0))
    cp = side.ControlPlane(eng, store, sched, use_prefix_cache=False,
                           resubmit_dropped=False)
    cp.submit(_prompt(side.cfg), max_new=4)
    store.publish(side.params, 5)
    cp.step(side.key)
    assert cp.metrics.drops_staleness_budget == 1
    assert cp.dropped_requests[-1].drop_reason == "staleness_budget"
    assert cp.dropped_requests[-1].t_done >= 0
    cp.submit(_prompt(side.cfg), max_new=16)
    cp.step(side.key)
    store.publish(side.params, 20)
    cp.step(side.key)
    assert cp.metrics.preemptions == cp.metrics.preemptions_staleness == 1
    assert cp.metrics.drops_max_preempts == 1
    snap = cp.metrics.snapshot()
    assert snap["drops"] == snap["drops_staleness_budget"] + \
        snap["drops_max_preempts"] + snap["drops_slo_shed"]
    return {"metrics": _counters(cp.metrics),
            "dropped": [(r.rid, r.drop_reason)
                        for r in cp.dropped_requests]}


def test_drop_reason_counters(toy):
    _both(_drop_reasons, toy)


def _priority(side):
    store = side.Store(side.params, 0)
    eng = _engine(side, max_seqs=1)
    cp = side.ControlPlane(eng, store, side.Scheduler(
        side.SchedulerConfig(d_max=100)), use_prefix_cache=False)
    rid_bulk = cp.submit(_prompt(side.cfg, seed=1), max_new=2, priority=1)
    rid_urgent = cp.submit(_prompt(side.cfg, seed=2), max_new=2, priority=0)
    done = []
    while len(done) < 2:
        done += cp.step(side.key)
    assert [r.rid for r in done] == [rid_urgent, rid_bulk]
    return {"reqs": _reqs(done), "metrics": _counters(cp.metrics)}


def test_scheduler_priority_order(toy):
    _both(_priority, toy)


def test_serving_snapshot_has_the_reference_keys():
    assert set(ServingMetrics(register=False).snapshot()) \
        == set(JaxServingMetrics(register=False).snapshot())


def test_faults_refuse(toy):
    """``faults=`` is taken now (it was refused until the fault-tolerance
    runtime was ported; ``tests/test_torch_resilience.py`` holds its hooks
    against JAX's); what a fault plan refuses is an unknown kind."""
    from repro_torch.resilience import FaultPlan
    _, side = toy
    plan = FaultPlan.from_strings(["kv_exhaust@0:2"])
    cp = ServingControlPlane(_engine(side), WeightStore(side.params, 0),
                             faults=plan)
    free = cp.engine.allocator.n_free
    cp.step()
    assert cp.faults is plan and len(cp._kv_holds) == 2
    assert cp.engine.allocator.n_free == free - 2
    cp.step()  # the spec stops firing: the blocks go back
    assert cp._kv_holds == [] and cp.engine.allocator.n_free == free
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.from_strings(["disk_full@0"])


# ---------------------------------------------------------- prefill lane
def _radix_mid_prefill(side):
    prompt = _prompt(side.cfg, 12, seed=7)
    max_new = 4
    eng = _engine(side, max_blocks_per_seq=16, prefill_chunk=8)
    eng.prefix_cache = side.Radix(eng.allocator, eng.state.block_size)
    eng.admit_request(side.params, 0, side.Request(1, prompt, max_new))
    req2 = side.Request(2, prompt, max_new)
    eng.start_prefill(1, req2, version=0)
    assert req2.prefix_hit_tokens == 11
    assert req2.prefill_pos == 11 and not req2.prefill_done
    for _ in range(2):
        eng.step(side.params, side.key)
    assert len(eng.slots[0].generated) == 2 and not req2.generated
    while not req2.prefill_done:
        eng.prefill_step(side.params)
    done = []
    while len(done) < 2:
        done += eng.step(side.params, side.key)
    ref = _engine(side, max_blocks_per_seq=16, prefill_chunk=8)
    ref.admit_request(side.params, 0, side.Request(1, prompt, max_new))
    ref.admit_request(side.params, 1, side.Request(2, prompt, max_new))
    ref_done = []
    while len(ref_done) < 2:
        ref_done += ref.step(side.params, side.key)
    if side.name == "torch":
        cached, uncached = _reqs(done), _reqs(ref_done)
        for rid in (1, 2):
            assert cached[rid]["generated"] == uncached[rid]["generated"]
            np.testing.assert_allclose(cached[rid]["logp"],
                                       uncached[rid]["logp"], rtol=0,
                                       atol=LOGP_TOL)
    return {"ref": _reqs(ref_done), "forks": eng.allocator.forks,
            "launches": eng.prefill_launches}


def test_chunked_prefill_with_radix_hits_matches_uncached(toy):
    """A radix hit enters the chunk lane at the matched cursor, on pages
    another sequence wrote; decode steps beside the mid-prefill slot do
    not corrupt them: the port's tokens and logps equal its uncached
    engine's, and that engine's equal JAX's uncached engine's. The JAX
    engine's own cached run is not compared: it differs from its uncached
    run in some runs (about one in ten here), which the port's never does
    (ROADMAP queue 3, note e)."""
    _both(_radix_mid_prefill, toy)


def _publish_mid_prefill(side):
    store = side.Store(side.params, 0)
    eng = _engine(side, max_blocks_per_seq=16, prefill_chunk=8)
    cp = side.ControlPlane(eng, store, side.Scheduler(
        side.SchedulerConfig(d_max=100)), prefill_budget=1)
    rid = cp.submit(_prompt(side.cfg, 30, seed=4), max_new=3)
    published, done = False, []
    for _ in range(60):
        done += cp.step(side.key)
        req = eng.slots.get(0)
        if not published and req is not None and not req.prefill_done:
            store.publish(side.params, 2)
            published = True
        if done:
            break
    assert published and done and done[0].rid == rid
    assert done[0].token_versions == [2] * len(done[0].generated)
    return {"reqs": _reqs(done), "metrics": _counters(cp.metrics)}


def test_publish_mid_prefill_resumes_and_stamps(toy):
    """A publish while a prompt is mid-prefill: the cursor carries over
    and every generated token is stamped with the new version."""
    _both(_publish_mid_prefill, toy)


def _not_starved(side):
    store = side.Store(side.params, 0)
    eng = _engine(side, max_blocks_per_seq=16, prefill_chunk=8)
    cp = side.ControlPlane(eng, store, side.Scheduler(
        side.SchedulerConfig(d_max=100)), prefill_budget=1)
    rid_long = cp.submit(_prompt(side.cfg, 40, seed=8), max_new=2)
    rid_short = cp.submit(_prompt(side.cfg, 5, seed=9), max_new=3)
    finished, pending_at_short = {}, False
    for _ in range(80):
        for r in cp.step(side.key):
            finished[r.rid] = r
            if r.rid == rid_short:
                long_req = next((q for q in eng.slots.values()
                                 if q is not None and q.rid == rid_long),
                                None)
                pending_at_short = (long_req is not None
                                    and not long_req.prefill_done)
        if len(finished) == 2:
            break
    assert set(finished) == {rid_long, rid_short} and pending_at_short
    snap = cp.metrics.snapshot()
    assert snap["prefill_chunks"] >= 6
    assert snap["ttft_s_count"] == 2.0 and snap["ttft_s_max"] > 0.0
    if side.name == "torch":
        _hold_to_forward(side, finished.values())
    return {"reqs": _reqs(finished.values(), logp=False),
            "metrics": _counters(cp.metrics)}


def test_decode_lane_not_starved_by_long_prompt(toy):
    """Under a one-chunk budget a short request finishes while a long
    prompt is still prefilling, alike in both packages. The logps are
    held to the port's forward_logits, not to JAX: the reference's logps
    of the long prompt vary from run to run here (one of two values,
    within one process too; its tokens do not), and the port's agree
    with the whole-sequence forward (ROADMAP queue 3, note e)."""
    _both(_not_starved, toy)


# ------------------------------------------------------------ KV pressure
def _kv_pressure(side):
    """Three prompts of 6 tokens (a full page and a partial one) fill a
    pool of 10 usable pages at admission; once the radix cache holds each
    prompt's partial tail, the first decode must fork three of them with
    one page free, so the control plane sheds."""
    store = side.Store(side.params, 0)
    eng = _engine(side, max_seqs=3, n_blocks=11, decode_horizon=4)
    cp = side.ControlPlane(eng, store, side.Scheduler(
        side.SchedulerConfig(d_max=100)))
    for seed in range(3):
        cp.submit(_prompt(side.cfg, 6, seed=10 + seed), max_new=6)
    done, shortfalls = [], []
    for _ in range(40):
        done += cp.step(side.key)
        shortfalls.append((eng.decode_block_shortfall(),
                           eng.allocator.n_free,
                           eng.prefix_cache.evictable_count(),
                           cp.metrics.oom_sheds))
        if len(done) == 3:
            break
    assert len(done) == 3 and cp.metrics.oom_sheds >= 1
    eng.prefix_cache.clear()
    assert eng.allocator.n_free == 10
    return {"reqs": _reqs(done), "shortfalls": shortfalls,
            "metrics": _counters(cp.metrics)}


def test_kv_pressure_sheds_alike(toy):
    """``decode_block_shortfall`` equals the reference's at every boundary
    of a run that runs the pool dry, and both shed the same requests."""
    _both(_kv_pressure, toy)


def _shortfall_states(side):
    """Shortfall on hand-made states: prompts mid-way through decoding,
    each with a radix-shared partial write page."""
    eng = _engine(side, max_seqs=3, n_blocks=12, decode_horizon=4)
    eng.prefix_cache = side.Radix(eng.allocator, eng.state.block_size)
    out = []
    for slot in range(3):
        eng.start_prefill(slot, side.Request(slot + 1, _prompt(
            side.cfg, 5 + slot, seed=20 + slot), 7))
        out.append(eng.decode_block_shortfall())
    eng.prefill_step(side.params)
    out.append((eng.decode_block_shortfall(), eng.allocator.n_free,
                eng.prefix_cache.evictable_count()))
    eng.prefix_cache.evict(2)
    out.append(eng.decode_block_shortfall())
    return {"shortfalls": out}


def test_decode_block_shortfall_matches_jax(toy):
    _both(_shortfall_states, toy)


# ------------------------------------------------------------ SSM stack
@pytest.fixture(scope="module")
def mamba():
    return _sides("mamba2-370m-reduced",
                  _seeded_params("mamba2-370m-reduced", 1))


def _ssm_serving(side):
    store = side.Store(side.params, 0)
    eng = _engine(side, max_seqs=2, n_blocks=33, max_blocks_per_seq=16,
                  prefill_chunk=8, decode_horizon=4)
    cp = side.ControlPlane(eng, store, side.Scheduler(
        side.SchedulerConfig(d_max=100)))
    assert eng.prefix_cache is None
    prompts = np.stack([_prompt(side.cfg, 11, seed=s) for s in range(4)])
    rb = cp.generate_batch(prompts, np.array([11, 7, 9, 11]), side.key,
                           max_new=6)
    return {"tokens": rb.tokens, "mask": rb.gen_mask,
            "versions": rb.gen_versions, "logp": rb.gen_logp,
            "metrics": _counters(cp.metrics)}


def test_ssm_through_the_control_plane(mamba):
    """mamba2-370m-reduced through both control planes: no radix cache
    (recurrent state is not shared), the same tokens and stamps."""
    _both(_ssm_serving, mamba)


# ------------------------------------------------------- the async loop
def test_threaded_orchestrator_through_the_control_plane(toy):
    """AsyncOrchestrator(use_control_plane=True) on toy-2m: one record a
    step, each with a serving snapshot of the reference's keys, staleness
    within the gate, every slot free and the pool drained afterwards."""
    _, side = toy
    rl = RLConfig(group_size=4, num_minibatches=2, learning_rate=3e-4,
                  max_staleness=1)
    o = orch.AsyncOrchestrator(side.cfg, rl, ArithmeticTask(
        max_operand=9, n_terms=2, prompt_len=8), "a3po", n_prompts=2,
        max_new_tokens=3, queue_capacity=2, use_control_plane=True)
    state = ttrainer.Trainer(side.cfg, rl, "a3po").init_state(
        torch.Generator().manual_seed(0), device="cpu")
    state, recs = o.run(state, num_steps=3)
    keys = set(JaxServingMetrics(register=False).snapshot())
    assert [r.step for r in recs] == [0, 1, 2] and int(state.version) == 3
    assert all(set(r.serving) == keys for r in recs)
    assert all(0 <= r.staleness_mean <= rl.max_staleness for r in recs)
    assert recs[-1].serving["completed"] >= 8
    assert not o.worker.alive
    eng = o.control_plane.engine
    assert eng.free_slots() == list(range(eng.max_seqs))
    eng.prefix_cache.clear()
    assert eng.allocator.n_free == eng.allocator.n_blocks


def test_held_admission_ends_when_the_rollout_queue_closes(toy):
    """A rollout whose admission is held by a full rollout queue (the
    trainer has stopped popping) raises ``QueueClosed`` once the queue
    closes, where the reference idle-waits ~100 s and then raises; the
    worker that the loop stops takes that as its clean exit, so no slot is
    left held."""
    import time
    from repro_torch.async_rl.buffer import QueueClosed, RolloutQueue
    _, side = toy
    queue = RolloutQueue(capacity=1, max_staleness=4)
    queue.push(object())
    cp = side.ControlPlane(_engine(side), side.Store(side.params, 0),
                           side.Scheduler(side.SchedulerConfig(d_max=100)),
                           rollout_queue=queue)
    queue.close()
    t0 = time.perf_counter()
    with pytest.raises(QueueClosed):
        cp.generate_batch(_prompt(side.cfg)[None], np.array([12]), None,
                          max_new=3)
    assert time.perf_counter() - t0 < 5.0
    assert cp.n_inflight == 0
    assert cp.engine.free_slots() == list(range(cp.engine.max_seqs))


def test_launcher_engine_async_run_log_matches_jax_schema(tmp_path):
    """`--device cpu --arch toy-2m --steps 2 --engine async --log-jsonl`:
    step records with the JAX launcher's keys and a serving snapshot,
    valid under repro.obs.validate."""
    path = tmp_path / "run.jsonl"
    launcher.main(["--device", "cpu", "--arch", "toy-2m", "--steps", "2",
                   "--engine", "async", "--log-jsonl", str(path),
                   "--quiet"])
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    steps = [r for r in recs if r["kind"] == "step"]
    assert recs[0]["kind"] == "meta" and recs[0]["engine"] == "async"
    jax_keys = set(jrunlog.step_record_dict(JaxStepRecord(
        step=0, reward=0.0, loss=0.0, entropy=0.0, iw_max=1.0, iw_min=1.0,
        clipped_tokens=0.0, staleness_mean=0.0, prox_time_s=0.0,
        rollout_time_s=0.0, train_time_s=0.0, wall_time_s=0.0,
        serving=JaxServingMetrics(register=False).snapshot())))
    assert len(steps) == 2 and all(set(r) == jax_keys for r in steps)
    assert all(r["host_syncs"] == 1.0 for r in steps)
    assert validate_jsonl(str(path), min_steps=2) == []
    assert port_validate.validate_jsonl(str(path), min_steps=2) == []


# ----------------------------------------------------------------- on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "`PYTHONPATH=src python -m pytest -m cuda "
                    "tests/test_torch_control_plane.py`")
    return torch.device("cuda")


@pytest.mark.cuda
def test_control_plane_on_card_matches_cpu(cuda_device, toy):
    """The control plane over the engine on the card (the paged kernels)
    gives the CPU's tokens, stamps and prefix hits, logps within 1e-4,
    with group members hitting the radix cache and a publish mid-way."""
    import copy
    _, side = toy
    out = []
    for dev in ("cpu", "cuda"):
        params = copy.deepcopy(side.params).to(dev)
        store = WeightStore(params, 0)
        eng = ContinuousBatchingEngine(
            side.cfg, device=dev, max_seqs=4, block_size=4, n_blocks=64,
            max_blocks_per_seq=16, greedy=True, decode_horizon=4,
            prefill_chunk=8)
        cp = ServingControlPlane(eng, store, AdmissionScheduler(
            SchedulerConfig(d_max=100)))
        warm = [_prompt(side.cfg, n, seed=n) for n in (13, 22)]
        for p in warm:
            cp.submit(p, max_new=6)
        done = []
        while len(done) < 2:
            done += cp.step()
        for p in warm:
            for _ in range(2):
                cp.submit(p, max_new=6)
        steps = 0
        while len(done) < 6:
            done += cp.step()
            steps += 1
            if steps == 2:
                store.publish(params, 1)
        out.append({"reqs": _reqs(done), "metrics": _counters(cp.metrics)})
        hits = [r.prefix_hit_tokens for r in done[2:]]
        assert hits == [len(r.prompt) - 1 for r in done[2:]]
        eng.prefix_cache.clear()
        assert eng.allocator.n_free == 63
    _agree(*out)
