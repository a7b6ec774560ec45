"""The port's distribution layer against the JAX package
(``repro.distributed``, ``repro.launch.mesh``, ``restore_sharded``, the
expert-parallel MoE), on the CPU.

* Spec parity: every leaf of every registered arch (full and
  ``-reduced``), on the 16x16 and 2x16x16 production meshes, under fsdp on
  and off, ``tp_fallback`` on and off and the dry-run's ``kv_seq`` rule,
  resolves to the reference's ``PartitionSpec`` entry by entry, and so do
  the decode caches at decode_32k and long_500k (mirrors
  ``tests/test_system.py:190-218``).
* Per-device bytes of params and Adam moments from the port's placements
  equal the reference's from its specs.
* The census (``op_cost``): a matmul is 2mnk, a loop of L matmuls L 2mk^2,
  a nested 3 x 5 loop 15 2mk^2 (``tests/test_launch.py:19-56``); a sharded
  matmul on a fake 2x4 mesh counts per-device flops and the collectives
  ``CommDebugMode`` sees.
* ``restore_sharded`` on the one-device local mesh, and on a 2x4 mesh over
  8 gloo processes; ``moe_apply_ep`` on those 8 processes against the
  reference's ``moe_apply_gspmd`` (relative error < 2e-3, the reference's
  bound in ``tests/test_moe_ep.py``). Every test that builds a mesh of
  more than one rank runs in a subprocess: a process group is global
  state.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models.params import ParamSpec as JaxParamSpec
from repro.models.params import init_from_specs as jax_init_from_specs
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.distributed import op_cost
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    ShardingEnv,
    abstract_mesh,
    constrain,
    use_sharding,
)
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M
from repro_torch.models.params import walk
from repro_torch.training import Trainer
from repro_torch.training.checkpoints import restore_sharded, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSIGNED = list_archs(assigned_only=True)
ALL = list_archs() + [a + "-reduced" for a in ASSIGNED]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KV_SEQ = tuple(r for r in DEFAULT_RULES if r[0] != "kv_seq") \
    + (("kv_seq", "model"),)


def _specs(tree, env, logical=None):
    """{path: spec tuple} of a spec tree (ParamSpec leaves) or of a tree
    of shaped leaves with a mirror of logical axes."""
    out = {}
    if logical is None:
        for p, s in walk(tree):
            out["/".join(p)] = tuple(env.spec(s.shape, s.logical))
        return out
    for p, leaf in walk(tree):
        node = logical
        for k in p:
            node = node[k]
        out["/".join(p)] = tuple(env.spec(tuple(leaf.shape), node))
    return out


def _jax_specs(tree, env, logical=None):
    out = {}
    if logical is None:
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JaxParamSpec))[0]
        for path, s in flat:
            out["/".join(k.key for k in path)] = tuple(env.spec(s.shape,
                                                                s.logical))
        return out
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = logical
        for k in path:
            node = node[k.key]
        out["/".join(k.key for k in path)] = tuple(env.spec(leaf.shape,
                                                            node))
    return out


def _variants():
    for fsdp in (True, False):
        for tp in (False, True):
            for rules in (DEFAULT_RULES, KV_SEQ):
                yield dict(fsdp=fsdp, tp_fallback=tp), rules


@pytest.mark.parametrize("arch", ALL)
def test_spec_parity_with_jax(arch):
    """Every param leaf's spec, and every decode-cache leaf's at
    decode_32k and long_500k, equals the reference's under every rule
    variant on both production meshes."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for sizes, names in MESHES.values():
        for kw, rules in _variants():
            env = ShardingEnv(abstract_mesh(sizes, names), rules=rules, **kw)
            jenv = jsh.ShardingEnv(jsh.abstract_mesh(sizes, names),
                                   rules=rules, **kw)
            got = _specs(M.model_spec(cfg), env)
            assert got == _jax_specs(jmodel.model_spec(jcfg), jenv), \
                (names, kw, rules is KV_SEQ)
            for shape in ("decode_32k", "long_500k"):
                cache = steps.input_specs(cfg, SHAPES[shape])["cache"]
                jcache = jsteps.input_specs(jcfg, JAX_SHAPES[shape])["cache"]
                assert _specs(cache, env, M.cache_logical_axes(cfg, cache)) \
                    == _jax_specs(jcache, jenv,
                                  jmodel.cache_logical_axes(jcfg, jcache)), \
                    (shape, names, kw)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_per_device_bytes_match_jax(arch):
    """Per-device bytes of params (bf16) and Adam moments (2 x float32) on
    16x16, from the port's placements (``Sharding.shard_shape``) and from
    the reference's ``NamedSharding.shard_shape``."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sizes, names = MESHES["16x16"]
    env = ShardingEnv(abstract_mesh(sizes, names))
    jmesh = jsh.abstract_mesh(sizes, names)
    jenv = jsh.ShardingEnv(jmesh)
    port = sum(math.prod(env.sharding(s.shape, s.logical).shard_shape(
        s.shape)) for _, s in walk(M.model_spec(cfg)))
    flat = jax.tree_util.tree_flatten(
        jmodel.model_spec(jcfg),
        is_leaf=lambda x: isinstance(x, JaxParamSpec))[0]
    ref = sum(math.prod(NamedSharding(jmesh, jenv.spec(s.shape, s.logical))
                        .shard_shape(s.shape)) for s in flat)
    assert port == ref
    assert port * (2 + 8) < cfg.num_params() * (2 + 8)  # sharded at all


def test_sharding_env_divisibility_fallback():
    """kv_heads=8 on model=16 falls back to replication, not an error (the
    reference's ``test_sharding_env_divisibility_fallback``), and the
    placements follow the spec."""
    from torch.distributed.tensor import Replicate, Shard
    env = ShardingEnv(abstract_mesh((16, 16)))
    assert env.spec((8, 128), ("kv_heads", "head_dim")) == ()
    assert env.spec((96, 128), ("heads", "head_dim")) == ("model",)
    assert env.spec((4096, 11008), ("embed", "ff")) == ("data", "model")
    assert env.placements((4096, 11008), ("embed", "ff")) == (Shard(0),
                                                              Shard(1))
    assert ShardingEnv(abstract_mesh((16, 16)), fsdp=False).spec(
        (4096, 11008), ("embed", "ff")) == (None, "model")
    env3 = ShardingEnv(abstract_mesh((2, 16, 16)))
    assert env3.spec((256, 4096), ("batch", "seq")) == (("pod", "data"),)
    assert env3.placements((256, 4096), ("batch", "seq")) == (
        Shard(0), Shard(0), Replicate())
    assert env3.spec((1, 4096), ("batch", "seq")) == ()


def test_constrain_is_the_identity_off_mesh():
    x = torch.ones(4, 4)
    assert constrain(x, "batch", None) is x
    with use_sharding(ShardingEnv(make_local_mesh(device="cpu"))):
        assert constrain(x, "batch", None) is x


def test_local_mesh_raises_without_a_card_unless_the_cpu_is_asked(
        monkeypatch):
    """The one-device mesh lies on the caller's device: the card by
    default, which raises where there is none; the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_local_mesh(device="cuda")
    mesh = make_local_mesh(device="cpu")
    assert mesh.device_type == "cpu" and mesh.size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert make_local_mesh().device_type == "cuda"


# ------------------------------------------------------------------- census
def test_census_plain_matmul():
    m, n, k = 32, 48, 64
    with op_cost.Census() as c:
        torch.randn(m, k) @ torch.randn(k, n)
    assert c.cost.flops == 2 * m * n * k


def test_census_counts_loop_iterations():
    m, k, L = 32, 64, 7
    ws = torch.randn(L, k, k)
    with op_cost.Census() as c:
        x = torch.randn(m, k)
        for w in ws:
            x = x @ w
    assert c.cost.flops == L * 2 * m * k * k


def test_census_nested_loops():
    m, k = 16, 32
    ws = torch.randn(3, 5, k, k)
    with op_cost.Census() as c:
        x = torch.randn(m, k)
        for wset in ws:
            for w in wset:
                x = x @ w
    assert c.cost.flops == 15 * 2 * m * k * k


_SHARDED_MM = textwrap.dedent("""
    import json, torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.op_cost import (Census, collective_counts,
                                                 mesh_group_axes)
    from repro_torch.distributed.roofline import collective_stats
    from repro_torch.distributed.sharding import Sharding, shard_tensor
    from repro_torch.launch.mesh import init_fake_process_group
    from torch.distributed.device_mesh import init_device_mesh

    init_fake_process_group(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    def dt(shape, pl):
        return shard_tensor(torch.empty(shape, device="meta"),
                            Sharding(mesh, (), pl))
    h = dt((64, 32), (Shard(0), Replicate()))
    w = dt((32, 48), (Replicate(), Shard(1)))
    c = Census(mesh_group_axes(mesh))
    with c, implicit_replication():
        out = h @ w
        full = out.redistribute(mesh, (Replicate(), Replicate()))
    print("CENSUS " + json.dumps({
        "flops": c.cost.flops, "local": list(out.to_local().shape),
        "counts": collective_counts(c), "stats": collective_stats(c)[1],
        "axes": c.cost.collective_bytes_by_axis}))
""")


def _run(code, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout, cwd=REPO)
    return out


def test_census_counts_per_device_on_a_fake_mesh():
    """A [64, 32] x [32, 48] product sharded rows over data and columns
    over model on a fake 2x4 mesh counts one device's flops (an eighth of
    the whole product: a mode above DTensor would count all of them) and
    the two all-gathers of the redistribute after it."""
    out = _run(_SHARDED_MM)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("CENSUS ")]
    assert line, out.stdout[-2000:] + out.stderr[-3000:]
    r = json.loads(line[0][len("CENSUS "):])
    assert r["local"] == [32, 12]
    assert r["flops"] == 2 * 32 * 12 * 32 == 2 * 64 * 48 * 32 / 8
    assert r["counts"]["all-gather"] == 2
    # the first gather's output is one mesh axis's whole, the second's the
    # [64, 48] product (float32), whichever axis DTensor gathers first
    assert r["stats"]["all-gather"]["bytes"] in (4 * (32 * 48 + 64 * 48),
                                                 4 * (64 * 12 + 64 * 48))
    assert set(r["axes"]) == {"data", "model"}


# --------------------------------------------------------- sharded restore
def test_restore_sharded_on_the_local_mesh(tmp_path):
    """A checkpoint of a trainer's params restores onto the one-device
    local mesh's shardings bit for bit (``tests/test_system.py:220-242``)."""
    cfg = dataclasses.replace(get_config("toy-2m"), dtype="float32")
    state = Trainer(cfg).init_state(torch.Generator().manual_seed(0),
                                    device="cpu")
    env = ShardingEnv(make_local_mesh(device="cpu"))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state.params, {"v": 1})
    restored, meta = restore_sharded(path, M.param_shardings(cfg, env))
    assert meta["v"] == 1
    got = dict(walk(restored))
    for p, v in walk(state.params):
        assert torch.equal(got[p], v.detach())


_GLOO = textwrap.dedent("""
    import dataclasses, json, os, socket, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, port, path, data):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=8)
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        from repro_torch.configs.registry import get_config
        from repro_torch.distributed.sharding import (ShardingEnv,
                                                      use_sharding)
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import model as M
        from repro_torch.models import moe
        from repro_torch.models.params import from_jax, walk
        from repro_torch.training.checkpoints import (restore_sharded,
                                                      save_checkpoint)
        out = {"rank": rank}
        mesh = make_local_mesh(model_parallel=4, device="cpu")
        out["mesh"] = list(mesh.mesh.shape)
        # sharded restore of toy-2m
        cfg = dataclasses.replace(get_config("toy-2m"), dtype="float32")
        env = ShardingEnv(mesh)
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        if rank == 0:
            save_checkpoint(path, params, {"arch": "toy-2m", "v": 9})
        dist.barrier()
        restored, meta = restore_sharded(path, M.param_shardings(cfg, env))
        assert meta["v"] == 9
        ok, n_sharded = True, 0
        full = dict(walk(params))
        for p, leaf in walk(restored):
            assert isinstance(leaf, DTensor), p
            shape, off = compute_local_shape_and_global_offset(
                leaf.shape, mesh, leaf.placements)
            want = full[p][tuple(slice(o, o + n)
                                 for o, n in zip(off, shape))]
            ok &= bool(torch.equal(leaf.to_local(), want))
            ok &= tuple(leaf.to_local().shape) == tuple(shape)
            if leaf.dim() >= 2 and any(pl.is_shard()
                                       for pl in leaf.placements):
                n_sharded += 1
        out["restore_ok"], out["n_sharded"] = ok, n_sharded
        # expert-parallel MoE against the reference's capacity path
        mcfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b-reduced"),
                                   dtype="float32")
        z = np.load(data)
        mparams = from_jax({k[2:]: z[k] for k in z.files
                            if k.startswith("p/")}, device="cpu")
        x = torch.from_numpy(z["x"])
        env.ep_shard_map = True
        with use_sharding(env):
            y, aux = moe.moe_apply(mparams, x, mcfg)
        y_ref = torch.from_numpy(z["y"])
        out["ep_err"] = float((y_ref - y).abs().max()
                              / (y_ref.abs().max() + 1e-9))
        out["aux"] = float(aux)
        with open(os.path.join(os.path.dirname(path), f"rank{rank}.json"),
                  "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(run, args=(port, sys.argv[1], sys.argv[2]), nprocs=8)
""")


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Eight gloo processes on a 2 x 4 mesh: the sharded restore and the
    expert-parallel MoE (float32, qwen3-moe-30b-a3b-reduced, B 4, S 20:
    the sequence is padded to a multiple of 4) against the reference's
    ``moe_apply_gspmd`` on the same weights."""
    d = tmp_path_factory.mktemp("gloo")
    cfg = dataclasses.replace(jax_get_config("qwen3-moe-30b-a3b-reduced"),
                              dtype="float32")
    params = jax_init_from_specs(jmoe.moe_spec(cfg), jax.random.PRNGKey(0),
                                 jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 20, cfg.d_model)) * 0.5
    y_ref, _ = jmoe.moe_apply_gspmd(params, x, cfg)
    flat = {"p/" + "/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    data = str(d / "moe.npz")
    np.savez(data, x=np.asarray(x), y=np.asarray(y_ref), **flat)
    script = d / "gloo_ranks.py"
    script.write_text(_GLOO)
    out = subprocess.run(
        [sys.executable, str(script), str(d / "ckpt"), data],
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
        capture_output=True, text=True, timeout=300, cwd=REPO)
    files = sorted(d.glob("rank*.json"))
    assert len(files) == 8, out.stdout[-2000:] + out.stderr[-4000:]
    ranks = [json.loads(f.read_text()) for f in files]
    return ranks


def test_restore_sharded_on_gloo_ranks(gloo_ranks):
    """Every rank keeps exactly its local shard of every leaf, equal to
    the saved array's slice, and weights are sharded
    (``tests/test_resilience.py:587-625``)."""
    for r in gloo_ranks:
        assert r["mesh"] == [2, 4]
        assert r["restore_ok"], r
        assert r["n_sharded"] >= 1, r


def test_ep_moe_matches_gspmd_on_gloo_ranks(gloo_ranks):
    """``moe_apply_ep`` with ``all_to_all_single`` over the model ranks
    equals the reference's capacity path within its own bound, and every
    rank holds the same aux loss."""
    errs = [r["ep_err"] for r in gloo_ranks]
    assert max(errs) < 2e-3, errs
    assert len({r["aux"] for r in gloo_ranks}) == 1
