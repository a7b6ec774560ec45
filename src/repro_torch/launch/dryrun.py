"""Multi-pod dry-run: run every (arch x shape x mesh) step once on the
production mesh, with nothing allocated (``repro.launch.dryrun``).

The reference lowers and compiles each step for 512 placeholder host
devices and reads the compiled program's memory and cost analyses. Here
the production mesh is a fake process group of 256 (16x16) or 512
(2x16x16) ranks in this one process (``launch.mesh``); the params, Adam
moments, batch and cache are ``meta`` DTensors in the ``ShardingEnv``'s
placements, and the step runs once eagerly under the per-device cost
census (``distributed.op_cost``): no kernel is compiled, no byte is
allocated, and the kernel ops take their plain versions for shapes only.

Each record has the reference's keys. ``memory.argument_size_in_bytes`` is
the per-device bytes of the step's inputs, from their local shard shapes;
``memory.temp_size_in_bytes`` is the census's peak of live op outputs
(an eager order's peak, not a compiler's plan; ``memory.temp_note`` says
so). ``lower_s`` is the time to build the abstract inputs and
``compile_s`` the time of the censused step. Records go to
``experiments/dryrun_torch/``. An (arch, shape) that fails is listed and
the run exits 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-1.5b \
      --shape train_4k [--multi-pod] [--all]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs.base import SHAPES, RLConfig
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.obs.runlog import RunLogger

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

TEMP_NOTE = ("peak of live op outputs in the eager step's order (the "
             "census's weakref accounting), not a compiler's buffer plan")


def _local_bytes(tree) -> int:
    """Per-device bytes of a tree of (D)Tensors: the local shards'."""
    from repro_torch.launch.steps import _is_dtensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    t = tree.to_local() if _is_dtensor(tree) else tree
    return t.numel() * t.element_size()


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def make_env(mesh, *, fsdp: bool = True, rules=None,
             kv_seq_shard: bool = False, tp_fallback: bool = False,
             ep_moe: bool = False):
    """The dry-run's ``ShardingEnv``: ``kv_seq_shard`` shards the decode
    cache along its sequence axis over "model"."""
    from repro_torch.distributed.sharding import DEFAULT_RULES, ShardingEnv
    rules = tuple(rules or DEFAULT_RULES)
    if kv_seq_shard:
        rules = tuple(r for r in rules if r[0] != "kv_seq") \
            + (("kv_seq", "model"),)
    env = ShardingEnv(mesh, rules=rules, fsdp=fsdp, tp_fallback=tp_fallback)
    env.ep_shard_map = ep_moe
    return env


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               algo="a3po", fsdp: bool = True,
               save: bool = True, verbose: bool = True,
               rules=None, hoist_gather: bool = False,
               kv_seq_shard: bool = False, zero1: bool = False,
               tp_fallback: bool = False, ep_moe: bool = False,
               num_microbatches: int = 8, prefill_microbatches: int = 1,
               tag_suffix: str = "", run_logger: RunLogger = None,
               mesh=None, results_dir: str = None, cfg=None) -> dict:
    """Run one (arch, shape) step on the production mesh (or ``mesh``)
    under the census and return (and save) its record. ``shape_name`` may
    be an ``InputShape``; ``cfg`` overrides the registry's config."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.algorithms import resolve_algorithm
    from repro_torch.distributed.op_cost import Census, mesh_group_axes
    from repro_torch.distributed.roofline import (
        collective_seconds,
        collective_stats,
        roofline_terms,
    )
    from repro_torch.distributed.sharding import (
        ShardingEnv,
        mesh_axes,
        shard_tree,
        use_sharding,
    )
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as M

    cfg = cfg or get_config(arch)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    shape_name = shape.name
    rl = RLConfig()
    algo = resolve_algorithm(algo, rl)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    axes = mesh_axes(mesh)
    n_chips = mesh.size()
    mesh_name = "x".join(str(s) for s in axes.values())
    env = make_env(mesh, fsdp=fsdp, rules=rules, kv_seq_shard=kv_seq_shard,
                   tp_fallback=tp_fallback, ep_moe=ep_moe)

    t0 = time.time()
    with use_sharding(env):
        specs = steps.input_specs(cfg, shape)
    if shape.kind == "train":
        step = steps.make_train_step(cfg, rl, algo,
                                     num_microbatches=num_microbatches,
                                     hoist_fsdp_gather=hoist_gather)
    elif shape.kind == "prefill" and prefill_microbatches > 1:
        step = steps.make_prefill_step(cfg, shape, prefill_microbatches)
    else:
        step = steps.make_step(cfg, shape, rl, algo)
    params_abs = M.abstract_params(cfg)
    param_sh = M.param_shardings(cfg, env)
    opt_env = env
    if zero1:
        # ZeRO-1: weights replicated across data (TP only), optimizer
        # moments FSDP-sharded
        env = ShardingEnv(mesh, rules=tuple(env.rules.items()), fsdp=False,
                          tp_fallback=tp_fallback)
        env.ep_shard_map = ep_moe
        param_sh = M.param_shardings(cfg, env)
    batch_sh = steps.batch_shardings(cfg, shape, env, specs)
    params = shard_tree(params_abs, param_sh)
    batch = {k: (v if k == "cache" else shard_tree(v, batch_sh[k]))
             for k, v in specs.items()}
    args = [params]
    if shape.kind == "train":
        opt_abs = steps.abstract_opt_state(params_abs)
        opt_sh = steps.opt_shardings(
            M.param_shardings(cfg, opt_env) if zero1 else param_sh, env)
        args.append(shard_tree(opt_abs, opt_sh))
    args.append(batch)
    arg_bytes = sum(_local_bytes(a) for a in args)
    t_lower = time.time() - t0

    census = Census(mesh_group_axes(mesh))
    with use_sharding(env), implicit_replication(), census, \
            torch.no_grad() if shape.kind != "train" \
            else torch.enable_grad():
        out = step(*args)
    t_compile = time.time() - t0 - t_lower
    out_bytes = sum(_local_bytes(o) for o in out
                    if isinstance(o, (dict, torch.Tensor)))
    del out

    cost = census.cost
    flops = cost.flops
    coll_bytes, coll_ops = collective_stats(census)
    terms = roofline_terms(flops, cost.traffic_bytes, coll_bytes,
                           collective_seconds(axes,
                                              cost.collective_bytes_by_axis))
    n_params = cfg.num_params()
    n_active = cfg.num_active_params()
    # MODEL_FLOPS: 6*N*D for a train step (fwd+bwd), 2*N*D for inference
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    mult = 6 if shape.kind == "train" else 2
    model_flops_per_dev = mult * n_active * tokens / n_chips

    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_chips": n_chips,
        "kind": shape.kind,
        "algo": algo.name,
        "fsdp": fsdp,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": {
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(cost.peak_live_bytes),
            "temp_note": TEMP_NOTE,
        },
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": cost.traffic_bytes,
        "collective_bytes_per_device": coll_bytes,
        "collective_ops": coll_ops,
        "collective_bytes_by_axis": dict(cost.collective_bytes_by_axis),
        "xla_cost_analysis_raw": None,
        "census_ops": cost.n_ops,
        "replicated_fallbacks": dict(cost.fallbacks),
        "fallback_reasons": dict(cost.fallback_reasons),
        "roofline": {k: (v if isinstance(v, str) else float(v))
                     for k, v in terms.items()},
        "roofline_source": "H100 SXM data sheet over a fake mesh "
                           "(distributed/roofline.py), not a measurement",
        "n_params": n_params,
        "n_active_params": n_active,
        "n_param_tensors": _count_leaves(params_abs),
        "model_flops_per_device": model_flops_per_dev,
        "useful_flops_ratio": (model_flops_per_dev / flops
                               if flops else None),
    }
    if verbose:
        line = (f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
                f"build {t_lower:.1f}s step {t_compile:.1f}s | "
                f"args {arg_bytes / 2**30:.2f}GiB temp "
                f"{cost.peak_live_bytes / 2**30:.2f}GiB | "
                f"flops/dev {flops:.3g} coll/dev {coll_bytes:.3g}B | "
                f"dominant={terms['dominant']}")
        if run_logger is not None:
            run_logger.print(line)
        else:
            print(line, flush=True)
    if run_logger is not None:
        run_logger.log_event(
            "dryrun", arch=arch, shape=shape_name, mesh=mesh_name,
            shape_kind=shape.kind, lower_s=record["lower_s"],
            compile_s=record["compile_s"],
            temp_bytes=record["memory"]["temp_size_in_bytes"],
            hlo_flops_per_device=flops,
            collective_bytes_per_device=coll_bytes,
            dominant=terms["dominant"])
    if save:
        out_dir = results_dir or RESULTS_DIR
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{mesh_name}"
        if not fsdp:
            tag += "_nofsdp"
        tag += tag_suffix
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=2)
    return record


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, help="architecture id")
    p.add_argument("--shape", default=None, choices=sorted(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true",
                   help="run every assigned arch x shape")
    p.add_argument("--algo", default=None,
                   help="policy-optimization algorithm (registry name, "
                        "default a3po)")
    p.add_argument("--method", default=None,
                   help="DEPRECATED alias for --algo")
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--ep-moe", action="store_true",
                   help="expert-parallel all_to_all MoE dispatch")
    p.add_argument("--kv-seq-shard", action="store_true",
                   help="shard decode KV cache along sequence")
    p.add_argument("--tp-fallback", action="store_true",
                   help="row-parallel fallback for non-divisible heads")
    p.add_argument("--hoist-gather", action="store_true",
                   help="hoist FSDP weight all-gather out of microbatches")
    p.add_argument("--tag", default="", help="suffix for result files")
    p.add_argument("--log-jsonl", default=None, metavar="FILE",
                   help="append one schema-versioned JSONL record per combo")
    p.add_argument("--quiet", action="store_true",
                   help="suppress stdout progress lines (JSONL still logs)")
    args = p.parse_args(argv)
    if args.method:
        import warnings
        warnings.warn("--method is deprecated; use --algo",
                      DeprecationWarning)

    combos = []
    if args.all:
        for arch in list_archs(assigned_only=True):
            for shape in SHAPES:
                combos.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    log = RunLogger(args.log_jsonl, quiet=args.quiet)
    failures = []
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    try:
        for arch, shape in combos:
            try:
                dryrun_one(arch, shape, multi_pod=args.multi_pod,
                           algo=args.algo or args.method or "a3po",
                           fsdp=not args.no_fsdp,
                           ep_moe=args.ep_moe,
                           kv_seq_shard=args.kv_seq_shard,
                           tp_fallback=args.tp_fallback,
                           hoist_gather=args.hoist_gather,
                           tag_suffix=args.tag, run_logger=log)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                log.log_event("dryrun_failure", arch=arch, shape=shape,
                              error=repr(e))
                traceback.print_exc()
        if failures:
            log.print(f"\nFAILED {len(failures)}/{len(combos)}:")
            for f in failures:
                log.print(f"   {f}")
            raise SystemExit(1)
        log.print(f"\nALL {len(combos)} combos ran OK ({mesh_name})")
    finally:
        log.close()


if __name__ == "__main__":
    main()
