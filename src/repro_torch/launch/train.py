"""Training launcher (``repro.launch.train``): the async A-3PO loop on one
device.

``--engine sim`` (the default) runs ``simulate_async``: the behaviour
policy lags ``--staleness`` versions behind the trainer (0 for on-policy
algorithms). ``--engine async`` runs the threaded ``AsyncOrchestrator``
through the serving control plane (continuous batching with a radix prefix
cache, publishes absorbed mid-batch, per-token version stamps), with the
staleness gate at ``--staleness + 1``. The model runs on the card
unless ``--device cpu`` asks for the CPU, which also switches the model to
float32 and refuses full-scale architectures, as the reference does on its
host.

Algorithm selection goes through the Algorithm registry
(``core.algorithms``): ``--algo a3po|recompute|sync|asympo|grpo_mu|...``
(``--algo list`` enumerates it). ``--trace trace.json`` records spans for
rollout, weight publishes, prox passes and train steps and their phases
(Chrome/Perfetto format) on ``torch.profiler``'s clock: timestamps are
Unix-epoch microseconds, as the profiler's events; ``--log-jsonl run.jsonl``
writes one schema-versioned record per step (the reference's schema);
``--quiet`` suppresses the human stdout lines; ``--metrics-prom FILE``
dumps the metrics registry in prometheus text format at exit.

Fault tolerance (``repro_torch.resilience``), with either engine:
``--ckpt-dir DIR --ckpt-every N`` commits crash-consistent checkpoints,
``--resume auto|STEP`` continues from one (bit-identical to the
uninterrupted run with ``--engine sim``), ``--fault KIND@AT[xN][:MAG]``
(repeatable, seeded by ``--fault-seed``) injects deterministic faults and
``--guard skip|rollback`` applies the non-finite update policy.

``--mesh prod|prod-multipod`` runs the sharded dry-run, as the reference
does on a host: the training step on the production mesh (a fake process
group of 256 / 512 ranks, ``launch.mesh``), with params, Adam moments and
batch as ``meta`` DTensors in the ``ShardingEnv``'s placements, run once
under the per-device cost census. It asserts that no weight or Adam moment
of two or more dims is fully replicated, before and after the step, and
exits 0; nothing is allocated and no card is needed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-1.5b \
      --steps 4 --staleness 2 --algo a3po [--log-jsonl run.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-1.5b \
      --steps 4 --engine async
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch toy-2m --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-1.5b \
      --steps 4 --ckpt-dir ckpts --ckpt-every 2 --fault train_crash@3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-1.5b \
      --steps 4 --ckpt-dir ckpts --ckpt-every 2 --resume auto
  PYTHONPATH=src python -m repro_torch.launch.train --algo list
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import warnings
from typing import List, Optional

import torch

from repro_torch.async_rl.orchestrator import (
    AsyncOrchestrator,
    simulate_async,
)
from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithms import registry_table, resolve_algorithm
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.models.model import require_device
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.runlog import RunLogger
from repro_torch.obs.tracing import SpanTracer, install_tracer
from repro_torch.resilience import (
    CheckpointManager,
    FaultPlan,
    ResilienceConfig,
    TrainGuard,
)
from repro_torch.training.checkpoints import save_checkpoint

def _replicated_weights(sh_tree, abs_tree, logical_tree) -> List[str]:
    """Paths of weights of two or more dims whose sharding replicates them
    over every mesh axis. A weight is a leaf with a d_model ("embed")
    axis: the reference also counts per-layer bias vectors stacked over
    the layers (qwen2.5's qkv biases, whose heads do not divide the model
    axis), so its own check fails on qwen2.5-1.5b."""
    from repro_torch.training.optimizer import flatten
    sh, logical = flatten(sh_tree), flatten(logical_tree)
    return [k for k, leaf in flatten(abs_tree).items()
            if leaf.dim() >= 2 and "embed" in logical[k]
            and sh[k].is_fully_replicated]


def sharded_dryrun(cfg, rl: RLConfig, env, algo, batch_size: int = 32,
                   seq_len: int = 14, num_microbatches: int = 1,
                   log: Optional[RunLogger] = None) -> dict:
    """Run ``Trainer.step``'s update (``trainer._train_step``) once on the
    production mesh with ``ShardingEnv`` placements for params, Adam
    moments and batch, all ``meta`` DTensors, under the cost census.
    Raises if a weight or moment of two or more dims is fully replicated,
    before or after the step. Returns the census's numbers."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.op_cost import Census, mesh_group_axes
    from repro_torch.distributed.sharding import shard_tree, use_sharding
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models.params import logical_axes_tree
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.optimizer import flatten

    say = log.print if log is not None else print
    params_abs = M.abstract_params(cfg)
    param_sh = M.param_shardings(cfg, env)
    opt_abs = steps.abstract_opt_state(params_abs)
    opt_sh = steps.opt_shardings(param_sh, env)
    logical = logical_axes_tree(M.model_spec(cfg))
    bad = _replicated_weights(param_sh, params_abs, logical)
    assert not bad, f"fully-replicated weight tensors on the mesh: {bad}"
    bad_m = _replicated_weights(opt_sh["m"], params_abs, logical)
    assert not bad_m, f"fully-replicated Adam moments on the mesh: {bad_m}"
    n_leaves = len(flatten(param_sh))
    say(f"[sharded] params + Adam moments carry ShardingEnv placements "
        f"({n_leaves} tensors, 0 replicated weight matrices)")

    B, T = batch_size, seq_len

    def meta(shape, dtype, logical):
        return shard_tree(torch.empty(shape, dtype=dtype, device="meta"),
                          env.sharding(shape, logical))

    batch = trainer_mod.TrainBatch(
        tokens=meta((B, T), torch.long, ("batch", None)),
        response_mask=meta((B, T - 1), torch.float32, ("batch", None)),
        behav_logp=meta((B, T - 1), torch.float32, ("batch", None)),
        versions=meta((B,), torch.int32, ("batch",)),
        rewards=meta((B,), torch.float32, ("batch",)))
    version = meta((), torch.int32, ())
    params = shard_tree(params_abs, param_sh)
    params = {k: v.requires_grad_(True) for k, v in flatten(params).items()}
    from repro_torch.training.optimizer import unflatten
    opt = shard_tree(opt_abs, opt_sh)
    census = Census(mesh_group_axes(env.mesh))
    t0 = time.time()
    with use_sharding(env), implicit_replication(), census:
        # the dry-run has no recomputed prox; behav_logp stands in (same
        # shape and placements)
        prox = batch.behav_logp if algo.needs_prox_forward else None
        new_params, _, _ = trainer_mod._train_step(
            unflatten(params), opt, version, batch, prox, cfg=cfg, rl=rl,
            algo=algo, num_minibatches=rl.num_minibatches,
            num_microbatches=num_microbatches, skip_nonfinite=False,
            donate_params=False)
    dt = time.time() - t0
    out = flatten(new_params)
    rep = tuple([Replicate()] * env.mesh.ndim)
    flat_logical = flatten(logical)
    bad_out = [k for k, leaf in out.items()
               if leaf.dim() >= 2 and "embed" in flat_logical[k]
               and (not isinstance(leaf, DTensor)
                    or tuple(leaf.placements) == rep)]
    assert not bad_out, f"the step replicates weights: {bad_out}"
    c = census.cost
    say(f"[sharded] train_step {dt:.1f}s | flops/dev {c.flops:.3g} "
        f"coll/dev {c.collective_bytes:.3g}B | output params stay sharded")
    return {"step_s": dt, "flops_per_device": c.flops,
            "collective_bytes_per_device": c.collective_bytes,
            "n_param_tensors": n_leaves}


def print_algo_list() -> None:
    """``--algo list``: enumerate the Algorithm registry with flags."""
    cols = ("needs_behav_logp", "needs_prox_forward", "needs_versions",
            "needs_group_rewards", "on_policy")
    header = f"{'name':10s} {'aliases':10s} " \
        + " ".join(f"{c:>{len(c)}s}" for c in cols)
    print(header)
    print("-" * len(header))
    for r in registry_table():
        alias = ",".join(r["aliases"]) or "-"
        flags = " ".join(f"{'yes' if r[c] else 'no':>{len(c)}s}"
                         for c in cols)
        print(f"{r['name']:10s} {alias:10s} {flags}  # {r['doc']}")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="toy-2m")
    p.add_argument("--algo", default=None,
                   help="policy-optimization algorithm (registry name, "
                        "default a3po), or 'list' to enumerate the "
                        "registry")
    p.add_argument("--method", default=None,
                   help="DEPRECATED alias for --algo")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--staleness", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (float32, toy archs only)")
    p.add_argument("--mesh", default="local",
                   choices=["local", "prod", "prod-multipod"])
    p.add_argument("--microbatch", type=int, default=1,
                   help="gradient-accumulation microbatches per minibatch")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--engine", default="sim", choices=["sim", "async"],
                   help="sim: deterministic single-thread simulation; "
                        "async: threaded orchestrator through the serving "
                        "control plane")
    p.add_argument("--trace", default=None, metavar="FILE",
                   help="record spans and export a Chrome/Perfetto "
                        "trace.json here, on torch.profiler's clock "
                        "(Unix-epoch microseconds)")
    p.add_argument("--log-jsonl", default=None, metavar="FILE",
                   help="write one schema-versioned JSONL record per "
                        "training step")
    p.add_argument("--quiet", action="store_true",
                   help="suppress human status lines (JSONL/trace still "
                        "written)")
    p.add_argument("--metrics-prom", default=None, metavar="FILE",
                   help="dump the metrics registry in prometheus text "
                        "format at exit")
    # fault tolerance (repro_torch.resilience)
    p.add_argument("--ckpt-dir", default=None, metavar="DIR",
                   help="crash-consistent step-named checkpoints go here "
                        "(atomic npz+json pairs with checksum + a 'latest' "
                        "pointer)")
    p.add_argument("--ckpt-every", type=int, default=0, metavar="N",
                   help="commit a checkpoint every N completed steps "
                        "(requires --ckpt-dir)")
    p.add_argument("--resume", default=None, metavar="auto|STEP",
                   help="'auto': resume from the newest valid checkpoint "
                        "in --ckpt-dir (fresh start when none); an "
                        "integer: resume from exactly that step's "
                        "checkpoint. Sim-engine resume is bit-identical "
                        "to the uninterrupted run.")
    p.add_argument("--fault", action="append", default=[],
                   metavar="KIND@AT[xN][:MAG]",
                   help="inject a deterministic fault (repeatable), e.g. "
                        "rollout_crash@1, train_crash@3, publish_fail@0x2, "
                        "queue_stall@2:0.5, nan_grad@4, kv_exhaust@5x3:64, "
                        "nan_logits@2")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed for the fault plane's RNG (which row/reward "
                        "gets poisoned, backoff jitter)")
    p.add_argument("--guard", default="off",
                   choices=["off", "skip", "rollback"],
                   help="non-finite update policy: 'skip' keeps the "
                        "previous params/opt for poisoned minibatches "
                        "(on the device, no extra host sync); 'rollback' "
                        "also restores the last checkpoint when a step "
                        "goes non-finite or diverges")
    return p


def _resilience(args, device, log):
    """(ResilienceConfig or None, ResumeInfo or None) from the flags."""
    resilience = resume = None
    if args.ckpt_dir or args.fault or args.guard != "off":
        resilience = ResilienceConfig(
            faults=(FaultPlan.from_strings(args.fault, seed=args.fault_seed)
                    if args.fault else None),
            guard=(TrainGuard(policy=args.guard) if args.guard != "off"
                   else None),
            checkpointer=(CheckpointManager(args.ckpt_dir)
                          if args.ckpt_dir else None),
            ckpt_every=args.ckpt_every, seed=args.fault_seed)
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt-dir")
        ckpt = resilience.checkpointer
        if args.resume == "auto":
            resume = ckpt.restore_latest(device)
        else:
            resume = ckpt.restore(ckpt.path_for(int(args.resume)), device)
        if resume is not None:
            log.print(f"resuming at step {resume.step} "
                      f"(version {int(resume.state.version)}) from "
                      f"{resume.path}")
            log.log_event("resume", step=resume.step, path=resume.path)
        else:
            log.print(f"--resume auto: no valid checkpoint in "
                      f"{args.ckpt_dir}; starting fresh")
    return resilience, resume


def _mesh_dryrun(args, algo) -> None:
    """``--mesh prod|prod-multipod``: the sharded dry-run on the host."""
    from repro_torch.distributed.sharding import ShardingEnv
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(args.arch)
    if args.device == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
    mesh = make_production_mesh(multi_pod=args.mesh == "prod-multipod")
    log = RunLogger(args.log_jsonl, quiet=args.quiet)
    try:
        log.print(f"mesh {args.mesh} ({mesh.size()} ranks, fake process "
                  f"group), arch {args.arch}, algo {algo.name}")
        log.log_event("meta", mesh=args.mesh, n_devices=mesh.size(),
                      arch=args.arch, algo=algo.name, steps=args.steps,
                      engine=args.engine, staleness=args.staleness,
                      device="meta")
        rl = RLConfig(group_size=4, num_minibatches=2, learning_rate=2e-4,
                      max_staleness=args.staleness + 1)
        out = sharded_dryrun(cfg, rl, ShardingEnv(mesh), algo,
                             num_microbatches=args.microbatch, log=log)
        log.log_event("sharded_dryrun", **out)
    finally:
        log.close()


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    if args.algo == "list":
        print_algo_list()
        return
    if args.method:
        warnings.warn("--method is deprecated; use --algo",
                      DeprecationWarning)
    # an explicit --algo always wins over the deprecated --method alias
    algo = resolve_algorithm(args.algo or args.method or "a3po")
    if args.mesh != "local":
        _mesh_dryrun(args, algo)
        return
    device = require_device(args.device)

    cfg = get_config(args.arch)
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
        if cfg.num_params() > 5e7:
            raise SystemExit(
                f"{args.arch} is full-scale ({cfg.num_params() / 1e9:.1f}B "
                "params): train it on the card (--device cuda). Toy archs "
                "for the CPU: toy-2m / toy-20m.")

    log = RunLogger(args.log_jsonl, quiet=args.quiet)
    tracer = install_tracer(SpanTracer()) if args.trace else None
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log.print(f"device {name}, arch {args.arch}, algo {algo.name}")
    log.log_event("meta", mesh=args.mesh, n_devices=1, arch=args.arch,
                  algo=algo.name, steps=args.steps, engine=args.engine,
                  staleness=args.staleness, device=name)

    rl = RLConfig(group_size=4, num_minibatches=2, learning_rate=2e-4,
                  max_staleness=args.staleness + 1)
    task = ArithmeticTask(max_operand=9, n_terms=2, prompt_len=8)
    try:
        resilience, resume = _resilience(args, device, log)
        if args.engine == "async":
            orch = AsyncOrchestrator(cfg, rl, task, algo, n_prompts=8,
                                     max_new_tokens=6,
                                     use_control_plane=True,
                                     resilience=resilience)
            start_step = 0
            if resume is not None:
                state = resume.state
                start_step = resume.step
                if resume.task_rng_state is not None:
                    task.rng.bit_generator.state = resume.task_rng_state
            else:
                state = orch.trainer.init_state(
                    torch.Generator(device=device).manual_seed(7),
                    device=device)
            state, recs = orch.run(state, args.steps, run_logger=log,
                                   start_step=start_step)
        else:
            state, recs = simulate_async(
                cfg, rl, task, algo, args.steps, n_prompts=8,
                max_new_tokens=6,
                staleness=0 if algo.on_policy else args.staleness,
                num_microbatches=args.microbatch, run_logger=log,
                resilience=resilience, resume=resume, device=device)
        for r in recs[:: max(1, len(recs) // 8)]:
            log.print(
                f"  step {r.step:3d} reward {r.reward:.3f} loss "
                f"{r.loss:+.4f} prox {r.prox_time_s * 1e3:.2f}ms stale "
                f"{r.staleness_mean:.1f} tok/s "
                f"{r.train_tokens / max(r.train_time_s, 1e-9):.0f} "
                f"syncs {r.host_syncs:.0f}")
        if args.checkpoint:
            save_checkpoint(args.checkpoint, {"params": state.params},
                            {"arch": args.arch, "algo": algo.name,
                             "steps": args.steps})
            log.print(f"saved {args.checkpoint}")
            log.log_event("checkpoint", path=args.checkpoint)
        if tracer is not None:
            tracer.export(args.trace)
            log.print(f"trace -> {args.trace}")
        if args.metrics_prom:
            get_registry().dump_prometheus(args.metrics_prom)
            log.print(f"prometheus metrics -> {args.metrics_prom}")
    finally:
        if tracer is not None:
            install_tracer(None)
        log.close()


if __name__ == "__main__":
    main()
