"""End-to-end run on the PyTorch port: asynchronous RL training with
A-3PO (the counterpart of ``examples/train_async_rl.py``).

Pipeline (mirrors the paper's setup at toy scale):
  1. SFT-warm a ~2M/20M-param decoder on the synthetic arithmetic task
     (the stand-in for an instruct base model).
  2. Run async RL — rollout engine + trainer decoupled, behavior policy
     lagging `--staleness` versions — with the chosen algorithm (any
     registry name: a3po / recompute / sync / asympo / grpo_mu / ...).
  3. Report reward curves, prox-computation time, stability stats, and a
     held-out greedy eval. Checkpoints saved under experiments/torch/ckpt/
     in the JAX package's file format.

It runs on the card in the config's dtype unless `--device cpu` asks for
the CPU, where the model runs in float32 and full-scale archs are refused.

Run: PYTHONPATH=src python examples/torch_train_async_rl.py \
       --algo a3po --steps 40 [--model toy-20m] [--threaded] [--device cpu]
"""
import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.async_rl.orchestrator import AsyncOrchestrator, simulate_async
from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithms import resolve_algorithm
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.models.model import require_device
from repro_torch.training.checkpoints import save_checkpoint
from repro_torch.training.optimizer import adam_init
from repro_torch.training.trainer import TrainState
from repro_torch.training.warmup import eval_reward, sft_warmup

OUT_DIR = os.path.join("experiments", "torch")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--algo", default="a3po",
                   help="policy-optimization algorithm (registry name)")
    p.add_argument("--model", default="toy-2m")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--staleness", type=int, default=2)
    p.add_argument("--sft-steps", type=int, default=150)
    p.add_argument("--prompts", type=int, default=8)
    p.add_argument("--threaded", action="store_true",
                   help="real thread-decoupled engines instead of the "
                        "deterministic simulator")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (float32, toy archs)")
    args = p.parse_args(argv)

    device = require_device(args.device)
    algo = resolve_algorithm(args.algo)
    cfg = get_config(args.model)
    if device.type == "cpu":  # float32 and toy archs, as launch/train.py
        cfg = dataclasses.replace(cfg, dtype="float32")
        if cfg.num_params() > 5e7:
            raise SystemExit(
                f"{args.model} is full-scale ({cfg.num_params() / 1e9:.1f}B "
                "params): run it on the card (--device cuda). Toy archs "
                "for the CPU: toy-2m / toy-20m.")
    rl = RLConfig(algo=algo, group_size=4, num_minibatches=2,
                  learning_rate=2e-4)
    task = ArithmeticTask(max_operand=9, n_terms=2, prompt_len=8,
                          seed=args.seed)

    print(f"== SFT warmup ({args.sft_steps} steps, "
          f"{cfg.num_params()/1e6:.1f}M params) ==")
    params, sft_loss = sft_warmup(cfg, task, steps=args.sft_steps,
                                  device=device)
    base = eval_reward(cfg, params, task)
    print(f"base eval reward: {base:.3f} (sft loss {sft_loss:.3f})")

    state = TrainState(params, adam_init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    print(f"== async RL: algo={algo.name} staleness={args.staleness} ==")
    if args.threaded:
        orch = AsyncOrchestrator(cfg, rl, task, algo,
                                 n_prompts=args.prompts, max_new_tokens=6)
        state, recs = orch.run(state, args.steps)
    else:
        staleness = 0 if algo.on_policy else args.staleness
        state, recs = simulate_async(
            cfg, rl, task, algo, args.steps, n_prompts=args.prompts,
            max_new_tokens=6, staleness=staleness, seed=args.seed,
            init_state=state, eval_every=10,
            eval_fn=lambda p: eval_reward(cfg, p, task, n=32))

    for r in recs:
        if r.step % 5 == 0 or r.step == len(recs) - 1 or r.eval_reward is not None:
            ev = f" eval {r.eval_reward:.3f}" if r.eval_reward is not None else ""
            print(f"  step {r.step:3d} reward {r.reward:.3f} "
                  f"loss {r.loss:+.4f} entropy {r.entropy:.3f} "
                  f"prox {r.prox_time_s*1e3:.2f}ms "
                  f"stale {r.staleness_mean:.1f}{ev}")

    final = eval_reward(cfg, state.params, task)
    print(f"final eval reward: {final:.3f} (base {base:.3f})")
    out = os.path.join(OUT_DIR, "ckpt", f"{args.model}_{algo.name}")
    save_checkpoint(out, {"params": state.params},
                    {"algo": algo.name, "steps": args.steps,
                     "final_eval_reward": final})
    print(f"checkpoint: {out}.npz")
    summary = {"algo": algo.name, "base_eval": base, "final_eval": final,
               "mean_prox_ms": float(np.mean(
                   [r.prox_time_s for r in recs[1:]])) * 1e3}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
