"""Beyond-paper ablation on the PyTorch port: alpha schedules for the prox
approximation (the counterpart of ``examples/ablate_alpha.py``).

The paper fixes alpha = 1/d. We compare: inverse (paper), exp (gamma^d),
clipped inverse, and const — same SFT base, same data order — and report
final eval reward + stability stats for each. Each variant is just the
``A3PO`` Algorithm with a different nested ``schedule`` override — the
registry API makes an ablation a list of frozen Algorithm instances.

It runs on the card in the config's dtype unless `--device cpu` asks for
the CPU (float32).

Run: PYTHONPATH=src python examples/torch_ablate_alpha.py [--steps 25]
       [--device cpu]
"""
import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.async_rl.orchestrator import simulate_async
from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithms import A3PO
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.models.model import require_device
from repro_torch.training.optimizer import adam_init
from repro_torch.training.trainer import TrainState
from repro_torch.training.warmup import eval_reward, sft_warmup

OUT_DIR = os.path.join("experiments", "torch")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--staleness", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (float32)")
    args = p.parse_args(argv)

    device = require_device(args.device)
    cfg = get_config("toy-2m")
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
    task = ArithmeticTask(max_operand=9, n_terms=2, prompt_len=8, seed=0)
    base_params, _ = sft_warmup(cfg, task, device=device)
    base = eval_reward(cfg, base_params, task)
    print(f"base eval reward {base:.3f}")

    results = {}
    for schedule in ("inverse", "exp", "clipped", "const"):
        # per-algorithm nested config: the schedule override lives on the
        # frozen A3PO instance, not in a parallel RLConfig field
        algo = A3PO(schedule=schedule)
        rl = RLConfig(algo=algo, group_size=4, num_minibatches=2,
                      learning_rate=2e-4)
        state = TrainState(base_params, adam_init(base_params),
                           torch.zeros((), dtype=torch.int32, device=device))
        state, recs = simulate_async(
            cfg, rl, task, algo, args.steps, n_prompts=8,
            max_new_tokens=6, staleness=args.staleness, seed=0,
            init_state=state)
        final = eval_reward(cfg, state.params, task)
        results[schedule] = {
            "final_eval": final,
            "iw_max": float(np.max([r.iw_max for r in recs])),
            "clipped_tokens_mean": float(np.mean(
                [r.clipped_tokens for r in recs])),
        }
        print(f"{schedule:8s}: eval {final:.3f} "
              f"iw_max {results[schedule]['iw_max']:.2f} "
              f"clip/step {results[schedule]['clipped_tokens_mean']:.1f}")
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, "alpha_ablation.json")
    with open(out, "w") as f:
        json.dump({"base_eval": base, "staleness": args.staleness,
                   "results": results}, f, indent=2)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
