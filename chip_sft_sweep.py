"""Sweep the SFT warmup's learning rate at Qwen2.5-1.5B full width on one
NVIDIA GPU: how the loss falls and where the held-out greedy eval lands
after a given number of steps. It chose the steps and lr of
``chip_smoke.py``'s ``EX_SFT`` (phase 18 (b)).

    python3 chip_sft_sweep.py [--lrs 3e-5,1e-4,3e-4,3e-3] [--steps 150]

For each lr it runs ``repro_torch.training.warmup.sft_warmup`` (bf16, the
config's dtype; seed 0; batch 32, 14 tokens; the arithmetic task of
phase 18, seed 0), and after the steps in ``--eval-at`` scores the
parameters with ``eval_reward`` (n 64, outside the step timing). It prints
the card's name and power limit, then one JSON line per lr: the loss every
5 steps, the evals, the seconds per step and the peak memory. It exits 2
without CUDA.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TASK = dict(max_operand=9, n_terms=2, prompt_len=8, seed=0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen2.5-1.5b")
    p.add_argument("--lrs", default="3e-5,1e-4,3e-4,3e-3")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--eval-at", default="10,20,40,60,80,100,150")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_sft_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tasks import ArithmeticTask
    from repro_torch.kernels import _build
    from repro_torch.training import warmup

    from chip_smoke import _sft_losses

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    _build.build()
    cfg = get_config(args.arch)
    at = {int(x) for x in args.eval_at.split(",")}
    for lr in (float(x) for x in args.lrs.split(",")):
        evals, eval_s = {}, [0.0]

        def on_step(n, out):
            if n in at:
                t0 = time.perf_counter()
                evals[n] = warmup.eval_reward(cfg, out[0],
                                              ArithmeticTask(**TASK))
                eval_s[0] += time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        with _sft_losses(warmup, on_step) as losses:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warmup.sft_warmup(cfg, ArithmeticTask(**TASK), steps=args.steps,
                              lr=lr, device="cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0 - eval_s[0]
        curve = [float(x) for x in losses]
        print(json.dumps({
            "arch": cfg.name, "dtype": cfg.dtype, "lr": lr,
            "steps": len(curve), "step_s": seconds / len(curve),
            "finite": all(math.isfinite(x) for x in curve),
            "loss_every5": curve[::5], "last10_mean": sum(curve[-10:]) / 10,
            "eval_n64": evals,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
