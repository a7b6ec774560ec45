"""Sweep the SFT warmup's or the RL loop's learning rate at Qwen2.5-1.5B
full width on one NVIDIA GPU. The SFT mode chose the steps and lr of
``chip_smoke.py``'s ``EX_SFT``, the RL mode the lr of its ``EX_RL``
(phase 18 (b)).

    python3 chip_sft_sweep.py [--lrs 3e-5,1e-4,3e-4,3e-3] [--steps 150]
    python3 chip_sft_sweep.py --mode rl [--lrs 2e-4,5e-5,1e-5,3e-6,1e-6]

SFT mode: for each lr it runs ``repro_torch.training.warmup.sft_warmup``
(bf16, the config's dtype; seed 0; batch 32, 14 tokens; the arithmetic
task of phase 18, seed 0), and after the steps in ``--eval-at`` scores the
parameters with ``eval_reward`` (n 64, outside the step timing). It prints
one JSON line per lr: the loss every 5 steps, the evals, the seconds per
step and the peak memory.

RL mode: it warms one base with ``EX_SFT`` and scores it (n 64), then for
each lr runs phase 18 (b)'s loop (``chip_smoke._rl_from_base``: a3po, then
recompute, each from that base) and prints one JSON line per lr and
algorithm: reward and entropy per step, the evals (n 32 every 4 steps,
final n 64) and why the run collapsed by ``chip_smoke._collapse`` (empty
when it did not); last, the largest lr at which neither run collapsed.

Both modes print the card's name and power limit first, and exit 2
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
    p.add_argument("--mode", choices=("sft", "rl"), default="sft")
    p.add_argument("--arch", default="qwen2.5-1.5b")
    p.add_argument("--lrs", default=None,
                   help="default 3e-5,1e-4,3e-4,3e-3 (sft), "
                   "2e-4,5e-5,1e-5,3e-6,1e-6 (rl)")
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
    if args.mode == "rl":
        return _rl_sweep(torch, cfg, [float(x) for x in (
            args.lrs or "2e-4,5e-5,1e-5,3e-6,1e-6").split(",")])
    at = {int(x) for x in args.eval_at.split(",")}
    for lr in (float(x) for x in (args.lrs
                                  or "3e-5,1e-4,3e-4,3e-3").split(",")):
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


def _rl_sweep(torch, cfg, lrs) -> int:
    from repro_torch.data.tasks import ArithmeticTask
    from repro_torch.training import warmup

    from chip_smoke import EX_SFT, EX_TASK, _collapse, _rl_from_base

    t0 = time.perf_counter()
    base_params, _ = warmup.sft_warmup(cfg, ArithmeticTask(**EX_TASK),
                                       device="cuda", **EX_SFT)
    base = warmup.eval_reward(cfg, base_params, ArithmeticTask(**EX_TASK))
    print(json.dumps({"arch": cfg.name, "dtype": cfg.dtype, "sft": EX_SFT,
                      "base_eval_n64": base,
                      "seconds": time.perf_counter() - t0}), flush=True)
    held = []
    for lr in lrs:
        whys = []
        for name in ("a3po", "recompute"):
            state, recs, seconds = _rl_from_base(torch, cfg, base_params,
                                                 name, lr)
            final = warmup.eval_reward(cfg, state.params,
                                       ArithmeticTask(**EX_TASK))
            entropy = [r["entropy"] for r in recs]
            why = _collapse(entropy, final, base)
            whys.append(why)
            print(json.dumps({
                "lr": lr, "algo": name, "seconds": seconds,
                "reward": [r["reward"] for r in recs], "entropy": entropy,
                "eval_n32": {r["step"]: r["eval_reward"] for r in recs
                             if r["eval_reward"] is not None},
                "base_eval_n64": base, "final_eval_n64": final,
                "collapse": why}), flush=True)
            del state
            torch.cuda.empty_cache()
        if not any(whys):
            held.append(lr)
    print(json.dumps({"largest_lr_without_collapse":
                      max(held) if held else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
