"""Serving launcher (``repro.launch.serve``): waves of batched generation
through the dense ``RolloutEngine`` on seeded random weights, in float32
as the reference casts them.

The model runs on the card unless ``--device cpu`` asks for the CPU,
where a config of more than 5e7 parameters is swapped for its
``-reduced`` variant, as the reference does on its host. Sampling is
seeded by one ``torch.Generator`` a wave, where the reference splits a
JAX key. Frontend (vision, audio) stacks need precomputed embeddings the
engine is not given, so they raise, as in the reference.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      deepseek-v2-lite-16b --batch 8 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch toy-2m
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import model as M
from repro_torch.rollout.engine import RolloutEngine


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="toy-2m")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--waves", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (reduced variants of "
                        "full-scale archs)")
    args = p.parse_args(argv)
    device = M.require_device(args.device)

    cfg = get_config(args.arch)
    if device.type == "cpu" and cfg.num_params() > 5e7:
        cfg = get_config(args.arch + "-reduced")
        print(f"(CPU host: serving reduced variant of {args.arch})")
    cfg = dataclasses.replace(cfg, dtype="float32")

    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    engine = RolloutEngine(cfg, RLConfig(temperature=0.8),
                           max_new_tokens=args.max_new)
    rng = np.random.default_rng(0)
    for wave in range(args.waves):
        prompts = rng.integers(4, cfg.vocab_size,
                               (args.batch, args.prompt_len)).astype(np.int32)
        lengths = np.full((args.batch,), args.prompt_len, np.int32)
        t0 = time.perf_counter()
        rb = engine.generate(params, prompts, lengths,
                             torch.Generator(device=device).manual_seed(wave))
        dt = time.perf_counter() - t0
        n = int(rb.gen_mask.sum())
        print(f"wave {wave}: {args.batch} seqs x {args.max_new} new -> "
              f"{n} tokens, {n / dt:.1f} tok/s", flush=True)


if __name__ == "__main__":
    main()
