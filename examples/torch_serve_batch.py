"""Batched serving on the PyTorch port: continuous request handling with
the dense rollout engine (the counterpart of ``examples/serve_batch.py``;
the inference half of the async system).

Submits several waves of prompts, generates with the KV-cached decode loop
(prefill through the flash attention kernel, decode through the dense
decode attention kernel on the card), and reports tokens/s + per-request
completions. ``--arch`` selects any registry architecture the engine
serves. It runs on the card in the config's dtype unless `--device cpu`
asks for the CPU, where the model runs in float32 and full-scale archs are
refused (their ``-reduced`` variants serve there).

Run: PYTHONPATH=src python examples/torch_serve_batch.py \
       [--arch toy-2m] [--waves 3] [--batch 8] [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import RLConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.models import model as M
from repro_torch.rollout.engine import RolloutEngine


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="toy-2m")
    p.add_argument("--waves", type=int, default=3)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (float32, toy and -reduced "
                        "archs)")
    args = p.parse_args(argv)

    device = M.require_device(args.device)
    name = args.arch
    cfg = get_config(name)
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
        if cfg.num_params() > 5e7:
            raise SystemExit(
                f"{name} is full-scale ({cfg.num_params() / 1e9:.1f}B "
                f"params): serve it on the card (--device cuda), or "
                f"--arch {name}-reduced on the CPU.")
    print(f"serving {name}: {cfg.num_params()/1e6:.1f}M params, "
          f"{cfg.arch_type}")

    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    engine = RolloutEngine(cfg, RLConfig(temperature=0.8),
                           max_new_tokens=args.max_new)
    task = ArithmeticTask(max_operand=99, n_terms=2, prompt_len=12, seed=1)

    total_tokens, total_time = 0, 0.0
    for wave in range(args.waves):
        b = task.sample(args.batch)
        # clamp token ids into this arch's vocab (task vocab is tiny)
        prompts = np.minimum(b.prompts, cfg.vocab_size - 1)
        t0 = time.perf_counter()
        rb = engine.generate(params, prompts, b.prompt_lengths,
                             torch.Generator(device=device).manual_seed(wave),
                             version=wave)
        dt = time.perf_counter() - t0
        n_tok = int(rb.gen_mask.sum())
        total_tokens += n_tok
        total_time += dt
        print(f"wave {wave}: {args.batch} reqs, {n_tok} tokens in "
              f"{dt:.2f}s ({n_tok/dt:.1f} tok/s)")
        if cfg.vocab_size >= tok.VOCAB_SIZE:
            for i in range(min(2, args.batch)):
                comp = engine.completions(rb)[i]
                print(f"   req{i}: {tok.decode(prompts[i])!r} -> "
                      f"{tok.decode(comp)!r}")
    print(f"TOTAL: {total_tokens} tokens, "
          f"{total_tokens/max(total_time,1e-9):.1f} tok/s")


if __name__ == "__main__":
    main()
