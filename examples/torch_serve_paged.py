"""Continuous-batching serving over the paged KV cache on the PyTorch port
(the counterpart of ``examples/serve_paged.py``).

Requests of different lengths stream through a fixed number of slots;
pages are recycled as sequences finish (the paged prefill and paged decode
attention kernels on the card). Compare with
examples/torch_serve_batch.py (static batching, dense cache). It runs on
the card in the config's dtype unless `--device cpu` asks for the CPU
(float32).

Run: PYTHONPATH=src python examples/torch_serve_paged.py [--requests 12]
       [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.models import model as M
from repro_torch.rollout.continuous import ContinuousBatchingEngine


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--horizon", type=int, default=8,
                   help="decode tokens per fused launch (1 = per-token)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (float32)")
    args = p.parse_args(argv)

    device = M.require_device(args.device)
    cfg = get_config("toy-2m")
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    srv = ContinuousBatchingEngine(cfg, max_seqs=args.slots, block_size=8,
                                   n_blocks=128, max_blocks_per_seq=8,
                                   greedy=True, decode_horizon=args.horizon,
                                   device=device)
    task = ArithmeticTask(max_operand=99, n_terms=2, prompt_len=12, seed=3)
    batch = task.sample(args.requests)
    for i in range(args.requests):
        L = int(batch.prompt_lengths[i])
        srv.submit(batch.prompts[i, :L], max_new=args.max_new)

    t0 = time.perf_counter()
    done = srv.run(params, torch.Generator(device=device).manual_seed(1))
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.generated) for r in done)
    print(f"{len(done)} requests through {args.slots} slots "
          f"(horizon {args.horizon}): {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s, {srv.host_syncs} host syncs)")
    for r in done[:4]:
        print(f"  req{r.rid}: {tok.decode(r.prompt)!r} -> "
              f"{tok.decode(r.generated)!r}")
    print(f"free pages after drain: {srv.allocator.n_free}")


if __name__ == "__main__":
    main()
