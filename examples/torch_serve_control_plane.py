"""Staleness-aware rollout control plane on the PyTorch port (the
counterpart of ``examples/serve_control_plane.py``).

Serves two GRPO-style groups of repeated prompts plus one urgent request
through the control plane while weight versions are published mid-flight:

* the radix prefix cache turns each group's repeated prompt into one
  prefill (watch ``prefix_hit_rate``);
* a publish mid-generation does NOT drain or restart in-flight sequences —
  they resume under the new params and their tokens carry per-token
  version stamps (the ``[B, T]`` staleness signal A-3PO's alpha consumes);
* the admission scheduler runs priority classes and a staleness budget.

Sampling draws Gumbel-max noise from one seeded ``torch.Generator`` (the
reference splits a JAX key). It runs on the card in the config's dtype
(the paged prefill and paged decode attention kernels over radix-shared
pages) unless `--device cpu` asks for the CPU (float32).

Run: PYTHONPATH=src python examples/torch_serve_control_plane.py
       [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.async_rl.weights import WeightStore
from repro_torch.configs.registry import get_config
from repro_torch.data.tasks import ArithmeticTask
from repro_torch.models import model as M
from repro_torch.rollout.continuous import ContinuousBatchingEngine
from repro_torch.serving import (
    AdmissionScheduler,
    SchedulerConfig,
    ServingControlPlane,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--group", type=int, default=4)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--publish-every", type=int, default=3,
                   help="steps between simulated weight publishes")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (float32)")
    args = p.parse_args(argv)

    device = M.require_device(args.device)
    cfg = get_config("toy-2m")
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    store = WeightStore(params, 0)
    engine = ContinuousBatchingEngine(cfg, max_seqs=args.slots, block_size=8,
                                      n_blocks=128, max_blocks_per_seq=8,
                                      device=device)
    cp = ServingControlPlane(
        engine, store, AdmissionScheduler(SchedulerConfig(d_max=8)))

    task = ArithmeticTask(max_operand=99, n_terms=2, prompt_len=12, seed=3)
    batch = task.sample(2)
    for i in range(2):  # two GRPO groups: group-size copies of each prompt
        L = int(batch.prompt_lengths[i])
        for _ in range(args.group):
            cp.submit(batch.prompts[i, :L], max_new=args.max_new, priority=1)
    urgent = task.sample(1)
    cp.submit(urgent.prompts[0, : int(urgent.prompt_lengths[0])],
              max_new=args.max_new, priority=0)  # jumps the bulk queue

    generator = torch.Generator(device=device).manual_seed(1)
    version = 0
    done = []
    steps = 0
    while len(done) < 2 * args.group + 1 and steps < 500:
        done.extend(cp.step(generator))
        steps += 1
        if steps % args.publish_every == 0:
            version += 1
            store.publish(params, version)  # trainer publish, mid-flight

    print(f"served {len(done)} requests in {steps} steps, "
          f"{version} weight publishes absorbed mid-flight")
    for r in done[: args.group + 1]:
        boundary = len(set(r.token_versions)) > 1
        print(f"  req{r.rid} prio={r.priority} prefix_hit="
              f"{r.prefix_hit_tokens}/{len(r.prompt)} "
              f"stamps={r.token_versions}"
              f"{'  <- crossed publish' if boundary else ''}")
    snap = cp.metrics.snapshot()
    keys = ("prefix_hit_rate", "prefill_tokens_computed", "decode_tokens",
            "interrupts", "resumed_sequences", "staleness_mean",
            "staleness_max", "page_util_mean", "completed")
    print("metrics:", {k: round(snap[k], 3) for k in keys})


if __name__ == "__main__":
    main()
