"""Trace-driven load harness on the PyTorch port: 2-class bursty overload,
SLO vs FIFO (the counterpart of ``examples/loadgen_trace.py``).

Synthesizes a bursty two-class workload (latency-critical ``chat`` vs
best-effort ``batch``) that oversubscribes the engine's virtual capacity
about 2x, then replays the *same* trace twice through the serving
control plane on the virtual clock:

* ``fifo`` — no priorities: chat requests queue behind batch bursts and
  blow through their TTFT SLO;
* ``slo`` — priority admission + deadline-aware shedding + overload
  preemption: chat stays inside its SLO, batch absorbs the tail.

Everything is deterministic (numpy-seeded trace + virtual clock + greedy
decoding), so the numbers printed here are reproducible to the last
digit on one device. The model runs in float32, as the reference casts
it, with seeded random weights, on the card (the paged prefill and paged
decode attention kernels) unless `--device cpu` asks for the CPU.

Run: PYTHONPATH=src python examples/torch_loadgen_trace.py [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs.registry import get_config
from repro_torch.loadgen.harness import CostModel, run_trace
from repro_torch.loadgen.traces import SLOClass, TraceConfig, synthesize
from repro_torch.models import model as M
from repro_torch.obs.report import render_load


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--duration", type=float, default=2.5,
                   help="trace length (virtual seconds)")
    p.add_argument("--rate", type=float, default=14.0,
                   help="mean arrivals/s (~2x virtual capacity)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = M.require_device(args.device)
    classes = (
        SLOClass("chat", 0, ttft_slo_s=0.5, e2e_slo_s=4.0,
                 share=0.35, max_new=8),
        SLOClass("batch", 2, ttft_slo_s=6.0, e2e_slo_s=30.0,
                 share=0.65, max_new=16),
    )
    trace = synthesize(TraceConfig(
        seed=args.seed, duration_s=args.duration, rate_rps=args.rate,
        burstiness=0.5, publish_every_s=1.0), classes)
    print(f"trace: {len(trace.requests)} requests / "
          f"{trace.duration_s:.1f}s, {len(trace.publishes)} publishes\n")

    cfg = dataclasses.replace(get_config("toy-2m"), dtype="float32")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    # inflated virtual costs: a small trace still queues like an
    # overloaded production box
    cost = CostModel(step_overhead_s=0.010, prefill_chunk_s=0.020,
                     decode_token_s=0.010)

    for policy in ("fifo", "slo"):
        res = run_trace(cfg, params, trace, policy=policy, cost=cost,
                        max_seqs=2, device=device)
        print(render_load(res.summary))
        print()

    print("same trace, same engine — only the admission policy changed.")


if __name__ == "__main__":
    main()
