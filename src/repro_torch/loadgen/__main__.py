"""Load-harness CLI: synthesize (or load) a trace and replay it
(``repro.loadgen``'s CLI).

    python -m repro_torch.loadgen --trace synthetic --seed 0
    python -m repro_torch.loadgen --trace path/to/trace.jsonl --policy fifo
    python -m repro_torch.loadgen --device cpu --quick

Deterministic by construction: the same trace + seed + policy produces
byte-identical lifecycle JSONL (virtual-clock stamps only — validate
with two runs and ``cmp``). Output: per-request ``kind="request"``
records plus one ``kind="load_summary"`` (the per-class SLO table) in
``--jsonl``, rendered via ``repro_torch.obs.report`` at the end of the run.

The model runs in float32 (as the reference forces), with seeded random
weights, on the card unless ``--device cpu`` asks for the CPU, which
refuses full-scale architectures as the training launcher does.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.loadgen",
        description="Trace-driven multi-tenant load harness")
    p.add_argument("--trace", default="synthetic",
                   help="'synthetic' or a trace JSONL path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--policy", default="slo",
                   choices=["slo", "priority", "fifo"])
    p.add_argument("--arch", default="toy-2m")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (toy archs only)")
    p.add_argument("--duration", type=float, default=6.0,
                   help="synthetic trace length (virtual seconds)")
    p.add_argument("--rate", type=float, default=10.0,
                   help="synthetic mean arrival rate (requests/s)")
    p.add_argument("--burstiness", type=float, default=0.6,
                   help="gamma shape: 1=Poisson, <1 bursty")
    p.add_argument("--publish-every", type=float, default=2.0,
                   help="virtual seconds between weight publishes "
                        "(0 = none)")
    p.add_argument("--jsonl", default="loadgen_run.jsonl",
                   help="lifecycle JSONL output path")
    p.add_argument("--save-trace", default=None,
                   help="also write the (synthetic) trace JSONL here")
    p.add_argument("--max-seqs", type=int, default=4)
    p.add_argument("--horizon", type=int, default=4)
    p.add_argument("--prefill-chunk", type=int, default=16)
    p.add_argument("--d-max", type=int, default=1_000_000)
    p.add_argument("--age-promote-s", type=float, default=math.inf)
    p.add_argument("--fault", action="append", default=[],
                   metavar="KIND@AT[xN][:MAG]",
                   help="inject a deterministic serving fault "
                        "(repeatable): kv_exhaust@STEPxN:BLOCKS holds KV "
                        "blocks hostage, nan_logits@STEP poisons a decode "
                        "logits row")
    p.add_argument("--fault-seed", type=int, default=0)
    p.add_argument("--quick", action="store_true",
                   help="CI smoke: short trace")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    # imports deferred so --help stays instant
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.loadgen.harness import run_trace
    from repro_torch.loadgen.traces import (
        TraceConfig,
        load_trace,
        save_trace,
        synthesize,
    )
    from repro_torch.models import model as M
    from repro_torch.obs.report import render_load
    from repro_torch.obs.runlog import RunLogger
    from repro_torch.resilience import FaultPlan

    if args.trace == "synthetic":
        duration = 2.0 if args.quick else args.duration
        rate = 6.0 if args.quick else args.rate
        trace = synthesize(TraceConfig(
            seed=args.seed, duration_s=duration, rate_rps=rate,
            burstiness=args.burstiness,
            publish_every_s=args.publish_every))
    else:
        trace = load_trace(args.trace)
    if args.save_trace:
        save_trace(args.save_trace, trace)

    device = M.require_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch), dtype="float32")
    if device.type == "cpu" and cfg.num_params() > 5e7:
        raise SystemExit(
            f"{args.arch} is full-scale ({cfg.num_params() / 1e9:.1f}B "
            "params): replay it on the card (--device cuda). Toy archs "
            "for the CPU: toy-2m / toy-20m.")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device, dtype=torch.float32)

    with RunLogger(jsonl_path=args.jsonl, quiet=args.quiet) as logger:
        logger.log_event(
            "load_header", trace=args.trace, seed=args.seed,
            policy=args.policy, arch=args.arch,
            requests=len(trace.requests), classes=len(trace.classes),
            time_unix_s=0.0)  # fixed stamp: keep the file deterministic
        logger.print(f"replaying {len(trace.requests)} requests "
                     f"({len(trace.classes)} classes, "
                     f"{len(trace.publishes)} publishes) "
                     f"policy={args.policy} arch={args.arch}")
        t0 = time.perf_counter()
        faults = None
        if args.fault:
            faults = FaultPlan.from_strings(args.fault,
                                            seed=args.fault_seed)
        result = run_trace(
            cfg, params, trace, policy=args.policy, logger=logger,
            seed=args.seed, max_seqs=args.max_seqs,
            decode_horizon=args.horizon,
            prefill_chunk=args.prefill_chunk, d_max=args.d_max,
            age_promote_s=args.age_promote_s, faults=faults, device=device)
        wall = time.perf_counter() - t0
        logger.print(render_load(result.summary))
        logger.print(
            f"  wall {wall:.1f}s for {result.steps} control-plane steps "
            f"({result.virtual_time_s:.2f}s virtual)")
        logger.print(f"  lifecycle JSONL -> {args.jsonl}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
