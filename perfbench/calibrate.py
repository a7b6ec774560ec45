"""Readings for setting a training cell's limits: the numbers the
comparison computes, for sound runs of the program and for each run that
has to fail them, on several seeds in one process (no measured window).

    python3 perfbench/calibrate.py --workload <name> \
        --runs sound:1-12,control:101-103,half:201-203 [--out FILE]

Modes: ``sound`` (the program as the configuration states it),
``control`` (the reference in float8, e4m3 with one scale per tensor, in
the program's place), ``half`` (the program handed the first half of
each batch's rows, the mean taken over them), ``unchanged`` (the
program's step returning its state as it was). One JSON line a run, on
standard output and appended to ``--out``.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def seeds(text: str):
    out = []
    for part in text.split("+"):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def reading(run, mode: str) -> dict:
    """One run's numbers (``run`` as ``harness.Run`` makes it)."""
    import torch

    from perfbench.kinds import train as K
    t0 = time.perf_counter()
    if mode == "control":
        K.setup(run, run.device, control="fp8")
    else:
        prog = K.setup(run, run.device,
                       fault=None if mode == "sound" else mode)
        del prog
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    K.compare(run)
    return {"mode": mode, "seed": run.seed, "numbers": run.numbers,
            "nought": run.nought,
            "program_s": t1 - t0, "reference_s": run.reference_s,
            "program_steps": run.program_readings["steps"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness
    sp = harness.spec()
    wl = harness.workload(sp, args.workload)
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build()
    model = harness.config_file(sp, wl["config"])["model"]
    tr = harness.traffic_file(wl["traffic"])
    for item in args.runs.split(","):
        mode, _, spec_ = item.partition(":")
        for seed in seeds(spec_):
            run = harness.Run(cell=wl["name"], model=model, traffic=tr,
                              limits={}, seed=seed, seconds=0,
                              trace_on=False, device=torch.device("cuda", 0),
                              t_start=time.perf_counter())
            rec = dict(reading(run, mode), workload=wl["name"])
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            del run
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
