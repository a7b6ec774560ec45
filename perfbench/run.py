"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``;
``compared`` last: each number compared with its limit). The numbers
compared are also the last lines of standard error. Exits non-zero and
prints no result without CUDA or with fewer cards than the cell asks
for, without the port, or if JAX or the JAX package was imported.
"""
import os
import time

T_START = time.perf_counter()
# one process with few threads: the step is paced by the host's dispatch,
# and idle OpenMP workers spinning beside it steal the cores it runs on
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness
    sp = harness.spec()
    wl = harness.workload(sp, args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: src/repro_torch is missing from the checkout",
              file=sys.stderr)
        return 2
    tr = harness.traffic_file(wl["traffic"])
    run = harness.Run(cell=wl["name"],
                      model=harness.config_file(sp, wl["config"])["model"],
                      traffic=tr, limits=harness.limits_file(wl["name"]),
                      seed=args.seed, seconds=args.seconds,
                      trace_on=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START)
    from repro_torch.kernels import _build
    _build.build()
    harness.runner(tr["kind"]).execute(run)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run imported {found}", file=sys.stderr)
        return 3
    out = harness.result(sp, run, wl["chips"])
    print(f"setup {run.setup_s!r} s: {run.setup_parts}", file=sys.stderr)
    print(f"steps end at {[s['end_s'] for s in run.steps]} s; reference "
          f"{run.reference_s!r} s; leaves left out of change_leaf "
          f"{run.nought}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
