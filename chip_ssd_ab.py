"""Time the port's two SSD kernels in two checkouts on one card, with one
timer and the same inputs, so that only the kernels differ.

    python3 chip_ssd_ab.py --base DIR [--out FILE]

DIR is another checkout of this repo (for example the parent commit,
unpacked with ``git archive``). Four runs go in the order base, this,
this, base (labels P1, G1, G2, P2), each a fresh process that builds and
loads one checkout's ``repro_torch`` (its ``csrc/ssd.cu``). A run times
that checkout's ``ssd_decode_step`` (in place, every row updated) and
``ssd_intra_chunk`` at ``chip_smoke.py``'s SSD shapes, on the inputs
``chip_smoke.py`` makes (seeded per shape), with this checkout's
``chip_smoke.Timer``, after holding each against its plain version with
``chip_smoke.py``'s tolerances. Prints the card's name and power limit,
one JSON line per run, kernel and shape, and one summary line per kernel
and shape; exits 1 if a run fails or a kernel misses its tolerance.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ORDER = (("P1", "base"), ("G1", "this"), ("G2", "this"), ("P2", "base"))


def _worst(got, ref, rtol, atol) -> float:
    """max |got - ref| / (atol + rtol |ref|): at most 1 within tolerance."""
    err = (got.float() - ref).abs() / (atol + rtol * ref.abs())
    return float(err.max())


def worker(tree: Path, label: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops as sops
    from repro_torch.kernels.ssd.ref import (
        ssd_decode_step_ref,
        ssd_intra_chunk_ref,
    )

    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"repro_torch from {repro_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["ssd"])
    timer = cs.Timer(torch)
    base = {"run": label, "tree": str(tree)}
    with torch.no_grad():
        for k, (model, nh, ds) in enumerate(cs.SSD_DECODE_SHAPES):
            g = torch.Generator(device="cuda").manual_seed(100 + k)
            state, x, dt, a_log, b, c = cs._ssd_decode_inputs(torch, g, nh,
                                                               ds)
            y, new = sops.ssd_decode_step(state, x, dt, a_log, b, c)
            y_ref, new_ref = ssd_decode_step_ref(
                state, x.float(), dt, a_log.float(), b.float(), c.float())
            worst = max(_worst(y, y_ref, **cs.TOL["bfloat16"]),
                        _worst(new, new_ref, **cs.TOL["float32"]))
            pool = state.clone()
            ms = timer.ms(lambda: sops.ssd_decode_step(pool, x, dt, a_log, b,
                                                       c, out=pool), iters=50)
            cs.emit({**base, "name": "ssd_decode_step", "model": model,
                     "shape": {"B": cs.SSD_SLOTS, "nh": nh, "ds": ds},
                     "ms": ms, "worst_err_over_tol": worst})
            if worst > 1.0:
                raise AssertionError(f"{label} ssd_decode_step {model}")
        for k, (model, B, S, L, nh, ds) in enumerate(cs.SSD_INTRA_SHAPES):
            g = torch.Generator(device="cuda").manual_seed(200 + k)
            xdt, la, b, c = cs._ssd_intra_inputs(torch, g, B, S, nh, ds)
            outs = sops.ssd_intra_chunk(xdt, la, b, c, L)
            refs = ssd_intra_chunk_ref(xdt, la, b.float(), c.float(), L)
            worst = max(_worst(o, r, cs.SSD_INTRA_RTOL,
                               cs.SSD_INTRA_RTOL * float(r.abs().max()))
                        for o, r in zip(outs, refs))
            del outs, refs
            ms = timer.ms(lambda: sops.ssd_intra_chunk(xdt, la, b, c, L))
            cs.emit({**base, "name": "ssd_intra_chunk", "model": model,
                     "shape": {"B": B, "S": S, "chunk": L, "nh": nh,
                               "ds": ds},
                     "writes_cum": hasattr(sops, "ssd_intra_chunk_cum"),
                     "ms": ms, "worst_err_over_tol": worst})
            if worst > 1.0:
                raise AssertionError(f"{label} ssd_intra_chunk {model}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker.resolve(), args.label)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_ssd_ab: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    trees = {"base": args.base.resolve(), "this": ROOT}
    records = []
    for label, which in ORDER:
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--base",
             str(trees["base"]), "--worker", str(trees[which]), "--label",
             label], capture_output=True, text=True, timeout=900)
        sys.stderr.write(run.stderr[-4000:])
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
        print("\n".join(lines), flush=True)
        records += [json.loads(ln) for ln in lines]
        if run.returncode != 0:
            print(f"chip_ssd_ab: run {label} failed ({run.returncode})",
                  file=sys.stderr)
            return 1
    if args.out:
        args.out.write_text("".join(json.dumps(r) + "\n" for r in records))
    keys = []
    for r in records:
        key = (r["name"], r["model"], json.dumps(r["shape"]))
        if key not in keys:
            keys.append(key)
    for name, model, shape in keys:
        ms = {r["run"]: r["ms"] for r in records
              if (r["name"], r["model"], json.dumps(r["shape"]))
              == (name, model, shape)}
        base_ms = (ms["P1"] + ms["P2"]) / 2
        this_ms = (ms["G1"] + ms["G2"]) / 2
        print(json.dumps({"summary": name, "model": model,
                          "shape": json.loads(shape), "ms": ms,
                          "base_over_this": base_ms / this_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
