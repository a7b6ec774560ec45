"""CI schema gate: validate a run's JSONL log and trace.json (a copy of
``repro_torch.obs.validate``: the same schema, so it gates either package's runs).

    python -m repro_torch.obs.validate --jsonl run.jsonl [--trace trace.json] \
        [--min-steps N] [--expect-span NAME ...]
    python -m repro_torch.obs.validate --jsonl load_run.jsonl --loadgen \
        [--min-requests N]

Fails (exit 1) when:
* any JSONL step record is missing a required key or carries a schema
  version other than ``RUNLOG_SCHEMA_VERSION`` (schema drift);
* fewer than ``--min-steps`` step records were emitted;
* the trace is not valid Chrome trace-event JSON (``traceEvents`` list of
  events with ``ph``/``ts``), or an ``--expect-span`` name is absent;
* with ``--loadgen``: a request-lifecycle record is missing a required
  key, no ``load_summary`` record closes the run, or fewer than
  ``--min-requests`` lifecycle records were emitted.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

from repro_torch.obs.runlog import (
    RUNLOG_SCHEMA_VERSION,
    STEP_REQUIRED_KEYS,
    read_jsonl,
)


def validate_jsonl(path: str, min_steps: int = 1) -> List[str]:
    errors: List[str] = []
    try:
        steps = read_jsonl(path, kind="step")
    except (OSError, json.JSONDecodeError) as e:
        return [f"jsonl unreadable: {e!r}"]
    if len(steps) < min_steps:
        errors.append(f"expected >= {min_steps} step records, "
                      f"got {len(steps)}")
    for i, rec in enumerate(steps):
        if rec.get("schema") != RUNLOG_SCHEMA_VERSION:
            errors.append(f"record {i}: schema {rec.get('schema')!r} != "
                          f"{RUNLOG_SCHEMA_VERSION}")
        missing = [k for k in STEP_REQUIRED_KEYS if k not in rec]
        if missing:
            errors.append(f"record {i}: missing keys {missing}")
    return errors


def validate_loadgen_jsonl(path: str, min_requests: int = 1) -> List[str]:
    """Schema-gate the load harness's lifecycle JSONL."""
    from repro_torch.loadgen.traces import (
        LIFECYCLE_REQUIRED_KEYS,
        SUMMARY_REQUIRED_KEYS,
    )
    errors: List[str] = []
    try:
        records = read_jsonl(path, kind=None)
    except (OSError, json.JSONDecodeError) as e:
        return [f"jsonl unreadable: {e!r}"]
    reqs = [r for r in records if r.get("kind") == "request"]
    summaries = [r for r in records if r.get("kind") == "load_summary"]
    if len(reqs) < min_requests:
        errors.append(f"expected >= {min_requests} request records, "
                      f"got {len(reqs)}")
    for i, rec in enumerate(reqs):
        if rec.get("schema") != RUNLOG_SCHEMA_VERSION:
            errors.append(f"request {i}: schema {rec.get('schema')!r} != "
                          f"{RUNLOG_SCHEMA_VERSION}")
        missing = [k for k in LIFECYCLE_REQUIRED_KEYS if k not in rec]
        if missing:
            errors.append(f"request {i}: missing keys {missing}")
        if rec.get("outcome") not in ("done", "dropped"):
            errors.append(f"request {i}: bad outcome "
                          f"{rec.get('outcome')!r}")
    if not summaries:
        errors.append("no load_summary record")
    for rec in summaries:
        missing = [k for k in SUMMARY_REQUIRED_KEYS if k not in rec]
        if missing:
            errors.append(f"load_summary: missing keys {missing}")
    return errors


def validate_trace(path: str,
                   expect_spans: Optional[List[str]] = None) -> List[str]:
    errors: List[str] = []
    try:
        with open(path) as f:
            trace = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"trace unreadable: {e!r}"]
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["trace has no traceEvents list"]
    for i, ev in enumerate(events):
        if "ph" not in ev or "pid" not in ev:
            errors.append(f"event {i}: missing ph/pid")
            break
        if ev["ph"] != "M" and "ts" not in ev:
            errors.append(f"event {i} ({ev.get('name')}): missing ts")
            break
    names = {ev.get("name") for ev in events if ev.get("ph") == "X"}
    for want in expect_spans or []:
        if want not in names:
            errors.append(f"expected span {want!r} absent "
                          f"(have: {sorted(n for n in names if n)})")
    return errors


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs.validate")
    p.add_argument("--jsonl", default=None)
    p.add_argument("--trace", default=None)
    p.add_argument("--min-steps", type=int, default=1)
    p.add_argument("--expect-span", action="append", default=[],
                   help="span name that must appear in the trace "
                        "(repeatable)")
    p.add_argument("--loadgen", action="store_true",
                   help="validate load-harness lifecycle JSONL instead "
                        "of step records")
    p.add_argument("--min-requests", type=int, default=1)
    args = p.parse_args(argv)
    assert args.jsonl or args.trace, "nothing to validate"

    errors: List[str] = []
    if args.jsonl and args.loadgen:
        errors += [f"[loadgen] {e}"
                   for e in validate_loadgen_jsonl(args.jsonl,
                                                   args.min_requests)]
    elif args.jsonl:
        errors += [f"[jsonl] {e}"
                   for e in validate_jsonl(args.jsonl, args.min_steps)]
    if args.trace:
        errors += [f"[trace] {e}"
                   for e in validate_trace(args.trace, args.expect_span)]
    if errors:
        for e in errors:
            print(f"VALIDATION FAILED: {e}")
        return 1
    print("obs validation OK"
          + (f" — jsonl {args.jsonl}" if args.jsonl else "")
          + (f" — trace {args.trace}" if args.trace else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
