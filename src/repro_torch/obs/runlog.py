"""Schema-versioned JSONL run log + uniform status output (a copy of
``repro.obs.runlog``: the same schema, so either package's tools read
either package's runs).

One ``kind="step"`` record per training step (the machine-readable twin
of the human stdout line), plus free-form ``kind="meta"`` / ``kind=...``
records for run headers and launcher events. The schema version rides in
every record so downstream consumers (``repro.obs.report``, the CI
validator, future bench PRs) can fail loudly on drift instead of
mis-parsing.

``RunLogger`` is also the single chokepoint for launcher status lines:
``print()`` goes to stdout unless ``--quiet``, while ``log_*`` always
lands in the JSONL file (when one is configured). Default behavior with
no flags is byte-identical to the old bare ``print`` calls.
"""
from __future__ import annotations

import dataclasses
import io
import json
import sys
import time
from typing import Any, Dict, Optional

RUNLOG_SCHEMA_VERSION = 1

# Keys every kind="step" record must carry — the CI schema gate
# (repro.obs.validate) and the report CLI both key off these.
STEP_REQUIRED_KEYS = (
    "schema", "kind", "step", "reward", "loss", "staleness_mean",
    "rollout_time_s", "train_time_s", "wall_time_s",
)


def step_record_dict(rec) -> Dict[str, Any]:
    """Flatten a ``StepRecord`` (or any dataclass/dict) into a JSON-ready
    step record, ``serving.*`` kept as a nested dict."""
    if dataclasses.is_dataclass(rec) and not isinstance(rec, type):
        d = dataclasses.asdict(rec)
    else:
        d = dict(rec)
    out: Dict[str, Any] = {"schema": RUNLOG_SCHEMA_VERSION, "kind": "step"}
    for k, v in d.items():
        if v is None:
            continue
        if isinstance(v, dict):
            out[k] = {kk: _scalar(vv) for kk, vv in v.items()}
        else:
            out[k] = _scalar(v)
    return out


def _scalar(v):
    if isinstance(v, (bool, int, str)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class RunLogger:
    """Uniform run output: human stdout lines + optional JSONL sink.

    * ``print(msg)`` — human-facing status (suppressed by ``quiet``).
    * ``log_step(record)`` — one schema-versioned JSONL line per step.
    * ``log_event(kind, **fields)`` — run headers, checkpoints, etc.
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 quiet: bool = False,
                 stream: Optional[io.TextIOBase] = None):
        self.quiet = quiet
        self.jsonl_path = jsonl_path
        self.stream = stream if stream is not None else sys.stdout
        self._f = open(jsonl_path, "w") if jsonl_path else None
        self.steps_logged = 0
        self._t_open = time.time()

    # ------------------------------------------------------------- stdout
    def print(self, msg: str = "") -> None:
        if not self.quiet:
            print(msg, file=self.stream, flush=True)

    # -------------------------------------------------------------- jsonl
    def _write(self, record: Dict[str, Any]) -> Dict[str, Any]:
        if self._f is not None:
            json.dump(record, self._f)
            self._f.write("\n")
            self._f.flush()
        return record

    def log_step(self, rec) -> Dict[str, Any]:
        """Write one step record (a ``StepRecord``, dataclass, or dict)."""
        record = step_record_dict(rec)
        missing = [k for k in STEP_REQUIRED_KEYS if k not in record]
        assert not missing, f"step record missing required keys: {missing}"
        self.steps_logged += 1
        return self._write(record)

    def log_event(self, kind: str, **fields) -> Dict[str, Any]:
        record = {"schema": RUNLOG_SCHEMA_VERSION, "kind": kind,
                  "time_unix_s": time.time()}
        record.update({k: _scalar(v) if not isinstance(v, (dict, list))
                       else v for k, v in fields.items()})
        return self._write(record)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_jsonl(path: str, kind: Optional[str] = "step") -> list:
    """Load records from a run log (``kind=None`` keeps every record)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if kind is None or rec.get("kind") == kind:
                out.append(rec)
    return out
