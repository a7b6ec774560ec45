"""Run-report CLI: summarize a run's JSONL log (+ optional trace.json); a
copy of ``repro_torch.obs.report``, which imports no framework.

    python -m repro_torch.obs.report --jsonl run.jsonl [--trace trace.json] \
        [--json report.json]

Renders (text, optionally machine-readable JSON):

* step/reward/loss summary and wall-clock totals
* per-phase time breakdown (rollout / prefill / decode / train / publish)
  from the trace's canonical spans
* the staleness distribution (from the last step's ``serving.*`` snapshot
  when the control plane ran, else per-step ``staleness_mean``)
* training + decode tokens/sec
* the weight-publish timeline (span start times from the trace, in
  seconds since the tracer was installed)

This is the artifact future bench PRs commit alongside raw JSON.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

from repro_torch.obs.runlog import read_jsonl
from repro_torch.obs.tracing import phase_breakdown


def _fmt_s(s: float) -> str:
    return f"{s * 1e3:.1f}ms" if s < 1.0 else f"{s:.2f}s"


def summarize(steps: List[Dict[str, Any]],
              trace: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Aggregate step records (+ trace events) into a report dict."""
    out: Dict[str, Any] = {"num_steps": len(steps)}
    if not steps:
        return out
    last = steps[-1]
    out["schema"] = last.get("schema")
    out["wall_time_s"] = last.get("wall_time_s", 0.0)
    out["final_reward"] = last.get("reward")
    out["final_loss"] = last.get("loss")
    n = len(steps)
    out["mean_reward"] = sum(s.get("reward", 0.0) for s in steps) / n
    out["mean_staleness"] = (
        sum(s.get("staleness_mean", 0.0) for s in steps) / n)
    train_t = sum(s.get("train_time_s", 0.0) for s in steps)
    rollout_t = sum(s.get("rollout_time_s", 0.0) for s in steps)
    prox_t = sum(s.get("prox_time_s", 0.0) for s in steps)
    out["train_time_s"] = train_t
    out["rollout_time_s"] = rollout_t
    out["prox_time_s"] = prox_t
    tokens = sum(s.get("train_tokens", 0.0) for s in steps)
    out["train_tokens"] = tokens
    out["train_tokens_per_s"] = tokens / train_t if train_t > 0 else 0.0
    out["host_syncs_per_step"] = (
        sum(s.get("host_syncs", 0.0) for s in steps) / n)

    # resilience counters are cumulative — the last step's snapshot is the
    # run total (faults injected, worker restarts, skipped updates, ...)
    res = last.get("resilience")
    if res:
        out["resilience"] = dict(res)

    serving = last.get("serving")
    if serving:
        out["serving"] = {
            "staleness": {k.split("staleness_", 1)[1]: v
                          for k, v in serving.items()
                          if k.startswith("staleness_")},
            "ttft_s": {k.split("ttft_s_", 1)[1]: v
                       for k, v in serving.items()
                       if k.startswith("ttft_s_")},
            "decode_tokens_per_s": serving.get("decode_tokens_per_s"),
            "prefill_chunks": serving.get("prefill_chunks"),
            "prefix_hit_rate": serving.get("prefix_hit_rate"),
            "interrupts": serving.get("interrupts"),
            "resumed_sequences": serving.get("resumed_sequences"),
        }

    if trace is not None:
        events = trace.get("traceEvents", [])
        # seconds since the tracer's install: the export stamps the Unix
        # epoch and records the install time beside it
        t0_us = trace.get("metadata", {}).get("t0_us", 0.0)
        out["phases"] = phase_breakdown(events)
        out["publish_timeline_s"] = [
            round((ev["ts"] - t0_us) / 1e6, 6) for ev in events
            if ev.get("ph") == "X" and ev.get("name") == "weight_publish"]
        out["trace_events"] = len(events)
    return out


def render_load(summary: Dict[str, Any]) -> str:
    """Per-class SLO table for a ``kind="load_summary"`` record (the
    loadgen harness's run summary)."""
    lines: List[str] = []
    lines.append(
        f"load harness — policy {summary.get('policy', '?')}: "
        f"{summary.get('requests', 0)} requests over "
        f"{summary.get('virtual_time_s', 0.0):.2f}s virtual "
        f"({summary.get('completed', 0)} done, "
        f"{summary.get('dropped', 0)} dropped, "
        f"{summary.get('publishes', 0)} publishes)")
    classes = summary.get("classes") or {}
    slo = summary.get("slo") or {}
    if classes:
        lines.append(
            f"  {'class':<12s} {'subm':>5s} {'done':>5s} {'shed':>5s} "
            f"{'ttft_p50':>9s} {'ttft_p99':>9s} {'e2e_p99':>9s} "
            f"{'slo%':>6s} {'goodput':>10s}")
        for name, row in classes.items():
            tgt = slo.get(name, {})
            lines.append(
                f"  {name:<12s} {row.get('submitted', 0):>5.0f} "
                f"{row.get('completed', 0):>5.0f} "
                f"{row.get('shed', 0):>5.0f} "
                f"{_fmt_s(row.get('ttft_p50_s') or 0.0):>9s} "
                f"{_fmt_s(row.get('ttft_p99_s') or 0.0):>9s} "
                f"{_fmt_s(row.get('e2e_p99_s') or 0.0):>9s} "
                f"{100 * (row.get('slo_attainment') or 0.0):>5.1f}% "
                f"{row.get('goodput_tok_s') or 0.0:>6.1f} tok/s"
                + (f"  (ttft slo {_fmt_s(tgt['ttft_slo_s'])})"
                   if "ttft_slo_s" in tgt else ""))
    srv = summary.get("serving") or {}
    if srv:
        lines.append(
            "  drops: "
            f"staleness {srv.get('drops_staleness_budget', 0):.0f}  "
            f"max_preempts {srv.get('drops_max_preempts', 0):.0f}  "
            f"slo_shed {srv.get('drops_slo_shed', 0):.0f}   "
            "preempts: "
            f"staleness {srv.get('preemptions_staleness', 0):.0f}  "
            f"slo {srv.get('preemptions_slo', 0):.0f}")
    return "\n".join(lines)


def render(report: Dict[str, Any]) -> str:
    """Human-readable report text."""
    lines: List[str] = []
    n = report.get("num_steps", 0)
    lines.append(f"run report — {n} steps, schema "
                 f"{report.get('schema', '?')}")
    if not n:
        return "\n".join(lines)
    lines.append(
        f"  wall {_fmt_s(report['wall_time_s'])}  "
        f"reward {report['mean_reward']:.3f} (final "
        f"{report['final_reward']:.3f})  loss {report['final_loss']:+.4f}")
    lines.append(
        f"  train {_fmt_s(report['train_time_s'])} "
        f"({report['train_tokens_per_s']:.0f} tok/s, "
        f"{report['host_syncs_per_step']:.1f} syncs/step)  "
        f"rollout {_fmt_s(report['rollout_time_s'])}  "
        f"prox {_fmt_s(report['prox_time_s'])}")
    lines.append(f"  staleness mean {report['mean_staleness']:.2f}")
    srv = report.get("serving")
    if srv:
        st = srv.get("staleness", {})
        if st:
            lines.append(
                "  staleness dist (serving): "
                + "  ".join(f"{k}={st[k]:.2f}" for k in
                            ("mean", "p50", "p99", "max") if k in st)
                + f"  n={st.get('count', 0):.0f}")
        tt = srv.get("ttft_s", {})
        if tt.get("count"):
            lines.append(
                "  ttft: "
                + "  ".join(f"{k}={_fmt_s(tt[k])}" for k in
                            ("mean", "p50", "p99", "max") if k in tt)
                + f"  n={tt['count']:.0f}")
        lines.append(
            f"  decode {srv.get('decode_tokens_per_s') or 0.0:.0f} tok/s  "
            f"prefix-hit {(srv.get('prefix_hit_rate') or 0.0) * 100:.0f}%  "
            f"prefill-chunks {srv.get('prefill_chunks') or 0:.0f}  "
            f"interrupts {srv.get('interrupts') or 0:.0f} "
            f"(resumed {srv.get('resumed_sequences') or 0:.0f} seqs)")
    res = report.get("resilience")
    if res:
        def _r(name: str) -> float:
            # labeled counters (resilience_faults_injected_total{kind=..})
            # fold into their base name for the one-line summary
            return sum(v for k, v in res.items()
                       if k == name or k.startswith(name + "{"))
        lines.append("  resilience:")
        lines.append(
            f"    faults injected "
            f"{_r('resilience_faults_injected_total'):.0f}  "
            f"worker crashes {_r('resilience_worker_crashes_total'):.0f} "
            f"(restarts {_r('resilience_worker_restarts_total'):.0f}, "
            f"permanent {_r('resilience_worker_failures_total'):.0f})")
        lines.append(
            f"    skipped updates "
            f"{_r('resilience_skipped_updates_total'):.0f}  "
            f"rollbacks {_r('resilience_rollbacks_total'):.0f}  "
            f"publish retries "
            f"{_r('resilience_publish_retries_total'):.0f}  "
            f"checkpoints {_r('resilience_checkpoint_saves_total'):.0f} "
            f"(restores {_r('resilience_checkpoint_restores_total'):.0f})")
    phases = report.get("phases")
    if phases:
        lines.append("  phase breakdown (trace):")
        total = sum(p["total_s"] for p in phases.values()) or 1.0
        for name in ("rollout", "prefill", "decode", "train", "publish"):
            p = phases.get(name)
            if p is None:
                continue
            lines.append(
                f"    {name:8s} {_fmt_s(p['total_s']):>9s}  "
                f"{100 * p['total_s'] / total:5.1f}%  "
                f"x{p['count']:.0f} (mean {p['mean_ms']:.2f}ms)")
    pubs = report.get("publish_timeline_s")
    if pubs:
        head = ", ".join(f"{t:.3f}" for t in pubs[:8])
        more = f" … +{len(pubs) - 8}" if len(pubs) > 8 else ""
        lines.append(f"  publishes at t(s): {head}{more}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a run's JSONL log (+ optional trace.json)")
    p.add_argument("--jsonl", required=True, help="run log (JSONL)")
    p.add_argument("--trace", default=None, help="Chrome trace.json")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the report as JSON to this path")
    args = p.parse_args(argv)

    records = read_jsonl(args.jsonl, kind=None)
    steps = [r for r in records if r.get("kind") == "step"]
    loads = [r for r in records if r.get("kind") == "load_summary"]
    trace = None
    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
    report = summarize(steps, trace)
    if steps or not loads:
        print(render(report))
    if loads:
        # loadgen runs: the per-class SLO table (latest summary wins)
        print(render_load(loads[-1]))
        report["load"] = loads[-1]
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report JSON -> {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
