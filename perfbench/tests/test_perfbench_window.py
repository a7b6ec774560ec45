"""The window and the traced steps after it, driven on the CPU at a small
size: the window's steps set the rate, a traced run traces one more step
on each of the pool's batches, and the result line carries each cell's
metrics."""
import pytest

from perfbench import harness
from perfbench.kinds import train as K
from perfbench.tests import tiny

SPEC = harness.spec()


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_window_and_traced_steps(wl, traced, monkeypatch):
    tr = tiny.traffic(wl["traffic"])
    run = tiny.run(tiny.model("dense", "float32"), tr, 2 ** 31 + 31,
                   seconds=0.5, trace=traced,
                   limits=harness.limits_file(wl["name"]))
    K.execute(run)
    assert run.correct, run.compared
    ends = [s["end_s"] for s in run.steps]
    assert ends == sorted(ends) and ends[-1] >= 0.5
    assert run.window_s == ends[-1]
    slots = [s["slot"] for s in run.steps + run.traced_steps]
    assert slots == [(K.CHECKED_STEPS + i) % tr["pool"]
                     for i in range(len(slots))]
    if traced:
        assert len(run.traced_steps) == tr["pool"]
        assert run.trace.window_s == run.traced_steps[-1]["end_s"]
    else:
        assert run.traced_steps == [] and run.trace is None
    import torch
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "cpu")
    run.cell = wl["name"]
    run.peak_bytes = 1  # the CPU has no device peak
    out = harness.result(SPEC, run, 1)
    assert out["attempted"] == len(run.steps) + len(run.traced_steps)
    got = set(out["metrics"])
    if not traced:
        assert got == {"train_tokens_per_s", "setup_s"}
    else:
        # no device events on the CPU: the trace's readers find nothing
        want = {"train_mfu", "peak_mem_gb"}
        if tr["algo"] == "recompute":
            want.add("prox_ms")
        assert got == want
        assert 0 < out["metrics"]["train_mfu"]["value"] < 100
