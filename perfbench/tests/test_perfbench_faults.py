"""A run with its timed path broken underneath has to come out not
correct, under each cell's own limits: the harness's set-up, window and
comparison driven on the CPU at a small size (the look for a card
skipped), with a step that returns its state unchanged, with half of the
batch left out, and with the control (the reference in float8 in the
program's place). The same run without a fault comes out correct."""
import pytest

from perfbench import check, harness
from perfbench.calibrate import reading
from perfbench.kinds import train as K
from perfbench.tests import tiny

SPEC = harness.spec()
CELLS = SPEC["workloads"]


def _case(wl, dtype="bfloat16"):
    arch = harness.config_file(SPEC, wl["config"])["model"]["arch"]
    return (tiny.model(arch, dtype), tiny.traffic(wl["traffic"]),
            harness.limits_file(wl["name"]))


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("wl", CELLS, ids=lambda w: w["name"])
def test_fault_is_not_correct(wl, fault):
    m, tr, limits = _case(wl)
    run = tiny.run(m, tr, 2 ** 31 + 21, limits=limits)
    K.execute(run, fault=fault)
    assert not run.correct, run.compared


@pytest.mark.parametrize("wl", CELLS, ids=lambda w: w["name"])
def test_control_is_not_correct(wl):
    m, tr, limits = _case(wl)
    r = reading(tiny.run(m, tr, 2 ** 31 + 22), "control")
    ok, compared = check.judge(r["numbers"], limits)
    assert not ok, compared


@pytest.mark.parametrize("wl", CELLS, ids=lambda w: w["name"])
def test_sound_run_is_correct(wl):
    m, tr, limits = _case(wl, dtype="float32")
    run = tiny.run(m, tr, 2 ** 31 + 23, limits=limits)
    K.execute(run)
    assert run.correct, run.compared
    assert run.steps and all(s["finite"] for s in run.steps)


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    """On the card: the control at cell 1's own size."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl = CELLS[0]
    m = harness.config_file(SPEC, wl["config"])["model"]
    run = harness.Run(cell=wl["name"], model=m,
                      traffic=harness.traffic_file(wl["traffic"]),
                      limits={}, seed=2 ** 31 + 24, seconds=0,
                      trace_on=False, device=torch.device("cuda", 0),
                      t_start=0.0)
    r = reading(run, "control")
    ok, compared = check.judge(r["numbers"], harness.limits_file(wl["name"]))
    assert not ok, compared
