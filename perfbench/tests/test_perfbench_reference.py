"""The plain reference against the port's ``Trainer.step`` on the CPU, at
the port's ``-reduced`` configurations in float32 (where the two differ
only in the order of float32 sums), through the harness's own set-up,
checked steps and comparison."""
import dataclasses

import pytest

from perfbench.calibrate import reading
from perfbench.tests import tiny

TOL = 1e-3


def reduced(name: str, arch: str) -> dict:
    from repro_torch.configs.registry import get_config
    cfg = get_config(f"{name}-reduced")
    m = {k: v for k, v in dataclasses.asdict(cfg).items()
         if v is not None and k not in ("moe", "mla", "frontend")}
    m.update(arch=arch, dtype="float32",
             weight_scale=tiny.MODELS[arch]["weight_scale"])
    return m


@pytest.mark.parametrize("name,arch,traffic", [
    ("qwen2.5-1.5b", "dense", "train.a3po"),
    ("qwen2.5-1.5b", "dense", "train.recompute"),
])
def test_reference_matches_trainer_step(name, arch, traffic):
    m = reduced(name, arch)
    tr = tiny.traffic(traffic)
    r = reading(tiny.run(m, tr, 2 ** 31 + 3), "sound")
    assert max(r["numbers"].values()) < TOL, r["numbers"]
    # the steps did something: a loss, a gradient, an entropy
    for s in r["program_steps"]:
        assert s["grad_norm"] > 0 and s["entropy"] > 0

