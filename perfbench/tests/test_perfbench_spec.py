"""BENCHMARK.json against the contract's characters and limits, and each
entry's files."""
import re

import pytest

from perfbench import harness

SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _names():
    out = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [(group, e["name"]) for e in SPEC[group]]
    out += [("config", w["config"]) for w in SPEC["workloads"]]
    out += [("traffic", w["traffic"]) for w in SPEC["workloads"]]
    out += [("reduced", k) for c in SPEC["configs"] for k in c["reduced"]]
    return out


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in SPEC["command"])


@pytest.mark.parametrize("group,name", _names())
def test_name_characters(group, name):
    assert NAME.match(name), (group, name)


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moves = [e for e in SPEC["end_to_end"] if e["name"] == m["moves"]]
        assert moves
        # every cell the metric lists reports the metric it moves
        assert set(m["workloads"]) <= set(moves[0].get("workloads", cells))
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    if m["unit"] == "%" and "roofline" in m["name"]:
        assert m["source"] == "device_trace"


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files(wl):
    assert wl["chips"] in (1, 4)
    assert 1 <= len(wl["why"]) <= 200
    tr = harness.traffic_file(wl["traffic"])
    assert (harness.HERE / "kinds" / f"{tr['kind']}.py").exists()
    assert harness.limits_file(wl["name"]), "no limits for the cell"
    assert harness.config_file(SPEC, wl["config"])["model"]
    for group in ("end_to_end", "per_layer"):
        reports = [m for m in SPEC[group]
                   if wl["name"] in m.get("workloads", [wl["name"]])]
        assert len(reports) >= (2 if group == "end_to_end" else 1)


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_is_the_ports(c):
    from perfbench.kinds.train import port_config
    assert c["file"].startswith("perfbench/")
    f = harness.config_file(SPEC, c["name"])
    assert f["model"]["name"] == c["name"]
    cfg = port_config(f["model"])  # raises where the two differ
    assert cfg.name == c["name"]
    assert len(c["reduced"]) <= 16
