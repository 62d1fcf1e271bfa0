"""Every cell of ``BENCHMARK.json`` finds its files by name, and the file
keeps to the benchmark's contract."""

import json
import re

import pytest

from portbench import harness
from portbench.reference.bsp import Model

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL_NAMES = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (harness.ROOT / p).is_dir()
    assert (harness.ROOT / BENCH["command"][1]).is_file()


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_cell_files_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert cell == f"{entry['config']}.{entry['traffic']}"
    c = harness.load_cell(cell)
    assert c.config["name"] == entry["config"]
    assert c.chips == entry["chips"] == 1
    harness.driver(c.kind)
    model = Model.of(c.config)
    assert model.spec.name == entry["config"]
    assert model.family.param_leaves(model.spec)
    assert c.limits and set(c.limits) <= {"loss_gap", "grad_gap",
                                          "change_gap"}
    for section in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(cell, section, BENCH):
            if section == "per_layer":
                harness.reader(m["name"])
    names = {m["name"] for m in harness.metrics_of(cell, "end_to_end", BENCH)}
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_of(cell, "per_layer", BENCH)


def test_names_units_and_bounds():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELL_NAMES)
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert {w["config"] for w in BENCH["workloads"]} == \
        {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    path = harness.ROOT / entry["file"]
    cfg = json.loads(path.read_text())
    assert cfg["source"].startswith(entry["source"])
    assert cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert cfg["published"][key] != cfg[key]
