"""BENCHMARK.json's configurations and cells against the files the harness
reads: a cell's workload file names the configuration file it runs, and the
configuration BENCHMARK.json declares for the cell has to be that one as run."""

import json

import pytest

import cellspec
from conftest import BENCH

DECLARED = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: c for c in DECLARED["configs"]}


def as_run(conf, chips):
    """A configuration's groups as the harness runs them on `chips` cards
    (`harness._run` sets `exp.num_devices` from the cell's chips)."""
    tracker = cellspec.merge(conf["tracker"], {"exp": {"num_devices": chips}})
    return {"recipe": conf["recipe"], "tracker": tracker, "scene": conf["scene"]}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_declared_config_file_names_itself(name):
    entry = CONFIGS[name]
    conf = json.loads((BENCH.parent / entry["file"]).read_text())
    assert conf["name"] == name
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]


@pytest.mark.parametrize("cell", [w["name"] for w in DECLARED["workloads"]])
def test_declared_config_is_what_the_cell_runs(cell):
    entry = next(w for w in DECLARED["workloads"] if w["name"] == cell)
    spec = cellspec.cell(cell)
    assert spec["workload"]["traffic"] == entry["traffic"]
    assert spec["workload"]["chips"] == entry["chips"]
    declared = json.loads((BENCH.parent / CONFIGS[entry["config"]]["file"]).read_text())
    assert declared["tracker"]["exp"]["num_devices"] == entry["chips"]
    assert as_run(declared, entry["chips"]) == as_run(spec["config"], entry["chips"])
