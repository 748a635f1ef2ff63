"""BENCHMARK.json against the benchmark's contract, and every
configuration, workload and metric file found by the name it gives."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    """A check with the full 24 cells fits its 43,200 s."""
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_are_unique_and_well_formed():
    for names in (CELLS, CONFIGS, METRICS):
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("benchmark/")
    cfg = harness.load_json(os.path.join(ROOT, entry["file"]))
    assert cfg["name"] == name
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    assert 1 <= len(entry["source"]) <= 200 and 1 <= len(entry["why"]) <= 200
    # Every field of SLAMConfig as it is run.
    harness.slam_config(cfg)
    assert any(c["config"] == name for c in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_and_workload_file(name):
    cell, config, workload = harness.find_cell(SPEC, name)
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert workload["name"] == cell["traffic"]
    assert workload["why"] == cell["why"]
    assert workload["touches"] and workload["setup_frames"] > max(
        workload["touches"])
    for number, limit in workload["limits"].items():
        assert number in harness.check.__doc__
        assert limit >= 0


@pytest.mark.parametrize("name", METRICS)
def test_metric_entry(name):
    m = next(x for x in SPEC["end_to_end"] + SPEC["per_layer"]
             if x["name"] == name)
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
        assert 1 <= len(m["layer"]) <= 200
        # The reader is found by name.
        assert callable(harness.metric_reader(name))
        for cell in m.get("workloads", []):
            assert cell in CELLS
    if name.endswith("_roofline"):
        assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in harness.cell_metrics(SPEC, cell,
                                                       "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = harness.cell_metrics(SPEC, cell, "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in e2e


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())

