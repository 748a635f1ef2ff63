"""The command line and the run on the CPU: the last line's shape from
canned numbers, no card and no fallback, nothing of JAX loaded, and a
whole run of the tiny CPU cell in both modes."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness

DATA = os.path.join(os.path.dirname(__file__), "data")
TINY_SPEC = harness.load_json(os.path.join(DATA, "BENCHMARK.json"))
CANNED = {
    "correct": True, "attempted": 400, "failed": 3,
    "metrics": {"frames_per_s": {"value": 8.5, "unit": "frames/s"},
                "frame_ms_p95": {"value": 201.25, "unit": "ms"},
                "setup_s": {"value": 21.5, "unit": "s"}},
    "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
               "count": 1, "memory_peak_bytes": 123},
    "numbers": {"tracked_pct": 99.0},
    "checks": {"ate_pct": {"value": 0.05, "limit": 0.5}},
}


def run_tiny(seed, seconds, trace, **kwargs):
    return harness.run_cell("tiny_desk_occluded", seed, seconds, trace, "cpu",
                            time.perf_counter(), spec=TINY_SPEC,
                            workload_dir=DATA, **kwargs)


def test_last_line_from_canned_numbers(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: dict(CANNED))
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    rc = harness.main(["--workload", "desk_orbit", "--seed", "2147483659",
                       "--seconds", "50", "--trace", "0"], 0.0)
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.strip().splitlines()
    assert tail[-2] == "check ate_pct: 0.05 limit 0.5"
    assert tail[-1] == "correct: True"


def test_failed_counts_wrong_answers_not_covered_frames():
    from types import SimpleNamespace as NS

    from visualslam_android_tpu_torch.models import slam as slam_mod

    def result(tracked):
        return NS(phase=slam_mod.PHASE_TRACKING, lost=not tracked,
                  quality=slam_mod.tracker_mod.QUALITY_GOOD)

    blank = [False, True, True, False, False, True, False]
    answers = {0: True, 1: False, 2: False, 3: True, 5: True, 6: False}
    feed = NS(n=len(blank), traffic=NS(blank=blank),
              results={f: result(a) for f, a in answers.items()})
    # Frame 4 has no result, frame 5 is covered and claims a pose, frame 6
    # is visible and lost; covered frames 1 and 2 reported lost are right.
    assert harness.failed_frames(feed, 0, slam_mod) == 3
    assert harness.failed_frames(feed, 5, slam_mod) == 2
    feed.results.update({4: result(True), 5: result(False),
                         6: result(True)})
    assert harness.failed_frames(feed, 0, slam_mod) == 0


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "desk_orbit", "--seed", "1",
                       "--seconds", "5", "--trace", "0"], 0.0)
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_forbidden_module_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: dict(CANNED))
    monkeypatch.setattr(harness, "forbidden_modules", lambda: ["jax"])
    rc = harness.main(["--workload", "desk_orbit", "--seed", "1",
                       "--seconds", "5", "--trace", "0"], 0.0)
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "jax" in err


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "visualslam_android_tpu_torch_x",
                        sys.modules["json"])
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["json"])
    assert harness.forbidden_modules() == ["jax"]


def test_measured_path_raises_without_a_card():
    """On a machine without CUDA the measured path raises; it never runs on
    the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises((RuntimeError, AssertionError)):
        harness.run_cell("desk_orbit", 1, 1.0, 0, "cuda:0",
                         time.perf_counter())


def test_imports_nothing_of_jax():
    """The harness, the reference, the readers and the command line load
    neither jax nor the JAX package (top-level names compared whole; the
    port, visualslam_android_tpu_torch, is allowed). In a fresh process:
    pytest's own plugins may have loaded jax into this one."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, traffic, devtrace, control\n"
        "from benchmark.reference import check, scene, fast, ate, roofline\n"
        "spec = harness.load_spec()\n"
        "[harness.metric_reader(m['name']) for m in spec['per_layer']]\n"
        "import visualslam_android_tpu_torch.models.slam\n"
        "print(harness.forbidden_modules())\n" % harness.ROOT)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_command_line_without_a_card():
    """python benchmark/run.py exits non-zero and prints no result here."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "desk_orbit",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture(scope="module")
def tiny_runs():
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return {trace: run_tiny(2 ** 31 + 11, 6.0, trace) for trace in (0, 1)}


def test_tiny_run_is_correct(tiny_runs):
    line = tiny_runs[0]
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0
    assert line["failed"] == 0
    assert line["numbers"]["covered_frames"] > 0
    assert set(line["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                    "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    assert list(line)[-1] == "checks"


def test_tiny_traced_run(tiny_runs):
    line = tiny_runs[1]
    assert line["correct"], line["checks"]
    names = set(line["metrics"])
    assert {"tracking.step_ms", "mapping.task_ms_p95",
            "facade.stats_wait_ms"} <= names
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
