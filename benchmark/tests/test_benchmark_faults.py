"""The check fails a run whose timed path is broken underneath: the tiny
CPU cell driven through the whole run (set-up, window, check) with one
fault planted in the port at a time, and ``correct`` must come out false.
The look for a chip is the command line's; run_cell is driven on the CPU.
The cells run on one chip, so no exchange between chips can be left out.

The faults are control.FAULTS, which ``benchmark/control.py --fault``
plants on the card at a cell's own size; the controls run on the card:
in the test marked ``chip`` at the end, and through ``control.py``
(readings in PERF.md)."""

import os
import time

import pytest
import torch

from benchmark import control, harness

DATA = os.path.join(os.path.dirname(__file__), "data")
TINY_SPEC = harness.load_json(os.path.join(DATA, "BENCHMARK.json"))
SEED = 2 ** 31 + 23


def run_tiny(seconds=6.0):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return harness.run_cell("tiny_desk_occluded", SEED, seconds, 0, "cpu",
                            time.perf_counter(), spec=TINY_SPEC,
                            workload_dir=DATA)


def test_clean_run_is_correct():
    line = run_tiny()
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered", "nonmax_skipped"])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    control.FAULTS[fault](monkeypatch.setattr)
    try:
        line = run_tiny()
    except RuntimeError as e:      # a run that cannot finish is no pass
        pytest.skip(f"the faulty run did not finish: {e}")
    assert not line["correct"], line["checks"]


def test_bundle_adjustment_fault(monkeypatch):
    control.FAULTS["ba_unchanged"](monkeypatch.setattr)
    line = run_tiny()
    print(line["checks"])
    assert not line["correct"], line["checks"]


def test_planted_fault_is_taken_out_again():
    from visualslam_android_tpu_torch.ops import fast

    before = fast.nonmax_levels
    with control.planted("nonmax_skipped"):
        assert fast.nonmax_levels is not before
    assert fast.nonmax_levels is before


@pytest.mark.chip
def test_controls_are_incorrect_on_the_card():
    """The controls the limits are set from, at desk_orbit's own size on
    the card (a shorter window): the program comes out correct, its state
    held in bfloat16 and the FAST segment test in bfloat16 do not."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    run = harness.drive("desk_orbit", 2 ** 31 + 101, 20.0, 0, "cuda:0",
                        time.perf_counter())
    line = harness.result_line(run)
    assert line["correct"], line["checks"]
    for name in control.CONTROLS:
        numbers, correct, _ = harness.judge_outputs(
            control.controlled(run.out, name,
                               run.cfg.tracker.fast_thresholds),
            run.feed, run.first, run.config, run.workload)
        assert not correct, (name, numbers)
