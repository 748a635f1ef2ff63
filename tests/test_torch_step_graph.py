"""The tracking step's cache (models/step_graph.py) in the facade, on the
CPU, where it runs the step eagerly into reused buffers with the card's
copy-if-changed inputs and double-buffered state.

The sequence is test_slam.py's (tests/test_torch_slam.py's `_port_path`:
320x240, the sideways path over the planar scene, touches at frames 0 and
6, seed 3), rendered by the port; the relocalization cases run its first
N_FRAMES frames with the lens covered on frames BLANKS.

- Every result and the final state of a facade with the cache equal those
  of a facade whose step is the plain function (monkeypatched), bit for
  bit, in sync mode and pipelined at depths 1 and 3.
- A keyframe held in the queue across later tracked frames goes into the
  map as the frame it was: its pyramid, corner masks and pose.
- A relocalized frame runs the variant (False, True), the next frame
  (True, True), then (True, False); step_graph_counts counts each step.
- An input is copied into its buffer only where it is not that buffer:
  all of them on the first step, no state tensor when the facade hands
  back the state the step returned, the new measurement flags after a
  task replaces them, and the step reads what was copied.
- The step never writes a tensor it was handed that is not one of its
  buffers.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_slam import (
    BLANKS,
    N_FRAMES,
    _clone_tracking_state,
    _config,
    _first_track,
    _port_path,
    _run_port,
)
from visualslam_android_tpu_torch import config as tconfig
from visualslam_android_tpu_torch import native_runtime
from visualslam_android_tpu_torch.models import frame_step as fstep
from visualslam_android_tpu_torch.models import keyframe as kf_mod
from visualslam_android_tpu_torch.models import slam as tslam
from visualslam_android_tpu_torch.models import step_graph
from visualslam_android_tpu_torch.utils.tensors import tree_leaves

torch.set_num_threads(2)

PREFIX = 14
FIELDS = ("frame_id", "phase", "quality", "n_found", "n_points",
          "n_keyframes", "lost", "did_coarse", "added_keyframe", "message",
          "valid")
MODES = {"sync": {}, "depth_1": dict(pipelined=True, pipeline_depth=1),
         "depth_3": dict(pipelined=True, pipeline_depth=3)}
STATE = ("R", "t", "velocity", "_msd", "_depth", "_wiggle_dev", "new_points",
         "never_retry", "failure_mask")


def _without_graphs(step):
    def plain(*args, graphs=None, **kwargs):
        return step(*args, **kwargs)
    return plain


def _run(images, plain=False, **facade):
    """_run_port over `images`; with `plain`, the facade's step is the
    plain frame_step."""
    saved = fstep.frame_step
    if plain:
        fstep.frame_step = _without_graphs(saved)
    try:
        return _run_port(_config(tconfig), images, **facade)
    finally:
        fstep.frame_step = saved


def _same_results(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert [getattr(ra, f) for f in FIELDS] == [getattr(rb, f)
                                                   for f in FIELDS]
        np.testing.assert_array_equal(ra.pose_R, rb.pose_R)
        np.testing.assert_array_equal(ra.pose_t, rb.pose_t)


def _same_state(a, b):
    for x, y in zip(tree_leaves(a.slam_map), tree_leaves(b.slam_map)):
        assert torch.equal(x, y)
    for name in STATE:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(tree_leaves(a.sbi_last), tree_leaves(b.sbi_last)):
        assert torch.equal(x, y)
    assert a.host_reads == b.host_reads
    assert (a.lost_frames, a.last_kf_frame, a._kf_count_host,
            len(a.kf_queue)) == (b.lost_frames, b.last_kf_frame,
                                 b._kf_count_host, len(b.kf_queue))


@pytest.fixture(scope="module")
def path():
    return _port_path(PREFIX)[0]


@pytest.fixture(scope="module")
def long_path():
    return _port_path(N_FRAMES)[0]


@pytest.fixture(scope="module")
def reloc_path():
    return _port_path(N_FRAMES, blanks=tuple(BLANKS))[0]


@pytest.fixture(scope="module")
def sync_run(path):
    return _run(path)


# ---- (a) against the plain step ------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_results_and_state_equal_the_plain_step(path, sync_run, mode):
    """Every result, placeholders included, and the final map and state
    bit for bit; the cache ran every step, eagerly."""
    cached = sync_run if mode == "sync" else _run(path, **MODES[mode])
    plain = _run(path, plain=True, **MODES[mode])
    _same_results(cached[1], plain[1])
    _same_state(cached[0], plain[0])
    n_steps = len(cached[2])  # one mapping task after each step
    assert _first_track(cached[1]) < PREFIX - 3
    assert cached[0].step_graph_counts == {"captures": 0, "replays": 0,
                                           "eager": n_steps}
    assert plain[0].step_graph_counts == {"captures": 0, "replays": 0,
                                          "eager": 0}


# ---- (b) a keyframe held in the queue ------------------------------------


def test_held_keyframe_enters_the_map_as_its_frame(long_path):
    """The first keyframe after the bootstrap waits in the queue while the
    next HOLD tracked frames run their steps (which overwrite the step's
    outputs); it then goes into the map with its own frame's pyramid and
    corner masks and its own pose."""
    HOLD = 2
    sys_ = tslam.SLAMSystem(_config(tconfig), seed=3, device="cpu")
    select = sys_._select_task
    held = []

    def holding():
        if sys_.kf_queue and "slot" not in sys_.kf_queue[0] and (
                len(held) < HOLD):
            held.append(sys_.frame_idx - 1)
            return native_runtime.TASK_NONE
        return select()

    sys_._select_task = holding
    path = long_path
    results = []
    for k, img in enumerate(path):
        if k in (0, 6):
            sys_.on_touch()
        results.append(sys_.track_frame(img))
    added = [r.frame_id for r in results if r.added_keyframe]
    assert added and len(held) == HOLD
    fid = added[0]
    assert held == [fid + 1, fid + 2]
    kfs = sys_.slam_map.keyframes
    assert int(kfs.count()) >= 3
    slot = 2
    want = kf_mod.make_frame(path[fid], sys_.config)
    for lvl in range(len(want.pyramid)):
        assert torch.equal(kfs.pyramid[lvl][slot], want.pyramid[lvl])
        assert torch.equal(kfs.corner_mask[lvl][slot], want.corner_mask[lvl])
    assert not torch.equal(kfs.pyramid[0][slot], path[fid + HOLD])
    np.testing.assert_array_equal(kfs.R[slot].numpy(), results[fid].pose_R)
    np.testing.assert_array_equal(kfs.t[slot].numpy(), results[fid].pose_t)


# ---- (c, d) variants and counts across a relocalization ------------------


def test_relocalization_variants_and_counts(reloc_path, monkeypatch):
    """The blank frames go BAD, the facade loses tracking, relocalizes and
    tracks on: each step's variant is (False, True) on a relocalized frame,
    (True, True) on the frame after one, else (True, False); the last
    relocalization, on a real frame, is followed by (True, True) then
    (True, False). The results equal the plain step's, and
    step_graph_counts counts one eager step per step run (none on a frame
    whose relocalization failed)."""
    calls = []
    step = step_graph.StepGraphs.step

    def recorded(self, body, *args, use_prior=True, forced_coarse=False,
                 **kwargs):
        calls.append((use_prior, forced_coarse))
        return step(self, body, *args, use_prior=use_prior,
                    forced_coarse=forced_coarse, **kwargs)

    monkeypatch.setattr(step_graph.StepGraphs, "step", recorded)
    sys_, results, _ = _run(reloc_path)
    monkeypatch.undo()
    _, plain, _ = _run(reloc_path, plain=True)
    _same_results(results, plain)
    reloc = [r.message.startswith("Relocalized") for r in results]
    assert any(reloc[BLANKS[-1] + 1:]), "never relocalized on a real frame"
    first = _first_track(results)
    want = [(False, True) if reloc[k] else (True, True) if reloc[k - 1]
            else (True, False)
            for k in range(first + 1, len(results))
            if not results[k].message.startswith("Lost")]
    assert calls == want
    k = len(want) - 1 - want[::-1].index((False, True))
    assert calls[k:k + 3] == [(False, True), (True, True), (True, False)]
    assert sys_.step_graph_counts == {"captures": 0, "replays": 0,
                                      "eager": len(calls)}


# ---- (e) copy-if-changed -------------------------------------------------


def test_copies_only_the_inputs_that_changed(sync_run, path, monkeypatch):
    """On a copy of a tracking facade whose mapping tasks do nothing, the
    same image three times: the first step copies every input into its
    buffer but the keyframe store (adopted as it is); the second no state
    tensor (the facade hands back the set the step reads) and not the
    draws (made in their buffers), only the inputs that are not state (the
    image, camera, wiggle, failure mask, pending pair); after the measurement
    flags are replaced (as a mapping task replaces the table) the third
    copies those and the new flags. Each step equals the plain step on
    copies of its inputs. A copy is read from its buffer's version
    counter."""
    sys_ = _clone_tracking_state(sync_run[0])
    sys_._mapmaker_step = lambda: native_runtime.TASK_NONE
    graphs = sys_._step_graphs
    load = graphs._load
    copies = []

    def counted(inputs):
        bufs = graphs._flat[graphs._next] if graphs._flat else None
        before = [b._version for b in bufs] if bufs else None
        load(inputs)
        labels = step_graph._input_labels(inputs)
        bufs = graphs._flat[graphs._next]
        copies.append([label for k, (label, b) in enumerate(zip(labels, bufs))
                       if b._version != (before[k] if before else 0)])

    monkeypatch.setattr(graphs, "_load", counted)
    step = fstep.frame_step
    same = []

    def checked(*args, graphs=None, generator=None, **kwargs):
        again = torch.Generator().manual_seed(0)
        again.set_state(generator.get_state())
        want = step(*(a.clone() if hasattr(a, "clone") else a
                      for a in args), generator=again, **kwargs)
        out = step(*args, graphs=graphs, generator=generator, **kwargs)
        same.append(all(torch.equal(x, y) for x, y in zip(
            tree_leaves(out), tree_leaves(want))))
        return out

    monkeypatch.setattr(fstep, "frame_step", checked)
    img = path[-1]
    sys_.track_frame(img)
    sys_.track_frame(img)
    meas = sys_.slam_map.meas
    keep = (torch.arange(meas.valid.shape[0]) % 2 == 0)[:, None]
    n_meas = (int(meas.count()), int((meas.valid & keep).sum()))
    sys_.slam_map = sys_.slam_map.replace(
        meas=meas.replace(valid=meas.valid & keep))
    sys_.track_frame(img)
    labels = step_graph._input_labels(dict(zip(step_graph.INPUTS, (
        img, sys_.slam_map, sys_.cam, sys_.R, sys_.t, sys_.velocity,
        sys_._msd, sys_._depth, sys_._wiggle_dev, sys_.sbi_last,
        sys_.new_points, sys_.failure_mask, torch.zeros(2),
        (torch.zeros(1), torch.zeros(1))))))
    not_state = {"img", "cam", "wiggle_depth_norm", "failure_mask",
                 "pending"}
    first, second, third = copies
    assert first == [label for label in labels
                     if not label.startswith("slam_map.keyframes.")]
    assert second == [label for label in labels
                      if label.split(".")[0].split("[")[0] in not_state]
    assert third == [label for label in labels
                     if label in second or label == "slam_map.meas.valid"]
    assert "slam_map.meas.valid" in first and len(second) < len(first)
    assert same == [True] * 3
    assert n_meas[0] > n_meas[1] > 0


# ---- (f) the step's inputs stay as handed in ------------------------------


def test_step_writes_no_tensor_it_was_handed(sync_run, path):
    """frame_step through a StepGraphs leaves every tensor it was handed as
    it was, and the same inputs twice give the same outputs (the second
    reads the other state set)."""
    src = sync_run[0]
    cfg = src.config
    inputs = (path[-1], src.slam_map.clone(), src.cam, src.R.clone(),
              src.t.clone(), src.velocity.clone(), src._msd.clone(),
              src._depth.clone(), src._wiggle_dev.clone(),
              src.sbi_last.clone(), src.new_points.clone(),
              src.failure_mask.clone(), torch.zeros(2))
    before = [x.clone() for x in tree_leaves(inputs)]
    graphs = step_graph.StepGraphs()
    draws = tuple(torch.rand(cfg.tracker.max_map_points,
                             generator=torch.Generator().manual_seed(4))
                  for _ in range(2))
    outs = []
    for _ in range(2):
        out = fstep.frame_step(*inputs, cfg, uniforms=draws, graphs=graphs)
        outs.append([x.clone() for x in tree_leaves(out)])
        for x, y in zip(tree_leaves(inputs), before):
            assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    assert graphs.counts == {"captures": 0, "replays": 0, "eager": 2}
