"""The port's pipelined facade mode, SLAMSystem(pipelined=True,
pipeline_depth=d), on the CPU: against the port's sync mode, against the
JAX package's pipelined mode, and on the paths that must resolve the
frames in flight first.

The sequence is test_slam.py's (tests/test_torch_slam.py's `_port_path`:
320x240, 26 frames of the sideways path over the planar scene, touches at
frames 0 and 6, seed 3), rendered by the port. The delivery and
equality cases run its first PREFIX frames (the bootstrap at frame 6,
then tracked frames); the comparison with the JAX package runs all 26.

- Depth 1 against sync mode, matched by frame_id: every field and pose
  bit for bit, the same reads, the same map (test_slam.py:113-145's
  check of the JAX package).
- Depth 3 against the JAX package's depth 3: the same frame_id sequence,
  placeholders included, and the outcome within
  test_torch_slam.py::test_matches_jax_run_by_outcome's bounds (first
  tracked frame and tracked count equal, keyframes within 1, points within
  10%); the random draws differ between the packages.
- Delivery at depths 1-3: every frame id once and in order, placeholders
  only on the d calls after the bootstrap, the tail through flush().
- A corrupting bundle adjustment (test_slam.py:276-311's setup) at depths
  1 and 3: track_frame services the reset within d + 1 calls and no
  result carries a non-finite pose.
- The failed-relocalization path at depth 3 resolves the frames in flight
  before it relocalizes; pipelined mode starts no thread.
"""

import threading

import numpy as np
import pytest
import torch

from tests.test_torch_slam import (
    N_FRAMES,
    _clone_tracking_state,
    _config,
    _first_track,
    _port_path,
    _run_jax,
    _run_port,
)
from visualslam_android_tpu_torch import config as tconfig
from visualslam_android_tpu_torch.models import slam as tslam
from visualslam_android_tpu_torch.utils import ate as tate

torch.set_num_threads(2)

PREFIX = 14
FIELDS = ("frame_id", "phase", "quality", "n_found", "n_points",
          "n_keyframes", "lost", "did_coarse", "added_keyframe", "message")


@pytest.fixture(scope="module")
def path():
    return _port_path(N_FRAMES)


@pytest.fixture(scope="module")
def sync_run(path):
    sys_, results, _ = _run_port(_config(tconfig), path[0][:PREFIX])
    return sys_, results


@pytest.fixture(scope="module")
def piped(path):
    """Pipelined runs by depth, made once each: depths 1 and 2 on the
    first PREFIX frames, depth 3 on all N_FRAMES. Each is (system,
    results in delivery order: one per call, then flush()'s, frames run)."""
    runs = {}

    def run(depth):
        if depth not in runs:
            n = N_FRAMES if depth == 3 else PREFIX
            sys_, results, _ = _run_port(_config(tconfig), path[0][:n],
                                         pipelined=True,
                                         pipeline_depth=depth)
            runs[depth] = (sys_, results, n)
        return runs[depth]

    return run


@pytest.fixture(scope="module")
def jax_depth3():
    """The JAX package's facade pipelined at depth 3 over test_slam.py's
    sequence; results in delivery order, flush()'s last."""
    sys_, results = _run_jax(pipelined=True, pipeline_depth=3)
    sys_._pull_pool.shutdown()
    return results


def _delivered(results):
    """The real results of a run, in delivery order."""
    return [r for r in results if r.valid]


# ---- (a) depth 1 against sync mode -------------------------------------


def test_depth_1_results_equal_sync(sync_run, piped):
    """Matched by frame_id, every result of depth 1 equals sync mode's:
    fields, message and pose bit for bit."""
    _, res_sync = sync_run
    _, res_piped, n = piped(1)
    by_id = {r.frame_id: r for r in _delivered(res_piped)}
    assert sorted(by_id) == list(range(n)) == [r.frame_id for r in res_sync]
    for a in res_sync:
        b = by_id[a.frame_id]
        assert [getattr(a, f) for f in FIELDS] == [getattr(b, f)
                                                  for f in FIELDS]
        np.testing.assert_array_equal(a.pose_R, b.pose_R)
        np.testing.assert_array_equal(a.pose_t, b.pose_t)
    assert _first_track(res_sync) < n - 3, "too few tracked frames"


def test_depth_1_state_equals_sync(sync_run, piped):
    """After flush() the two systems hold the same map, pose and host state,
    and counted the same reads (one stats read per tracked frame)."""
    sys_a, _ = sync_run
    sys_b, _, _ = piped(1)
    assert sys_a.host_reads == sys_b.host_reads
    for name in ("pos_w", "valid"):
        assert torch.equal(getattr(sys_a.slam_map.points, name),
                           getattr(sys_b.slam_map.points, name))
    assert torch.equal(sys_a.slam_map.meas.valid, sys_b.slam_map.meas.valid)
    assert torch.equal(sys_a.R, sys_b.R) and torch.equal(sys_a.t, sys_b.t)
    assert (sys_a.lost_frames, sys_a.last_kf_frame, sys_a._kf_count_host,
            sys_a.recent_converged, sys_a.full_converged) == (
        sys_b.lost_frames, sys_b.last_kf_frame, sys_b._kf_count_host,
        sys_b.recent_converged, sys_b.full_converged)


# ---- (b) depth 3 against the JAX package's depth 3 ----------------------


def test_depth_3_frame_ids_match_jax(piped, jax_depth3):
    """The same delivery sequence: frame ids in order, the placeholders
    (-1) on the same calls, the same tail through flush()."""
    _, res_t, _ = piped(3)
    assert [r.frame_id for r in res_t] == [r.frame_id for r in jax_depth3]
    assert [r.valid for r in res_t] == [r.valid for r in jax_depth3]


def test_depth_3_matches_jax_by_outcome(piped, jax_depth3):
    res_t = _delivered(piped(3)[1])
    res_j = _delivered(jax_depth3)
    first = _first_track(res_t)
    assert first == _first_track(res_j)
    tracked = [sum(r.phase == tslam.PHASE_TRACKING and not r.lost
                   for r in res) for res in (res_t, res_j)]
    assert tracked[0] == tracked[1]
    assert abs(res_t[-1].n_keyframes - res_j[-1].n_keyframes) <= 1
    assert abs(res_t[-1].n_points - res_j[-1].n_points) <= (
        0.1 * res_j[-1].n_points)
    assert abs(res_t[first].n_points - res_j[first].n_points) <= (
        0.1 * res_j[first].n_points)


def test_depth_3_meets_test_slam_bounds(path, piped):
    """test_slam.py's bounds hold at depth 3 too: bootstrap by frame 8, no
    BAD or lost frame after it, at least 3 keyframes, ATE under 2% of the
    span."""
    results = _delivered(piped(3)[1])
    gt = path[1]
    first = _first_track(results)
    assert first <= 8
    tracked = results[first:]
    assert not any(r.quality == 0 or r.lost for r in tracked)
    assert results[-1].n_keyframes >= 3
    est = tate.camera_centers([r.pose_R for r in tracked],
                              [r.pose_t for r in tracked])
    gtc = tate.camera_centers([g[0] for g in gt[first:]],
                              [g[1] for g in gt[first:]])
    rmse, _ = tate.ate_rmse(est, gtc)
    assert rmse < 0.02 * np.linalg.norm(gtc.max(0) - gtc.min(0))


# ---- (c) delivery -------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_delivery(piped, depth):
    """Every frame id once and in order; a placeholder (valid False,
    frame_id -1, identity pose) on each of the `depth` calls after the
    bootstrap frame and nowhere else; flush() returns the last `depth`
    frames and leaves nothing in flight; one stats read per tracked
    frame."""
    sys_, results, n = piped(depth)
    calls, tail = results[:n], results[n:]
    assert [r.frame_id for r in _delivered(results)] == list(range(n))
    first = _first_track(_delivered(results))
    waiting = [k for k, r in enumerate(calls) if not r.valid]
    assert waiting == list(range(first + 1, first + 1 + depth))
    for k in waiting:
        assert calls[k].frame_id == -1
        np.testing.assert_array_equal(calls[k].pose_R, np.eye(3))
    assert [r.frame_id for r in tail] == list(range(n - depth, n))
    assert not sys_._ctxs and not sys_._result_backlog and not sys_.flush()
    assert sys_.host_reads["stats"] == n - first - 1


# ---- (d) a corrupting bundle adjustment ---------------------------------


def _corrupted(src, **facade):
    """test_slam.py:276-311's setup on a copy of `src`'s tracking state
    (SLAMSystem keywords `facade`): the points and keyframe translations
    NaN and a real global round over them, whose deferred map_ok is False.
    The motion model is made non-finite as well, so that the next frames
    track to non-finite poses and their stats take the non-finite branch:
    on this map alone they find no point and keep a finite pose."""
    sys_ = _clone_tracking_state(src, **facade)
    pts, kfs = sys_.slam_map.points, sys_.slam_map.keyframes
    sys_.slam_map = sys_.slam_map.replace(
        points=pts.replace(pos_w=torch.where(pts.valid[:, None], torch.nan,
                                             pts.pos_w)),
        keyframes=kfs.replace(t=torch.where(kfs.valid[:, None], torch.nan,
                                            kfs.t)))
    sys_._dispatch_ba("global", max_iters=2)
    assert sys_._pending_ba is not None
    sys_.velocity = torch.full((6,), torch.nan)
    return sys_


@pytest.mark.parametrize("depth", [1, 3])
def test_corrupt_ba_leaves_no_nan_pose(sync_run, depth):
    """Tier-3 recovery with frames in flight (fault b of the reference):
    the first frame after the corrupting round carries its map_ok = False
    and tracks to a NaN pose; at depth 3 the two frames after it start
    from that NaN pose. track_frame services the reset within depth + 1
    calls, and every result keeps a finite pose: the newest finite pose
    read, which is the clone's pose. The JAX package fails this at depth
    3: its non-finite branch restores the pose the frame started from
    (visualslam_android_tpu/models/slam.py:488), the previous in-flight
    frame's NaN."""
    src = sync_run[0]
    sys_ = _corrupted(src, pipelined=True, pipeline_depth=depth)
    finite_stats = []
    read = sys_._read_stats

    def spy(ctx):
        stats = read(ctx)
        finite_stats.append(bool(np.isfinite(stats).all()))
        return stats

    sys_._read_stats = spy
    img = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 255, (240, 320)).astype(np.float32))
    results = []
    for call in range(depth + 1):
        results.append(sys_.track_frame(img))
        if sys_.phase == tslam.PHASE_NOT_STARTED:
            break
    assert sys_.phase == tslam.PHASE_NOT_STARTED, (
        "track_frame never serviced the tier-3 map reset")
    assert call <= depth
    assert not sys_.reset_requested
    assert int(sys_.slam_map.keyframes.count()) == 0
    results += sys_.flush()
    assert finite_stats == [False] * depth
    real = _delivered(results)
    assert [r.frame_id for r in real][:depth] == list(
        range(src.frame_idx, src.frame_idx + depth))
    for r in real:
        assert np.isfinite(r.pose_R).all() and np.isfinite(r.pose_t).all()
    for r in real[:depth]:
        assert r.quality == 0
        np.testing.assert_array_equal(r.pose_R, src._pose_host[0])
        np.testing.assert_array_equal(r.pose_t, src._pose_host[1])
    assert any(r.phase == tslam.PHASE_NOT_STARTED for r in real)


def test_corrupt_ba_restores_the_start_pose_as_sync_mode(sync_run):
    """In sync mode the non-finite branch restores, on the device and in
    the result, the pose the frame started from, bit for bit; depth 1
    gives the same result and the same device pose."""
    src = sync_run[0]
    img = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 255, (240, 320)).astype(np.float32))
    sync = _corrupted(src)
    R_start, t_start = sync.R.clone(), sync.t.clone()
    a = sync.track_frame(img)
    assert a.quality == 0 and sync.reset_requested
    assert torch.equal(sync.R, R_start) and torch.equal(sync.t, t_start)
    np.testing.assert_array_equal(a.pose_R, R_start.numpy())
    np.testing.assert_array_equal(a.pose_t, t_start.numpy())
    piped = _corrupted(src, pipelined=True, pipeline_depth=1)
    assert not piped.track_frame(img).valid
    piped._drain_ctxs()  # what the next call does before it resets
    assert piped.reset_requested
    assert torch.equal(piped.R, R_start) and torch.equal(piped.t, t_start)
    b = piped.flush()[0]
    assert [getattr(a, f) for f in FIELDS] == [getattr(b, f) for f in FIELDS]
    np.testing.assert_array_equal(a.pose_R, b.pose_R)
    np.testing.assert_array_equal(a.pose_t, b.pose_t)


# ---- (e) failed relocalization, (f) no thread ----------------------------


def test_failed_relocalization_drains_first(sync_run, monkeypatch):
    """At depth 3, blank frames go BAD three calls late; the call on which
    lost_frames reaches max_lost_frames takes the relocalization path,
    which resolves the frames still in flight before it tries (here it
    fails: the keyframes' SBIs are poisoned) and the results stay in
    order, the lost result after the drained ones."""
    src = sync_run[0]
    sys_ = _clone_tracking_state(src, pipelined=True, pipeline_depth=3)
    kfs = sys_.slam_map.keyframes
    sys_.slam_map = sys_.slam_map.replace(keyframes=kfs.replace(
        sbi_template=torch.full_like(kfs.sbi_template, torch.inf)))
    in_flight = []
    attempt = tslam.relocalizer.attempt_recovery

    def recorded(*args):
        in_flight.append(len(sys_._ctxs))
        return attempt(*args)

    monkeypatch.setattr(tslam.relocalizer, "attempt_recovery", recorded)
    blank = torch.full((240, 320), 127.0)
    results = [sys_.track_frame(blank) for _ in range(8)] + sys_.flush()
    assert in_flight and set(in_flight) == {0}
    real = _delivered(results)
    assert [r.frame_id for r in real] == list(
        range(src.frame_idx, src.frame_idx + 8))
    lost = [k for k, r in enumerate(real) if r.message.startswith("Lost")]
    max_lost = src.config.tracker.max_lost_frames
    assert lost and lost[0] == max_lost + 2
    assert all(r.quality == 0 for r in real)
    assert sys_.host_reads["reloc"] == len(in_flight) == len(lost)


def test_pipelined_mode_starts_no_thread(sync_run):
    """The stats copy is a stream-ordered copy and an event on the card and
    a plain copy on the CPU: no thread pool, no thread."""
    before = set(threading.enumerate())
    sys_ = _clone_tracking_state(sync_run[0], pipelined=True,
                                 pipeline_depth=3)
    img = torch.full((240, 320), 127.0)
    for _ in range(4):
        sys_.track_frame(img)
    sys_.flush()
    assert set(threading.enumerate()) == before
    assert len(sys_._stats_ring) == 4
    assert all(done is None and not buf.is_pinned()
               for buf, done in sys_._stats_ring)
