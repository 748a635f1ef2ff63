"""The port's SLAMSystem facade on the CPU, against tests/test_slam.py's
bounds and against one run of the JAX package's SLAMSystem; and the pieces
it carries: the mapping scheduler, the ATE evaluation and the synthetic
sequence generator.

The facade runs test_slam.py's configuration (320x240, 512 point slots,
8 keyframe slots, keyframes at least 6 frames apart), scene (seed 21,
px_per_m 140) and sideways camera path (26 frames, touches at frames 0 and
6), rendered by the port on the CPU. Its run must meet test_slam.py's own
bounds: the bootstrap done by frame 8 with more than 60 points and two
keyframes, no BAD or lost frame after it, at least 3 keyframes, ATE under
2% of the trajectory's span. Against the JAX package's run of the same
sequence (seed 3 on both; the random draws differ between the packages)
it is held by outcome: the same first tracking frame and tracked count,
the keyframe count within 1, the point count within 10%. Also test_slam.py's
relocalization run (4 blank frames, then the camera back where it was):
lost trips after max_lost_frames, the next real frame relocalizes and
runs the coarse stage, as does the one after it, and tracking stays good;
the local bundle-adjustment branch with local_ba_min_kfs lowered to 3; the
deferred bundle-adjustment result and the reset it may request; and the
device rule (no card and no device="cpu": the constructor raises).

The scheduler is compared with the JAX package's over all 64 input
combinations; ATE with the JAX package's to 1e-9 (both numpy float64);
the synthetic sequence's poses within 1e-6 and its camera centers within
1e-5; its 320x240 frames within 1e-3 grey on all but 0.2% of the pixels and
within 1e-2 on every pixel: the two renderers intersect the rays with the
plane in another order of f32 operations and their blurred textures differ
by up to 5e-5, so on the steep edges of the texture's blobs a few pixels in
a thousand differ by up to ~8e-3 (the same at the same pose).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu import config as jconfig
from visualslam_android_tpu import native_runtime as jnative
from visualslam_android_tpu.models import slam as jslam
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu.utils import ate as jate
from visualslam_android_tpu.utils import datasets as jdatasets
from visualslam_android_tpu.utils import synthetic as jsyn
from visualslam_android_tpu_torch import config as tconfig
from visualslam_android_tpu_torch import native_runtime as tnative
from visualslam_android_tpu_torch.models import frame_step as tfs
from visualslam_android_tpu_torch.models import slam as tslam
from visualslam_android_tpu_torch.utils import ate as tate
from visualslam_android_tpu_torch.utils import datasets as tdatasets
from visualslam_android_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

N_FRAMES = 26
RELOC_FRAMES = 30
BLANKS = range(14, 18)


def _config(mod, **mapmaker):
    """test_slam.py's configuration in the JAX package (mod = its config
    module) or the port."""
    return mod.SLAMConfig(
        tracker=mod.TrackerConfig(
            width=320, height=240, max_map_points=512,
            max_corners_per_level=(256, 128, 64, 32),
            min_frames_between_kfs=6,
        ),
        mapmaker=mod.MapMakerConfig(max_keyframes=8, max_epi_candidates=128,
                                    **mapmaker),
    )


def _port_path(n_frames, blanks=()):
    """(images, truth poses) of test_slam.py's sequences, rendered by the
    port on the CPU: the sideways path; with `blanks`, those frames are
    flat grey and the path resumes at the pose before them."""
    rng = np.random.default_rng(21)
    scene = tsyn.make_planar_scene(rng, depth=4.0, px_per_m=140.0,
                                   device="cpu")
    R0, t0 = tsyn.look_at_pose((0.0, 0.0, 0.0), device="cpu")
    cfg = _config(tconfig)
    from visualslam_android_tpu_torch.ops import camera as tcam
    cam = tcam.make_camera(cfg.camera.params(), 320, 240, device="cpu")
    images, gt = [], []
    for k in range(n_frames):
        if blanks:
            kk = min(k, blanks[0] - 1) if k <= blanks[-1] else k - len(blanks)
        else:
            kk = k
        R, t = tsyn.sideways_pose(R0, t0, kk / max(n_frames - 1, 1))
        if k in blanks:
            images.append(torch.full((240, 320), 127.0))
        else:
            images.append(tsyn.render(scene, cam, R, t, (240, 320)))
        gt.append((R.numpy(), t.numpy()))
    return images, gt


def _run_port(config, images, seed=3, **facade):
    """Drive the port's facade (SLAMSystem keywords `facade`, such as the
    pipelined mode's) over `images`, touching at frames 0 and 6, then
    flush it; returns (system, results in delivery order, tasks run after
    each tracked frame)."""
    sys_ = tslam.SLAMSystem(config, seed=seed, device="cpu", **facade)
    tasks = []
    step = sys_._mapmaker_step

    def recorded():
        tasks.append((step(), sys_._kf_count_host))
        return tasks[-1][0]

    sys_._mapmaker_step = recorded
    results = []
    for k, img in enumerate(images):
        if k in (0, 6):
            sys_.on_touch()
        results.append(sys_.track_frame(img))
    return sys_, results + sys_.flush(), tasks


@pytest.fixture(scope="module")
def port_run():
    images, gt = _port_path(N_FRAMES)
    sys_, results, tasks = _run_port(_config(tconfig), images)
    return sys_, results, gt, tasks


def _run_jax(**facade):
    """test_slam.py's slam_run: the JAX package's facade (SLAMSystem
    keywords `facade`) over its sequence, then flushed; returns (system,
    results in delivery order)."""
    config = _config(jconfig)
    rng = np.random.default_rng(21)
    scene = jsyn.make_planar_scene(rng, depth=4.0, px_per_m=140.0)
    base_R, base_t = jsyn.look_at_pose((0.0, 0.0, 0.0))
    sys_ = jslam.SLAMSystem(config, seed=3, **facade)
    results = []
    for k in range(N_FRAMES):
        s = k / (N_FRAMES - 1)
        mu = jnp.asarray([0.55 * s, 0.08 * np.sin(2 * s), 0.05 * s, 0.0,
                          0.12 * s, 0.0], jnp.float32)
        R, t = jlie.se3_mul(*jlie.se3_exp(mu), base_R, base_t)
        img = jsyn.render(scene, sys_.cam, R, t, (240, 320))
        if k in (0, 6):
            sys_.on_touch()
        results.append(sys_.track_frame(img))
    return sys_, results + sys_.flush()


@pytest.fixture(scope="module")
def jax_run():
    """test_slam.py's slam_run fixture: the JAX package's facade."""
    return _run_jax()


def _first_track(results):
    return [r.phase for r in results].index(tslam.PHASE_TRACKING)


def _ate(results, gt, first):
    est = tate.camera_centers([r.pose_R for r in results[first:]],
                              [r.pose_t for r in results[first:]])
    gtc = tate.camera_centers([g[0] for g in gt[first:]],
                              [g[1] for g in gt[first:]])
    rmse, _ = tate.ate_rmse(est, gtc)
    return rmse, float(np.linalg.norm(gtc.max(0) - gtc.min(0)))


# ---- the facade: test_slam.py's bounds --------------------------------


def test_bootstrap_completed(port_run):
    _, results, _, _ = port_run
    assert results[0].phase == tslam.PHASE_TRAILS
    first = _first_track(results)
    assert first <= 8
    assert results[first].n_points > 60
    assert results[first].n_keyframes == 2


def test_tracking_stays_good(port_run):
    _, results, _, _ = port_run
    tracked = results[_first_track(results):]
    assert sum(r.quality == 0 for r in tracked) == 0
    assert not any(r.lost for r in tracked)
    for r in tracked:
        assert np.isfinite(r.pose_R).all() and np.isfinite(r.pose_t).all()


def test_map_grows(port_run):
    sys_, results, _, tasks = port_run
    assert results[-1].n_keyframes >= 3, "no keyframe added after the two"
    assert results[-1].n_points > results[10].n_points * 0.8
    assert int(sys_.slam_map.meas.count()) > results[-1].n_points
    # Each keyframe came from the queue a tracked frame filled, and its
    # integration ran as five mapping tasks (the last may be under way).
    n_added = results[-1].n_keyframes - 2
    assert sum(r.added_keyframe for r in results) >= n_added
    n_tasks = sum(t == tnative.TASK_ADD_KEYFRAME for t, _ in tasks)
    assert 5 * n_added - 4 <= n_tasks <= 5 * n_added + 5 * len(sys_.kf_queue)


def test_ate_small(port_run):
    _, results, gt, _ = port_run
    rmse, span = _ate(results, gt, _first_track(results))
    assert rmse < 0.02 * span, f"ATE {rmse:.4f} vs span {span:.3f}"


def test_one_stats_read_per_tracked_frame(port_run):
    """The facade's own reads on this run: one per tracked frame, none for
    relocalization or a deferred result."""
    sys_, results, _, _ = port_run
    n_tracked = len(results) - _first_track(results) - 1  # not the init frame
    assert sys_.host_reads["stats"] == n_tracked
    assert sys_.host_reads["reloc"] == sys_.host_reads["pending"] == 0


def test_matches_jax_run_by_outcome(port_run, jax_run):
    _, res_t, _, _ = port_run
    _, res_j = jax_run
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


# ---- relocalization (test_slam.py:158-224) ------------------------------


@pytest.fixture(scope="module")
def reloc_run():
    images, gt = _port_path(RELOC_FRAMES, blanks=tuple(BLANKS))
    sys_, results, _ = _run_port(_config(tconfig), images)
    return sys_, results, gt


def test_lost_trips_after_bad_frames(reloc_run):
    sys_, results, _ = reloc_run
    for k in BLANKS:
        assert results[k].quality == 0, f"frame {k} not BAD"
    trip = BLANKS[0] + sys_.config.tracker.max_lost_frames
    assert results[trip].lost
    assert "relocal" in results[trip].message.lower()


def test_recovery_succeeds_and_forces_coarse(reloc_run):
    _, results, _ = reloc_run
    first_real = BLANKS[-1] + 1
    rec = results[first_real]
    assert not rec.lost, "relocalization failed"
    assert rec.message.startswith("Relocalized")
    assert rec.n_found > 20
    assert rec.did_coarse, "recovery frame skipped the coarse stage"
    assert results[first_real + 1].did_coarse, (
        "just-recovered frame skipped the coarse stage")
    tail = results[first_real + 1:]
    assert not any(r.lost for r in tail)
    assert sum(r.quality == 0 for r in tail) == 0


def test_reloc_reads(reloc_run):
    """One read per relocalization attempt: the lost frames before the
    camera came back, and the frame that relocalized."""
    sys_, results, _ = reloc_run
    attempts = sum(r.message.startswith(("Lost", "Relocalized"))
                   for r in results)
    assert sys_.host_reads["reloc"] == attempts >= 1


def test_post_recovery_ate_bounded(reloc_run):
    _, results, gt = reloc_run
    first_real = BLANKS[-1] + 1
    est = tate.camera_centers([r.pose_R for r in results[first_real:]],
                              [r.pose_t for r in results[first_real:]])
    gtc = tate.camera_centers([g[0] for g in gt[first_real:]],
                              [g[1] for g in gt[first_real:]])
    pre = tate.camera_centers([r.pose_R for r in results[8:BLANKS[0]]],
                              [r.pose_t for r in results[8:BLANKS[0]]])
    pre_gt = tate.camera_centers([g[0] for g in gt[8:BLANKS[0]]],
                                 [g[1] for g in gt[8:BLANKS[0]]])
    s, Ra, ta = tate.umeyama_alignment(pre, pre_gt)
    aligned = (s * (Ra @ est.T)).T + ta
    err = np.linalg.norm(aligned - gtc, axis=-1)
    span = np.linalg.norm(gtc.max(0) - gtc.min(0)) + 1e-9
    assert np.median(err) < 0.25 * max(span, 0.1)


# ---- the mapping branches and the deferred results ---------------------


def test_local_ba_branch(monkeypatch):
    """With local_ba_min_kfs lowered to 3, BundleAdjustRecent runs as soon
    as the third keyframe is in (a local round over the newest keyframe and
    its neighbours), and tracking stays good."""
    rounds = []
    ba_round = tfs.ba_round

    def recorded(slam_map, newest_kf, *args, mode, **kwargs):
        out = ba_round(slam_map, newest_kf, *args, mode=mode, **kwargs)
        rounds.append((mode, newest_kf, int(slam_map.keyframes.count())))
        return out

    monkeypatch.setattr(tfs, "ba_round", recorded)
    images, gt = _port_path(N_FRAMES)
    _, results, tasks = _run_port(_config(tconfig, local_ba_min_kfs=3),
                                  images)
    local = [r for r in rounds if r[0] == "local"]
    assert local, f"no local round ran: tasks {tasks}"
    assert all(n >= 3 and newest == n - 1 for _, newest, n in local)
    tracked = results[_first_track(results):]
    assert sum(r.quality == 0 for r in tracked) == 0
    rmse, span = _ate(results, gt, _first_track(results))
    assert rmse < 0.02 * span


def test_solver_choice_beyond_the_dense_limit_raises():
    """Beyond dense_solver_max_cams the choice no longer raises: on an empty
    map every pair fits the band (one read, counted); within the limit it
    is the dense path without a read."""
    cfg = _config(tconfig)
    cfg = dataclasses.replace(cfg, mapmaker=dataclasses.replace(
        cfg.mapmaker, max_keyframes=cfg.bundle.dense_solver_max_cams + 1))
    sys_ = tslam.SLAMSystem(cfg, device="cpu")
    assert sys_._solver_choice() == ("band", "band_pcg")
    assert sys_.host_reads["solver"] == 1
    dense = tslam.SLAMSystem(_config(tconfig), device="cpu")
    assert dense._solver_choice() == ("scatter", "chol")
    assert dense.host_reads["solver"] == 0


def test_resolve_pending_ladder():
    sys_ = tslam.SLAMSystem(_config(tconfig), device="cpu")
    sys_._resolve_pending("recent", conv=False, ok=True)
    assert not sys_.reset_requested
    assert not sys_.recent_converged and not sys_.full_converged
    sys_._resolve_pending("full", conv=True, ok=True)
    assert sys_.recent_converged and sys_.full_converged
    sys_._resolve_pending("full", conv=True, ok=False)
    assert sys_.reset_requested


def _clone_tracking_state(src, **facade):
    """A new facade (SLAMSystem keywords `facade`) holding a deep copy of
    `src`'s tracking state."""
    dst = tslam.SLAMSystem(src.config, seed=7, device="cpu", **facade)
    dst.slam_map = src.slam_map.clone()
    dst.phase = tslam.PHASE_TRACKING
    for name in ("R", "t", "velocity", "_msd", "_depth", "_wiggle_dev",
                 "never_retry", "failure_mask", "new_points"):
        setattr(dst, name, getattr(src, name).clone())
    for name in ("sbi_last", "_prev_frame"):
        setattr(dst, name, getattr(src, name).clone())
    for name in ("_kf_count_host", "_newest_kf_host", "_n_points_host",
                 "scene_depth_mean", "wiggle_depth_norm", "frame_idx",
                 "_pose_host"):
        setattr(dst, name, getattr(src, name))
    return dst


def test_corrupt_ba_requests_map_reset(port_run):
    """Tier-3 recovery (MapMaker.cc:906-915): a bundle adjustment over a
    non-finite map reports map_ok = False through the next frame's stats;
    track_frame itself then resets the map, and no result carries NaN."""
    src = port_run[0]
    sys_ = _clone_tracking_state(src)
    pts, kfs = sys_.slam_map.points, sys_.slam_map.keyframes
    sys_.slam_map = sys_.slam_map.replace(
        points=pts.replace(pos_w=torch.where(pts.valid[:, None], torch.nan,
                                             pts.pos_w)),
        keyframes=kfs.replace(t=torch.where(kfs.valid[:, None], torch.nan,
                                            kfs.t)))
    sys_._dispatch_ba("global", max_iters=2)
    assert sys_._pending_ba is not None
    img = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 255, (240, 320)).astype(np.float32))
    first = sys_.track_frame(img)
    assert sys_.reset_requested
    assert np.isfinite(first.pose_R).all() and np.isfinite(first.pose_t).all()
    later = [sys_.track_frame(img), sys_.track_frame(img)]
    assert sys_.phase == tslam.PHASE_NOT_STARTED
    assert not sys_.reset_requested
    assert int(sys_.slam_map.keyframes.count()) == 0
    assert any(r.phase == tslam.PHASE_NOT_STARTED for r in later)


def test_lost_path_resolves_pending_ba(port_run):
    """A deferred result must not vanish during a lost streak: the failed
    relocalization frame has no frame_step to carry it, so it is read
    there, and the reset it requests follows."""
    sys_ = _clone_tracking_state(port_run[0])
    kfs = sys_.slam_map.keyframes
    sys_.slam_map = sys_.slam_map.replace(keyframes=kfs.replace(
        sbi_template=torch.full_like(kfs.sbi_template, torch.inf)))
    sys_.lost_frames = sys_.config.tracker.max_lost_frames
    sys_._pending_ba = ("full", torch.zeros(()), torch.zeros(()))
    img = torch.full((240, 320), 127.0)
    res = sys_.track_frame(img)
    assert res.lost
    assert sys_._pending_ba is None
    assert sys_.reset_requested, "the lost path dropped the pending result"
    sys_.track_frame(img)
    assert sys_.phase == tslam.PHASE_NOT_STARTED


def test_facade_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tslam.SLAMSystem(_config(tconfig))
    assert tslam.SLAMSystem(_config(tconfig),
                            device="cpu").slam_map.points.pos_w.is_cpu


# ---- scheduler, ATE, synthetic sequence ---------------------------------


@pytest.mark.parametrize("bits", range(64))
def test_scheduler_matches_jax(bits):
    args = [(bits >> i) & 1 for i in range(6)]
    queue = args[0] * (1 + bits % 3)  # 0, or a queue of 1-3 entries
    inputs = (queue, *map(bool, args[1:]))
    assert tnative.scheduler_next_py(*inputs) == jnative.scheduler_next_py(
        *inputs)


def test_scheduler_task_ids_match_jax():
    for name in ("TASK_NONE", "TASK_BA_RECENT", "TASK_REFIND_NEWLY",
                 "TASK_BA_ALL", "TASK_REFIND_FAILURES", "TASK_ADD_KEYFRAME"):
        assert getattr(tnative, name) == getattr(jnative, name)


@pytest.mark.parametrize("seed,with_scale", [(0, True), (1, True),
                                             (2, False)])
def test_ate_matches_jax(seed, with_scale):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(scale=0.1, size=(40, 3)), axis=0)
    Rq = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    Rq *= np.sign(np.linalg.det(Rq))
    est = 0.7 * gt @ Rq.T + rng.normal(scale=0.01, size=gt.shape) + 0.3
    for a, b in zip(tate.umeyama_alignment(est, gt, with_scale),
                    jate.umeyama_alignment(est, gt, with_scale)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    rmse_t, al_t = tate.ate_rmse(est, gt, with_scale)
    rmse_j, al_j = jate.ate_rmse(est, gt, with_scale)
    np.testing.assert_allclose(rmse_t, rmse_j, atol=1e-9)
    np.testing.assert_allclose(al_t, al_j, atol=1e-9)
    Rs = [np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(5)]
    ts = [rng.normal(size=3) for _ in range(5)]
    np.testing.assert_allclose(tate.camera_centers(Rs, ts),
                               jate.camera_centers(Rs, ts), atol=1e-12)


def test_synthetic_sequence_matches_jax():
    kw = dict(n_frames=3, size=(320, 240), px_per_m=140.0)
    img_j, poses_j, cen_j, _, _ = jdatasets.make_synthetic_sequence(
        np.random.default_rng(11), **kw)
    img_t, poses_t, cen_t, cam, _ = tdatasets.make_synthetic_sequence(
        np.random.default_rng(11), device="cpu", **kw)
    assert len(img_t) == 3 and tuple(img_t[0].shape) == (240, 320)
    for a, b in zip(img_t, img_j):
        d = np.abs(a.numpy() - b)
        assert (d > 1e-3).mean() <= 2e-3 and d.max() <= 1e-2, d.max()
    for (Rt, tt), (Rj, tj) in zip(poses_t, poses_j):
        np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), tj, atol=1e-6)
    np.testing.assert_allclose(cen_t, cen_j, atol=1e-5)
    assert cam.focal.is_cpu
