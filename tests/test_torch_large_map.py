"""The port's large-map solver path through the facade: the four cases of
SLAMSystem._solver_choice held to the JAX facade's answers
(tests/test_large_map.py), and a port-only facade run whose every bundle
adjustment goes through the band or CG solvers.

The run is tests/test_large_map.py's (320x240, 26 frames of a rendered
sideways path, touches at frames 0 and 6, max_keyframes 12 above a dense
limit of 4) with that file's bounds, and then HOLD more frames at the
path's last pose: along the path a keyframe is queued every 5 frames and
takes 5 mapping tasks, so the queue only empties, and bundle adjustment
only runs, once the camera stops. The JAX facade is not run here (its file
marks that run slow).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu import config as jconfig
from visualslam_android_tpu.models import slam as jslam
from visualslam_android_tpu_torch import config as tconfig
from visualslam_android_tpu_torch.models import bundle as tb
from visualslam_android_tpu_torch.models import slam as tslam
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.utils import synthetic

torch.set_num_threads(2)

N_FRAMES = 26
HOLD = 12


def _large_map_config(cfg_mod, band_halfwidth=4):
    """tests/test_large_map.py's configuration, from either package's
    config module: small frames, max_keyframes above dense_solver_max_cams."""
    return cfg_mod.SLAMConfig(
        tracker=cfg_mod.TrackerConfig(
            width=320, height=240, max_map_points=512,
            max_corners_per_level=(256, 128, 64, 32),
            min_frames_between_kfs=4, max_trails=256,
        ),
        mapmaker=cfg_mod.MapMakerConfig(
            max_keyframes=12, max_epi_candidates=64, local_ba_min_kfs=4,
        ),
        bundle=cfg_mod.BundleConfig(
            dense_solver_max_cams=4, band_halfwidth=band_halfwidth,
            cg_iters=120,
        ),
    )


def _co_observations(shape, point_kfs):
    """(kf, valid) tables where point i observes the keyframes in
    point_kfs[i]."""
    kf = np.zeros(shape, np.int32)
    valid = np.zeros(shape, bool)
    for i, kfs in enumerate(point_kfs):
        for o, k in enumerate(kfs):
            kf[i, o], valid[i, o] = k, True
    return kf, valid


def _both(config=None):
    """(JAX facade, port facade) at the large-map configuration."""
    j = jslam.SLAMSystem(config[0] if config else
                         _large_map_config(jconfig), seed=0)
    t = tslam.SLAMSystem(config[1] if config else
                         _large_map_config(tconfig), seed=0, device="cpu")
    return j, t


def _set_meas(j, t, point_kfs):
    kf, valid = _co_observations(np.asarray(j.slam_map.meas.kf).shape,
                                 point_kfs)
    j.slam_map = j.slam_map._replace(meas=j.slam_map.meas._replace(
        kf=jnp.asarray(kf), valid=jnp.asarray(valid)))
    t.slam_map = t.slam_map.replace(meas=t.slam_map.meas.replace(
        kf=torch.as_tensor(kf), valid=torch.as_tensor(valid)))


def _set_count(j, t, n):
    j._kf_count_host = n
    t._kf_count_host = n


_PORT_NAME = {"onehot": "scatter"}  # the port runs one-hot as the scatter form


def _same_choice(j, t):
    jc = j._solver_choice()
    tc = t._solver_choice()
    assert tc == (_PORT_NAME.get(jc[0], jc[0]), jc[1]), (jc, tc)
    return tc


def test_solver_choice_dense_under_cap():
    """The default 64 keyframe slots are within dense_solver_max_cams: the
    dense path, and no read."""
    j = jslam.SLAMSystem(jconfig.SLAMConfig(), seed=0)
    t = tslam.SLAMSystem(tconfig.SLAMConfig(), seed=0, device="cpu")
    assert _same_choice(j, t) == ("scatter", "chol")
    assert t.host_reads["solver"] == 0


def test_solver_choice_band_when_offsets_fit():
    j, t = _both()
    _set_meas(j, t, [(0, 1, 2), (2, 3), (4, 6)])  # max offset 2 <= 4
    _set_count(j, t, 7)
    assert _same_choice(j, t) == ("band", "band_pcg")
    assert t.host_reads["solver"] == 1


def test_solver_choice_scatter_when_band_exceeded():
    j, t = _both()
    _set_meas(j, t, [(0, 1), (0, 6)])  # offset 6 > band 4
    _set_count(j, t, 7)
    assert _same_choice(j, t) == ("scatter", "pcg")


def test_solver_choice_cache_invalidates_on_kf_count():
    """The band check reads the device, so its answer is kept per keyframe
    count, and taken again when the count changes."""
    j, t = _both()
    _set_meas(j, t, [(0, 1)])
    _set_count(j, t, 2)
    assert _same_choice(j, t) == ("band", "band_pcg")
    _set_meas(j, t, [(0, 6)])  # same count: the kept answer
    assert _same_choice(j, t) == ("band", "band_pcg")
    assert t.host_reads["solver"] == 1
    _set_count(j, t, 7)
    assert _same_choice(j, t) == ("scatter", "pcg")
    assert t.host_reads["solver"] == 2


def _gt_pose(base_R, base_t, k, n_frames):
    s = k / max(n_frames - 1, 1)
    mu = torch.tensor([0.55 * s, 0.08 * np.sin(2 * s), 0.05 * s, 0.0,
                       0.12 * s, 0.0], dtype=torch.float32)
    dR, dt = lie.se3_exp(mu)
    return lie.se3_mul(dR, dt, base_R, base_t)


@pytest.fixture(scope="module")
def large_map_run():
    """The port's facade over tests/test_large_map.py's 26 frames and HOLD
    still ones; every _solver_choice answer and CG solve recorded."""
    config = _large_map_config(tconfig)
    scene = synthetic.make_planar_scene(np.random.default_rng(21), depth=4.0,
                                        px_per_m=140.0, device="cpu")
    base_R, base_t = synthetic.look_at_pose((0.0, 0.0, 0.0), device="cpu")
    shape = (config.tracker.height, config.tracker.width)
    sys_ = tslam.SLAMSystem(config, seed=3, device="cpu")
    chosen = []
    orig = sys_._solver_choice

    def spy():
        chosen.append(orig())
        return chosen[-1]

    sys_._solver_choice = spy
    tb.CG_STATS.update(solves=0, iterations=0)
    results = []
    for k in range(N_FRAMES + HOLD):
        R, t = _gt_pose(base_R, base_t, min(k, N_FRAMES - 1), N_FRAMES)
        img = synthetic.render(scene, sys_.cam, R, t, shape)
        if k in (0, 6):
            sys_.on_touch()
        results.append(sys_.track_frame(img))
    return sys_, results, chosen, dict(tb.CG_STATS)


def test_large_map_run_uses_scaled_solver(large_map_run):
    """Every bundle adjustment after the bootstrap asked _solver_choice and
    took a band or CG path; the CG solvers ran."""
    sys_, results, chosen, cg = large_map_run
    assert any(r.phase == tslam.PHASE_TRACKING for r in results)
    assert chosen, "no bundle adjustment consulted _solver_choice"
    assert all(c in (("band", "band_pcg"), ("scatter", "pcg"))
               for c in chosen), chosen
    assert sys_._band_choice is not None
    assert cg["solves"] >= len(chosen) and cg["iterations"] > 0


def test_large_map_run_stays_healthy(large_map_run):
    """tests/test_large_map.py's bounds: no reset after the bootstrap, more
    than half the tracked frames not BAD, keyframes beyond the stereo pair,
    a finite map."""
    sys_, results, _, _ = large_map_run
    phases = [r.phase for r in results]
    first = phases.index(tslam.PHASE_TRACKING)
    tracked = results[first:]
    assert all(r.phase == tslam.PHASE_TRACKING for r in tracked)
    assert results[-1].n_keyframes >= 3
    assert sum(1 for r in tracked if r.quality > 0) > len(tracked) // 2
    assert bool(torch.isfinite(sys_.slam_map.points.pos_w).all())
    assert bool(torch.isfinite(sys_.slam_map.keyframes.t).all())


def test_large_map_config_fields_match():
    """The two packages' configurations of this file are field for field
    the same."""
    j = dataclasses.asdict(_large_map_config(jconfig))
    t = dataclasses.asdict(_large_map_config(tconfig))
    assert j == t
