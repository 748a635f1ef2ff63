"""The slow tier's utilities and checks in the port, held against the JAX
package on the CPU.

Not slow, at small sizes: the histogram sigma (``find_sigma_squared_hist``)
and ``bundle_adjust(sigma_mode="hist")``, ``build_band_ba_map``,
``random_structure``, ``apply_sensor_effects``, the committed photograph
behind ``make_photo_scene`` and the TUM-format sequence's ``degrade``.

Marked ``slow`` (run with ``-m slow``): the port's counterparts of
``tests/test_scale_ba.py`` (512 keyframes / 30,000 points through the CG,
band and histogram-sigma paths), ``tests/test_drift.py`` (200 frames),
``tests/test_real_texture.py`` (80 frames of the photograph with sensor
effects), each with its file's bounds, and ``run_slam`` of both packages
on the same TUM-format files. Tolerances stand beside the assertions.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.models import bundle as jb
from visualslam_android_tpu.models import mapmaker as jmm
from visualslam_android_tpu.ops import mestimator as jme
from visualslam_android_tpu.utils import fixtures as jfix
from visualslam_android_tpu.utils import synthetic as jsyn
from visualslam_android_tpu_torch.config import (
    MapMakerConfig,
    SLAMConfig,
    TrackerConfig,
)
from visualslam_android_tpu_torch.models import bundle as tb
from visualslam_android_tpu_torch.models import mapmaker as tmm
from visualslam_android_tpu_torch.models import slam as tslam
from visualslam_android_tpu_torch.ops import lie as tlie
from visualslam_android_tpu_torch.ops import mestimator as tme
from visualslam_android_tpu_torch.utils import ate as tate
from visualslam_android_tpu_torch.utils import convert, imageio
from visualslam_android_tpu_torch.utils import fixtures as tfix
from visualslam_android_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "make_tum_synthetic.py")


def _np(x):
    return jax.tree.map(np.asarray, x)


def _leaves(tree, prefix=""):
    """{dotted name: numpy array} of a port dataclass of tensors."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        name = f"{prefix}{f.name}"
        if isinstance(v, torch.Tensor):
            out[name] = v.numpy()
        elif isinstance(v, tuple):
            for i, x in enumerate(v):
                out[f"{name}[{i}]"] = x.numpy()
        else:
            out.update(_leaves(v, name + "."))
    return out


def _tool():
    """tools/make_tum_synthetic.py as a module (its degrade is the
    reference for the port's copy)."""
    spec = importlib.util.spec_from_file_location("make_tum_synthetic", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- sigma


def _errors(case):
    rng = np.random.default_rng(31)
    err_sq = (rng.normal(scale=1.5, size=(300, 4)) ** 2).astype(np.float32)
    err_sq[::17, 1] *= 400.0          # gross outliers
    mask = rng.uniform(size=err_sq.shape) < 0.7
    if case == "unmasked":
        return err_sq, None
    if case == "empty":
        return err_sq, np.zeros_like(mask)
    if case == "tiny":
        # Zeros and values below the histogram's 2^-30 floor, a few huge.
        err_sq[:100] = 0.0
        err_sq[100:150] = 1e-12
        err_sq[150:160] = 1e9
    return err_sq, mask


@pytest.mark.parametrize("case", ["masked", "unmasked", "empty", "tiny"])
@pytest.mark.parametrize("estimator", [tme.TUKEY, tme.CAUCHY, tme.HUBER,
                                       tme.LEAST_SQUARES])
def test_find_sigma_squared_hist_matches_jax(estimator, case):
    """The 512-bin log2 histogram, the floor(n/2) rank, the in-bin
    interpolation and the MAD factor: rtol 1e-5 (f32 log2 / exp2 of the
    two libraries; a bin edge would move the count by one, which these
    inputs do not hit)."""
    err_sq, mask = _errors(case)
    want = jme.find_sigma_squared_hist(
        jnp.asarray(err_sq), None if mask is None else jnp.asarray(mask),
        estimator)
    got = tme.find_sigma_squared_hist(
        torch.from_numpy(err_sq),
        None if mask is None else torch.from_numpy(mask), estimator)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    if case == "empty":
        assert float(got) == 0.0


def test_find_sigma_squared_hist_is_near_the_exact_median():
    """The histogram median is the exact one within its bin's resolution
    ((24 + 30) / 512 octaves: sigma^2 within 2^0.106 - 1 = 7.6%)."""
    err_sq, mask = _errors("masked")
    e, m = torch.from_numpy(err_sq), torch.from_numpy(mask)
    hist = tme.find_sigma_squared_hist(e, m)
    exact = tme.find_sigma_squared(e.reshape(-1), m.reshape(-1))
    assert abs(float(hist) / float(exact) - 1.0) < 0.076


def test_find_sigma_squared_hist_over_a_mesh_axis_raises(tmp_path):
    """Over a mesh the axis is a parallel.mesh.Mesh: the JAX package's bare
    axis string raises. On a one-rank gloo mesh the psum of the histogram
    leaves the unsharded sigma as it is (the D = 2 and 4 cases are in
    tests/test_torch_sharded.py)."""
    import torch.distributed as dist

    from visualslam_android_tpu_torch.parallel import mesh as tmesh

    err = torch.linspace(0.01, 40.0, 64)
    with pytest.raises(TypeError, match="Mesh"):
        tme.find_sigma_squared_hist(err, axis_name="points")
    mesh = tmesh.init_mesh("gloo", 0, 1, f"file://{tmp_path}/rendezvous",
                           "host", device="cpu", timeout=30)
    try:
        for est in (tme.TUKEY, tme.LEAST_SQUARES):
            assert torch.equal(
                tme.find_sigma_squared_hist(err, estimator=est,
                                            axis_name=mesh),
                tme.find_sigma_squared_hist(err, estimator=est))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- band BA map


def _band_maps(seed, n_kf, n_pts, **kw):
    j_cfg, j_sm, j_cam, j_adj = jfix.build_band_ba_map(
        np.random.default_rng(seed), n_kf=n_kf, n_pts=n_pts, **kw)
    t_cfg, t_sm, t_cam, t_adj = tfix.build_band_ba_map(
        np.random.default_rng(seed), n_kf=n_kf, n_pts=n_pts, device="cpu",
        **kw)
    return (j_cfg, j_sm, j_cam, j_adj), (t_cfg, t_sm, t_cam, t_adj)


def test_build_band_ba_map_matches_jax():
    """Every tensor of the map, the camera, the adjust mask and the config
    equal to the JAX package's from the same seed: integers and masks
    exactly, floats within 1e-6 (f32 se3_exp of the perturbations) plus
    one ulp of the 64x48 pixel positions (4e-6 px at |uv| < 64)."""
    (j_cfg, j_sm, j_cam, j_adj), (t_cfg, t_sm, t_cam, t_adj) = _band_maps(
        8, 16, 400)
    assert t_cfg == _convert_config(j_cfg)
    want = _leaves(convert.map_from_numpy(_np(j_sm), device="cpu"))
    got = _leaves(t_sm)
    assert set(got) == set(want)
    for name in got:
        w, g = want[name], got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=5e-7, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(t_adj.numpy(), np.asarray(j_adj))
    for name, w in _leaves(convert.camera_from_numpy(
            _np(j_cam), device="cpu")).items():
        np.testing.assert_allclose(_leaves(t_cam)[name], w, rtol=1e-6,
                                   err_msg=name)
    assert int(t_sm.meas.count()) > 0.9 * 400 * 4


def _convert_config(j_cfg):
    """The JAX config as the port's (the two are field-for-field copies)."""
    from visualslam_android_tpu_torch import config as tcfg

    def conv(obj, cls):
        import dataclasses

        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            sub = getattr(tcfg, type(v).__name__, None)
            kw[f.name] = conv(v, sub) if dataclasses.is_dataclass(v) else v
        return cls(**kw)

    return conv(j_cfg, tcfg.SLAMConfig)


@pytest.fixture(scope="module")
def band16():
    """A 16-keyframe, 600-point band problem from both packages' fixture
    and build_ba_problem."""
    (j_cfg, j_sm, j_cam, j_adj), (t_cfg, t_sm, t_cam, t_adj) = _band_maps(
        4, 16, 600, pose_perturb=0.015, point_perturb=0.02)
    j_prob = jmm.build_ba_problem(j_sm, j_adj, j_cfg)
    t_prob = tmm.build_ba_problem(t_sm, t_adj, t_cfg)
    return dict(j_prob=j_prob, j_cam=j_cam, t_prob=t_prob, t_cam=t_cam)


HIST_KW = dict(max_iters=3, solver="band_pcg", band_halfwidth=16,
               point_block=1024, cg_iters=300, cg_tol=1e-7)


def _objective_at(prob, cam, res, sigma_sq):
    """Robust objective of a result at one sigma^2 (Tukey scores of the
    kept measurements plus one per ejected one)."""
    kept = prob.replace(meas_valid=res.meas_valid)
    sp, valid = tb._sanitized(kept)
    _, _, err_sq, z_bad = tb._project_all(cam, res.cam_R, res.cam_t,
                                          res.points, sp)
    score = tme.objective_score(err_sq, sigma_sq)
    return float(torch.sum(torch.where(valid & ~z_bad, score, 0.0))
                 + res.outlier_meas.sum())


def test_hist_sigma_bundle_adjust_matches_jax(band16):
    """bundle_adjust(sigma_mode="hist") through band_pcg on the same
    problem in both packages, 20 LM iterations (both near the optimum, 10
    steps accepted): the problems equal (1e-6), the final sigma^2 within
    2e-3 relative (near the optimum one count crossing a bin edge moves the
    interpolated median by ~0.073 / (counts in its bin), ~0.2% here), the
    objective at the JAX run's sigma rtol 1e-5 and the
    ejected sets equal. Whole runs are compared by outcome, not by poses
    (ROADMAP queue 3 a), and near the optimum: after the first LM steps from
    this far-off start (sigma^2 ~45) f32 solves of the two libraries leave
    objectives up to 3e-4 apart, with either sigma mode; the first
    histogram sigma is bit-equal in both."""
    j_prob, t_prob = band16["j_prob"], band16["t_prob"]
    for name, w in _leaves(convert.ba_problem_from_numpy(
            _np(j_prob), device="cpu")).items():
        np.testing.assert_allclose(_leaves(t_prob)[name], w, rtol=5e-7,
                                   atol=1e-6, err_msg=name)
    kw = dict(HIST_KW, max_iters=20)
    j_res = jb.bundle_adjust(j_prob, band16["j_cam"], sigma_mode="hist",
                             **kw)
    tb.HOST_READS["bundle_adjust"] = 0
    t_res = tb.bundle_adjust(t_prob, band16["t_cam"], sigma_mode="hist",
                             **kw)
    assert tb.HOST_READS["bundle_adjust"] <= kw["max_iters"]
    j_t = convert.ba_result_from_numpy(_np(j_res), device="cpu")
    sigma = j_t.sigma_squared
    np.testing.assert_allclose(float(t_res.sigma_squared), float(sigma),
                               rtol=2e-3)
    want = _objective_at(t_prob, band16["t_cam"], j_t, sigma)
    got = _objective_at(t_prob, band16["t_cam"], t_res, sigma)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(t_res.outlier_meas.numpy(),
                                  j_t.outlier_meas.numpy())
    assert int(t_res.accepted) >= 1


def test_hist_sigma_bundle_adjust_matches_exact_sigma(band16):
    """tests/test_scale_ba.py's hist-against-gather check at 16 keyframes:
    the final rms of the two sigma modes within 0.05."""
    t_prob, t_cam = band16["t_prob"], band16["t_cam"]
    rms = {}
    for mode in ("gather", "hist"):
        res = tb.bundle_adjust(t_prob, t_cam, sigma_mode=mode, **HIST_KW)
        rms[mode] = float(tb.reprojection_rms(t_prob, t_cam, res.cam_R,
                                              res.cam_t, res.points))
    assert rms["gather"] < 0.45
    assert abs(rms["hist"] - rms["gather"]) < 0.05, rms


# ------------------------------------------------------- scene utilities


def test_random_structure_matches_jax():
    """Equal: the same float64 draws rounded to f32 once."""
    want = jsyn.random_structure(np.random.default_rng(3), 50,
                                 depth_range=(2.0, 5.0), xy_range=1.5)
    got = tsyn.random_structure(np.random.default_rng(3), 50,
                                depth_range=(2.0, 5.0), xy_range=1.5,
                                device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("blur_sigma", [0.0, 0.8])
def test_apply_sensor_effects_matches_jax(blur_sigma):
    """Exposure drift, optional blur, read noise from the same rng draws:
    atol 1e-4 grey (the JAX package runs the gain in float64 when given a
    numpy float, the port in f32; the blur sums ~10 terms of up to 255)."""
    img = np.random.default_rng(1).uniform(0, 255, (48, 64)).astype(
        np.float32)
    kw = dict(exposure_gain=1.0 + 0.10 * np.sin(7 / 9.0),
              exposure_bias=4.0 * np.sin(7 / 5.0), noise_std=2.0,
              blur_sigma=blur_sigma)
    want = jsyn.apply_sensor_effects(img, np.random.default_rng(2), **kw)
    got = tsyn.apply_sensor_effects(torch.from_numpy(img),
                                    np.random.default_rng(2), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_committed_photo_is_the_pil_decode():
    """data/grace_hopper_L.png holds, byte for byte, what PIL's
    convert("L") gives for matplotlib's bundled grace_hopper.jpg."""
    matplotlib = pytest.importorskip("matplotlib")
    Image = pytest.importorskip("PIL.Image")
    jpg = os.path.join(matplotlib.get_data_path(), "sample_data",
                       "grace_hopper.jpg")
    want = np.asarray(Image.open(jpg).convert("L"))
    got = imageio.read_gray(tsyn.PHOTO_PATH)
    assert got.dtype == np.uint8 and got.shape == (600, 512)
    np.testing.assert_array_equal(got, want)


def test_make_photo_scene_matches_jax():
    """The mirror-tiled texture equal to the JAX package's (which decodes
    the JPEG with PIL); depth and scale passed through."""
    pytest.importorskip("PIL.Image")
    want = jsyn.make_photo_scene(depth=3.5, px_per_m=200.0)
    got = tsyn.make_photo_scene(depth=3.5, px_per_m=200.0, device="cpu")
    assert got.texture.shape == (2400, 2048)
    np.testing.assert_array_equal(got.texture.numpy(),
                                  np.asarray(want.texture))
    assert (got.depth, got.px_per_m) == (3.5, 200.0)


@pytest.mark.parametrize("k", [0, 13, 40])
def test_degrade_matches_the_tool(k):
    """The port's copy of tools/make_tum_synthetic.py's degrade on the same
    frame and draws: atol 1e-4 (the same float64 numpy and scipy code; k =
    13 takes no blur, sigma < 0.05)."""
    img = np.random.default_rng(5).uniform(0, 255, (48, 64)).astype(
        np.float32)
    want = _tool().degrade(img, k, np.random.default_rng(6))
    got = tsyn.degrade(img, k, np.random.default_rng(6))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ------------------------------------------------------------- slow tier


@pytest.fixture(scope="module")
def big_problem():
    config, sm, cam, adjust = tfix.build_band_ba_map(
        np.random.default_rng(5), n_kf=512, n_pts=30000, obs_per_pt=4,
        pose_perturb=0.02, point_perturb=0.03, device="cpu")
    return config, tmm.build_ba_problem(sm, adjust, config), cam


def _small_problem(seed, n_kf, n_pts):
    config, sm, cam, adjust = tfix.build_band_ba_map(
        np.random.default_rng(seed), n_kf=n_kf, n_pts=n_pts, obs_per_pt=4,
        pose_perturb=0.015, point_perturb=0.02, device="cpu")
    return config, tmm.build_ba_problem(sm, adjust, config), cam


def _rms(prob, cam, res):
    return float(tb.reprojection_rms(prob, cam, res.cam_R, res.cam_t,
                                     res.points))


@pytest.mark.slow
def test_512kf_problem_is_kitti_scale(big_problem):
    config, prob, cam = big_problem
    assert prob.cam_R.shape[0] == 512 and prob.points.shape[0] == 30000
    assert int(prob.meas_valid.sum()) > 80000
    assert prob.cam_R.shape[0] > config.bundle.dense_solver_max_cams


@pytest.mark.slow
def test_512kf_global_ba_reduces_error(big_problem):
    """tests/test_scale_ba.py's bounds: rms > 1 before, < 0.45 after four
    pcg iterations, a step accepted, finite, camera 0 unchanged."""
    config, prob, cam = big_problem
    rms0 = float(tb.reprojection_rms(prob, cam))
    res = tb.bundle_adjust(prob, cam, max_iters=4, solver="pcg",
                           cg_iters=200, cg_tol=1e-6)
    assert rms0 > 1.0
    assert _rms(prob, cam, res) < 0.45
    assert int(res.accepted) >= 1
    assert bool(torch.isfinite(res.cam_t).all())
    assert torch.equal(res.cam_R[0], prob.cam_R[0])


@pytest.mark.slow
def test_512kf_band_ba(big_problem):
    config, prob, cam = big_problem
    band = config.bundle.band_halfwidth
    assert tb.max_pair_offset(prob.meas_kf, prob.meas_valid) <= band
    res = tb.bundle_adjust(prob, cam, max_iters=3, solver="chol",
                           assembly="band", band_halfwidth=band,
                           point_block=2048)
    assert _rms(prob, cam, res) < 0.45


@pytest.mark.slow
def test_96kf_pcg_matches_dense():
    config, prob, cam = _small_problem(6, 96, 4000)
    res_p = tb.bundle_adjust(prob, cam, max_iters=3, solver="pcg",
                             cg_iters=400, cg_tol=1e-9)
    res_c = tb.bundle_adjust(prob, cam, max_iters=3, solver="chol",
                             assembly="scatter", point_block=1024)
    assert abs(_rms(prob, cam, res_p) - _rms(prob, cam, res_c)) < 0.05


@pytest.mark.slow
def test_96kf_band_pcg_matches_band_chol():
    config, prob, cam = _small_problem(3, 96, 4000)
    res_c = tb.bundle_adjust(prob, cam, max_iters=3, solver="chol",
                             assembly="band", band_halfwidth=16,
                             point_block=1024)
    res_p = tb.bundle_adjust(prob, cam, max_iters=3, solver="band_pcg",
                             band_halfwidth=16, point_block=1024,
                             cg_iters=300, cg_tol=1e-7)
    assert int(res_p.accepted) >= 1
    assert abs(_rms(prob, cam, res_p) - _rms(prob, cam, res_c)) < 0.05
    np.testing.assert_allclose(res_p.cam_t.numpy(), res_c.cam_t.numpy(),
                               rtol=0, atol=5e-2)


@pytest.mark.slow
def test_64kf_hist_sigma_matches_exact_sigma():
    config, prob, cam = _small_problem(4, 64, 3000)
    kw = dict(max_iters=3, solver="band_pcg", band_halfwidth=16,
              point_block=1024, cg_iters=300, cg_tol=1e-7)
    res_g = tb.bundle_adjust(prob, cam, sigma_mode="gather", **kw)
    res_h = tb.bundle_adjust(prob, cam, sigma_mode="hist", **kw)
    assert abs(_rms(prob, cam, res_h) - _rms(prob, cam, res_g)) < 0.05


def _slow_config():
    """tests/test_drift.py's and tests/test_real_texture.py's config."""
    return SLAMConfig(
        tracker=TrackerConfig(width=320, height=240, max_map_points=512,
                              max_corners_per_level=(256, 128, 64, 32),
                              min_frames_between_kfs=6),
        mapmaker=MapMakerConfig(max_keyframes=12, max_epi_candidates=128),
    )


def drift_pose(base_R, base_t, k):
    """tests/test_drift.py's back-and-forth sweep with pan."""
    s = k / 100.0
    mu = torch.tensor([0.45 * np.sin(1.5708 * s), 0.06 * np.sin(2.2 * s),
                       0.04 * np.sin(1.3 * s), 0.02 * np.sin(1.7 * s),
                       0.10 * np.sin(1.5708 * s), 0.03 * np.sin(0.9 * s)],
                      dtype=torch.float32)
    return tlie.se3_mul(*tlie.se3_exp(mu), base_R, base_t)


def photo_pose(base_R, base_t, k):
    """tests/test_real_texture.py's path."""
    s = k / 40.0
    mu = torch.tensor([0.30 * np.sin(1.2 * s), 0.05 * np.sin(2.1 * s),
                       0.05 * np.sin(0.9 * s), 0.02 * np.sin(1.4 * s),
                       0.08 * np.sin(1.2 * s), 0.02 * np.sin(0.8 * s)],
                      dtype=torch.float32)
    return tlie.se3_mul(*tlie.se3_exp(mu), base_R, base_t)


def _ate(results, gt, first):
    est = tate.camera_centers([r.pose_R for r in results[first:]],
                              [r.pose_t for r in results[first:]])
    gtc = tate.camera_centers([g[0] for g in gt[first:]],
                              [g[1] for g in gt[first:]])
    rmse, _ = tate.ate_rmse(est, gtc)
    span = float(np.linalg.norm(gtc.max(0) - gtc.min(0)))
    return est, gtc, rmse, span


@pytest.fixture(scope="module")
def drift_run():
    rng = np.random.default_rng(21)
    config = _slow_config()
    scene = tsyn.make_planar_scene(rng, depth=4.0, px_per_m=140.0,
                                   device="cpu")
    base_R, base_t = tsyn.look_at_pose((0.0, 0.0, 0.0), device="cpu")
    sys_ = tslam.SLAMSystem(config, seed=3, device="cpu")
    results, gt = [], []
    for k in range(200):
        R, t = drift_pose(base_R, base_t, k)
        img = tsyn.render(scene, sys_.cam, R, t, (240, 320))
        if k in (0, 6):
            sys_.on_touch()
        results.append(sys_.track_frame(img))
        gt.append((R.numpy(), t.numpy()))
    return sys_, results, gt


@pytest.mark.slow
def test_drift_never_lost_over_200_frames(drift_run):
    sys_, results, gt = drift_run
    phases = [r.phase for r in results]
    first = phases.index(tslam.PHASE_TRACKING)
    assert first <= 8
    tracked = results[first:]
    assert all(not r.lost for r in tracked)
    assert sum(r.quality == 0 for r in tracked) == 0


@pytest.mark.slow
def test_drift_ate_bounded_over_200_frames(drift_run):
    sys_, results, gt = drift_run
    first = [r.phase for r in results].index(tslam.PHASE_TRACKING)
    est, gtc, rmse, span = _ate(results, gt, first)
    assert rmse < 0.025 * span
    s, Ra, ta = tate.umeyama_alignment(est, gtc)
    err = np.linalg.norm((s * (Ra @ est.T)).T + ta - gtc, axis=-1)
    q = len(err) // 4
    early, late = np.median(err[:q]), np.median(err[-q:])
    assert late < 3.0 * max(early, 0.002), (early, late)


@pytest.mark.slow
def test_drift_map_stays_healthy(drift_run):
    sys_, results, gt = drift_run
    first = [r.phase for r in results].index(tslam.PHASE_TRACKING)
    counts = [r.n_points for r in results[first:]]
    assert counts[-1] > 0.5 * max(counts)
    assert results[-1].n_keyframes >= 4
    assert int(sys_.slam_map.meas.count()) > results[-1].n_points
    assert np.median([r.n_found for r in results[-40:]]) > 60


@pytest.fixture(scope="module")
def photo_run():
    rng = np.random.default_rng(13)
    scene = tsyn.make_photo_scene(depth=4.0, px_per_m=200.0, device="cpu")
    base_R, base_t = tsyn.look_at_pose((0.0, 0.0, 0.0), device="cpu")
    sys_ = tslam.SLAMSystem(_slow_config(), seed=9, device="cpu")
    results, gt = [], []
    for k in range(80):
        R, t = photo_pose(base_R, base_t, k)
        img = tsyn.render(scene, sys_.cam, R, t, (240, 320))
        img = tsyn.apply_sensor_effects(
            img, rng, exposure_gain=1.0 + 0.10 * np.sin(k / 9.0),
            exposure_bias=4.0 * np.sin(k / 5.0), noise_std=2.0,
            blur_sigma=0.8 if k % 7 == 3 else 0.0)
        if k in (0, 8):
            sys_.on_touch()
        results.append(sys_.track_frame(img))
        gt.append((R.numpy(), t.numpy()))
    return sys_, results, gt


@pytest.mark.slow
def test_photo_tracks_and_maps(photo_run):
    """tests/test_real_texture.py's bounds: tracking by frame 12, never
    lost, no BAD frame, >= 3 keyframes, > 100 points; and the ATE under
    7.5% of the span, not that file's 4.5%: the JAX package itself reads
    6.10% on these frames on the CPU (its test fails there; ROADMAP queue 3,
    reference fault j), the port 6.08-6.30% over four facade seeds."""
    sys_, results, gt = photo_run
    phases = [r.phase for r in results]
    first = phases.index(tslam.PHASE_TRACKING)
    assert first <= 12
    tracked = results[first:]
    assert all(not r.lost for r in tracked)
    assert sum(r.quality == 0 for r in tracked) == 0
    _, _, rmse, span = _ate(results, gt, first)
    assert rmse < 0.075 * span, (rmse, span)
    assert results[-1].n_keyframes >= 3 and results[-1].n_points > 100


@pytest.mark.slow
def test_run_slam_side_by_side_on_the_same_files(tmp_path):
    """ROADMAP queue 3 x: tools/make_tum_synthetic.py's clean 640x480,
    120-frame sequence, written once, through the JAX package's run_slam
    and the port's at the default preset, both on the CPU. Tolerances: the
    same tracked count within 2 frames, keyframes within 1, map points
    within 10%, both ATEs under 2% of the span, the port's within 20% of
    the JAX package's (the packages' random draws differ: on the four
    variants of artifacts/ATE_r5.json the two ATEs were 0-6% apart)."""
    from visualslam_android_tpu_torch import run_slam as trun

    root = str(tmp_path / "clean_640x480")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, TOOL, "--out", root, "--frames", "120"],
                   check=True, env=env, cwd=REPO, capture_output=True)
    args = ["--dataset", "tum", "--root", root, "--frames", "120", "--json"]
    out = subprocess.run(
        [sys.executable, "-m", "visualslam_android_tpu.run_slam", *args,
         "--platform", "cpu", "--sync"],
        check=True, env=env, cwd=REPO, capture_output=True, text=True)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got, _ = trun.main([*args, "--device", "cpu"])
    gt = np.loadtxt(os.path.join(root, "groundtruth.txt"))[:, 1:4]
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    assert abs(got["tracked"] - want["tracked"]) <= 2, (got, want)
    assert abs(got["keyframes"] - want["keyframes"]) <= 1, (got, want)
    assert abs(got["map_points"] - want["map_points"]) <= (
        0.1 * want["map_points"]), (got, want)
    assert max(got["ate_rmse"], want["ate_rmse"]) < 0.02 * span
    assert abs(got["ate_rmse"] - want["ate_rmse"]) < 0.2 * want["ate_rmse"], (
        got, want)
