"""Parity of the PyTorch port's math and image ops with the JAX package.

Every input is made with numpy from a seed and fed to the JAX function (on
the CPU) and to its torch counterpart. Tolerance: atol 1e-5 (f32 math in
another evaluation order); 1e-4 for ESM alignment and Gaussian blur, whose
outputs sum many terms of magnitude up to 255; for outputs far above 1
(projection Jacobians ~270, Shi-Tomasi scores ~1e4) a few f32 ulp of
their magnitude instead.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu import config as jconfig
from visualslam_android_tpu.ops import camera as jcam
from visualslam_android_tpu.ops import image as jimg
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu.ops import mestimator as jme
from visualslam_android_tpu.ops import sbi as jsbi
from visualslam_android_tpu.ops import wls as jwls
from visualslam_android_tpu.utils import fixtures as jfix
from visualslam_android_tpu_torch import config as tconfig
from visualslam_android_tpu_torch.ops import camera as tcam
from visualslam_android_tpu_torch.ops import image as timg
from visualslam_android_tpu_torch.ops import levels as tlevels
from visualslam_android_tpu_torch.ops import lie as tlie
from visualslam_android_tpu_torch.ops import mestimator as tme
from visualslam_android_tpu_torch.ops import sbi as tsbi
from visualslam_android_tpu_torch.ops import wls as twls
from visualslam_android_tpu_torch.utils import fixtures as tfix

torch.set_num_threads(2)

ATOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=atol)


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("name", ["default", "small", "full"])
def test_config_matches(name):
    make = {
        "default": (jconfig.SLAMConfig, tconfig.SLAMConfig),
        "small": (jfix.small_config, tfix.small_config),
        "full": (jfix.full_config, tfix.full_config),
    }[name]
    assert dataclasses.asdict(make[0]()) == dataclasses.asdict(make[1]())


# ---------------------------------------------------------------- lie


def _rot_vectors(rng, n=64):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[:8] *= 1e-5          # Taylor branches
    w[8:16] /= np.linalg.norm(w[8:16], axis=-1, keepdims=True)
    w[8:16] *= 3.1         # near pi
    return w


def _twists(rng, n=64):
    return np.concatenate(
        [rng.normal(size=(n, 3)), _rot_vectors(rng, n)], axis=-1
    ).astype(np.float32)


LIE_CASES = ["so3_exp", "so3_ln", "se3_exp", "se3_ln", "se3_mul",
             "se3_inverse", "se2_exp", "se2_ln", "generator_field"]


@pytest.mark.parametrize("case", LIE_CASES)
def test_lie(case):
    rng = np.random.default_rng(1)
    if case == "so3_exp":
        w = _rot_vectors(rng)
        _close(jlie.so3_exp(w), tlie.so3_exp(_t(w)))
    elif case == "so3_ln":
        R = np.asarray(jlie.so3_exp(_rot_vectors(rng)))
        _close(jlie.so3_ln(R), tlie.so3_ln(_t(R)))
    elif case == "se3_exp":
        mu = _twists(rng)
        for j, t in zip(jlie.se3_exp(mu), tlie.se3_exp(_t(mu))):
            _close(j, t)
    elif case == "se3_ln":
        mu = _twists(rng) * np.float32(0.5)
        R, t = (np.asarray(a) for a in jlie.se3_exp(mu))
        _close(jlie.se3_ln(R, t), tlie.se3_ln(_t(R), _t(t)))
    elif case in ("se3_mul", "se3_inverse"):
        Ra, ta = (np.asarray(a) for a in jlie.se3_exp(_twists(rng)))
        Rb, tb = (np.asarray(a) for a in jlie.se3_exp(_twists(rng)))
        if case == "se3_mul":
            pairs = zip(jlie.se3_mul(Ra, ta, Rb, tb),
                        tlie.se3_mul(_t(Ra), _t(ta), _t(Rb), _t(tb)))
        else:
            pairs = zip(jlie.se3_inverse(Ra, ta),
                        tlie.se3_inverse(_t(Ra), _t(ta)))
        for j, t in pairs:
            _close(j, t)
    elif case == "se2_exp":
        mu = rng.normal(size=(64, 3)).astype(np.float32)
        mu[:8, 2] *= 1e-7
        for j, t in zip(jlie.se2_exp(mu), tlie.se2_exp(_t(mu))):
            _close(j, t)
    elif case == "se2_ln":
        mu = rng.normal(size=(64, 3)).astype(np.float32)
        R, t = (np.asarray(a) for a in jlie.se2_exp(mu))
        _close(jlie.se2_ln(R, t), tlie.se2_ln(_t(R), _t(t)))
    else:
        pos = rng.normal(size=(16, 4)).astype(np.float32)
        for i in range(6):
            _close(jlie.se3_generator_field(pos, i),
                   tlie.se3_generator_field(_t(pos), i))


# ---------------------------------------------------------------- camera


def _cameras():
    p = jconfig.CameraConfig().params()
    return (jcam.make_camera(p, 320, 240),
            tcam.make_camera(p, 320, 240, device="cpu"))


CAMERA_CASES = ["make_camera", "scale_camera", "project", "unproject",
                "project_derivs", "largest_radius", "levels"]


@pytest.mark.parametrize("case", CAMERA_CASES)
def test_camera(case):
    rng = np.random.default_rng(2)
    jc, tc = _cameras()
    m = rng.uniform(-0.8, 0.8, size=(128, 2)).astype(np.float32)
    m[:4] = 0.0  # r -> 0 branch
    if case == "make_camera":
        for f in dataclasses.fields(tc):
            _close(getattr(jc, f.name), getattr(tc, f.name))
    elif case == "scale_camera":
        js, ts = jcam.scale_camera(jc, 0.0625), tcam.scale_camera(tc, 0.0625)
        for f in dataclasses.fields(ts):
            _close(getattr(js, f.name), getattr(ts, f.name))
    elif case == "project":
        _close(jcam.project(jc, m), tcam.project(tc, _t(m)))
    elif case == "unproject":
        px = rng.uniform(-20, 340, size=(128, 2)).astype(np.float32)
        _close(jcam.unproject(jc, px), tcam.unproject(tc, _t(px)))
    elif case == "project_derivs":
        jpx, jd = jcam.project_derivs(jc, m)
        tpx, td = tcam.project_derivs(tc, _t(m))
        _close(jpx, tpx)
        # The diagonal is ~ focal (270 px), where one f32 ulp is 3e-5; the
        # off-diagonal terms carry errors of that size: a few ulp of 270.
        _close(jd, td, atol=1e-4)
    elif case == "largest_radius":
        _close(jcam.largest_radius_in_image(jc),
               tcam.largest_radius_in_image(tc))
    else:
        from visualslam_android_tpu.ops import levels as jlevels

        pos = rng.uniform(0, 300, size=(32, 2)).astype(np.float32)
        for lvl in range(4):
            _close(jlevels.level_zero_pos(pos, lvl),
                   tlevels.level_zero_pos(_t(pos), lvl))
            _close(jlevels.level_n_pos(pos, lvl),
                   tlevels.level_n_pos(_t(pos), lvl))


# ---------------------------------------------------------------- mestimator


@pytest.mark.parametrize("n_valid", [0, 1, 2, 7, 64, 200])
def test_tukey_sigma_and_weight(n_valid):
    rng = np.random.default_rng(3)
    err_sq = rng.exponential(4.0, size=200).astype(np.float32)
    mask = np.zeros(200, bool)
    mask[rng.permutation(200)[:n_valid]] = True
    js = jme.find_sigma_squared(err_sq, mask, jme.TUKEY)
    ts = tme.find_sigma_squared(_t(err_sq), _t(mask), tme.TUKEY)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-6)
    sigma = np.float32(max(float(js), 1e-12))
    _close(jme.weight(err_sq, sigma, jme.TUKEY),
           tme.weight(_t(err_sq), torch.tensor(sigma), tme.TUKEY))


def test_inv3x3():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, -1, -2) + 3 * np.eye(3, dtype=np.float32)
    _close(jwls.inv3x3(A), twls.inv3x3(_t(A)))


# ---------------------------------------------------------------- image


def _image(rng, h=48, w=64):
    return rng.uniform(0, 255, size=(h, w)).astype(np.float32)


IMAGE_CASES = ["half_sample", "make_pyramid", "bilinear_sample",
               "patch_grid", "shi_tomasi_dense", "gaussian_blur"]


@pytest.mark.parametrize("case", IMAGE_CASES)
def test_image(case):
    rng = np.random.default_rng(5)
    img = _image(rng)
    if case == "half_sample":
        _close(jimg.half_sample(img), timg.half_sample(_t(img)))
    elif case == "make_pyramid":
        for j, t in zip(jimg.make_pyramid(img, 4),
                        timg.make_pyramid(_t(img), 4)):
            _close(j, t)
    elif case == "bilinear_sample":
        xy = rng.uniform(-3, 70, size=(200, 2)).astype(np.float32)
        _close(jimg.bilinear_sample(img, xy),
               timg.bilinear_sample(_t(img), _t(xy)))
    elif case == "patch_grid":
        _close(jimg.patch_grid(5), timg.patch_grid(5, device="cpu"), atol=0)
    elif case == "shi_tomasi_dense":
        # Box sums of squared gradients reach ~1e6 (scores ~1e4), summed
        # in another order: 1e-5 relative.
        j = np.asarray(jimg.shi_tomasi_dense(img, 3))
        t = timg.shi_tomasi_dense(_t(img), 3).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=ATOL)
    else:
        _close(jimg.gaussian_blur(img, 1.0),
               timg.gaussian_blur(_t(img), 1.0), atol=1e-4)
        _close(jimg.gaussian_blur(img, 0.75),
               timg.gaussian_blur(_t(img), 0.75), atol=1e-4)


# ---------------------------------------------------------------- sbi


def _level3(rng, h=60, w=100):
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    return np.asarray(jimg.gaussian_blur(jnp.asarray(img), 2.0))


@pytest.mark.parametrize("case", ["make_sbi", "esm_align", "se3_from_se2"])
def test_sbi(case):
    rng = np.random.default_rng(6)
    lvl3 = _level3(rng)
    js = jsbi.make_sbi(lvl3, 0.75)
    ts = tsbi.make_sbi(_t(lvl3), 0.75)
    if case == "make_sbi":
        _close(js.template, ts.template)
        _close(js.jacs, ts.jacs)
        return
    # A shifted, rotated view of the same image to align against.
    jc, tc = _cameras()
    R2, t2 = jlie.se2_exp(jnp.asarray([1.5, -1.0, 0.05], jnp.float32))
    h, w = lvl3.shape
    ys, xs = np.mgrid[0:h, 0:w]
    grid = np.stack([xs, ys], -1).astype(np.float32)
    src = np.einsum("ij,hwj->hwi", np.asarray(R2), grid) + np.asarray(t2)
    moved = np.asarray(jimg.bilinear_sample(lvl3, src))
    cur = jsbi.make_sbi(moved, 0.75).template
    target_np = tsbi.SBI(template=_t(js.template), jacs=_t(js.jacs))
    j_se2, j_score = jsbi.esm_align(cur, js, 6)
    t_se2, t_score = tsbi.esm_align(_t(cur), target_np, 6)
    if case == "esm_align":
        _close(j_se2, t_se2, atol=1e-4)
        np.testing.assert_allclose(_np(t_score), _np(j_score), rtol=1e-4)
    else:
        se2 = np.asarray(j_se2)
        jR, jt = jsbi.se3_from_se2(jnp.asarray(se2), jc, cur.shape)
        tR, tt = tsbi.se3_from_se2(_t(se2), tc, cur.shape)
        _close(jR, tR)
        _close(jt, tt)


def test_constructors_build_on_the_card_unless_told():
    """Every state constructor takes device=None and resolves it to the
    CUDA card; without one it raises and says to pass device="cpu". It
    never carries on on the CPU unasked. device="cpu" builds there. The
    multi-device entry points (parallel/mesh.init_mesh, run_ranks) put
    their ranks on the card the same way, and raise before any process
    group or rank starts."""
    import inspect

    from visualslam_android_tpu_torch.models import map_store as tms
    from visualslam_android_tpu_torch.parallel import mesh as tmesh
    from visualslam_android_tpu_torch.parallel import rank_programs
    from visualslam_android_tpu_torch.parallel import replicated_tracking
    from visualslam_android_tpu_torch.utils import convert
    from visualslam_android_tpu_torch.utils import fixtures as tfix
    from visualslam_android_tpu_torch.utils import synthetic as tsyn
    from visualslam_android_tpu_torch.utils import tensors

    cfg = tfix.small_config()
    rng = np.random.default_rng(0)
    calls = [
        lambda **kw: tms.empty_map(cfg, **kw),
        lambda **kw: tcam.make_camera(cfg.camera.params(), 320, 240, **kw),
        lambda **kw: timg.patch_grid(2, **kw),
        lambda **kw: tsyn.look_at_pose((0.0, 0.0, 0.0), **kw),
        lambda **kw: tsyn.make_planar_scene(rng, tex_size=64, n_blobs=3, **kw),
        lambda **kw: tfix.build_fixed_map(cfg, rng, **kw),
        lambda **kw: convert.camera_from_numpy(
            tcam.make_camera(cfg.camera.params(), 320, 240, device="cpu"),
            **kw),
        lambda **kw: replicated_tracking.init_streams(
            2, np.eye(3), np.zeros(3), cfg, **kw),
        lambda **kw: tlie.se3_identity((2,), **kw),
        lambda **kw: tfix.build_band_ba_map(rng, n_kf=4, n_pts=8, **kw),
        lambda **kw: tsyn.random_structure(rng, 4, **kw),
        lambda **kw: tsyn.make_photo_scene(tile=1, **kw),
        lambda **kw: tmesh.init_mesh("gloo", 0, 1, "file:///nonexistent",
                                     "host", **kw),
        lambda **kw: tmesh.run_ranks(rank_programs.run_cases, 1, "gloo",
                                     "host", args=([],), **kw),
    ]
    functions = [tms.empty_map, tcam.make_camera, timg.patch_grid,
                 tsyn.look_at_pose, tsyn.make_planar_scene,
                 tfix.build_fixed_map, replicated_tracking.init_streams,
                 tlie.se3_identity, tfix.build_band_ba_map,
                 tsyn.random_structure, tsyn.make_photo_scene,
                 tmesh.init_mesh, tmesh.run_ranks] + [
        getattr(convert, n) for n in dir(convert) if n.endswith("_from_numpy")]
    assert len(functions) == 13 + 11
    for fn in functions:
        assert inspect.signature(fn).parameters["device"].default is None, fn
    if torch.cuda.is_available():
        assert tensors.default_device().type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
    assert tensors.default_device("cpu") == torch.device("cpu")
    assert tms.empty_map(cfg, device="cpu").points.valid.device.type == "cpu"
    assert timg.patch_grid(2, device="cpu").shape == (25, 2)
