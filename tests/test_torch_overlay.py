"""Parity of the port's overlays and camera.gl_frustum with the JAX package
on the CPU: the same numpy inputs through both, images compared within
1e-6 (one division of f32 sums of at most a few colours per pixel) and the
frustum within rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.config import CameraConfig
from visualslam_android_tpu.ops import camera as jcam
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu.utils import overlay as jov
from visualslam_android_tpu_torch.ops import camera as tcam
from visualslam_android_tpu_torch.utils import overlay as tov

H, W = 60, 80
ATOL = 1e-6


def _same(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    M = 40
    return dict(
        grey=rng.uniform(0, 255, (H, W)).astype(np.float32),
        rgb=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        # Some dots off the image and some half-way between pixels.
        xy=np.concatenate([rng.uniform(-5, 85, (M - 2, 2)),
                           [[10.5, 20.5], [11.5, 20.5]]]).astype(np.float32),
        xy2=rng.uniform(0, 79, (M, 2)).astype(np.float32),
        colors=rng.uniform(0, 1, (M, 3)).astype(np.float32),
        mask=rng.uniform(size=M) < 0.8,
        level=rng.integers(-1, 5, M).astype(np.int32),
        gray=rng.uniform(-20, 280, M).astype(np.float32),
        corner_mask=rng.uniform(size=(H, W)) < 0.05,
    )


def _pair(x):
    return jnp.asarray(x), torch.as_tensor(x)


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_draw_dots_matches_jax(inputs, radius):
    ji, ti = _pair(inputs["rgb"])
    args = [inputs[k] for k in ("xy", "colors", "mask")]
    _same(tov.draw_dots(ti, *(torch.as_tensor(a) for a in args),
                        radius=radius),
          jov.draw_dots(ji, *(jnp.asarray(a) for a in args), radius=radius))


def test_segments_trails_and_corners_match_jax(inputs):
    ji, ti = _pair(inputs["grey"])
    p0, p1, m = inputs["xy"], inputs["xy2"], inputs["mask"]
    _same(tov.draw_segments(tov._ensure_rgb(ti), torch.as_tensor(p0),
                            torch.as_tensor(p1),
                            torch.as_tensor(inputs["colors"]),
                            torch.as_tensor(m), samples=33, thickness=2),
          jov.draw_segments(jov._ensure_rgb(ji), p0, p1, inputs["colors"], m,
                            samples=33, thickness=2))
    _same(tov.draw_trails(ti, torch.as_tensor(p0), torch.as_tensor(p1),
                          torch.as_tensor(m)),
          jov.draw_trails(ji, jnp.asarray(p0), jnp.asarray(p1),
                          jnp.asarray(m)))
    _same(tov.draw_fast_corners(ti, torch.as_tensor(p1), torch.as_tensor(m)),
          jov.draw_fast_corners(ji, jnp.asarray(p1), jnp.asarray(m)))
    _same(tov.draw_corner_mask(ti, torch.as_tensor(inputs["corner_mask"])),
          jov.draw_corner_mask(ji, jnp.asarray(inputs["corner_mask"])))


def test_points_by_level_and_grey_match_jax(inputs):
    ji, ti = _pair(inputs["rgb"])
    p, m = inputs["xy2"], inputs["mask"]
    _same(tov.draw_found_points(ti, torch.as_tensor(p),
                                torch.as_tensor(inputs["level"]),
                                torch.as_tensor(m)),
          jov.draw_found_points(ji, jnp.asarray(p),
                                jnp.asarray(inputs["level"]),
                                jnp.asarray(m)))
    _same(tov.draw_map_points_colored(ti, torch.as_tensor(p),
                                      torch.as_tensor(inputs["gray"]),
                                      torch.as_tensor(m), radius=1),
          jov.draw_map_points_colored(ji, jnp.asarray(p),
                                      jnp.asarray(inputs["gray"]),
                                      jnp.asarray(m), radius=1))
    np.testing.assert_array_equal(np.asarray(tov.LEVEL_COLORS, np.float32),
                                  jov.LEVEL_COLORS)


def _cameras(w, h):
    jc = jcam.make_camera(CameraConfig().params(), w, h)
    tc = tcam.make_camera(CameraConfig().params(), w, h, device="cpu")
    return jc, tc


def test_render_grid_matches_jax(inputs):
    """The ground grid through a pose that sees it, as both render it: the
    same pixels painted (the projected lattice agrees to f32 rounding, so
    a stamp may round to the next pixel at a few of them: at most 0.5% of
    the pixels differ), and most of them black."""
    jc, tc = _cameras(W, H)
    mu = np.array([0.02, -0.03, 1.5, 0.1, -0.15, 0.2], np.float32)
    R, t = (np.array(a) for a in jlie.se3_exp(jnp.asarray(mu)))
    ji, ti = _pair(inputs["rgb"])
    j = np.asarray(jov.render_grid(ji, jc, jnp.asarray(R), jnp.asarray(t)))
    t_out = tov.render_grid(ti, tc, torch.as_tensor(R),
                            torch.as_tensor(t)).numpy()
    black_j = (j == 0).all(-1)
    black_t = (t_out == 0).all(-1)
    assert black_j.sum() > 100
    assert (black_j != black_t).mean() <= 0.005
    both = ~(black_j | black_t)
    np.testing.assert_allclose(t_out[both], j[both], atol=ATOL)


@pytest.mark.parametrize("size,near,far", [((640, 480), 0.01, 100.0),
                                           ((800, 480), 0.1, 50.0)])
def test_gl_frustum_matches_jax(size, near, far):
    jc, tc = _cameras(*size)
    np.testing.assert_allclose(tcam.gl_frustum(tc, near, far).numpy(),
                               np.asarray(jcam.gl_frustum(jc, near, far)),
                               rtol=1e-6, atol=1e-7)
