"""Parity of the port's small helpers with the JAX package's: the image
border test and affine patch warp, the measurement-table slot helpers,
the corner count and the SE(3) / SE(2) utilities.

Every input is made with numpy from a seed and fed to both functions.
Tolerances: integer and boolean results equal; the warped patch within
atol 1e-4 (bilinear blends of grey levels up to 255 in f32); the Lie
utilities within atol 1e-6 (one matrix product of unit-scale f32 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.models import map_store as jms
from visualslam_android_tpu.ops import fast as jfast
from visualslam_android_tpu.ops import image as jimg
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu_torch.models import map_store as tms
from visualslam_android_tpu_torch.ops import fast as tfast
from visualslam_android_tpu_torch.ops import image as timg
from visualslam_android_tpu_torch.ops import lie as tlie

torch.set_num_threads(2)

PATCH_ATOL = 1e-4
LIE_ATOL = 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


def _rotations(rng, n):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    return np.asarray(jlie.so3_exp(jnp.asarray(w)))


@pytest.mark.parametrize("border", [0, 3, 10])
def test_in_image_with_border(border):
    rng = np.random.default_rng(border)
    xy = rng.uniform(-5, 70, size=(200, 2)).astype(np.float32)
    want = np.asarray(jimg.in_image_with_border((48, 64), jnp.asarray(xy),
                                                border))
    got = timg.in_image_with_border((48, 64), _t(xy), border).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["identity", "rotated", "edge", "batched"])
def test_affine_warp_patch(case):
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, size=(48, 64)).astype(np.float32)
    if case == "batched":
        # The JAX function is one patch, batched by vmap; the port's takes
        # leading axes itself.
        M = rng.normal(size=(5, 2, 2)).astype(np.float32)
        c = rng.uniform(0, 64, size=(5, 2)).astype(np.float32)
        jp, jn = jax.vmap(
            lambda m, cc: jimg.affine_warp_patch(jnp.asarray(img), m, cc, 4,
                                                 -7.0)
        )(jnp.asarray(M), jnp.asarray(c))
    else:
        M = {"identity": np.eye(2), "rotated": [[0.8, -0.7], [0.6, 0.9]],
             "edge": np.eye(2)}[case]
        M = np.asarray(M, np.float32)
        c = np.asarray([2.0, 45.5] if case == "edge" else [30.3, 20.7],
                       np.float32)
        jp, jn = jimg.affine_warp_patch(jnp.asarray(img), jnp.asarray(M),
                                        jnp.asarray(c), 4, -7.0)
    tp, tn = timg.affine_warp_patch(_t(img), _t(M), _t(c), 4, -7.0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=PATCH_ATOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    if case in ("edge", "batched"):
        assert int(np.asarray(jn).sum()) > 0


def _meas(rng, N=6, O=4):
    valid = np.zeros((N, O), bool)
    for p in range(N):
        valid[p, rng.permutation(O)[:p % (O + 1)]] = True
    valid[N - 1] = True  # a full row
    return dict(
        kf=rng.integers(0, 8, (N, O)).astype(np.int32),
        uv=rng.uniform(0, 100, (N, O, 2)).astype(np.float32),
        level=rng.integers(0, 4, (N, O)).astype(np.int32),
        source=rng.integers(0, 5, (N, O)).astype(np.int32),
        subpix=rng.random((N, O)) < 0.5, valid=valid,
    )


@pytest.mark.parametrize("point", range(6))
def test_first_free_slot(point):
    valid = _meas(np.random.default_rng(1))["valid"][point]
    want = int(jms.first_free_slot(jnp.asarray(valid)))
    assert int(tms.first_free_slot(_t(valid))) == want


@pytest.mark.parametrize("point", [0, 2, 3, 5])
def test_add_measurement(point):
    arrays = _meas(np.random.default_rng(2))
    args = (point, 7, np.asarray([12.5, 40.25], np.float32), 2, 3, True)
    jm = jms.add_measurement(jms.MeasStore(**{k: jnp.asarray(v) for k, v in
                                              arrays.items()}),
                             *[jnp.asarray(a) for a in args])
    before = tms.MeasStore(**{k: _t(v) for k, v in arrays.items()})
    tm = tms.add_measurement(before, *[_t(a) for a in args])
    for name in arrays:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
        # The input store is left as it was.
        np.testing.assert_array_equal(getattr(before, name).numpy(),
                                      arrays[name])


@pytest.mark.parametrize("shape", [(48, 64), (3, 12, 16)])
def test_corner_count(shape):
    mask = np.random.default_rng(3).random(shape) < 0.1
    want = jfast.corner_count(jnp.asarray(mask))
    got = tfast.corner_count(_t(mask))
    assert got.dtype == torch.int32 and int(got) == int(want)


@pytest.mark.parametrize("name", ["se3_apply", "se3_identity", "se3_matrix",
                                  "se3_unstack", "se2_inverse"])
def test_lie_helpers(name):
    rng = np.random.default_rng(9)
    R = _rotations(rng, 5)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    if name == "se3_apply":
        x = rng.normal(size=(5, 3)).astype(np.float32)
        want = (jlie.se3_apply(R, t, x),)
        got = (tlie.se3_apply(_t(R), _t(t), _t(x)),)
    elif name == "se3_identity":
        want = jlie.se3_identity((2, 3)) + jlie.se3_identity()
        got = (tlie.se3_identity((2, 3), device="cpu")
               + tlie.se3_identity(device="cpu"))
    elif name == "se3_matrix":
        want = (jlie.se3_matrix(R, t),)
        got = (tlie.se3_matrix(_t(R), _t(t)),)
    elif name == "se3_unstack":
        T = np.concatenate([R, t[..., None]], axis=-1)
        want = jlie.se3_unstack(T)
        got = tlie.se3_unstack(_t(T))
    else:
        th = rng.uniform(-3, 3, size=5).astype(np.float32)
        R2 = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                       np.stack([np.sin(th), np.cos(th)], -1)], -2)
        want = jlie.se2_inverse(R2, t[:, :2])
        got = tlie.se2_inverse(_t(R2), _t(t[:, :2]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LIE_ATOL)
