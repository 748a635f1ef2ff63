"""Parity of the port's relocalizer with the JAX package on the CPU: the
SmallBlurryImage scores (zmssd, score_against_all) and attempt_recovery.

The inputs are made once with the JAX package from a seed: a planar scene
(320x240) rendered from four keyframe poses along a sideways path, whose
SBIs fill keyframe slots 0-3 of a six-slot map, and from query poses near
each keyframe, turned and shifted a little; the same numpy arrays go to
both packages.

Tolerances: the scores rtol 1e-5 (sums of ~300 squares in another order);
attempt_recovery's best keyframe and success equal, its ESM score rtol
1e-4 and its pose (R entries, t) within 1e-4 (six ESM iterations and three
rotation-lift iterations in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.config import MapMakerConfig
from visualslam_android_tpu.models import map_store as jms
from visualslam_android_tpu.models import relocalizer as jrel
from visualslam_android_tpu.ops import camera as jcam
from visualslam_android_tpu.ops import image as jimg
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu.ops import sbi as jsbi
from visualslam_android_tpu.utils import fixtures as jfix
from visualslam_android_tpu.utils import synthetic as jsyn
from visualslam_android_tpu_torch.models import relocalizer as trel
from visualslam_android_tpu_torch.ops import sbi as tsbi
from visualslam_android_tpu_torch.utils import convert

torch.set_num_threads(2)

N_KF = 4
QUERIES = (  # (keyframe the query is near, extra motion mu)
    (0, (0.01, 0.0, 0.0, 0.0, 0.0, 0.02)),
    (1, (-0.02, 0.01, 0.0, 0.01, 0.0, -0.015)),
    (2, (0.0, -0.01, 0.02, 0.0, 0.01, 0.03)),
    (3, (0.015, 0.0, 0.0, -0.01, 0.0, 0.0)),
)


def _np(x):
    return jax.tree.map(np.array, x)  # writable copies


def _kf_mu(k):
    return np.array([0.15 * k, 0.02 * k, 0.0, 0.0, 0.04 * k, 0.0], np.float32)


def _sbi_at(scene, cam, R, t, shape):
    img = jsyn.render(scene, cam, R, t, shape)
    return jsbi.make_sbi(jimg.make_pyramid(img, 4)[-1])


@pytest.fixture(scope="module")
def case():
    cfg = jfix.small_config()
    cfg = cfg.__class__(tracker=cfg.tracker,
                        mapmaker=MapMakerConfig(max_keyframes=6))
    tc = cfg.tracker
    shape = (tc.height, tc.width)
    cam = jcam.make_camera(cfg.camera.params(), tc.width, tc.height)
    scene = jsyn.make_planar_scene(np.random.default_rng(5), depth=4.0,
                                   px_per_m=140.0)
    R0, t0 = jsyn.look_at_pose((0.0, 0.0, 0.0))
    sm = _np(jms.empty_map(cfg))
    kfs = sm.keyframes
    valid, R, t = kfs.valid.copy(), kfs.R.copy(), kfs.t.copy()
    tmpl, jacs = kfs.sbi_template.copy(), kfs.sbi_jacs.copy()
    for k in range(N_KF):
        Rk, tk = jlie.se3_mul(*jlie.se3_exp(jnp.asarray(_kf_mu(k))), R0, t0)
        s = _np(_sbi_at(scene, cam, Rk, tk, shape))
        valid[k], R[k], t[k] = True, np.asarray(Rk), np.asarray(tk)
        tmpl[k], jacs[k] = s.template, s.jacs
    sm = sm._replace(keyframes=kfs._replace(
        valid=valid, R=R, t=t, sbi_template=tmpl, sbi_jacs=jacs))
    queries = []
    for k, mu in QUERIES:
        Rk, tk = jlie.se3_mul(*jlie.se3_exp(jnp.asarray(_kf_mu(k))), R0, t0)
        Rq, tq = jlie.se3_mul(*jlie.se3_exp(jnp.asarray(mu, jnp.float32)),
                              Rk, tk)
        queries.append(_np(_sbi_at(scene, cam, Rq, tq, shape)).template)
    return dict(map=sm, cam=_np(cam), queries=queries)


def _jmap(sm):
    return jax.tree.map(jnp.asarray, sm)


def test_zmssd_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 15, 20)).astype(np.float32) * 40
    b = rng.normal(size=(5, 15, 20)).astype(np.float32) * 40
    want = np.asarray(jsbi.zmssd(jnp.asarray(a), jnp.asarray(b)))
    got = tsbi.zmssd(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_score_against_all_matches_jax(case):
    kfs = case["map"].keyframes
    valid = kfs.valid.copy()
    valid[1] = False  # an invalid slot among valid ones scores +inf
    for q in case["queries"]:
        want = np.asarray(jsbi.score_against_all(
            jnp.asarray(q), jnp.asarray(kfs.sbi_template),
            jnp.asarray(valid)))
        got = tsbi.score_against_all(
            torch.from_numpy(q), torch.from_numpy(kfs.sbi_template),
            torch.from_numpy(valid)).numpy()
        assert np.array_equal(np.isinf(got), np.isinf(want))
        assert np.isinf(got[~valid]).all()
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_attempt_recovery_matches_jax(case, q):
    sm, query = case["map"], case["queries"][q]
    want = _np(jrel.attempt_recovery(_jmap(sm), jnp.asarray(query),
                                     _jmap(case["cam"])))
    got = trel.attempt_recovery(
        convert.map_from_numpy(sm, device="cpu"), torch.from_numpy(query),
        convert.camera_from_numpy(case["cam"], device="cpu"))
    assert int(got.best_kf) == int(want.best_kf) == QUERIES[q][0]
    assert bool(got.success) == bool(want.success)
    np.testing.assert_allclose(float(got.score), float(want.score),
                               rtol=1e-4)
    np.testing.assert_allclose(got.R.numpy(), want.R, atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), want.t, atol=1e-4)


@pytest.mark.parametrize("kind", ["no_keyframe", "score_too_high"])
def test_attempt_recovery_fails_as_jax_does(case, kind):
    sm, query = case["map"], case["queries"][2]
    max_score = 9e6
    if kind == "no_keyframe":
        sm = sm._replace(keyframes=sm.keyframes._replace(
            valid=np.zeros_like(sm.keyframes.valid)))
    else:
        max_score = 1.0
    want = _np(jrel.attempt_recovery(_jmap(sm), jnp.asarray(query),
                                     _jmap(case["cam"]), max_score))
    got = trel.attempt_recovery(
        convert.map_from_numpy(sm, device="cpu"), torch.from_numpy(query),
        convert.camera_from_numpy(case["cam"], device="cpu"), max_score)
    assert not bool(want.success) and not bool(got.success)
    assert int(got.best_kf) == int(want.best_kf)
