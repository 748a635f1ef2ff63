"""The tracking slice end to end: the port's frame_step against the JAX
package's on the same map, camera, frames and random draws.

The JAX fixed map (small_config, seed 11) is carried into the port with
utils/convert.py; three chained frames are rendered with the JAX renderer.
The JAX random keys are reproduced here (frame_step splits its key once,
track_map splits the subkey in three) and the resulting uniforms handed to
the port, so both select the same lanes.

Tolerances per frame: R and t within 1e-4 (f32 Gauss-Newton over ~100
points, different summation order); `found` agreeing on at least 98% of
the points either side found (ZMSSD argmin near-ties); quality code,
need_kf and dist_excessive equal; the stats vector within rtol 1e-3, with
atol 1e-4 for the near-zero pose entries it carries.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.models import frame_step as jfs
from visualslam_android_tpu.models import keyframe as jkf
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu.ops import sbi as jsbi
from visualslam_android_tpu.utils import fixtures as jfix
from visualslam_android_tpu.utils import synthetic as jsyn
from visualslam_android_tpu_torch.models import frame_step as tfs
from visualslam_android_tpu_torch.models import keyframe as tkf
from visualslam_android_tpu_torch.utils import convert
from visualslam_android_tpu_torch.utils import fixtures as tfix
from visualslam_android_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

N_FRAMES = 3


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _trajectory_mu(k):
    s = (k + 1) / 100.0
    return np.asarray(
        [0.05 * np.sin(6.28 * s), 0.02 * np.sin(4.4 * s), 0.03 * s,
         0.02 * np.sin(5.1 * s), 0.04 * np.sin(6.28 * s),
         0.01 * np.sin(3.3 * s)], np.float32)


@pytest.fixture(scope="module")
def chain():
    jcfg, tcfg = jfix.small_config(), tfix.small_config()
    tc = jcfg.tracker
    N, K = tc.max_map_points, jcfg.mapmaker.max_keyframes
    sm, cam, scene, (R0, t0), _ = jfix.build_fixed_map(
        jcfg, np.random.default_rng(11)
    )
    sm_np = _np_tree(sm)  # frame_step donates its map argument
    frames = []
    for k in range(N_FRAMES):
        dR, dt = jlie.se3_exp(jnp.asarray(_trajectory_mu(k)))
        Rk, tk = jlie.se3_mul(dR, dt, R0, t0)
        frames.append(np.asarray(
            jsyn.render(scene, cam, Rk, tk, (tc.height, tc.width))
        ))
    sbi0 = jsbi.make_sbi(
        jkf.make_frame(jnp.asarray(frames[0]), jcfg).pyramid[-1], tc.sbi_blur
    )

    t_map = convert.map_from_numpy(_np_tree(sm), device="cpu")
    t_cam = convert.camera_from_numpy(_np_tree(cam), device="cpu")
    j = dict(sm=sm, R=R0, t=t0, v=jnp.zeros(6), msd=jnp.asarray(0.0),
             depth=jnp.asarray(4.0), sbi=sbi0)
    t = dict(sm=t_map, R=torch.as_tensor(np.array(R0)),
             t=torch.as_tensor(np.array(t0)), v=torch.zeros(6),
             msd=torch.tensor(0.0), depth=torch.tensor(4.0),
             sbi=convert.sbi_from_numpy(_np_tree(sbi0), device="cpu"))
    key = jax.random.PRNGKey(0)
    outs = []
    for img in frames:
        # frame_step.py:121 then tracker.py:236-237,266.
        _, sub = jax.random.split(key)
        _, k1, k2 = jax.random.split(sub, 3)
        uniforms = tuple(
            torch.as_tensor(np.array(jax.random.uniform(kk, (N,), jnp.float32)))
            for kk in (k1, k2)
        )
        jo = jfs.frame_step(
            jnp.asarray(img), j["sm"], cam, j["R"], j["t"], j["v"],
            j["msd"], j["depth"], jnp.asarray(1.0), j["sbi"],
            jnp.zeros(N, bool), jnp.zeros((N, K), bool), jnp.zeros(2), key,
            jcfg,
        )
        to = tfs.frame_step(
            torch.from_numpy(img.copy()), t["sm"], t_cam, t["R"], t["t"], t["v"],
            t["msd"], t["depth"], torch.tensor(1.0), t["sbi"],
            torch.zeros(N, dtype=torch.bool),
            torch.zeros(N, K, dtype=torch.bool), torch.zeros(2), tcfg,
            uniforms=uniforms,
        )
        outs.append((_np_tree(jo.R), _np_tree(jo.t), np.asarray(jo.found),
                     np.asarray(jo.stats), to))
        key = jo.key
        j = dict(sm=jo.slam_map, R=jo.R, t=jo.t, v=jo.velocity, msd=jo.msd,
                 depth=jo.depth, sbi=jo.sbi)
        t = dict(sm=to.slam_map, R=to.R, t=to.t, v=to.velocity, msd=to.msd,
                 depth=to.depth, sbi=to.sbi)
    return dict(outs=outs, jcfg=jcfg, tcfg=tcfg, sm_np=sm_np, cam=cam,
                t_map=t_map, t_cam=t_cam, frames=frames, R0=R0, t0=t0,
                sbi0=sbi0)


@pytest.mark.parametrize("k", range(N_FRAMES))
def test_frame_step_matches_jax(chain, k):
    _check_frame(*chain["outs"][k])


def _check_frame(jR, jt, jfound, jstats, to):
    np.testing.assert_allclose(to.R.numpy(), jR, rtol=0, atol=1e-4)
    np.testing.assert_allclose(to.t.numpy(), jt, rtol=0, atol=1e-4)
    tfound = to.found.numpy()
    either = jfound | tfound
    assert either.sum() > 50
    assert (jfound == tfound)[either].mean() >= 0.98
    tstats = to.stats.numpy()
    for i in (tfs.STAT_QUALITY, tfs.STAT_NEED_KF, tfs.STAT_DIST_EXCESSIVE):
        assert tstats[i] == jstats[i], i
    np.testing.assert_allclose(tstats, jstats, rtol=1e-3, atol=1e-4)


def test_make_frame_matches_jax(chain):
    """The front-end alone (pyramid + FAST at 10/15/15/10) on the first
    frame, the JAX FrameData carried over with convert.frame_from_numpy:
    pyramid within 1e-5 grey, corner masks equal, scores within 1e-3
    (sums of 16 f32 terms)."""
    img = chain["frames"][0]
    jf = convert.frame_from_numpy(
        _np_tree(jkf.make_frame(jnp.asarray(img), chain["jcfg"])), device="cpu"
    )
    tf = tkf.make_frame(torch.from_numpy(img.copy()), chain["tcfg"])
    for jp, tp, jm, tm, js, ts in zip(jf.pyramid, tf.pyramid, jf.corner_mask,
                                      tf.corner_mask, jf.corner_score,
                                      tf.corner_score):
        np.testing.assert_allclose(tp.numpy(), jp.numpy(), rtol=0, atol=1e-5)
        assert tm.dtype == jm.dtype == torch.bool
        np.testing.assert_array_equal(tm.numpy(), jm.numpy())
        np.testing.assert_allclose(ts.numpy(), js.numpy(), rtol=0, atol=1e-3)
    assert int(tf.corner_mask[0].sum()) > 100


def test_forced_coarse_without_prior_matches_jax(chain):
    """The relocalization-frame variant: no SBI prior / motion model, and
    the recovered coarse stage (doubled budget and range, 60 px). The
    3-frame chain above does not reach the coarse velocity gate, so this
    is the test that covers the coarse search and coarse GN loop."""
    c = chain
    N = c["jcfg"].tracker.max_map_points
    K = c["jcfg"].mapmaker.max_keyframes
    key = jax.random.PRNGKey(5)
    _, sub = jax.random.split(key)
    _, k1, k2 = jax.random.split(sub, 3)
    uniforms = tuple(
        torch.as_tensor(np.array(jax.random.uniform(kk, (N,), jnp.float32)))
        for kk in (k1, k2)
    )
    img = c["frames"][1]
    jo = jfs.frame_step(
        jnp.asarray(img), jax.tree.map(jnp.asarray, c["sm_np"]), c["cam"],
        c["R0"], c["t0"], jnp.zeros(6),
        jnp.asarray(0.0), jnp.asarray(4.0), jnp.asarray(1.0), c["sbi0"],
        jnp.zeros(N, bool), jnp.zeros((N, K), bool), jnp.zeros(2), key,
        c["jcfg"], use_prior=False, forced_coarse=True,
    )
    to = tfs.frame_step(
        torch.from_numpy(img.copy()), c["t_map"], c["t_cam"],
        torch.as_tensor(np.array(c["R0"])), torch.as_tensor(np.array(c["t0"])),
        torch.zeros(6), torch.tensor(0.0), torch.tensor(4.0),
        torch.tensor(1.0),
        convert.sbi_from_numpy(_np_tree(c["sbi0"]), device="cpu"),
        torch.zeros(N, dtype=torch.bool), torch.zeros(N, K, dtype=torch.bool),
        torch.zeros(2), c["tcfg"], use_prior=False, forced_coarse=True,
        uniforms=uniforms,
    )
    assert float(np.asarray(jo.stats)[jfs.STAT_DID_COARSE]) == 1.0
    _check_frame(_np_tree(jo.R), _np_tree(jo.t), np.asarray(jo.found),
                 np.asarray(jo.stats), to)


def test_stats_layout_matches_jax():
    names = [n for n in dir(jfs) if n.startswith("STAT")]
    assert names and all(getattr(tfs, n) == getattr(jfs, n) for n in names)


def test_fixed_map_and_render_match_jax():
    """The port's own build_fixed_map (what chip_smoke.py runs on the card)
    against the JAX one from the same seed: same candidates, points within
    1e-4 m, rendered frames within 1e-3 grey levels (plus 1e-5
    relative: texture coordinates reach ~1e3, so f32 rounding of a sample
    position moves its value by up to ~1e-3)."""
    jcfg, tcfg = jfix.small_config(), tfix.small_config()
    jsm, jcam, jscene, (jR, jt), jn = jfix.build_fixed_map(
        jcfg, np.random.default_rng(5)
    )
    tsm, tcam, tscene, (tR, tt), tn = tfix.build_fixed_map(
        tcfg, np.random.default_rng(5), device="cpu"
    )
    assert jn == tn > 50
    jp, tp = jsm.points, tsm.points
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.center.numpy(), np.asarray(jp.center))
    np.testing.assert_array_equal(tp.source_level.numpy(),
                                  np.asarray(jp.source_level))
    np.testing.assert_allclose(tp.pos_w.numpy(), np.asarray(jp.pos_w),
                               rtol=0, atol=1e-4)
    for lvl in range(jcfg.tracker.n_levels):
        jv = np.asarray(jsm.keyframes.cand_valid[lvl][0])
        tv = tsm.keyframes.cand_valid[lvl][0].numpy()
        jxy = {tuple(p) for p in np.asarray(jsm.keyframes.cand_xy[lvl][0])[jv]}
        txy = {tuple(p) for p in tsm.keyframes.cand_xy[lvl][0].numpy()[tv]}
        assert jxy == txy, lvl
    dR, dt = jlie.se3_exp(jnp.asarray(_trajectory_mu(10)))
    Rk, tk = jlie.se3_mul(dR, dt, jR, jt)
    shape = (jcfg.tracker.height, jcfg.tracker.width)
    jimg = np.asarray(jsyn.render(jscene, jcam, Rk, tk, shape))
    timg = tsyn.render(tscene, tcam, torch.as_tensor(np.array(Rk)),
                       torch.as_tensor(np.array(tk)), shape).numpy()
    np.testing.assert_allclose(timg, jimg, rtol=1e-5, atol=1e-3)
    # The port's front-end on its own rendering finds the JAX corners.
    jf = jkf.make_frame(jnp.asarray(jimg), jcfg)
    tf = tkf.make_frame(torch.from_numpy(timg), tcfg)
    agree = np.mean(tf.corner_mask[0].numpy() == np.asarray(jf.corner_mask[0]))
    assert agree > 0.999


def test_port_does_not_import_jax():
    """Every module of the port, found by walking the package, imports
    without jax or the JAX package."""
    code = ("import sys, pkgutil, importlib; "
            "import visualslam_android_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "p.__name__ + '.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert p.__name__ + '.models.bundle' in names, names; "
            "assert len(names) >= 27, names; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'visualslam_android_tpu' not in sys.modules")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)
