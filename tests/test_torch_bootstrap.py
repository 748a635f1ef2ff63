"""Parity of the port's stereo bootstrap with the JAX package, module by
module and as a whole, on the CPU at the small config (320x240).

A planar scene (seed 21) is rendered with the JAX renderer along the
sideways path of tests/test_slam.py: frame 0 starts the trails, frames
1..6 advance them, frame 6 is the second keyframe, frames 7 and 8 are
tracked on the new map. The JAX package runs the chain once (module
fixture `ref`): every stage's inputs and outputs are kept as numpy and fed
to the port's counterpart, so each comparison is on the same arrays. The
random draws (MLESAC trials, plane-RANSAC trials, track_map's uniforms)
are made once with jax.random exactly as the JAX functions make them, and
handed to the port.

The JAX chain calls the stage functions the JAX SLAMSystem calls in
_init_from_stereo, in its order: trail points, 5 rounds of global bundle
adjustment on the prefix, scene depth, epipolar growth from keyframe 1 at
levels 0, 3, 1, 2, bundle adjustment until it converges (4 rounds at
most), plane alignment. The map before and after every stage is kept.

Tolerances, each with its reason, stand beside the assertions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.models import bundle as jbundle
from visualslam_android_tpu.models import frame_step as jfs
from visualslam_android_tpu.models import homography as jhom
from visualslam_android_tpu.models import keyframe as jkf
from visualslam_android_tpu.models import map_store as jms
from visualslam_android_tpu.models import mapmaker as jmm
from visualslam_android_tpu.models import triangulate as jtri
from visualslam_android_tpu.ops import camera as jcam
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu.ops import match as jmatch
from visualslam_android_tpu.utils import fixtures as jfix
from visualslam_android_tpu.utils import synthetic as jsyn
from visualslam_android_tpu_torch.models import bootstrap as tboot
from visualslam_android_tpu_torch.models import bundle as tbundle
from visualslam_android_tpu_torch.models import frame_step as tfs
from visualslam_android_tpu_torch.models import homography as thom
from visualslam_android_tpu_torch.models import mapmaker as tmm
from visualslam_android_tpu_torch.models import triangulate as ttri
from visualslam_android_tpu_torch.ops import match as tmatch
from visualslam_android_tpu_torch.utils import convert
from visualslam_android_tpu_torch.utils import fixtures as tfix
from visualslam_android_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

N_TRAIL_FRAMES = 6   # frames 1..6 advance the trails
N_TRACK_FRAMES = 2   # frames 7, 8 are tracked on the new map
N_PATH = 26          # the path's length in frames (sets the step)
GROW_LEVELS = (0, 3, 1, 2)


def _np(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _jx(x):
    return jax.tree.map(jnp.asarray, x)


def _pose(R0, t0, k):
    s = k / (N_PATH - 1)
    mu = jnp.asarray(
        [0.55 * s, 0.08 * np.sin(2 * s), 0.05 * s, 0.0, 0.12 * s, 0.0],
        jnp.float32,
    )
    dR, dt = jlie.se3_exp(mu)
    return jlie.se3_mul(dR, dt, R0, t0)


def _choice(key, valid, shape):
    """The draw homography.compute and calc_plane_aligner make."""
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return np.asarray(jax.random.choice(key, p.shape[0], shape=shape, p=p))


def _track_uniforms(key, N):
    """frame_step splits its key once, track_map the subkey in three."""
    _, sub = jax.random.split(key)
    _, k1, k2 = jax.random.split(sub, 3)
    return tuple(_t(jax.random.uniform(kk, (N,), jnp.float32))
                 for kk in (k1, k2))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's bootstrap chain, every stage kept as numpy."""
    jcfg, tcfg = jfix.small_config(), tfix.small_config()
    tc, mc = jcfg.tracker, jcfg.mapmaker
    N, K = tc.max_map_points, mc.max_keyframes
    cam = jcam.make_camera(jcfg.camera.params(), tc.width, tc.height)
    scene = jsyn.make_planar_scene(np.random.default_rng(21), depth=4.0,
                                   px_per_m=140.0)
    R0, t0 = jsyn.look_at_pose((0.0, 0.0, 0.0))
    imgs = [
        np.asarray(jsyn.render(scene, cam, *_pose(R0, t0, k),
                               (tc.height, tc.width)))
        for k in range(N_TRAIL_FRAMES + N_TRACK_FRAMES + 1)
    ]
    fronts = [jfs.bootstrap_frontend(jnp.asarray(im), jcfg) for im in imgs]
    frames = [f for f, _ in fronts]

    # TrailTracking_Start / _Advance (slam.py:599-630).
    extras0 = jkf.make_frame_extras(frames[0], jcfg)
    n = min(tc.max_trails, extras0.cand_xy[0].shape[0])
    pos0 = extras0.cand_xy[0][:n].astype(jnp.float32)
    patches = jmatch.sample_minipatches(frames[0].pyramid[0], pos0,
                                        jcfg.patch.mini_half_patch)
    steps = [(np.asarray(pos0), np.asarray(extras0.cand_valid[0][:n]))]
    for k in range(1, N_TRAIL_FRAMES + 1):
        pos, good, count = jfs.trail_advance_step(
            frames[k], frames[k - 1], patches, jnp.asarray(steps[-1][0]),
            jnp.asarray(steps[-1][1]), jcfg,
        )
        steps.append((np.asarray(pos), np.asarray(good)))
        assert int(count) == steps[-1][1].sum()

    # InitFromStereo (slam.py:632-783).
    second = frames[N_TRAIL_FRAMES]
    extras1 = jkf.make_frame_extras(second, jcfg)
    a, (b, valid) = pos0, steps[-1]
    m_a = jcam.unproject(cam, a)
    m_b = jcam.unproject(cam, jnp.asarray(b))
    _, jac = jcam.project_derivs(cam, m_b)
    key_h, key_p = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    hom = jhom.compute(m_a, m_b, jac, jnp.asarray(valid), key_h,
                       max_pixel_error=mc.max_pixel_error,
                       n_trials=mc.mlesac_trials,
                       refine_iters=mc.homography_refine_iters)
    hom_idx = _choice(key_h, valid, (mc.mlesac_trials, 4))
    assert bool(hom.success)
    R2 = hom.R
    t2 = hom.t * (mc.wiggle_scale / jnp.linalg.norm(hom.t))
    sm = jms.empty_map(jcfg)
    kfs = jkf.insert_keyframe(sm.keyframes, 0, frames[0], extras0,
                              jnp.eye(3), jnp.zeros(3), fixed=True)
    kfs = jkf.insert_keyframe(kfs, 1, second, extras1, R2, t2)
    map0 = _np(sm._replace(keyframes=kfs))
    sm1, n_ok = jfs.init_points_step(
        _jx(map0), second, m_a, a, jnp.asarray(b), jnp.asarray(valid), R2,
        t2, cam, jcfg,
    )
    sm1 = jkf.refresh_scene_depth(jkf.refresh_scene_depth(sm1, 0), 1)
    map1 = _np(sm1)

    # 5 global rounds on the prefix (slam.py:707-718).
    cap = (min(tc.max_map_points,
               -(-(tc.max_trails + 4 * mc.max_epi_candidates) // 256) * 256),
           2)
    queues = dict(never=jnp.zeros((N, K), bool), fail=jnp.zeros((N, K), bool))

    def ba(sm, max_iters):
        sm, queues["fail"], queues["never"], conv, ok = jfs.ba_round(
            sm, 1, queues["never"], queues["fail"], cam, jcfg,
            max_iters=max_iters, assembly="onehot", solver="chol",
            mode="global", cap=cap)
        assert bool(ok)
        return sm, bool(conv)

    sm = _jx(map1)
    for _ in range(5):
        sm, _ = ba(sm, 10)
    sm = jkf.refresh_scene_depth(jkf.refresh_scene_depth(sm, 0), 1)
    map_ba5 = _np(sm)
    depth = sm.keyframes.depth_mean[0]
    # Growth at levels 0, 3, 1, 2 (slam.py:730-733); the map before each.
    new_points = jnp.zeros(N, bool)
    grow_in = {}
    for lvl in GROW_LEVELS:
        grow_in[lvl] = (_np(sm), np.asarray(new_points))
        sm, new_points = jfs.add_map_points_step(_jx(grow_in[lvl][0]),
                                                 new_points, cam, 1, lvl, jcfg)
    map_grown = _np(sm)
    # BA until converged (slam.py:739-746).
    for conv_rounds in range(1, 5):
        sm, conv = ba(sm, 20)
        if conv:
            break
    assert conv
    map_conv = _np(sm)
    sm1 = _jx(map_conv)
    plane_idx = _choice(key_p, np.asarray(sm1.points.live()),
                        (mc.plane_ransac_trials, 3))
    Rp, tp, plane_ok = jmm.calc_plane_aligner(sm1, key_p, jcfg)
    assert bool(plane_ok)
    sm2 = jmm.apply_global_transformation(sm1, Rp, tp)
    sm2 = sm2._replace(good=jnp.asarray(True))
    map2 = _np(sm2)

    # Two tracked frames on the new map (slam.py:373-387).
    wiggle = mc.wiggle_scale / jnp.maximum(depth, 1e-6)
    j = dict(sm=sm2, R=sm2.keyframes.R[1], t=sm2.keyframes.t[1],
             v=jnp.zeros(6), msd=jnp.asarray(0.0), depth=depth,
             sbi=fronts[N_TRAIL_FRAMES][1])
    key = jax.random.PRNGKey(0)
    tracked = []
    for k in range(N_TRAIL_FRAMES + 1, len(imgs)):
        uniforms = _track_uniforms(key, N)
        jo = jfs.frame_step(
            jnp.asarray(imgs[k]), j["sm"], cam, j["R"], j["t"], j["v"],
            j["msd"], j["depth"], wiggle, j["sbi"], jnp.zeros(N, bool),
            jnp.zeros((N, K), bool), jnp.zeros(2), key, jcfg,
        )
        tracked.append(dict(uniforms=uniforms, R=np.asarray(jo.R),
                            t=np.asarray(jo.t), found=np.asarray(jo.found),
                            stats=np.asarray(jo.stats)))
        key = jo.key
        j = dict(sm=jo.slam_map, R=jo.R, t=jo.t, v=jo.velocity, msd=jo.msd,
                 depth=jo.depth, sbi=jo.sbi)
    return dict(
        jcfg=jcfg, tcfg=tcfg, cam=cam,
        t_cam=convert.camera_from_numpy(_np(cam), device="cpu"),
        imgs=imgs, frames=[_np(f) for f in frames],
        sbi_second=_np(fronts[N_TRAIL_FRAMES][1]),
        extras0=_np(extras0), extras1=_np(extras1),
        patches=np.asarray(patches), steps=steps,
        m_a=np.asarray(m_a), m_b=np.asarray(m_b), jac=np.asarray(jac),
        hom=_np(hom), hom_idx=hom_idx, R2=np.asarray(R2), t2=np.asarray(t2),
        map0=map0, map1=map1, n_ok=int(n_ok), plane_idx=plane_idx,
        Rp=np.asarray(Rp), tp=np.asarray(tp), map2=map2, cap=cap,
        map_ba5=map_ba5, grow_in=grow_in, map_grown=map_grown,
        map_conv=map_conv, new_points=np.asarray(new_points),
        never=np.asarray(queues["never"]), fail=np.asarray(queues["fail"]),
        depth=float(depth), wiggle=float(wiggle), tracked=tracked,
    )


def _t_frame(ref, k):
    return convert.frame_from_numpy(ref["frames"][k], device="cpu")


# ---------------------------------------------------------------------------
# Module by module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, N_TRAIL_FRAMES])
def test_minipatch_matches_jax(ref, k):
    """find_minipatch + sample_minipatches on frame k from the JAX trail
    state before it. `found` equal and positions equal on >= 99% of the
    active trails: SSDs reach ~5e6 in f32 and the JAX form
    (sum I^2 - 2 I.T + sum T^2) rounds differently from the direct
    sum (I - T)^2, so a near-tie of the argmin or of best < max_ssd may
    flip."""
    cfg = ref["jcfg"]
    pos, valid = ref["steps"][k - 1]
    jf = _jx(ref["frames"][k])
    kw = dict(search_range=cfg.tracker.trail_search_range,
              half_patch=cfg.patch.mini_half_patch,
              max_ssd=cfg.tracker.trail_max_ssd)
    jr = jmatch.find_minipatch(jf.pyramid[0], jf.corner_mask[0],
                               jnp.asarray(ref["patches"]), jnp.asarray(pos),
                               jnp.asarray(valid), **kw)
    tf = _t_frame(ref, k)
    tr = tmatch.find_minipatch(tf.pyramid[0], tf.corner_mask[0],
                               _t(ref["patches"]), _t(pos), _t(valid), **kw)
    jfound, tfound = np.asarray(jr.found), tr.found.numpy()
    assert valid.sum() > 100
    assert (jfound == tfound)[valid].mean() >= 0.99
    both = jfound & tfound
    assert both.sum() > 100
    same = np.all(np.asarray(jr.pos)[both] == tr.pos.numpy()[both], axis=-1)
    assert same.mean() >= 0.99
    # Patches re-sampled at the matches: exact copies of image pixels.
    jp = jmatch.sample_minipatches(jf.pyramid[0], jr.pos,
                                   cfg.patch.mini_half_patch)
    tp = tmatch.sample_minipatches(tf.pyramid[0], _t(np.asarray(jr.pos)),
                                   cfg.patch.mini_half_patch)
    np.testing.assert_array_equal(tp.numpy()[both], np.asarray(jp)[both])


def test_nowarp_templates_and_subpix_match_jax(ref):
    """make_templates_nowarp in keyframe 0 at the trails' first positions,
    then iterate_subpix in the second frame from their current positions.
    Template pixels are copies (equal), sums within rtol 1e-6, gradients
    exact, h_inv within rtol 1e-3 (a 3x3 inverse of f32 sums); subpixel
    positions within 1e-3 px where both converge (f32 inverse-composition
    updates, sampled by gathers here and by matmuls there), converged flags
    equal on >= 98%."""
    cfg = ref["jcfg"].patch
    a, (b, valid) = ref["steps"][0][0], ref["steps"][-1]
    T = a.shape[0]
    kf_pyr0 = ref["map0"].keyframes.pyramid[0]
    second = ref["frames"][N_TRAIL_FRAMES].pyramid[0]
    jt = jmatch.make_templates_nowarp(
        jnp.asarray(kf_pyr0), jnp.zeros(T, jnp.int32), jnp.asarray(a),
        cfg.half_patch_size)
    tt = tmatch.make_templates_nowarp(
        _t(kf_pyr0), torch.zeros(T, dtype=torch.int32), _t(a),
        cfg.half_patch_size)
    np.testing.assert_array_equal(tt.bad.numpy(), np.asarray(jt.bad))
    np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
    np.testing.assert_array_equal(tt.grad_x.numpy(), np.asarray(jt.grad_x))
    np.testing.assert_allclose(tt.t_sum.numpy(), np.asarray(jt.t_sum),
                               rtol=1e-6)
    np.testing.assert_allclose(tt.t_sumsq.numpy(), np.asarray(jt.t_sumsq),
                               rtol=1e-6)
    ok = ~np.asarray(jt.bad)
    np.testing.assert_allclose(tt.h_inv.numpy()[ok], np.asarray(jt.h_inv)[ok],
                               rtol=1e-3, atol=1e-7)

    active = valid & ok
    kw = dict(max_iters=cfg.subpix_max_iters, half_patch=cfg.half_patch_size,
              conv_limit=cfg.subpix_converged)
    js = jmatch.iterate_subpix(jnp.asarray(second), jt, jnp.asarray(b),
                               jnp.zeros(T, jnp.int32), jnp.asarray(active),
                               **kw)
    ts = tmatch.iterate_subpix(_t(second), tt, _t(b),
                               torch.zeros(T, dtype=torch.int32), _t(active),
                               **kw)
    jc, tcv = np.asarray(js.converged), ts.converged.numpy()
    assert (jc == tcv)[active].mean() >= 0.98
    both = jc & tcv
    assert both.sum() > 100
    np.testing.assert_allclose(ts.pos_zero.numpy()[both],
                               np.asarray(js.pos_zero)[both], rtol=0,
                               atol=1e-3)


def test_triangulate_matches_jax():
    """Random points 2..6 m in front of two cameras 1 m apart, seen with
    0.5 px of noise at focal 270: positions within 1e-5 of each point's
    largest coordinate. Both take the smallest eigenvector of a 4x4 f32
    A^T A, whose accuracy falls with the baseline: at 1 m the two LAPACK
    calls agree to ~5e-6, at 0.3 m only to ~3e-5 (and each is then ~2e-4
    from the truth), so the bound is stated for the wide baseline."""
    rng = np.random.default_rng(5)
    n = 200
    X = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                  rng.uniform(2, 6, n)], -1).astype(np.float32)
    Ra = np.eye(3, dtype=np.float32)
    ta = np.zeros(3, np.float32)
    Rb, tb = _np(jlie.se3_exp(jnp.asarray([1.0, 0.02, 0.01, 0.01, -0.05, 0.02],
                                          jnp.float32)))
    ma = X[:, :2] / X[:, 2:]
    Xb = X @ Rb.T + tb
    mb = (Xb[:, :2] / Xb[:, 2:]
          + rng.normal(scale=0.5 / 270, size=(n, 2))).astype(np.float32)
    bc = lambda x, s: np.broadcast_to(x, (n, *s)).copy()  # noqa: E731
    args = (bc(Ra, (3, 3)), bc(ta, (3,)), bc(Rb, (3, 3)), bc(tb, (3,)), ma, mb)
    jx = np.asarray(jtri.triangulate(*(jnp.asarray(x) for x in args)))
    tx = ttri.triangulate(*(_t(x) for x in args))
    rel = np.abs(tx.numpy() - jx) / np.abs(jx).max(axis=1, keepdims=True)
    assert rel.max() < 1e-5
    jz = np.asarray(jtri.depth_in_camera(jnp.asarray(args[2]),
                                         jnp.asarray(args[3]), jnp.asarray(jx)))
    tz = ttri.depth_in_camera(_t(args[2]), _t(args[3]), _t(jx))
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-6, atol=1e-6)
    assert (tz.numpy() > 1.5).all()


def _planar_matches(rng, R, t, d=4.0, n_pts=120, noise=0.0, n_outliers=0,
                    focal=270.0):
    """tests/test_homography.py's matches: points on the plane z = d of the
    first camera, seen from (R, t), with pixel noise and gross outliers."""
    m = rng.uniform(-0.5, 0.5, size=(n_pts, 2))
    X = d * np.concatenate([m, np.ones((n_pts, 1))], -1)
    Xb = X @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    second = Xb[:, :2] / Xb[:, 2:3]
    if noise > 0:
        second = second + rng.normal(scale=noise / focal, size=second.shape)
    if n_outliers > 0:
        idx = rng.choice(n_pts, n_outliers, replace=False)
        second[idx] += rng.uniform(-0.2, 0.2, size=(n_outliers, 2))
    jac = np.tile(np.eye(2, dtype=np.float32) * focal, (n_pts, 1, 1))
    return m.astype(np.float32), second.astype(np.float32), jac


def _check_homography(jres, tres, valid):
    """H equal up to sign and scale within 1e-3 (both normalise H to unit
    Frobenius norm; five f32 eigen-solves of a gauge-deficient 9x9 system
    in another summation order); R, t, normal and plane_d of the winning
    decomposition within 1e-3 (an f32 SVD of H; the plane up to the joint
    sign of normal and plane_d); inlier flags equal on
    >= 98% of the valid matches."""
    # Through the port's dataclass and back.
    jt = convert.homography_from_numpy(jres, device="cpu")
    jres = type(jres)(**{f: getattr(jt, f).numpy() for f in jres._fields})
    assert bool(tres.success) == bool(jres.success)
    jH = np.asarray(jres.H) / np.linalg.norm(jres.H)
    tH = tres.H.numpy() / np.linalg.norm(tres.H.numpy())
    if np.sum(jH * tH) < 0:
        tH = -tH
    np.testing.assert_allclose(tH, jH, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tres.R.numpy(), jres.R, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tres.t.numpy(), jres.t, rtol=0, atol=1e-3)
    # (normal, plane_d) and (-normal, -plane_d) are one plane; which of the
    # two comes out follows the free signs of the singular vectors.
    sign = 1.0 if float(tres.normal.numpy() @ jres.normal) > 0 else -1.0
    np.testing.assert_allclose(sign * tres.normal.numpy(), jres.normal,
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(sign * float(tres.plane_d),
                               float(jres.plane_d), rtol=0, atol=1e-3)
    agree = (tres.inliers.numpy() == np.asarray(jres.inliers))[valid]
    assert agree.mean() >= 0.98


@pytest.mark.parametrize("noise,outliers,n_invalid",
                         [(0.0, 0, 0), (0.3, 0, 0), (0.3, 12, 20)])
def test_homography_matches_jax(noise, outliers, n_invalid):
    """homography.compute on planar matches with a known motion, the MLESAC
    trials drawn once with jax.random.choice and passed to the port."""
    rng = np.random.default_rng(int(noise * 10) + outliers)
    R, t = _np(jlie.se3_exp(jnp.asarray([0.25, 0.1, 0.05, 0.02, -0.24, 0.03],
                                        jnp.float32)))
    first, second, jac = _planar_matches(rng, R, t, noise=noise,
                                         n_outliers=outliers)
    valid = np.ones(first.shape[0], bool)
    valid[:n_invalid] = False
    key = jax.random.PRNGKey(7)
    jres = _np(jhom.compute(jnp.asarray(first), jnp.asarray(second),
                            jnp.asarray(jac), jnp.asarray(valid), key))
    idx = _choice(key, valid, (300, 4))
    tres = thom.compute(_t(first), _t(second), _t(jac), _t(valid),
                        trial_idx=_t(idx))
    _check_homography(jres, tres, valid)
    assert bool(tres.success)
    # And the port recovers the motion itself (rotation angle, direction
    # of t), by tests/test_homography.py's bounds.
    dR = tres.R.numpy() @ R.T
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    te = tres.t.numpy() / np.linalg.norm(tres.t.numpy())
    tang = np.arccos(np.clip(abs(te @ (t / np.linalg.norm(t))), -1, 1))
    tol = 0.01 if noise == 0 else 0.06
    assert ang < tol and tang < 4 * tol


def test_homography_draws_its_own_trials():
    """Without trial_idx the port draws from the caller's generator, only
    among valid matches, and still finds the motion's inliers."""
    rng = np.random.default_rng(9)
    R, t = _np(jlie.se3_exp(jnp.asarray([0.25, 0.1, 0.05, 0.02, -0.24, 0.03],
                                        jnp.float32)))
    first, second, jac = _planar_matches(rng, R, t, noise=0.3, n_outliers=12)
    valid = np.ones(first.shape[0], bool)
    valid[:20] = False
    gen = torch.Generator().manual_seed(1)
    res = thom.compute(_t(first), _t(second), _t(jac), _t(valid),
                       generator=gen)
    assert bool(res.success)
    assert not res.inliers.numpy()[:20].any()
    assert res.inliers.numpy().sum() >= 80


def test_homography_on_the_trails_matches_jax(ref):
    """The bootstrap's own homography: the trails' matches, JAX draws."""
    valid = ref["steps"][-1][1]
    tres = thom.compute(_t(ref["m_a"]), _t(ref["m_b"]), _t(ref["jac"]),
                        _t(valid), trial_idx=_t(ref["hom_idx"]))
    _check_homography(ref["hom"], tres, valid)


def _assert_stores_equal(t_map, j_map, pos_atol):
    """Every field of points and measurements: integer and bool fields
    equal, float fields within pos_atol."""
    for store in ("points", "meas"):
        ts, js = getattr(t_map, store), getattr(j_map, store)
        for name in js._fields:
            tv, jv = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
            if jv.dtype.kind == "f":
                np.testing.assert_allclose(tv, jv, rtol=0, atol=pos_atol,
                                           err_msg=f"{store}.{name}")
            else:
                np.testing.assert_array_equal(tv, jv, f"{store}.{name}")


@pytest.mark.parametrize("max_new,n_taken", [(256, 3), (40, 0)])
def test_insert_new_points_matches_jax(ref, max_new, n_taken):
    """insert_new_points on the two-keyframe map with `n_taken` slots
    already in use and random candidates, about half of them successes:
    the same slots, the same point fields and the same two measurements.
    The port gathers per slot where the JAX package scatters per
    candidate; float fields within 1e-6 (unit rays and a bilinear colour
    computed in another order)."""
    rng = np.random.default_rng(max_new)
    C = 96
    jmap = _jx(ref["map0"])
    taken = np.zeros(jmap.points.valid.shape[0], bool)
    taken[[1, 4, 7][:n_taken]] = True
    jmap = jmap._replace(points=jmap.points._replace(valid=jnp.asarray(taken)))
    tc = ref["jcfg"].tracker
    res = dict(
        success=rng.uniform(size=C) < 0.5,
        pos_w=rng.uniform(-1, 1, (C, 3)).astype(np.float32) + [0, 0, 4],
        src_uv=rng.uniform(20, [tc.width - 20, tc.height - 20],
                           (C, 2)).astype(np.float32),
        target_uv=rng.uniform(20, 200, (C, 2)).astype(np.float32),
    )
    res["pos_w"] = res["pos_w"].astype(np.float32)
    t_map = convert.map_from_numpy(_np(jmap), device="cpu")
    jsm, jnew = jmm.insert_new_points(
        jmap, ref["cam"], jmm.EpipolarResult(**_jx(res)), 0, 1, 0, max_new)
    tsm, tnew = tmm.insert_new_points(
        t_map, ref["t_cam"],
        tmm.EpipolarResult(**{k: _t(v) for k, v in res.items()}), 0, 1, 0,
        max_new)
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    assert tnew.sum() == min(res["success"].sum(), max_new)
    _assert_stores_equal(tsm, jsm, 1e-6)


def test_add_measurements_evicts_like_jax(ref):
    """add_measurements_batch on rows that are empty, partly filled and
    full: a full row evicts its first lowest-value slot, never SRC_ROOT,
    and drops an incoming measurement worth less than all it holds."""
    rng = np.random.default_rng(2)
    meas = ref["map0"].meas
    N, O = meas.valid.shape
    fill = rng.integers(0, O + 1, N)
    fill[:8] = O  # some full rows for certain
    valid = np.arange(O)[None, :] < fill[:, None]
    source = rng.integers(0, 5, (N, O)).astype(np.int32)
    source[:, 0] = jms.SRC_ROOT
    jmeas = meas._replace(valid=valid, source=source,
                          kf=rng.integers(0, 4, (N, O)).astype(np.int32))
    mask = rng.uniform(size=N) < 0.7
    uv = rng.uniform(0, 100, (N, 2)).astype(np.float32)
    for src in (jms.SRC_REFIND, jms.SRC_TRACKER, jms.SRC_EPIPOLAR):
        jout = jmm.add_measurements_batch(_jx(jmeas), jnp.asarray(mask), 2,
                                          jnp.asarray(uv), 1, src, True)
        tmeas = convert.map_from_numpy(
            ref["map0"]._replace(meas=jmeas), device="cpu").meas
        tout = tmm.add_measurements_batch(tmeas, _t(mask), 2, _t(uv), 1, src,
                                          True)
        for name in jout._fields:
            np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                          np.asarray(getattr(jout, name)),
                                          f"{name} src={src}")


def test_plane_aligner_and_global_transform_match_jax(ref):
    """calc_plane_aligner on the grown and adjusted map with the JAX draws: R
    and t within 1e-4 (a 3x3 f32 eigh of the inliers' covariance); then
    apply_global_transformation with the JAX aligner: keyframe poses and
    points within 1e-5, and apply_global_scale likewise."""
    t_map = convert.map_from_numpy(ref["map_conv"], device="cpu")
    R, t, ok = tmm.calc_plane_aligner(t_map, ref["tcfg"],
                                      trial_idx=_t(ref["plane_idx"]))
    assert bool(ok)
    np.testing.assert_allclose(R.numpy(), ref["Rp"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), ref["tp"], rtol=0, atol=1e-4)
    # The aligned plane is z = 0: the inliers lie within the threshold.
    out = tmm.apply_global_transformation(t_map, _t(ref["Rp"]), _t(ref["tp"]))
    j2 = ref["map2"]
    np.testing.assert_allclose(out.keyframes.R.numpy(), j2.keyframes.R,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.keyframes.t.numpy(), j2.keyframes.t,
                               rtol=0, atol=1e-5)
    _assert_stores_equal(out, j2, 1e-5)
    z = out.points.pos_w.numpy()[out.points.live().numpy(), 2]
    thr = ref["jcfg"].mapmaker.plane_inlier_threshold
    assert (np.abs(z) < thr).mean() > 0.9
    jsc = jmm.apply_global_scale(_jx(ref["map_conv"]), 0.5)
    tsc = tmm.apply_global_scale(t_map, 0.5)
    np.testing.assert_allclose(tsc.keyframes.t.numpy(), jsc.keyframes.t,
                               rtol=0, atol=1e-6)
    _assert_stores_equal(tsc, jsc, 1e-6)


def test_plane_aligner_draws_its_own_trials(ref):
    t_map = convert.map_from_numpy(ref["map_conv"], device="cpu")
    gen = torch.Generator().manual_seed(3)
    R, t, ok = tmm.calc_plane_aligner(t_map, ref["tcfg"], generator=gen)
    assert bool(ok)
    # Same plane as with the JAX draws: normals within 2 degrees.
    assert float(R[2] @ _t(ref["Rp"])[2]) > np.cos(np.deg2rad(2.0))


# ---------------------------------------------------------------------------
# The slice as a whole, stage by stage on the JAX package's arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", range(1, N_TRAIL_FRAMES + 1))
def test_trail_advance_matches_jax(ref, k):
    """trail_advance_step on frame k from the JAX trail state: `good` equal
    and positions equal on >= 99% of the trails that were alive (two
    MiniPatch searches, see test_minipatch_matches_jax), count within 1%."""
    pos, valid = ref["steps"][k - 1]
    jpos, jgood = ref["steps"][k]
    tpos, tgood, tcount = tfs.trail_advance_step(
        _t_frame(ref, k), _t_frame(ref, k - 1), _t(ref["patches"]), _t(pos),
        _t(valid), ref["tcfg"])
    assert int(tcount) == int(tgood.sum())
    assert (tgood.numpy() == jgood)[valid].mean() >= 0.99
    assert abs(int(tcount) - jgood.sum()) <= 0.01 * jgood.sum() + 1
    both = tgood.numpy() & jgood
    assert both.sum() > 100
    assert np.all(tpos.numpy()[both] == jpos[both], axis=-1).mean() >= 0.99


def test_init_points_step_matches_jax(ref):
    """init_points_step on the JAX two-keyframe map, trails and (R2, t2):
    n_ok equal +- 1 (a subpixel convergence flag may flip); the points both
    made lie within 1e-3 relative of each other (triangulation at a
    baseline of 0.1 against depths of ~3 amplifies the 1e-3 px subpixel
    difference), with SRC_ROOT + SRC_TRAIL measurements."""
    a, (b, valid) = ref["steps"][0][0], ref["steps"][-1]
    t_map = convert.map_from_numpy(ref["map0"], device="cpu")
    tsm, n_ok = tfs.init_points_step(
        t_map, _t_frame(ref, N_TRAIL_FRAMES), _t(ref["m_a"]), _t(a), _t(b),
        _t(valid), _t(ref["R2"]), _t(ref["t2"]), ref["t_cam"], ref["tcfg"])
    assert abs(int(n_ok) - ref["n_ok"]) <= 1
    assert int(n_ok) > 100
    j1 = ref["map1"]
    # Points are packed in trail order, so compare by the source position.
    def by_source(center, posw, live):
        return {tuple(c): p for c, p in zip(center[live], posw[live])}
    jp = by_source(j1.points.center, j1.points.pos_w,
                   j1.points.valid & ~j1.points.bad)
    tp = by_source(tsm.points.center.numpy(), tsm.points.pos_w.numpy(),
                   tsm.points.live().numpy())
    common = set(jp) & set(tp)
    assert len(common) >= ref["n_ok"] - 1
    for c in common:
        np.testing.assert_allclose(tp[c], jp[c], rtol=1e-3, atol=1e-3)
    live = tsm.points.live().numpy()
    src = tsm.meas.source.numpy()[live]
    assert (src[:, 0] == jms.SRC_ROOT).all() and (src[:, 1] == jms.SRC_TRAIL).all()
    assert (tsm.meas.valid.numpy()[live].sum(1) == 2).all()


@pytest.mark.parametrize("k", range(N_TRACK_FRAMES))
def test_tracking_on_the_new_map_matches_jax(ref, k):
    """frame_step on the map the bootstrap built (trail points and the
    points of four growths, bundle-adjusted), chained over two frames from
    the JAX state: pose within 1e-4,
    found sets agreeing on >= 98% of the points either side found, as for
    the fixture map in test_torch_slice.py."""
    N = ref["jcfg"].tracker.max_map_points
    K = ref["jcfg"].mapmaker.max_keyframes
    sm = convert.map_from_numpy(ref["map2"], device="cpu")
    state = dict(sm=sm, R=sm.keyframes.R[1], t=sm.keyframes.t[1],
                 v=torch.zeros(6), msd=torch.tensor(0.0),
                 depth=torch.tensor(ref["depth"]),
                 sbi=convert.sbi_from_numpy(ref["sbi_second"], device="cpu"))
    for i in range(k + 1):
        want = ref["tracked"][i]
        to = tfs.frame_step(
            _t(ref["imgs"][N_TRAIL_FRAMES + 1 + i]), state["sm"],
            ref["t_cam"], state["R"], state["t"], state["v"], state["msd"],
            state["depth"], torch.tensor(ref["wiggle"]), state["sbi"],
            torch.zeros(N, dtype=torch.bool),
            torch.zeros(N, K, dtype=torch.bool), torch.zeros(2), ref["tcfg"],
            uniforms=want["uniforms"],
        )
        state = dict(sm=to.slam_map, R=to.R, t=to.t, v=to.velocity,
                     msd=to.msd, depth=to.depth, sbi=to.sbi)
    np.testing.assert_allclose(to.R.numpy(), want["R"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(to.t.numpy(), want["t"], rtol=0, atol=1e-4)
    either = want["found"] | to.found.numpy()
    assert either.sum() > 50
    assert (want["found"] == to.found.numpy())[either].mean() >= 0.98
    assert to.stats[tfs.STAT_QUALITY] == want["stats"][jfs.STAT_QUALITY]
    assert want["stats"][jfs.STAT_QUALITY] != 0  # not BAD


def _ba_problem(j_map, jcfg):
    """The global problem of a JAX map (numpy), as the JAX package builds
    it."""
    sm = _jx(j_map)
    return jmm.build_ba_problem(sm, sm.keyframes.valid & ~sm.keyframes.fixed,
                                jcfg)


def _rms(t_map, ref):
    prob = tmm.build_ba_problem(
        t_map, t_map.keyframes.valid & ~t_map.keyframes.fixed, ref["tcfg"])
    return float(tbundle.reprojection_rms(prob, ref["t_cam"]))


def test_init_ba_rounds_match_jax(ref):
    """The 5 global rounds of 10 iterations on the prefix, from the JAX
    trail-point map, by outcome: the rms falls and ends within 5% of the
    JAX chain's, keyframe 1 within 2e-3 of it (50 LM iterations whose
    accept tests the two packages may decide differently), the same
    points alive up to 2, and every round read the device at most 10
    times."""
    cfg, N, K = ref["tcfg"], *ref["never"].shape
    sm = convert.map_from_numpy(ref["map1"], device="cpu")
    rms0 = _rms(sm, ref)
    never = torch.zeros(N, K, dtype=torch.bool)
    fail = torch.zeros(N, K, dtype=torch.bool)
    for _ in range(5):
        tbundle.HOST_READS["bundle_adjust"] = 0
        sm, fail, never, conv, ok = tfs.ba_round(
            sm, 1, never, fail, ref["t_cam"], cfg, max_iters=10,
            assembly="onehot", solver="chol", mode="global", cap=ref["cap"])
        assert bool(ok)
        assert tbundle.HOST_READS["bundle_adjust"] <= 10
    j5 = ref["map_ba5"]
    t_rms = _rms(sm, ref)
    j_rms = float(jbundle.reprojection_rms(_ba_problem(j5, ref["jcfg"]),
                                           ref["cam"]))
    assert t_rms < rms0
    assert abs(t_rms - j_rms) <= 0.05 * j_rms
    np.testing.assert_allclose(sm.keyframes.R[1].numpy(), j5.keyframes.R[1],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(sm.keyframes.t[1].numpy(), j5.keyframes.t[1],
                               rtol=0, atol=2e-3)
    assert (sm.points.valid.numpy() != j5.points.valid).sum() <= 2
    np.testing.assert_array_equal(sm.keyframes.R[0].numpy(), np.eye(3))


@pytest.mark.parametrize("level", GROW_LEVELS)
def test_epipolar_search_matches_jax(ref, level):
    """epipolar_search from keyframe 1 into keyframe 0 on the JAX map
    before that level's growth (candidates not thinned): `success` equal on >= 98% of the
    candidates (the ZMSSD by expansion subtracts sums of squares of ~1e6
    in f32, so a near-tie of the argmin or of best < max may flip, and a
    subpixel convergence flag with it); where both succeed, target
    positions within the subpixel tolerance of 0.03 px on >= 98% (another
    winning corner is a flipped near-tie) and pos_w within 1e-3 relative
    for those."""
    j_map, _ = ref["grow_in"][level]
    jr = _np(jmm.epipolar_search(_jx(j_map), 1, 0, ref["cam"], level,
                                 ref["jcfg"]))
    tr = tmm.epipolar_search(convert.map_from_numpy(j_map, device="cpu"), 1,
                             0, ref["t_cam"], level, ref["tcfg"])
    js, ts = jr.success, tr.success.numpy()
    assert js.sum() >= {0: 20, 1: 20, 2: 5, 3: 3}[level]
    assert (js == ts).mean() >= 0.98
    both = js & ts
    np.testing.assert_array_equal(tr.src_uv.numpy(), jr.src_uv)
    d = np.abs(tr.target_uv.numpy() - jr.target_uv)[both].max(axis=1)
    same = d <= ref["jcfg"].patch.subpix_converged
    assert same.mean() >= 0.98
    jp, tp = jr.pos_w[both][same], tr.pos_w.numpy()[both][same]
    rel = np.abs(tp - jp).max(axis=1) / np.abs(jp).max(axis=1)
    assert rel.max() <= 1e-3
    # A 0-d tensor names the target as well as an int does.
    tr2 = tmm.epipolar_search(convert.map_from_numpy(j_map, device="cpu"), 1,
                              torch.tensor(0), ref["t_cam"], level,
                              ref["tcfg"])
    np.testing.assert_array_equal(tr2.success.numpy(), ts)


@pytest.mark.parametrize("level", GROW_LEVELS)
def test_add_map_points_step_matches_jax(ref, level):
    """add_map_points_step on the JAX map before each growth: the number
    of new points within 2 of the JAX step's (see
    test_epipolar_search_matches_jax), in the lowest free slots as there;
    the new points both made (matched by their source pixel) within 1e-3
    relative; root + epipolar measurements at this level; the thinned
    candidate masks equal."""
    j_map, j_new_in = ref["grow_in"][level]
    nxt = GROW_LEVELS.index(level) + 1
    j_out = (ref["grow_in"][GROW_LEVELS[nxt]][0] if nxt < len(GROW_LEVELS)
             else ref["map_grown"])
    t_in = convert.map_from_numpy(j_map, device="cpu")
    tsm, t_new = tfs.add_map_points_step(t_in, _t(j_new_in), ref["t_cam"], 1,
                                         level, ref["tcfg"])
    j_added = j_out.points.valid & ~j_map.points.valid
    t_added = tsm.points.valid.numpy() & ~j_map.points.valid
    # The 256 point slots of this size are full after levels 0 and 3:
    # at levels 1 and 2 both packages find matches and insert none.
    assert j_added.sum() >= (1 if level in (0, 3) else 0)
    assert level in (0, 3) or not (~j_map.points.valid).any()
    assert abs(int(t_added.sum()) - int(j_added.sum())) <= 2
    np.testing.assert_array_equal(t_new.numpy(), j_new_in | t_added)
    free = np.flatnonzero(~j_map.points.valid)
    np.testing.assert_array_equal(np.flatnonzero(t_added),
                                  free[:t_added.sum()])
    np.testing.assert_array_equal(tsm.keyframes.cand_valid[level].numpy(),
                                  j_out.keyframes.cand_valid[level])

    def by_source(center, pos, mask):
        return {tuple(c): x for c, x in zip(center[mask], pos[mask])}
    jp = by_source(j_out.points.center, j_out.points.pos_w, j_added)
    tp = by_source(tsm.points.center.numpy(), tsm.points.pos_w.numpy(),
                   t_added)
    common = set(jp) & set(tp)
    assert len(common) >= 0.9 * j_added.sum() - 1
    close = [np.abs(tp[c] - jp[c]).max() <= 1e-3 * np.abs(jp[c]).max()
             for c in common]
    assert not close or np.mean(close) >= 0.98
    assert (tsm.points.source_level.numpy()[t_added] == level).all()
    assert (tsm.points.source_kf.numpy()[t_added] == 1).all()
    src = tsm.meas.source.numpy()[t_added]
    assert (src[:, 0] == jms.SRC_ROOT).all()
    assert (src[:, 1] == jms.SRC_EPIPOLAR).all()
    assert (tsm.meas.kf.numpy()[t_added][:, :2] == [1, 0]).all()
    assert (tsm.meas.valid.numpy()[t_added].sum(1) == 2).all()


def test_add_map_points_step_without_a_target(ref):
    """With keyframe 0 invalid there is no other keyframe to search in:
    nothing is added and nothing raises."""
    j_map, _ = ref["grow_in"][0]
    t_in = convert.map_from_numpy(j_map, device="cpu")
    valid = t_in.keyframes.valid.clone()
    valid[0] = False
    t_in = t_in.replace(keyframes=t_in.keyframes.replace(valid=valid))
    N = valid.new_zeros(j_map.points.valid.shape[0])
    tsm, t_new = tfs.add_map_points_step(t_in, N, ref["t_cam"], 1, 0,
                                         ref["tcfg"])
    assert not t_new.any()
    np.testing.assert_array_equal(tsm.points.valid.numpy(),
                                  j_map.points.valid)


# ---------------------------------------------------------------------------
# The port's own chain, end to end
# ---------------------------------------------------------------------------


def test_port_bootstrap_end_to_end(ref):
    """The port's trail_start / trail_advance / init_from_stereo on the
    same images, with the JAX draws, against the JAX chain's results, by
    outcome: the trail count within 2%, (R2, t2) within 1e-3, n_ok within
    2%; after the 5 + up to 4 bundle-adjustment rounds and the four
    growths, the point count within 5% of the JAX chain's, the rms of the
    finished map within 10% of its rms, keyframe 1's aligned pose within
    5e-3 (about 130 LM iterations on maps that differ by a few points),
    points at the levels the JAX chain has them (0 and 3: the 256 slots of
    this size are full before levels 1 and 2), all in the prefix; then two frame_steps on the
    port's own map track GOOD with most points found."""
    cfg = ref["tcfg"]
    frames = [tfs.bootstrap_frontend(_t(im), cfg) for im in
              ref["imgs"][:N_TRAIL_FRAMES + 3]]
    trails = tboot.trail_start(frames[0][0], cfg)
    np.testing.assert_array_equal(trails.init_pos.numpy(), ref["steps"][0][0])
    for k in range(1, N_TRAIL_FRAMES + 1):
        trails, count = tboot.trail_advance(trails, frames[k][0],
                                            frames[k - 1][0], cfg)
        assert int(count) >= cfg.tracker.min_trails_to_continue
    n_ref = ref["steps"][-1][1].sum()
    assert abs(int(count) - n_ref) <= 0.02 * n_ref
    init = tboot.init_from_stereo(
        trails, frames[N_TRAIL_FRAMES][0], ref["t_cam"], cfg,
        homography_trial_idx=_t(ref["hom_idx"]),
        plane_trial_idx=_t(ref["plane_idx"]))
    assert init.ok, init.reason
    np.testing.assert_allclose(init.R2.numpy(), ref["R2"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(init.t2.numpy(), ref["t2"], rtol=0, atol=1e-3)
    assert abs(init.n_ok - ref["n_ok"]) <= 0.02 * ref["n_ok"]

    j2 = ref["map2"]
    j_live = j2.points.valid & ~j2.points.bad
    assert init.n_points > init.n_ok
    assert abs(init.n_points - j_live.sum()) <= 0.05 * j_live.sum()
    assert init.ba_converged and init.ba_rounds[0] == 5
    assert 1 <= init.ba_rounds[1] <= 4
    sm = init.slam_map
    live = sm.points.live().numpy()
    assert init.n_points == live.sum()
    assert not live[tboot.init_point_slots(cfg):].any()
    levels = sm.points.source_level.numpy()[live]
    j_levels = j2.points.source_level[j_live]
    for lvl in range(4):
        assert ((levels == lvl).sum() >= 1) == ((j_levels == lvl).sum() >= 1)
        assert abs((levels == lvl).sum() - (j_levels == lvl).sum()) <= max(
            3, 0.1 * (j_levels == lvl).sum())
    t_rms = _rms(sm, ref)
    j_rms = float(jbundle.reprojection_rms(_ba_problem(j2, ref["jcfg"]),
                                           ref["cam"]))
    assert abs(t_rms - j_rms) <= 0.1 * j_rms
    np.testing.assert_allclose(init.R.numpy(), j2.keyframes.R[1], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(init.t.numpy(), j2.keyframes.t[1], rtol=0,
                               atol=5e-3)
    np.testing.assert_array_equal(init.new_points.numpy(),
                                  live & (sm.points.source_kf.numpy() == 1))
    assert init.never_retry.shape == ref["never"].shape
    assert init.failure_mask.shape == ref["fail"].shape

    N, K = cfg.tracker.max_map_points, cfg.mapmaker.max_keyframes
    state = dict(sm=sm, R=init.R, t=init.t, v=init.velocity, msd=init.msd,
                 depth=init.depth, sbi=frames[N_TRAIL_FRAMES][1],
                 new=init.new_points)
    for i in range(2):
        out = tfs.frame_step(
            _t(ref["imgs"][N_TRAIL_FRAMES + 1 + i]), state["sm"],
            ref["t_cam"], state["R"], state["t"], state["v"], state["msd"],
            state["depth"], init.wiggle_depth_norm, state["sbi"],
            state["new"], init.failure_mask, torch.zeros(2), cfg,
            uniforms=ref["tracked"][i]["uniforms"])
        state = dict(sm=out.slam_map, R=out.R, t=out.t, v=out.velocity,
                     msd=out.msd, depth=out.depth, sbi=out.sbi,
                     new=out.new_points)
        assert out.stats[tfs.STAT_N_FOUND] > 0.5 * init.n_points
        assert out.stats[tfs.STAT_QUALITY] == 2  # GOOD
        np.testing.assert_allclose(out.R.numpy(), ref["tracked"][i]["R"],
                                   rtol=0, atol=5e-3)


def test_init_from_stereo_reports_a_non_finite_map(ref, monkeypatch):
    """Where the JAX package asks for a reset (a bundle-adjustment round
    leaves a non-finite map), init_from_stereo returns a failed StereoInit
    with that reason; and a map that has left the prefix raises."""
    cfg = ref["tcfg"]
    trails = convert.trails_from_numpy(
        ref["frames"][0], ref["extras0"], ref["patches"], ref["steps"][0][0],
        ref["steps"][-1][0], ref["steps"][-1][1], device="cpu")
    real = tfs.ba_round

    def corrupt(*args, **kwargs):
        sm, fail, never, conv, ok = real(*args, **kwargs)
        return sm, fail, never, conv, torch.zeros_like(ok)

    monkeypatch.setattr(tboot.fstep, "ba_round", corrupt)
    init = tboot.init_from_stereo(
        trails, _t_frame(ref, N_TRAIL_FRAMES), ref["t_cam"], cfg,
        homography_trial_idx=_t(ref["hom_idx"]),
        plane_trial_idx=_t(ref["plane_idx"]))
    assert not init.ok and init.slam_map is None
    assert init.reason == "bundle adjustment left a non-finite map"
    assert init.n_ok > 10

    def stray(*args, **kwargs):
        sm, *rest = real(*args, **kwargs)
        valid = sm.points.valid.clone()
        valid[-1] = True
        return (sm.replace(points=sm.points.replace(valid=valid)), *rest)

    monkeypatch.setattr(tboot.fstep, "ba_round", stray)
    monkeypatch.setattr(tboot, "init_point_slots", lambda config: 128)
    with pytest.raises(RuntimeError, match="left its first 128 point slots"):
        tboot.init_from_stereo(
            trails, _t_frame(ref, N_TRAIL_FRAMES), ref["t_cam"], cfg,
            homography_trial_idx=_t(ref["hom_idx"]),
            plane_trial_idx=_t(ref["plane_idx"]))


@pytest.mark.parametrize("reason", ["homography failed", "fewer than 10 points"])
def test_init_from_stereo_aborts(ref, reason):
    """The reference's aborts: no usable homography (all trails dead), and
    too few triangulated points (MapMaker.cc:313-316)."""
    cfg = ref["tcfg"]
    trails = convert.trails_from_numpy(
        ref["frames"][0], ref["extras0"], ref["patches"], ref["steps"][0][0],
        ref["steps"][-1][0], ref["steps"][-1][1], device="cpu")
    valid = trails.valid.clone()
    if reason == "homography failed":
        valid[:] = False
    else:
        keep = torch.nonzero(valid)[:8, 0]
        valid[:] = False
        valid[keep] = True
    init = tboot.init_from_stereo(
        trails.replace(valid=valid), _t_frame(ref, N_TRAIL_FRAMES),
        ref["t_cam"], cfg, generator=torch.Generator().manual_seed(0))
    assert not init.ok and init.slam_map is None
    assert init.reason == reason


def test_sideways_path_matches_the_jax_tests(ref):
    """utils/synthetic.sideways_pose is the path these frames were rendered
    along (tests/test_slam.py's): poses within 1e-6."""
    R0, t0 = jsyn.look_at_pose((0.0, 0.0, 0.0))
    for k in (0, 6, 25):
        jR, jt = _pose(R0, t0, k)
        tR, tt = tsyn.sideways_pose(_t(R0), _t(t0), k / (N_PATH - 1))
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
