"""Parity of the port's re-find with the JAX package on the CPU: the
keyframe-stack (kf_idx) forms of the coarse search and the subpixel
refinement, refind_pairs, refind_in_keyframe, integrate_keyframe, and the
budgeted refind_newly / refind_failures with their queues.

The map is made once with the JAX package from a seed, at 320x240: the
fixed map of utils/fixtures (keyframe 0 and 136 plane points at levels
0-3), keyframes 1-3 rendered along a short sideways path, and 40 more
plane points whose source patches lie in keyframe 1 (levels 0 and 1), so
templates come from two keyframes. Every point is observed in its source
keyframe only, so the other keyframes have points to re-find. The same
numpy arrays go to both packages.

Tolerances: coarse `found` equal on at least 99% of the lanes and the
matched position equal wherever both found (ZMSSD sums of ~1e6 can
reorder near-ties of the argmin); subpixel positions within 1e-3 px
wherever both converged; re-found measurements: the found set equal on at
least 99% of the points, positions within 1e-3 px where both found; the
queues and never-retry masks of refind_newly / refind_failures equal, the
measurement count within 2; integrate_keyframe's scene depth mean rtol
1e-5 and sigma within 1e-4 (the square root of a difference of two f32
sums of depths ~4 squared).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.config import MapMakerConfig
from visualslam_android_tpu.models import frame_step as jfs
from visualslam_android_tpu.models import keyframe as jkf
from visualslam_android_tpu.models import map_store as jms
from visualslam_android_tpu.models import mapmaker as jmm
from visualslam_android_tpu.models import tracker as jtracker
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu.ops import match as jmatch
from visualslam_android_tpu.utils import fixtures as jfix
from visualslam_android_tpu.utils import synthetic as jsyn
from visualslam_android_tpu_torch import config as tconfig
from visualslam_android_tpu_torch.models import frame_step as tfs
from visualslam_android_tpu_torch.models import mapmaker as tmm
from visualslam_android_tpu_torch.ops import match as tmatch
from visualslam_android_tpu_torch.utils import convert

torch.set_num_threads(2)

N_KF = 4          # keyframes 0-3 in the map; slot 4 is integrated by a test
K_SLOTS = 6       # max_keyframes of the test config
N_EXTRA = 40      # points sourced in keyframe 1
BUDGET = 64       # refind_pair_budget of the budget tests (< pending pairs)
FOUND_AGREE = 0.99
POS_ATOL = 1e-3


def _np(x):
    return jax.tree.map(np.array, x)  # writable copies


def _jx(x):
    return jax.tree.map(jnp.asarray, x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _configs(budget=4096):
    """The JAX config and the port's field-for-field copy."""
    jc = jfix.small_config()
    jc = jc.__class__(tracker=jc.tracker, mapmaker=MapMakerConfig(
        max_keyframes=K_SLOTS, refind_pair_budget=budget))

    def port(c):
        if dataclasses.is_dataclass(c):
            cls = getattr(tconfig, type(c).__name__)
            return cls(**{f.name: port(getattr(c, f.name))
                          for f in dataclasses.fields(c)})
        return c

    return jc, port(jc)


def _pose(k, R0, t0):
    mu = np.array([0.06 * k, 0.015 * k, 0.02 * k, 0.005 * k, 0.012 * k, 0.0],
                  np.float32)
    return jlie.se3_mul(*jlie.se3_exp(jnp.asarray(mu)), R0, t0)


@pytest.fixture(scope="module")
def case():
    jc, tc_ = _configs()
    tc = jc.tracker
    shape = (tc.height, tc.width)
    sm, cam, scene, (R0, t0), n_pts = jfix.build_fixed_map(
        jc, np.random.default_rng(11))
    kfs = sm.keyframes
    frames = []
    for k in range(1, N_KF + 1):
        R, t = _pose(k, R0, t0)
        frame = jkf.make_frame(jsyn.render(scene, cam, R, t, shape), jc)
        frames.append((frame, R, t))
        if k < N_KF:
            kfs = jkf.insert_keyframe(kfs, k, frame,
                                      jkf.make_frame_extras(frame, jc), R, t)
    sm = sm._replace(keyframes=kfs)

    # N_EXTRA points from keyframe 1's level-0 and level-1 candidates.
    pts, meas = _np(sm.points), _np(sm.meas)
    R1, t1 = kfs.R[1], kfs.t[1]
    slot = n_pts
    for lvl, n in ((0, N_EXTRA // 2), (1, N_EXTRA // 2)):
        xy = np.asarray(kfs.cand_xy[lvl][1][-n:], np.float32)
        zero = (xy + 0.5) * (1 << lvl) - 0.5
        pos_w = np.asarray(jsyn.plane_point_from_pixel(scene, cam, R1, t1,
                                                       jnp.asarray(zero)))
        rays = _np(jkf.candidate_rays(cam, jnp.asarray(xy), lvl))
        sl = slice(slot, slot + n)
        pts.valid[sl], pts.pos_w[sl] = True, pos_w
        pts.source_kf[sl], pts.source_level[sl] = 1, lvl
        pts.center[sl] = xy
        (pts.center_nc[sl], pts.right_nc[sl], pts.down_nc[sl],
         pts.normal_nc[sl]) = rays
        meas.kf[sl, 0], meas.uv[sl, 0], meas.level[sl, 0] = 1, zero, lvl
        meas.source[sl, 0], meas.subpix[sl, 0] = jms.SRC_ROOT, True
        meas.valid[sl, 0] = True
        slot += n
    pts = _np(jms.refresh_pixel_vectors(_jx(pts), kfs))
    sm = _np(sm._replace(points=pts, meas=meas))
    return dict(map=sm, cam=_np(cam), jc=jc, tc=tc_, n_pts=slot,
                frame4=_np(frames[-1]))


def _port_map(sm):
    return convert.map_from_numpy(sm, device="cpu")


def _port_cam(case):
    return convert.camera_from_numpy(case["cam"], device="cpu")


def _agree(a, b):
    either = a | b
    return float((a == b)[either].mean()) if either.any() else 1.0


@pytest.fixture(scope="module")
def pairs(case):
    """Every (point, keyframe) pair of the live points and keyframes 1-3,
    projected with the JAX package: predictions, search levels and warped
    templates for the kf_idx forms."""
    sm, jc = case["map"], case["jc"]
    tc = jc.tracker
    live = np.nonzero(sm.points.valid)[0]
    pt = np.repeat(live, N_KF - 1).astype(np.int32)
    kf = np.tile(np.arange(1, N_KF), len(live)).astype(np.int32)
    R, t = sm.keyframes.R[kf], sm.keyframes.t[kf]
    pc = np.einsum("qij,qj->qi", R, sm.points.pos_w[pt]) + t
    m = pc[:, :2] / pc[:, 2:3]
    px, derivs = _np(jtracker.cam_ops.project_derivs(_jx(case["cam"]),
                                                     jnp.asarray(m)))
    mr = np.einsum("qij,qj->qi", R, sm.points.pixel_right_w[pt])
    md = np.einsum("qij,qj->qi", R, sm.points.pixel_down_w[pt])
    warp, level, ok = _np(jmatch.calc_search_level_and_warp(
        jnp.asarray(pc), jnp.asarray(mr), jnp.asarray(md),
        jnp.asarray(derivs)))
    inside = ((px[:, 0] >= 0) & (px[:, 1] >= 0) & (px[:, 0] <= tc.width)
              & (px[:, 1] <= tc.height))
    tmpl = _np(jmatch.make_templates_warped_multilevel(
        _jx(sm.keyframes.pyramid), jnp.asarray(sm.points.source_kf[pt]),
        jnp.asarray(sm.points.source_level[pt]),
        jnp.asarray(sm.points.center[pt]), jnp.asarray(warp),
        jnp.asarray(level)))
    active = ok & inside & ~tmpl.bad
    assert active.sum() > 200
    return dict(pt=pt, kf=kf, px=px, level=level, tmpl=tmpl, active=active)


def _port_templates(tmpl):
    return tmatch.Templates(*(_t(getattr(tmpl, f.name))
                              for f in dataclasses.fields(tmatch.Templates)))


def test_coarse_search_kf_idx_matches_jax(case, pairs):
    kfs = case["map"].keyframes
    Q = len(pairs["pt"])
    args = dict(max_range=4, half_patch=5)
    want = _np(jmatch.find_patch_coarse_multilevel(
        _jx(kfs.pyramid), _jx(kfs.corner_mask), _jx(pairs["tmpl"]),
        jnp.asarray(pairs["px"]), jnp.asarray(pairs["level"]),
        jnp.full((Q,), 4.0), jnp.asarray(pairs["active"]),
        kf_idx=jnp.asarray(pairs["kf"]), **args))
    got = tmatch.find_patch_coarse_multilevel(
        tuple(_t(p) for p in kfs.pyramid),
        tuple(_t(m) for m in kfs.corner_mask),
        _port_templates(pairs["tmpl"]), _t(pairs["px"]), _t(pairs["level"]),
        torch.full((Q,), 4.0), _t(pairs["active"]), kf_idx=_t(pairs["kf"]),
        **args)
    f_j, f_t = want.found, got.found.numpy()
    assert f_j.sum() > 150, "too few matches for the comparison to mean much"
    assert _agree(f_t, f_j) >= FOUND_AGREE
    both = f_j & f_t
    np.testing.assert_allclose(got.pos_level.numpy()[both],
                               want.pos_level[both], atol=POS_ATOL)
    # The keyframe index matters: the same search in keyframe 0 only
    # finds something else.
    other = tmatch.find_patch_coarse_multilevel(
        tuple(_t(p[:1]) for p in kfs.pyramid),
        tuple(_t(m[:1]) for m in kfs.corner_mask),
        _port_templates(pairs["tmpl"]), _t(pairs["px"]), _t(pairs["level"]),
        torch.full((Q,), 4.0), _t(pairs["active"]), **args)
    assert _agree(other.found.numpy(), f_j) < 0.9


def test_subpix_kf_idx_matches_jax(case, pairs):
    kfs = case["map"].keyframes
    coarse = _np(jmatch.find_patch_coarse_multilevel(
        _jx(kfs.pyramid), _jx(kfs.corner_mask), _jx(pairs["tmpl"]),
        jnp.asarray(pairs["px"]), jnp.asarray(pairs["level"]),
        jnp.full((len(pairs["pt"]),), 4.0), jnp.asarray(pairs["active"]),
        max_range=4, kf_idx=jnp.asarray(pairs["kf"])))
    sel = coarse.found & (pairs["level"] > 0)
    sel[::3] |= coarse.found[::3]  # level-0 lanes too
    args = dict(max_iters=8, half_patch=5, conv_limit=0.03)
    want = _np(jmatch.iterate_subpix_multilevel(
        _jx(kfs.pyramid), _jx(pairs["tmpl"]), jnp.asarray(coarse.pos_level),
        jnp.asarray(pairs["level"]), jnp.asarray(sel),
        kf_idx=jnp.asarray(pairs["kf"]), **args))
    got = tmatch.iterate_subpix_multilevel(
        tuple(_t(p) for p in kfs.pyramid), _port_templates(pairs["tmpl"]),
        _t(coarse.pos_level), _t(pairs["level"]), _t(sel),
        kf_idx=_t(pairs["kf"]), **args)
    c_j, c_t = want.converged, got.converged.numpy()
    assert c_j.sum() > 100
    assert _agree(c_t, c_j) >= FOUND_AGREE
    both = c_j & c_t
    np.testing.assert_allclose(got.pos_zero.numpy()[both],
                               want.pos_zero[both], atol=POS_ATOL)


def test_refind_pairs_matches_jax(case, pairs):
    sm, jc, tc = case["map"], case["jc"], case["tc"]
    ok = np.ones(len(pairs["pt"]), bool)
    ok[::7] = False  # some lanes switched off
    want = _np(jmm.refind_pairs(
        _jx(sm), jnp.asarray(pairs["pt"]), jnp.asarray(pairs["kf"]),
        jnp.asarray(ok), _jx(case["cam"]), jc))
    got = [x.numpy() for x in tmm.refind_pairs(
        _port_map(sm), _t(pairs["pt"]), _t(pairs["kf"]), _t(ok),
        _port_cam(case), tc)]
    assert want[0].sum() > 150
    assert not (got[0] & ~ok).any()
    assert _agree(got[0], want[0]) >= FOUND_AGREE
    both = got[0] & want[0]
    np.testing.assert_allclose(got[1][both], want[1][both], atol=POS_ATOL)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3][both], want[3][both])


def _compare_meas(m_t, m_j, n_slack=0):
    """Measurement tables of two maps by outcome: the same number of valid
    measurements (within n_slack), and per point the same re-found set
    (within the found tolerance) at the same positions."""
    v_t, v_j = m_t.valid.numpy(), m_j.valid
    assert abs(int(v_t.sum()) - int(v_j.sum())) <= n_slack
    ref_t = v_t & (m_t.source.numpy() == jms.SRC_REFIND)
    ref_j = v_j & (m_j.source == jms.SRC_REFIND)
    K = int(max(m_t.kf.numpy().max(), m_j.kf.max())) + 1
    for k in range(K):
        a = (ref_t & (m_t.kf.numpy() == k)).any(1)
        b = (ref_j & (m_j.kf == k)).any(1)
        assert _agree(a, b) >= FOUND_AGREE, f"keyframe {k}"
        for n in np.nonzero(a & b)[0]:
            ot = np.nonzero(ref_t[n] & (m_t.kf.numpy()[n] == k))[0][0]
            oj = np.nonzero(ref_j[n] & (m_j.kf[n] == k))[0][0]
            np.testing.assert_allclose(m_t.uv.numpy()[n, ot], m_j.uv[n, oj],
                                       atol=POS_ATOL)


@pytest.mark.parametrize("kf", [1, 2, 3])
def test_refind_in_keyframe_matches_jax(case, kf):
    sm, jc, tc = case["map"], case["jc"], case["tc"]
    mask = sm.points.valid.copy()
    mask[5::9] = False
    jm, jf, jn = _np(jmm.refind_in_keyframe(_jx(sm), kf, _jx(case["cam"]),
                                           jnp.asarray(mask), jc))
    tm, tf, tn = tmm.refind_in_keyframe(_port_map(sm), kf, _port_cam(case),
                                        _t(mask), tc)
    assert jf.sum() > 50
    assert _agree(tf.numpy(), jf) >= FOUND_AGREE
    assert _agree(tn.numpy(), jn) >= FOUND_AGREE
    assert not (tf.numpy() & ~mask).any()
    _compare_meas(tm.meas, jm.meas, n_slack=int((tf.numpy() != jf).sum()))


def _tracker_found(case):
    """What track_map could have returned for frame 4: the live points that
    project into it, at their projections plus 0.2 px of noise, at random
    levels, 80% of them found, half of the found refined."""
    sm, frame4 = case["map"], case["frame4"]
    _, R, t = frame4
    rng = np.random.default_rng(3)
    N = sm.points.valid.shape[0]
    tc = case["jc"].tracker
    _, px, _, ok = _np(jtracker.project_points(
        _jx(case["cam"]), jnp.asarray(sm.points.pos_w), R, t,
        jnp.asarray([tc.width, tc.height], jnp.float32)))
    found = sm.points.valid & ok & (rng.uniform(size=N) < 0.8)
    pos = (px + rng.normal(scale=0.2, size=px.shape)).astype(np.float32)
    level = rng.integers(0, 4, N).astype(np.int32)
    subpix = found & (rng.uniform(size=N) < 0.5)
    return found, pos, level, subpix


def test_integrate_keyframe_matches_jax(case):
    sm, jc, tc = case["map"], case["jc"], case["tc"]
    frame, R, t = case["frame4"]
    N, K = sm.meas.valid.shape[0], sm.keyframes.valid.shape[0]
    found, pos, level, subpix = _tracker_found(case)
    rng = np.random.default_rng(4)
    new_points = rng.uniform(size=N) < 0.3
    never = rng.uniform(size=(N, K)) < 0.1
    failure = (rng.uniform(size=(N, K)) < 0.2) & ~never
    slot = N_KF
    want = _np(jfs.integrate_keyframe(
        _jx(sm), jnp.asarray(new_points), jnp.asarray(never),
        jnp.asarray(failure), _jx(frame), R, t, jnp.asarray(found),
        jnp.asarray(pos), jnp.asarray(level), jnp.asarray(subpix), slot,
        _jx(case["cam"]), jc))
    got = tfs.integrate_keyframe(
        _port_map(sm), _t(new_points), _t(never), _t(failure),
        convert.frame_from_numpy(frame, device="cpu"), _t(R), _t(t),
        _t(found), _t(pos), _t(level), _t(subpix), slot, _port_cam(case),
        tc)
    jm, tm = want[0], got[0]
    # The new keyframe: inserted with its candidates, scene depth refreshed.
    assert bool(tm.keyframes.valid[slot])
    assert not bool(tm.keyframes.fixed[slot])
    for a, b in zip(tm.keyframes.cand_xy, jm.keyframes.cand_xy):
        np.testing.assert_array_equal(a.numpy()[slot], b[slot])
    np.testing.assert_allclose(tm.keyframes.depth_mean.numpy()[slot],
                               jm.keyframes.depth_mean[slot], rtol=1e-5)
    np.testing.assert_allclose(tm.keyframes.depth_sigma.numpy()[slot],
                               jm.keyframes.depth_sigma[slot], atol=1e-4)
    # The tracker's measurements, exactly.
    tr_t = tm.meas.valid.numpy() & (tm.meas.source.numpy() == jms.SRC_TRACKER)
    tr_j = jm.meas.valid & (jm.meas.source == jms.SRC_TRACKER)
    np.testing.assert_array_equal(tr_t, tr_j)
    np.testing.assert_array_equal(tm.meas.uv.numpy()[tr_t], jm.meas.uv[tr_j])
    # The re-find in the new keyframe, and its queue bookkeeping.
    seen_t = (tm.meas.valid.numpy() & (tm.meas.kf.numpy() == slot)).any(1)
    seen_j = (jm.meas.valid & (jm.meas.kf == slot)).any(1)
    rf_diff = int((seen_t != seen_j).sum())
    _compare_meas(tm.meas, jm.meas, n_slack=rf_diff)
    for a, b in zip(got[1:], want[1:]):
        assert (a.numpy() != b).sum() <= rf_diff
    np.testing.assert_array_equal(got[1].numpy(), want[1])  # no growth here


def _refind_newly_both(case, n_kf):
    sm = case["map"]
    jc, tc = _configs(BUDGET)
    N, K = sm.meas.valid.shape[0], sm.keyframes.valid.shape[0]
    rng = np.random.default_rng(6)
    new_points = sm.points.valid & (rng.uniform(size=N) < 0.8)
    never = rng.uniform(size=(N, K)) < 0.05
    failure = (rng.uniform(size=(N, K)) < 0.2) & ~never
    j = (_jx(sm), jnp.asarray(new_points), jnp.asarray(never),
         jnp.asarray(failure))
    t = (_port_map(sm), _t(new_points), _t(never), _t(failure))
    cam_j, cam_t = _jx(case["cam"]), _port_cam(case)
    rounds = []
    for _ in range(2):  # two budgeted rounds: the leftovers of the first
        j = jfs.refind_newly(*j, cam_j, jc)
        t = tfs.refind_newly(*t, cam_t, tc, n_kf=n_kf)
        rounds.append((_np(j), t))
    return rounds, new_points


@pytest.mark.parametrize("n_kf", [K_SLOTS, N_KF])
def test_refind_newly_budgeted_matches_jax(case, n_kf):
    rounds, new_points = _refind_newly_both(case, n_kf)
    for i, (j, t) in enumerate(rounds):
        processed_all = not j[1].any()
        assert not processed_all, "the budget must leave pairs queued"
        np.testing.assert_array_equal(t[1].numpy(), j[1], f"round {i} queue")
        np.testing.assert_array_equal(t[2].numpy(), j[2],
                                      f"round {i} never-retry")
        np.testing.assert_array_equal(t[3].numpy(), j[3],
                                      f"round {i} failure queue")
        assert abs(int(t[0].meas.count()) - int(j[0].meas.valid.sum())) <= 2


@pytest.mark.parametrize("n_kf", [K_SLOTS, N_KF])
def test_refind_failures_budgeted_matches_jax(case, n_kf):
    sm = case["map"]
    jc, tc = _configs(BUDGET)
    N, K = sm.meas.valid.shape[0], sm.keyframes.valid.shape[0]
    rng = np.random.default_rng(7)
    never = rng.uniform(size=(N, K)) < 0.05
    failure = rng.uniform(size=(N, K)) < 0.4  # also dead points, slot 5
    j = (_jx(sm), jnp.asarray(never), jnp.asarray(failure))
    t = (_port_map(sm), _t(never), _t(failure))
    for i in range(2):
        j = _np(jfs.refind_failures(*j, _jx(case["cam"]), jc))
        t = tfs.refind_failures(*t, _port_cam(case), tc, n_kf=n_kf)
        assert j[2].any(), "the budget must leave pairs queued"
        np.testing.assert_array_equal(t[1].numpy(), j[1],
                                      f"round {i} never-retry")
        np.testing.assert_array_equal(t[2].numpy(), j[2],
                                      f"round {i} failure queue")
        assert abs(int(t[0].meas.count()) - int(j[0].meas.valid.sum())) <= 2
        j = _jx(j)


def test_pending_pairs_order_is_row_major(case):
    """The compaction takes the first budget pairs in [keyframe, point]
    order, as jnp.nonzero(size=Q) does: with a budget of 5 exactly the
    first five pending pairs are processed."""
    sm = case["map"]
    _, tc = _configs(5)
    pending = torch.zeros(6, sm.points.valid.shape[0], dtype=torch.bool)
    pending[1, [3, 9, 40]] = True
    pending[2, [0, 7, 8]] = True
    _, processed, _ = tfs._refind_pending_step(_port_map(sm), pending,
                                              _port_cam(case), tc)
    want = pending.clone()
    want[2, 8] = False
    assert torch.equal(processed, want)
