"""Parity of the port's mapping glue with the JAX package on the CPU: the
construction of the bundle-adjustment problem, the local adjust set, the
write-back with outlier routing, ba_round in both modes and on a prefix,
candidate thinning and candidate selection.

The map is made with numpy from a seed, at a small size: 12 keyframe slots
of which 9 hold keyframes along a sideways line (the first one fixed), 256
point slots of which 150 hold points seen with 0.3 px of noise (scaled by
the measurement's pyramid level) from up to 9 keyframes, 16 observation
slots per point; the first 30 points are seen by keyframes 0-3 only, so a
local round around keyframe 8 leaves them out. Some measurements are moved
by 30-60 px: root measurements (their points must die), measurements of
points with three observations (2 remain: they die too), and tracker /
epipolar / re-find measurements of well-observed points (routed to the
retry and never-retry masks). The same arrays go to both packages. The
epipolar search and add_map_points_step, which need real images, are held
in tests/test_torch_bootstrap.py on the bootstrap's own two keyframes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu import config as jconfig
from visualslam_android_tpu.models import bundle as jb
from visualslam_android_tpu.models import frame_step as jfs
from visualslam_android_tpu.models import map_store as jms
from visualslam_android_tpu.models import mapmaker as jmm
from visualslam_android_tpu.ops import camera as jcam
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu_torch import config as tconfig
from visualslam_android_tpu_torch.models import frame_step as tfs
from visualslam_android_tpu_torch.models import mapmaker as tmm
from visualslam_android_tpu_torch.utils import convert

torch.set_num_threads(2)

N_KFS, N_PTS, N_OLD = 9, 150, 30
W, H = 320, 240


def _np(x):
    return jax.tree.map(np.asarray, x)


def _jx(x):
    return jax.tree.map(jnp.asarray, x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _config(mod):
    return mod.SLAMConfig(
        tracker=mod.TrackerConfig(width=W, height=H, max_map_points=256,
                                  max_corners_per_level=(256, 128, 64, 32)),
        mapmaker=mod.MapMakerConfig(max_keyframes=12),
    )


def _numpy_map(rng, jcfg, cam):
    """The map described in the module docstring, as the JAX package's
    SLAMMap of numpy arrays, and the (point, slot) pairs that were moved."""
    sm = _np(jms.empty_map(jcfg))
    N, O = sm.meas.valid.shape
    K = sm.keyframes.valid.shape[0]
    kR, kt = sm.keyframes.R.copy(), sm.keyframes.t.copy()
    for i in range(N_KFS):
        mu = np.array([-0.2 * i, 0.03 * i, 0.0, 0.0, 0.03 * i, 0.0],
                      np.float32)
        kR[i], kt[i] = _np(jlie.se3_exp(jnp.asarray(mu)))
    pts = np.stack([rng.uniform(-0.5, 2.0, N_PTS),
                    rng.uniform(-1.0, 1.0, N_PTS),
                    rng.uniform(3.5, 6.0, N_PTS)], -1).astype(np.float32)
    kf = rng.integers(0, K, (N, O)).astype(np.int32)  # dead slots: anything
    uv = np.zeros((N, O, 2), np.float32)
    level = rng.integers(0, 4, (N, O)).astype(np.int32)
    source = rng.integers(0, 5, (N, O)).astype(np.int32)
    valid = np.zeros((N, O), bool)
    for n in range(N_PTS):
        seen_by = range(4) if n < N_OLD else range(N_KFS)
        if N_OLD <= n < N_OLD + 10:
            seen_by = range(5, 8)  # three observations only
        o = 0
        for k in seen_by:
            pc = kR[k] @ pts[n] + kt[k]
            px = np.asarray(jcam.project(cam, jnp.asarray(pc[:2] / pc[2])))
            if not (0 <= px[0] < W and 0 <= px[1] < H):
                continue
            lvl = int(rng.integers(0, 4))
            kf[n, o], level[n, o], valid[n, o] = k, lvl, True
            uv[n, o] = px + rng.normal(scale=0.3 * 2 ** lvl, size=2)
            source[n, o] = jms.SRC_ROOT if o == 0 else rng.choice(
                [jms.SRC_TRACKER, jms.SRC_REFIND, jms.SRC_TRAIL,
                 jms.SRC_EPIPOLAR])
            o += 1
    moved = []
    n_obs = valid.sum(1)
    for n, o in [(40, 0), (41, 0),                 # roots
                 (N_OLD + 2, 1), (N_OLD + 5, 2),   # three-observation points
                 (60, 2), (61, 3), (62, 1), (63, 4), (64, 2), (65, 5)]:
        assert valid[n, o] and n_obs[n] >= 3
        uv[n, o] += rng.uniform(30, 60, 2)
        moved.append((n, o))
    # Perturb the free keyframes and the points.
    for k in range(1, N_KFS):
        dmu = rng.normal(scale=0.01, size=6).astype(np.float32)
        kR[k], kt[k] = _np(jlie.se3_mul(*jlie.se3_exp(jnp.asarray(dmu)),
                                        jnp.asarray(kR[k]),
                                        jnp.asarray(kt[k])))
    pos_w = sm.points.pos_w.copy()
    pos_w[:N_PTS] = pts + rng.normal(scale=0.01, size=pts.shape)
    live = np.arange(N) < N_PTS
    kvalid = np.arange(K) < N_KFS
    unit = np.tile(np.array([0, 0, 1], np.float32), (N, 1))
    points = sm.points._replace(
        valid=live, pos_w=pos_w.astype(np.float32),
        source_kf=np.where(valid[:, 0], kf[:, 0], 0).astype(np.int32),
        center_nc=unit, right_nc=unit + np.float32([0.01, 0, 0]),
        down_nc=unit + np.float32([0, 0.01, 0]), normal_nc=-unit)
    cand_xy = tuple(
        np.stack([rng.integers(0, w, c.shape[:2]),
                  rng.integers(0, h, c.shape[:2])], -1).astype(np.int32)
        for c, (h, w) in zip(sm.keyframes.cand_xy,
                             jcfg.tracker.pyramid_shapes))
    cand_valid = tuple(rng.uniform(size=c.shape) < 0.8
                       for c in sm.keyframes.cand_valid)
    keyframes = sm.keyframes._replace(
        valid=kvalid, fixed=np.arange(K) == 0, R=kR, t=kt, cand_xy=cand_xy,
        cand_valid=cand_valid)
    meas = sm.meas._replace(kf=kf, uv=uv, level=level, source=source,
                            valid=valid)
    return sm._replace(points=points, keyframes=keyframes, meas=meas), moved


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = _config(jconfig), _config(tconfig)
    cam = jcam.make_camera(jcfg.camera.params(), W, H)
    sm, moved = _numpy_map(np.random.default_rng(0), jcfg, cam)
    return dict(jcfg=jcfg, tcfg=tcfg, cam=cam, sm=sm, moved=moved,
                t_cam=convert.camera_from_numpy(_np(cam), device="cpu"))


def _t_map(world, sm=None):
    return convert.map_from_numpy(world["sm"] if sm is None else sm,
                                  device="cpu")


def _assert_tree_equal(t_tree, j_tree, float_atol=0.0):
    for name in j_tree._fields:
        tv, jv = getattr(t_tree, name), np.asarray(getattr(j_tree, name))
        if jv.dtype.kind == "f" and float_atol:
            np.testing.assert_allclose(tv.numpy(), jv, rtol=0,
                                       atol=float_atol, err_msg=name)
        else:
            np.testing.assert_array_equal(tv.numpy(), jv, name)


# ---------------------------------------------------------------------------
# Problem construction, adjust set, write-back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("newest", [8, 2, 0])
def test_local_ba_adjust_mask_matches_jax(world, newest):
    """The newest keyframe and its 4 nearest, without the fixed one: equal
    masks; around keyframe 8 that is {4..8}."""
    jm = jmm.local_ba_adjust_mask(_jx(world["sm"]), newest, world["jcfg"])
    tm = tmm.local_ba_adjust_mask(_t_map(world), newest, world["tcfg"])
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if newest == 8:
        assert np.flatnonzero(tm.numpy()).tolist() == [4, 5, 6, 7, 8]
    # A 0-d tensor names the keyframe as well as an int.
    tm2 = tmm.local_ba_adjust_mask(_t_map(world), torch.tensor(newest),
                                   world["tcfg"])
    np.testing.assert_array_equal(tm2.numpy(), tm.numpy())


@pytest.mark.parametrize("mode", ["local", "global"])
def test_build_ba_problem_matches_jax(world, mode):
    """Every field of the BAProblem equal (copies, masks and 1/2^level).
    The local problem leaves out the points only keyframes 0-3 see."""
    jsm, tsm = _jx(world["sm"]), _t_map(world)
    if mode == "local":
        adjust = np.asarray(jmm.local_ba_adjust_mask(jsm, 8, world["jcfg"]))
    else:
        adjust = world["sm"].keyframes.valid & ~world["sm"].keyframes.fixed
    jp = jmm.build_ba_problem(jsm, jnp.asarray(adjust), world["jcfg"])
    tp = tmm.build_ba_problem(tsm, _t(adjust), world["tcfg"])
    _assert_tree_equal(tp, jp)
    n_in = int(tp.point_valid.sum())
    assert n_in == (N_PTS - N_OLD if mode == "local" else N_PTS)


def _jax_ba(world, mode, max_iters=5):
    """A JAX bundle adjustment of the map's local or global problem:
    (problem, result) as numpy."""
    jsm = _jx(world["sm"])
    adjust = (jmm.local_ba_adjust_mask(jsm, 8, world["jcfg"])
              if mode == "local"
              else jsm.keyframes.valid & ~jsm.keyframes.fixed)
    prob = jmm.build_ba_problem(jsm, adjust, world["jcfg"])
    res = jb.bundle_adjust(prob, world["cam"], max_iters=max_iters,
                           point_block=128, assembly="scatter")
    return _np(prob), _np(res)


@pytest.fixture(scope="module")
def jax_results(world):
    return {mode: _jax_ba(world, mode) for mode in ("local", "global")}


def test_apply_ba_result_matches_jax(world, jax_results):
    """The JAX global result written back by both: every field of points,
    keyframes' poses and measurements equal (float fields 1e-6: the pixel
    vectors are recomputed), and the retry / never / dies masks equal. The
    moved roots and the moved three-observation points die; moved tracker
    and epipolar measurements go to retry, re-find and trail ones to
    never."""
    prob, res = jax_results["global"]
    jsm, jretry, jnever, jdies = jmm.apply_ba_result(
        _jx(world["sm"]), _jx(prob), _jx(res), world["jcfg"])
    tsm, retry, never, dies = tmm.apply_ba_result(
        _t_map(world), convert.ba_problem_from_numpy(prob, device="cpu"),
        convert.ba_result_from_numpy(res, device="cpu"), world["tcfg"])
    for t, j in ((retry, jretry), (never, jnever), (dies, jdies)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    _assert_tree_equal(tsm.points, jsm.points, 1e-6)
    _assert_tree_equal(tsm.meas, jsm.meas)
    np.testing.assert_array_equal(tsm.keyframes.R.numpy(), res.cam_R)
    np.testing.assert_array_equal(tsm.keyframes.t.numpy(), res.cam_t)

    ej = res.outlier_meas
    src = world["sm"].meas.source
    for n, o in world["moved"]:
        assert ej[n, o], (n, o)
    d = dies.numpy()
    assert d[40] and d[41] and d[N_OLD + 2] and d[N_OLD + 5]
    assert not tsm.points.valid.numpy()[d].any()
    assert not tsm.meas.valid.numpy()[d].any()
    for n, o in world["moved"][4:]:
        if d[n]:
            continue
        want_retry = src[n, o] in (jms.SRC_TRACKER, jms.SRC_EPIPOLAR)
        assert retry.numpy()[n, o] == want_retry
        assert never.numpy()[n, o] == (not want_retry)
    assert retry.sum() + never.sum() >= 1
    assert not (retry & never).any()


def test_apply_ba_result_keeps_what_the_problem_left_out(world, jax_results):
    """A local result: on the points of the problem the port's map equals
    the JAX package's. The points only keyframes 0-3 see were not in the
    problem: the port keeps their measurements as they were, where the JAX
    package clears them (it writes the result's mask over the whole table;
    the reference removes ejected measurements only, MapMaker.cc:917-959)."""
    prob, res = jax_results["local"]
    jsm, *_ = jmm.apply_ba_result(_jx(world["sm"]), _jx(prob), _jx(res),
                                  world["jcfg"])
    tsm, *_ = tmm.apply_ba_result(
        _t_map(world), convert.ba_problem_from_numpy(prob, device="cpu"),
        convert.ba_result_from_numpy(res, device="cpu"), world["tcfg"])
    inside = prob.point_valid
    before = world["sm"].meas.valid
    assert inside.sum() == N_PTS - N_OLD
    np.testing.assert_array_equal(tsm.meas.valid.numpy()[inside],
                                  np.asarray(jsm.meas.valid)[inside])
    np.testing.assert_array_equal(tsm.meas.valid.numpy()[~inside],
                                  before[~inside])
    assert before[:N_OLD].sum() > 60
    assert not np.asarray(jsm.meas.valid)[:N_OLD].any()
    np.testing.assert_array_equal(tsm.points.valid.numpy(),
                                  np.asarray(jsm.points.valid))


@pytest.mark.parametrize("mode,cap", [("local", ()), ("global", ()),
                                      ("global", (192, 10))])
def test_ba_round_matches_jax(world, mode, cap):
    """ba_round with a budget of 3 iterations against the JAX package's,
    field by field: keyframe poses within 2e-4 and points within 2e-3
    (three LM steps of f32 solves; see tests/test_torch_bundle.py), the
    dead points equal, measurement validity equal on the points of the
    problem up to 2 flips (a measurement at the Tukey cut-off), the
    failure and never-retry masks up to as many, map_ok true and converged
    equal. On the prefix (192 point slots, 10 keyframe slots) the result
    is the full-shape run's within 1e-4 (sums over arrays of another
    length), with the same measurements kept."""
    N, K = 256, 12
    zeros = np.zeros((N, K), bool)
    args = dict(max_iters=3, assembly="scatter", solver="chol", mode=mode,
                cap=cap)
    jsm, jfail, jnever, jconv, jok = jfs.ba_round(
        _jx(world["sm"]), 8, jnp.asarray(zeros), jnp.asarray(zeros),
        world["cam"], world["jcfg"], **args)
    tsm, tfail, tnever, tconv, tok = tfs.ba_round(
        _t_map(world), 8, _t(zeros), _t(zeros), world["t_cam"],
        world["tcfg"], **args)
    assert bool(tok) and bool(jok)
    assert bool(tconv) == bool(jconv)
    np.testing.assert_allclose(tsm.keyframes.R.numpy(),
                               np.asarray(jsm.keyframes.R), rtol=0, atol=2e-4)
    np.testing.assert_allclose(tsm.keyframes.t.numpy(),
                               np.asarray(jsm.keyframes.t), rtol=0, atol=2e-4)
    np.testing.assert_allclose(tsm.points.pos_w.numpy(),
                               np.asarray(jsm.points.pos_w), rtol=0,
                               atol=2e-3)
    np.testing.assert_array_equal(tsm.points.valid.numpy(),
                                  np.asarray(jsm.points.valid))
    inside = np.arange(N) >= (N_OLD if mode == "local" else 0)
    flips = (tsm.meas.valid.numpy() != np.asarray(jsm.meas.valid))[inside]
    assert flips.sum() <= 2
    assert (tfail.numpy() != np.asarray(jfail)).sum() <= 2
    assert (tnever.numpy() != np.asarray(jnever)).sum() <= 2
    assert tfail.sum() + tnever.sum() >= 1
    # The fixed keyframe and the empty slots are untouched.
    np.testing.assert_array_equal(tsm.keyframes.R.numpy()[[0, 9, 10, 11]],
                                  world["sm"].keyframes.R[[0, 9, 10, 11]])
    np.testing.assert_array_equal(tsm.points.pos_w.numpy()[N_PTS:],
                                  world["sm"].points.pos_w[N_PTS:])
    if cap:
        full = tfs.ba_round(_t_map(world), 8, _t(zeros), _t(zeros),
                            world["t_cam"], world["tcfg"],
                            **dict(args, cap=()))
        np.testing.assert_allclose(tsm.keyframes.t.numpy(),
                                   full[0].keyframes.t.numpy(), rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(tsm.meas.valid.numpy(),
                                      full[0].meas.valid.numpy())


def test_ba_round_prefix_leaves_the_rest_alone(world):
    """A prefix that cuts the map (100 point slots, 6 keyframe slots):
    points and keyframes past it, and the measurements keyframes 6-8 made
    of prefix points, come back as they went in (the JAX package would
    hand those measurements to keyframe 5)."""
    zeros = torch.zeros(256, 12, dtype=torch.bool)
    before = world["sm"]
    tsm, *_ = tfs.ba_round(_t_map(world), 8, zeros, zeros, world["t_cam"],
                           world["tcfg"], max_iters=3, assembly="scatter",
                           solver="chol", mode="global", cap=(100, 6))
    np.testing.assert_array_equal(tsm.points.pos_w.numpy()[100:],
                                  before.points.pos_w[100:])
    np.testing.assert_array_equal(tsm.keyframes.t.numpy()[6:],
                                  before.keyframes.t[6:])
    outside = before.meas.valid & ((before.meas.kf >= 6)
                                   | (np.arange(256) >= 100)[:, None])
    survived = tsm.points.valid.numpy()
    assert outside[:100].sum() > 100
    np.testing.assert_array_equal(
        tsm.meas.valid.numpy()[outside & survived[:, None]], True)
    moved = tsm.keyframes.t.numpy()[1:6] - before.keyframes.t[1:6]
    assert np.abs(moved).max() > 1e-4
    with pytest.raises(ValueError):
        tfs.ba_round(_t_map(world), 8, zeros, zeros, world["t_cam"],
                     world["tcfg"], max_iters=1, assembly="scatter",
                     solver="chol", mode="recent")
    # The matrix-free CG solver runs a round on the same prefix and leaves
    # the rest alone the same way.
    tsm_cg, *_ = tfs.ba_round(_t_map(world), 8, zeros, zeros, world["t_cam"],
                              world["tcfg"], max_iters=1, assembly="scatter",
                              solver="pcg", mode="global", cap=(100, 6))
    np.testing.assert_array_equal(tsm_cg.points.pos_w.numpy()[100:],
                                  before.points.pos_w[100:])
    np.testing.assert_array_equal(tsm_cg.keyframes.t.numpy()[6:],
                                  before.keyframes.t[6:])
    assert torch.isfinite(tsm_cg.keyframes.t).all()


def test_obs_mask_to_point_kf_matches_jax(world):
    rng = np.random.default_rng(4)
    mask = world["sm"].meas.valid & (rng.uniform(size=(256, 16)) < 0.3)
    j = jfs._obs_mask_to_point_kf(jnp.asarray(mask),
                                  jnp.asarray(world["sm"].meas.kf), 12)
    t = tfs._obs_mask_to_point_kf(_t(mask), _t(world["sm"].meas.kf), 12)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.sum() > 100


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level,kf,radius", [(0, 8, 10), (1, 5, 10),
                                             (2, 5, 4), (3, 0, 3)])
def test_thin_candidates_matches_jax(world, level, kf, radius):
    """The blocked set equal: the same candidates lose their flag, at
    every level, other keyframes and levels untouched. Measurements at
    the frame's edge (their disks leave the image) are among them."""
    sm = world["sm"]
    uv = sm.meas.uv.copy()
    mine = sm.meas.valid & (sm.meas.kf == kf)
    rows = np.argwhere(mine)[:6]
    for (n, o), xy in zip(rows, [(0, 0), (W - 1, H - 1), (W + 40, 5),
                                 (3, H - 2), (W - 2, 100), (-30, -30)]):
        uv[n, o] = xy
    sm = sm._replace(meas=sm.meas._replace(uv=uv))
    jout = jmm.thin_candidates(_jx(sm), kf, level, radius)
    tin = _t_map(world, sm)
    tout = tmm.thin_candidates(tin, kf, level, radius)
    for lv in range(4):
        np.testing.assert_array_equal(
            tout.keyframes.cand_valid[lv].numpy(),
            np.asarray(jout.keyframes.cand_valid[lv]), f"level {lv}")
    before = sm.keyframes.cand_valid[level][kf]
    after = tout.keyframes.cand_valid[level][kf].numpy()
    assert (before & ~after).sum() >= 1 and after.sum() >= 1
    # The input map keeps its masks.
    np.testing.assert_array_equal(tin.keyframes.cand_valid[level].numpy(),
                                  sm.keyframes.cand_valid[level])


@pytest.mark.parametrize("max_n", [40, 256, 300])
def test_select_top_candidates_matches_jax(world, max_n):
    """The first max_n valid candidates in slot order, then invalid ones:
    equal slabs (a stable sort on both sides)."""
    xy = world["sm"].keyframes.cand_xy[0][3].astype(np.float32)
    ok = world["sm"].keyframes.cand_valid[0][3]
    jxy, jok = jmm.select_top_candidates(jnp.asarray(xy), jnp.asarray(ok),
                                         max_n)
    txy, tok = tmm.select_top_candidates(_t(xy), _t(ok), max_n)
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.shape[0] == min(max_n, 256)
    if max_n == 40:
        assert tok.all()
        np.testing.assert_array_equal(txy.numpy(), xy[ok][:40])


def test_row_corner_list_keeps_the_first_corners_of_each_row():
    """The epipolar search's corner list against the JAX package's
    construction (a stable argsort of each row): the same x positions in
    the same order wherever a slot is ok, the same ok flags; a row with
    more corners than the cap keeps its first ones by x."""
    rng = np.random.default_rng(6)
    cm = rng.uniform(size=(30, 100)) < 0.2
    cm[4] = True           # 100 corners in one row
    cm[7] = False          # none
    B = tmm.EPI_CORNERS_PER_ROW
    assert B == jmm.EPI_CORNERS_PER_ROW == 32
    order = np.asarray(
        jnp.argsort(~jnp.asarray(cm), axis=1, stable=True))[:, :B]
    count = cm.sum(1)
    j_ok = (np.arange(B)[None] < count[:, None]).reshape(-1)
    cx, cy, ok = tmm._row_corner_list(_t(cm), B)
    np.testing.assert_array_equal(ok.numpy(), j_ok)
    np.testing.assert_array_equal(cx.numpy()[j_ok], order.reshape(-1)[j_ok])
    np.testing.assert_array_equal(cy.numpy(), np.repeat(np.arange(30), B))
    assert cx.numpy().reshape(30, B)[4].tolist() == list(range(32))
    assert (count > B).sum() == 1 and ok.sum() == np.minimum(count, B).sum()
    # A level narrower than the cap.
    cx2, _, ok2 = tmm._row_corner_list(_t(cm[:, :20]), B)
    assert cx2.shape[0] == 30 * 20 and ok2.sum() == cm[:, :20].sum()
