"""Parity of the port's bundle adjustment with the JAX package on the CPU:
the M-estimators and small solvers it stands on, every stage of one LM
step from the same state, and whole runs by outcome.

The problem is tests/test_bundle.py's (its own copy here): 4 cameras, one
of them fixed, 120 points, up to 8 observations, 0.3 px of noise, 6 gross
outliers, padded with dead camera and point slots whose measurement rows
hold garbage camera indices (in range, past the last slot, negative). The
same numpy arrays go to both packages.

Why whole runs are compared by outcome and single stages tightly: a step
is accepted on a strict comparison of two f32 sums over ~1000 terms, which
the two packages add up in different orders, so after a few steps their
lambda schedules may part for good; the JAX package's own two assemblies
differ in pose by 2e-3 after 8 steps for the same reason. One step from
the same state has no such branch. Tolerances stand beside the assertions.

The JAX bundle_adjust is jitted per (shapes, static arguments): every run
here uses one problem shape, assembly="scatter", point_block=64, and
max_iters of 1, 3, 10 or 20.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.config import CameraConfig
from visualslam_android_tpu.models import bundle as jb
from visualslam_android_tpu.ops import camera as jcam
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu.ops import mestimator as jme
from visualslam_android_tpu.ops import wls as jwls
from visualslam_android_tpu_torch.models import bundle as tb
from visualslam_android_tpu_torch.ops import camera as tcam
from visualslam_android_tpu_torch.ops import mestimator as tme
from visualslam_android_tpu_torch.ops import wls as twls
from visualslam_android_tpu_torch.utils import convert

torch.set_num_threads(2)

N_CAMS, N_PTS, O_MAX = 4, 120, 8
BLOCK = 64
N_PLANTED = 6


def _np(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _make_problem(rng, noise_px=0.3, perturb=0.02, n_outlier_meas=0):
    """tests/test_bundle.py's _make_problem as numpy arrays, with garbage
    camera indices on the dead measurement slots."""
    cam = jcam.make_camera(CameraConfig().params(), 640, 480)
    K_pad, N_pad = N_CAMS + 2, N_PTS + 16
    pts_true = np.stack([rng.uniform(-1.5, 1.5, N_PTS),
                         rng.uniform(-1.0, 1.0, N_PTS),
                         rng.uniform(3.5, 6.0, N_PTS)], -1).astype(np.float32)
    poses = []
    for i in range(N_CAMS):
        mu = np.array([0.3 * i, 0.05 * i, 0.0, 0.0, -0.05 * i, 0.0],
                      np.float32)
        poses.append(_np(jlie.se3_exp(jnp.asarray(mu))))

    meas_kf = np.zeros((N_pad, O_MAX), np.int32)
    meas_uv = np.zeros((N_pad, O_MAX, 2), np.float32)
    meas_valid = np.zeros((N_pad, O_MAX), bool)
    for n in range(N_PTS):
        o = 0
        for k, (R, t) in enumerate(poses):
            pc = R @ pts_true[n] + t
            px = np.asarray(jcam.project(cam, jnp.asarray(pc[:2] / pc[2])))
            if pc[2] <= 0.1 or not (0 <= px[0] < 640 and 0 <= px[1] < 480):
                continue
            meas_kf[n, o] = k
            meas_uv[n, o] = px + rng.normal(scale=noise_px, size=2)
            meas_valid[n, o] = True
            o += 1
    corrupted = []
    if n_outlier_meas:
        flat = [(n, o) for n in range(N_PTS) for o in range(O_MAX)
                if meas_valid[n, o] and meas_kf[n, o] != 0]
        for s in rng.choice(len(flat), n_outlier_meas, replace=False):
            n, o = flat[s]
            meas_uv[n, o] += rng.uniform(30, 60, 2)
            corrupted.append((n, o))
    # Dead slots hold anything.
    garbage = rng.choice(np.array([0, 3, K_pad - 1, 99, -1], np.int32),
                         meas_kf.shape)
    meas_kf = np.where(meas_valid, meas_kf, garbage).astype(np.int32)

    cam_R = np.stack([p[0] for p in poses]
                     + [np.eye(3, dtype=np.float32)] * (K_pad - N_CAMS))
    cam_t = np.stack([p[1] for p in poses]
                     + [np.zeros(3, np.float32)] * (K_pad - N_CAMS))
    for k in range(1, N_CAMS):
        dmu = rng.normal(scale=perturb, size=6).astype(np.float32)
        R2, t2 = jlie.se3_mul(*jlie.se3_exp(jnp.asarray(dmu)),
                              jnp.asarray(cam_R[k]), jnp.asarray(cam_t[k]))
        cam_R[k], cam_t[k] = np.asarray(R2), np.asarray(t2)
    pts_pad = np.zeros((N_pad, 3), np.float32)
    pts_pad[:N_PTS] = pts_true + rng.normal(
        scale=perturb, size=pts_true.shape).astype(np.float32)
    point_valid = np.arange(N_pad) < N_PTS
    cam_fixed = np.ones(K_pad, bool)
    cam_fixed[1:N_CAMS] = False
    prob = jb.BAProblem(
        cam_R=cam_R, cam_t=cam_t, cam_fixed=cam_fixed,
        cam_valid=np.arange(K_pad) < N_CAMS, points=pts_pad,
        point_valid=point_valid, meas_kf=meas_kf, meas_uv=meas_uv,
        meas_sqrt_inv_noise=np.ones((N_pad, O_MAX), np.float32),
        meas_valid=meas_valid,
    )
    return prob, cam, poses, corrupted


def _both(prob, cam):
    """(JAX problem, JAX camera, port problem, port camera)."""
    return (jax.tree.map(jnp.asarray, prob), cam,
            convert.ba_problem_from_numpy(prob, device="cpu"),
            convert.camera_from_numpy(_np(cam), device="cpu"))


@pytest.fixture(scope="module")
def noisy():
    prob, cam, poses, corrupted = _make_problem(
        np.random.default_rng(0), n_outlier_meas=N_PLANTED)
    return dict(prob=prob, cam=cam, poses=poses, corrupted=corrupted)


def _close(t, j, rtol, atol, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# What bundle adjustment stands on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("estimator", [jme.TUKEY, jme.CAUCHY, jme.HUBER,
                                       jme.LEAST_SQUARES])
def test_mestimators_match_jax(estimator):
    """sigma^2, weights, square-root weights and objective scores of all
    four estimators on squared errors over 8 decades with a mask: rtol
    2e-6 (elementwise f32; the median is one element of the same sort)."""
    rng = np.random.default_rng(1)
    e = (10.0 ** rng.uniform(-4, 4, 257)).astype(np.float32)
    mask = rng.uniform(size=257) < 0.7
    js = jme.find_sigma_squared(jnp.asarray(e), jnp.asarray(mask), estimator)
    ts = tme.find_sigma_squared(_t(e), _t(mask), estimator)
    _close(ts, js, 2e-6, 0)
    s = np.float32(js) if float(js) > 0 else np.float32(1.0)
    for name in ("weight", "square_root_weight", "objective_score"):
        j = getattr(jme, name)(jnp.asarray(e), jnp.asarray(s), estimator)
        t = getattr(tme, name)(_t(e), _t(s), estimator)
        _close(t, j, 2e-6, 1e-7, name)
    # No mask, and nothing valid.
    _close(tme.find_sigma_squared(_t(e), None, estimator),
           jme.find_sigma_squared(jnp.asarray(e), None, estimator), 2e-6, 0)
    none = np.zeros(257, bool)
    assert float(tme.find_sigma_squared(_t(e), _t(none), estimator)) == 0.0


def test_wls_solvers_match_jax():
    """solve_normal_equations and solve_spd on a 40 x 6 weighted system:
    x within rtol 1e-4 (Cholesky of an f32 information matrix), A within
    1e-6; a matrix that is not positive definite gives NaN, not an
    exception."""
    rng = np.random.default_rng(2)
    J = rng.normal(size=(40, 6)).astype(np.float32)
    e = rng.normal(size=40).astype(np.float32)
    w = rng.uniform(0.1, 1.0, 40).astype(np.float32)
    jx, jA = jwls.solve_normal_equations(jnp.asarray(J), jnp.asarray(e),
                                         jnp.asarray(w), prior=0.5)
    tx, tA = twls.solve_normal_equations(_t(J), _t(e), _t(w), prior=0.5)
    _close(tA, jA, 1e-6, 1e-6)
    _close(tx, jx, 1e-4, 1e-6)
    tx2, _ = twls.solve_normal_equations(_t(J), _t(e))
    jx2, _ = jwls.solve_normal_equations(jnp.asarray(J), jnp.asarray(e))
    _close(tx2, jx2, 1e-4, 1e-6)
    b = rng.normal(size=6).astype(np.float32)
    _close(twls.solve_spd(tA, _t(b)), jwls.solve_spd(jA, jnp.asarray(b)),
           1e-4, 1e-6)
    bad = twls.solve_spd(-torch.eye(3), torch.ones(3))
    assert torch.isnan(bad).all()


def test_camera_helpers_match_jax(noisy):
    cam = noisy["cam"]
    t_cam = convert.camera_from_numpy(_np(cam), device="cpu")
    _close(tcam.one_pixel_dist(t_cam), jcam.one_pixel_dist(cam), 1e-5, 0)
    v = np.array([[0, 0], [639.5, 100], [640, 100], [5, 479], [5, 480],
                  [-0.1, 3], [320, 240]], np.float32)
    for border in (0.0, 10.0):
        np.testing.assert_array_equal(
            tcam.in_image(t_cam, _t(v), border).numpy(),
            np.asarray(jcam.in_image(cam, jnp.asarray(v), border)))


# ---------------------------------------------------------------------------
# One LM step from the same state, stage by stage
# ---------------------------------------------------------------------------


def _jax_linearize(jp, cam):
    """lm_step's first half (bundle.py:541-600) with the JAX package's own
    functions."""
    mv = jp.meas_valid & jp.point_valid[:, None]
    pc, err, err_sq, z_bad = jb._project_all(cam, jp.cam_R, jp.cam_t,
                                             jp.points, jp)
    ok = mv & ~z_bad
    sigma_sq = jnp.maximum(
        jme.find_sigma_squared(err_sq.reshape(-1), ok.reshape(-1)),
        jb.MIN_SIGMA_SQ)
    sqrt_w = jme.square_root_weight(err_sq, sigma_sq)
    bad = mv & (z_bad | (sqrt_w == 0.0))
    good = mv & ~bad
    cur = jnp.sum(jnp.where(good, jme.objective_score(err_sq, sigma_sq),
                            0.0)) + jnp.sum(bad.astype(jnp.float32))
    A, B = jb._jacobians(cam, pc, jp.cam_R[jp.meas_kf],
                         jnp.where(good, sqrt_w, 0.0),
                         jp.meas_sqrt_inv_noise, jp.cam_fixed[jp.meas_kf])
    g = good[..., None]
    eps = jnp.where(g, err * sqrt_w[..., None], 0.0)
    A, B = jnp.where(g[..., None], A, 0.0), jnp.where(g[..., None], B, 0.0)
    K = jp.cam_R.shape[0]
    kf = jp.meas_kf.reshape(-1)
    return dict(
        pc=pc, err=err, err_sq=err_sq, z_bad=z_bad, A=A, B=B, eps=eps,
        sigma_sq=sigma_sq, current_error=cur, bad=bad, good=good,
        U=jnp.zeros((K, 6, 6)).at[kf].add(
            jnp.einsum("nora,norb->noab", A, A).reshape(-1, 6, 6)),
        eps_a=jnp.zeros((K, 6)).at[kf].add(
            jnp.einsum("nora,nor->noa", A, eps).reshape(-1, 6)),
        V=jnp.einsum("nora,norb->nab", B, B),
        eps_b=jnp.einsum("nora,nor->na", B, eps),
        W=jnp.einsum("nora,norb->noab", A, B),
    )


def _jax_inner(jp, lin, lam):
    """inner_body (bundle.py:622-733) for the scatter assembly and the
    Cholesky solver, with the JAX package's own functions."""
    K = jp.cam_R.shape[0]
    V, W, U = lin["V"], lin["W"], lin["U"]
    eye3, eye6 = jnp.eye(3), jnp.eye(6)
    Vs = V + lam * V * eye3[None]
    singular = (V[:, 0, 0] * V[:, 1, 1] * V[:, 2, 2] == 0.0)[:, None, None]
    Vinv = jnp.where(singular, 0.0,
                     jwls.inv3x3(jnp.where(singular, eye3[None], Vs)))
    Y = jnp.einsum("noab,nbc->noac", W, Vinv)
    free = jp.cam_valid & ~jp.cam_fixed
    S_corr, E_corr = jb._schur_blocks_scatter(jp.meas_kf, Y, W, lin["eps_b"],
                                              K, BLOCK)
    kk = jnp.arange(K)
    S = (-S_corr).at[kk, :, kk, :].add(U * (1.0 + lam * eye6[None]))
    S = jnp.where(free[:, None, None, None] & free[None, None, :, None], S,
                  0.0)
    S = S.at[kk, :, kk, :].add(
        jnp.where(free[:, None, None], 0.0, eye6[None]))
    E = jnp.where(free[:, None], lin["eps_a"] - E_corr, 0.0)
    Sm = S.reshape(K * 6, K * 6) + 1e-9 * jnp.eye(K * 6)
    cam_upd = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(Sm, lower=True), E.reshape(-1)
    ).reshape(K, 6)
    wtd = jnp.einsum("noab,noa->nob", W, cam_upd[jp.meas_kf])
    pt_upd = jnp.einsum("nab,nb->na", Vinv, lin["eps_b"] - jnp.sum(wtd, 1))
    pt_upd = jnp.where(jp.point_valid[:, None], pt_upd, 0.0)
    return dict(Y=Y, S_corr=S_corr, E_corr=E_corr, S=Sm, E=E,
                cam_upd=cam_upd, pt_upd=pt_upd)


@pytest.fixture(scope="module")
def step(noisy):
    """Both packages' first LM step from the problem's own state."""
    jp, cam, tp, t_cam = _both(noisy["prob"], noisy["cam"])
    # The JAX helpers index with meas_kf as it stands: give them the
    # in-range indices the port's sanitised problem holds (dead slots only).
    tp_s, t_valid = tb._sanitized(tp)
    jp = jp._replace(meas_kf=jnp.asarray(tp_s.meas_kf.numpy()))
    jlin = _jax_linearize(jp, cam)
    tlin = tb._linearize(tp_s, t_cam, tp_s.cam_R, tp_s.cam_t, tp_s.points,
                         t_valid, tp_s.cam_fixed[tp_s.meas_kf.long()],
                         tb.MIN_SIGMA_SQ)
    lam = 1e-4
    jin = _jax_inner(jp, jlin, lam)
    tin = tb._solve_and_step(tlin, tp_s, t_cam, tp_s.cam_R, tp_s.cam_t,
                             tp_s.points, lam, BLOCK, 1e-6)
    return dict(jp=jp, cam=cam, tp=tp_s, t_cam=t_cam, t_valid=t_valid,
                jlin=jlin, tlin=tlin, jin=jin, tin=tin)


def test_sanitized_problem_masks_garbage_indices(noisy):
    """Dead slots hold camera indices past the last slot and negative
    ones: after _sanitized every index names a slot and no valid
    measurement was changed."""
    tp = convert.ba_problem_from_numpy(noisy["prob"], device="cpu")
    assert int(tp.meas_kf.max()) == 99 and int(tp.meas_kf.min()) == -1
    ts, valid = tb._sanitized(tp)
    K = tp.cam_R.shape[0]
    assert int(ts.meas_kf.min()) >= 0 and int(ts.meas_kf.max()) < K
    np.testing.assert_array_equal(valid.numpy(), noisy["prob"].meas_valid)
    np.testing.assert_array_equal(ts.meas_kf.numpy()[valid.numpy()],
                                  noisy["prob"].meas_kf[valid.numpy()])


def test_project_all_matches_jax(step):
    """Camera-frame points within 1e-5, noise-scaled errors within 2e-3 px
    (f32 at pixel magnitudes of ~500), z_bad equal, on valid slots."""
    jp, tp = step["jp"], step["tp"]
    pc, err, err_sq, z_bad = tb._project_all(step["t_cam"], tp.cam_R,
                                             tp.cam_t, tp.points, tp)
    v = step["t_valid"].numpy()
    jl = step["jlin"]
    assert v.sum() > 300
    np.testing.assert_allclose(pc.numpy()[v], np.asarray(jl["pc"])[v],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(err.numpy()[v], np.asarray(jl["err"])[v],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(err_sq.numpy()[v], np.asarray(jl["err_sq"])[v],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(z_bad.numpy()[v], np.asarray(jl["z_bad"])[v])


def test_jacobians_match_jax(step):
    """A and B on the good measurements: atol 1e-5 of the largest entry
    (the port multiplies the 2x2 camera derivative by the 2x3 perspective
    derivative once and takes A's rotation columns as a cross product; the
    JAX package sums six motions one by one), and A is zero for the fixed
    camera."""
    jl, tl = step["jlin"], step["tlin"]
    for name in ("A", "B"):
        j = np.asarray(jl[name])
        _close(tl[name], j, 0, 1e-5 * np.abs(j).max(), name)
    fixed_m = step["tp"].cam_fixed[step["tp"].meas_kf.long()].numpy()
    assert np.abs(tl["A"].numpy()[fixed_m]).max() == 0.0
    assert np.abs(tl["A"].numpy()).max() > 10.0


def test_accumulators_match_jax(step):
    """sigma^2 and the objective within rtol 1e-5; U, V, W, eps, eps_a,
    eps_b within 1e-5 of each one's largest entry (sums of up to ~500
    products of f32 Jacobian entries, in another order); ejection mask
    equal."""
    jl, tl = step["jlin"], step["tlin"]
    _close(tl["sigma_sq"], jl["sigma_sq"], 1e-5, 0)
    _close(tl["current_error"], jl["current_error"], 1e-5, 0)
    np.testing.assert_array_equal(tl["bad"].numpy(), np.asarray(jl["bad"]))
    for name in ("U", "V", "W", "eps", "eps_a", "eps_b"):
        j = np.asarray(jl[name])
        _close(tl[name], j, 0, 1e-5 * np.abs(j).max(), name)


@pytest.mark.parametrize("reference", ["scatter", "onehot"])
def test_schur_blocks_match_jax(step, reference):
    """_schur_blocks_scatter on the JAX step's own Y, W and eps_b against
    the JAX scatter form and against its one-hot form (the same sums by
    dense contractions): rtol 1e-4 of the largest entry."""
    jp, jl, jin = step["jp"], step["jlin"], step["jin"]
    K = jp.cam_R.shape[0]
    Y, W, eps_b = jin["Y"], jl["W"], jl["eps_b"]
    if reference == "scatter":
        jS, jE = jin["S_corr"], jin["E_corr"]
    else:
        C = jax.nn.one_hot(jp.meas_kf, K) * (
            jl["good"] & ~jp.cam_fixed[jp.meas_kf])[..., None]
        jS, jE = jb._schur_blocks(C, Y, W, eps_b, BLOCK)
    tS, tE = tb._schur_blocks_scatter(_t(jp.meas_kf), _t(Y), _t(W),
                                      _t(eps_b), K, BLOCK)
    assert tS.shape == (K, 6, K, 6)
    jS, jE = np.asarray(jS), np.asarray(jE)
    assert np.abs(jS).max() > 1.0
    _close(tS, jS, 0, 1e-4 * np.abs(jS).max())
    _close(tE, jE, 0, 1e-4 * np.abs(jE).max())
    # Another chunking gives the same sums.
    tS2, _ = tb._schur_blocks_scatter(_t(jp.meas_kf), _t(Y), _t(W),
                                      _t(eps_b), K, 1000)
    _close(tS2, tS.numpy(), 0, 1e-5 * np.abs(jS).max())


def test_reduced_system_and_updates_match_jax(step):
    """S and E within 1e-4 of their largest entries; the camera update
    within 5e-5 absolute and the point updates within 2e-3 of the largest
    (0.5 here: the perturbed problem is weak along depth, so the inverse
    point blocks amplify the 2e-5 by which two f32 Cholesky solves of the
    same 18-unknown system differ). Fixed and dead cameras have identity
    rows and take no update."""
    jin, tin = step["jin"], step["tin"]
    jS, jE = np.asarray(jin["S"]), np.asarray(jin["E"])
    _close(tin["S"], jS, 0, 1e-4 * np.abs(jS).max())
    _close(tin["E"], jE, 0, 1e-4 * np.abs(jE).max())
    _close(tin["cam_upd"], jin["cam_upd"], 0, 5e-5)
    jpu = np.asarray(jin["pt_upd"])
    _close(tin["pt_upd"], jpu, 0, 2e-3 * np.abs(jpu).max())
    S = tin["S"].numpy()
    for k in (0, N_CAMS, N_CAMS + 1):
        rows = S[6 * k:6 * k + 6]
        expect = np.zeros_like(rows)
        expect[:, 6 * k:6 * k + 6] = np.eye(6) * (1 + 1e-9)
        np.testing.assert_array_equal(rows, expect.astype(np.float32))
        assert np.abs(tin["cam_upd"].numpy()[k]).max() == 0.0
    assert np.abs(tin["cam_upd"].numpy()).max() > 1e-3


def test_one_lm_step_matches_jax(noisy):
    """bundle_adjust(max_iters=1) from the same state: the step is accepted
    by both, poses within 1e-4, points within 1e-3 (they move by up to 0.5;
    see test_reduced_system_and_updates_match_jax), sigma^2 within rtol
    1e-5, the same measurements ejected."""
    jp, cam, tp, t_cam = _both(noisy["prob"], noisy["cam"])
    jr = jb.bundle_adjust(jp, cam, max_iters=1, point_block=BLOCK,
                          assembly="scatter")
    tb.HOST_READS["bundle_adjust"] = 0
    tr = tb.bundle_adjust(tp, t_cam, max_iters=1, point_block=BLOCK,
                          assembly="scatter")
    assert tb.HOST_READS["bundle_adjust"] == 1
    assert int(tr.accepted) == int(jr.accepted) == 1
    _close(tr.cam_R, jr.cam_R, 0, 1e-4)
    _close(tr.cam_t, jr.cam_t, 0, 1e-4)
    _close(tr.points, jr.points, 0, 1e-3)
    _close(tr.sigma_squared, jr.sigma_squared, 1e-5, 0)
    np.testing.assert_array_equal(tr.outlier_meas.numpy(),
                                  np.asarray(jr.outlier_meas))
    np.testing.assert_array_equal(tr.meas_valid.numpy(),
                                  np.asarray(jr.meas_valid))
    np.testing.assert_array_equal(tr.point_outliers.numpy(),
                                  np.asarray(jr.point_outliers))


# ---------------------------------------------------------------------------
# Whole runs, by outcome
# ---------------------------------------------------------------------------


def _objective(prob, cam, res):
    """The robust objective both packages minimise, at a result's state,
    by the JAX package's functions: Tukey scores at the result's own sigma
    over the measurements it kept, plus one per ejected measurement."""
    _, _, err_sq, z_bad = jb._project_all(
        cam, jnp.asarray(np.asarray(res.cam_R)),
        jnp.asarray(np.asarray(res.cam_t)),
        jnp.asarray(np.asarray(res.points)), prob)
    keep = jnp.asarray(np.asarray(res.meas_valid)) & ~z_bad
    s = jnp.asarray(np.asarray(res.sigma_squared))
    score = jnp.sum(jnp.where(keep, jme.objective_score(err_sq, s), 0.0))
    return float(score) + float(np.asarray(res.outlier_meas).sum())


@pytest.mark.parametrize("max_iters", [3, 10, 20])
def test_bundle_adjust_matches_jax(noisy, max_iters):
    """Whole runs from the same problem. rms after the run within 2% of
    the JAX run's and the robust objective within 2%; the ejected sets
    differ by at most 2 measurements (one sitting at the Tukey cut-off
    flips with sigma's last bits); the fixed camera bit-unchanged; the
    loop control read the device at most max_iters times."""
    jp, cam, tp, t_cam = _both(noisy["prob"], noisy["cam"])
    jr = jb.bundle_adjust(jp, cam, max_iters=max_iters, point_block=BLOCK,
                          assembly="scatter")
    tb.HOST_READS["bundle_adjust"] = 0
    tr = tb.bundle_adjust(tp, t_cam, max_iters=max_iters, point_block=BLOCK,
                          assembly="scatter")
    assert 1 <= tb.HOST_READS["bundle_adjust"] <= max_iters
    assert int(tr.accepted) >= 1
    rms0 = float(tb.reprojection_rms(tp, t_cam))
    t_rms = float(tb.reprojection_rms(
        tp.replace(meas_valid=tr.meas_valid), t_cam, tr.cam_R, tr.cam_t,
        tr.points))
    j_rms = float(jb.reprojection_rms(
        jp._replace(meas_valid=jr.meas_valid), cam, jr.cam_R, jr.cam_t,
        jr.points))
    assert rms0 > 3.0 and t_rms < 0.6
    assert abs(t_rms - j_rms) <= 0.02 * j_rms
    t_obj, j_obj = _objective(jp, cam, tr), _objective(jp, cam, jr)
    assert abs(t_obj - j_obj) <= 0.02 * j_obj
    differ = tr.outlier_meas.numpy() != np.asarray(jr.outlier_meas)
    assert differ.sum() <= 2
    np.testing.assert_array_equal(tr.cam_R[0].numpy(), noisy["prob"].cam_R[0])
    np.testing.assert_array_equal(tr.cam_t[0].numpy(), noisy["prob"].cam_t[0])
    # Dead camera and point slots come back as they went in.
    np.testing.assert_array_equal(tr.cam_R[N_CAMS:].numpy(),
                                  noisy["prob"].cam_R[N_CAMS:])
    np.testing.assert_array_equal(tr.points[N_PTS:].numpy(),
                                  noisy["prob"].points[N_PTS:])


def test_ba_ejects_the_planted_outliers(noisy):
    """Every measurement moved by 30-60 px is ejected within 10
    iterations, and few others are: at most 5% of the valid ones (Tukey's
    cut-off sits near 3 sigma of the 0.3 px noise once the fit is good, and
    the JAX run ejects the same ones, see
    test_bundle_adjust_matches_jax)."""
    _, _, tp, t_cam = _both(noisy["prob"], noisy["cam"])
    res = tb.bundle_adjust(tp, t_cam, max_iters=10, point_block=BLOCK,
                           assembly="scatter")
    ej = res.outlier_meas.numpy()
    for n, o in noisy["corrupted"]:
        assert ej[n, o], (n, o)
    assert ej.sum() - N_PLANTED <= 0.05 * noisy["prob"].meas_valid.sum()
    assert not (res.meas_valid.numpy() & ej).any()
    np.testing.assert_array_equal(res.point_outliers.numpy(), ej.sum(1))


def test_ba_exact_data_converges():
    """Noise-free measurements, small perturbation: converges within 20
    iterations to rms < 0.05 px and the true second camera within 5e-3
    (tests/test_bundle.py's bounds)."""
    prob, cam, poses, _ = _make_problem(np.random.default_rng(3),
                                        noise_px=0.0, perturb=0.01)
    _, _, tp, t_cam = _both(prob, cam)
    res = tb.bundle_adjust(tp, t_cam, max_iters=20, point_block=BLOCK,
                           assembly="onehot")
    rms = float(tb.reprojection_rms(tp, t_cam, res.cam_R, res.cam_t,
                                    res.points))
    assert rms < 0.05
    assert bool(res.converged)
    Ri, ti = jlie.se3_inverse(jnp.asarray(res.cam_R[1].numpy()),
                              jnp.asarray(res.cam_t[1].numpy()))
    err = jlie.se3_ln(*jlie.se3_mul(*map(jnp.asarray, poses[1]), Ri, ti))
    assert np.abs(np.asarray(err)).max() < 5e-3


def test_ba_points_without_measurements_and_failed_solves(noisy):
    """A valid point whose measurements are all invalid has V = 0: its
    inverse block is 0 and it does not move, with no NaN anywhere. And a
    reduced system that does not factor (cameras with no measurements but
    marked free) gives NaN updates that are rejected: the state comes back
    finite and unchanged."""
    prob = noisy["prob"]
    mv = prob.meas_valid.copy()
    mv[:5] = False
    _, _, tp, t_cam = _both(prob._replace(meas_valid=mv), noisy["cam"])
    res = tb.bundle_adjust(tp, t_cam, max_iters=3, point_block=BLOCK)
    for x in (res.cam_R, res.cam_t, res.points):
        assert torch.isfinite(x).all()
    np.testing.assert_array_equal(res.points[:5].numpy(), prob.points[:5])

    broken = tp.replace(meas_uv=torch.full_like(tp.meas_uv, torch.nan))
    tb.HOST_READS["bundle_adjust"] = 0
    res = tb.bundle_adjust(broken, t_cam, max_iters=3, point_block=BLOCK)
    assert tb.HOST_READS["bundle_adjust"] == 3 and int(res.accepted) == 0
    np.testing.assert_array_equal(res.cam_t.numpy(), prob.cam_t)
    np.testing.assert_array_equal(res.points.numpy(), prob.points)


def _one_rank_mesh():
    """A Mesh of one rank on the CPU (no process group: the mode checks
    raise before any collective)."""
    from visualslam_android_tpu_torch.parallel import mesh as tmesh

    return tmesh.Mesh(rank=0, size=1, device=torch.device("cpu"),
                      transport="host")


@pytest.mark.parametrize("kwargs,error", [
    (dict(solver="pcg", reduce_mode="halo", shard_rows=4), ValueError),
    (dict(solver="band_pcg", reduce_mode="halo"), ValueError),
    (dict(assembly="band", axis_name="points"), TypeError),
    (dict(sigma_mode="hist", axis_name="points"), TypeError),
    (dict(solver="band_pcg", reduce_mode="halo", shard_rows=4), ValueError),
    (dict(axis_name="points"), TypeError),
    (dict(solver="chol", reduce_mode="halo", shard_rows=4, mesh=True),
     ValueError),
    (dict(solver="band_pcg", reduce_mode="halo", mesh=True), ValueError),
])
def test_unported_modes_raise(noisy, kwargs, error):
    """The multi-device modes refuse what the JAX package refuses
    (bundle.py:513-518 there): reduce_mode "halo" without a mesh, without
    shard_rows or beside another solver than band_pcg is a ValueError, and
    axis_name must be a parallel.mesh.Mesh, not the JAX package's bare
    axis string (a TypeError). An unknown name is a ValueError. Nothing
    runs: no host read is made."""
    _, _, tp, t_cam = _both(noisy["prob"], noisy["cam"])
    kwargs = dict(kwargs)
    if kwargs.pop("mesh", False):
        kwargs["axis_name"] = _one_rank_mesh()
    tb.HOST_READS["bundle_adjust"] = 0
    with pytest.raises(error):
        tb.bundle_adjust(tp, t_cam, max_iters=1, **kwargs)
    with pytest.raises(ValueError):
        tb.bundle_adjust(tp, t_cam, max_iters=1, solver="lu")
    assert tb.HOST_READS["bundle_adjust"] == 0


def test_reprojection_rms_and_pair_offset_match_jax(noisy):
    jp, cam, tp, t_cam = _both(noisy["prob"], noisy["cam"])
    _close(tb.reprojection_rms(tp, t_cam), jb.reprojection_rms(jp, cam),
           1e-5, 0)
    shifted = noisy["prob"].points + np.float32(0.01)
    _close(tb.reprojection_rms(tp, t_cam, pts=_t(shifted)),
           jb.reprojection_rms(jp, cam, pts=jnp.asarray(shifted)), 1e-5, 0)
    assert tb.max_pair_offset(tp.meas_kf, tp.meas_valid) == \
        jb.max_pair_offset(jp.meas_kf, jp.meas_valid) == N_CAMS - 1
    assert tb.max_pair_offset(tp.meas_kf, torch.zeros_like(tp.meas_valid)) == 0
