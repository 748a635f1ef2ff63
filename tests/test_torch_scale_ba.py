"""Parity of the port's large-map bundle adjustment with the JAX package on
the CPU: the block-band Schur assembly, the two conjugate-gradient solvers,
the chunked CG loop, and whole runs with each new (assembly, solver) pair.

The problem is an odometry-style one made here with numpy: 30 cameras on
a sideways path (camera 0 fixed, two dead slots after them), 480 points
each seen by up to 6 consecutive cameras (co-observation offsets at most
4, so a band of half-width 4 holds every pair), 0.3 px of noise, 4 gross
outliers, dead point slots whose measurement rows hold garbage camera
indices. The same numpy arrays go to both packages.

Whole runs are compared by outcome (robust objective, rms, ejected set),
never by poses after several LM steps: the accept test compares two f32
sums that the packages add in different orders (ROADMAP queue 3 a). Each
JAX bundle_adjust pair is compiled once. Tolerances stand beside the
assertions.
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
from visualslam_android_tpu_torch.models import bundle as tb
from visualslam_android_tpu_torch.ops import mestimator as tme
from visualslam_android_tpu_torch.utils import convert

torch.set_num_threads(2)

N_CAMS, K_PAD = 30, 32
N_PTS, N_PAD = 480, 496
O_MAX = 6
BAND = 4
BLOCK = 128
N_OUTLIERS = 4
MAX_ITERS = 8


def _np(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _odometry_problem(rng, noise_px=0.3, perturb=0.01):
    """(problem as numpy arrays, JAX camera, planted outliers [N, O])."""
    cam = jcam.make_camera(CameraConfig().params(), 640, 480)
    centers = np.stack([0.12 * np.arange(N_CAMS),
                        0.05 * np.sin(0.3 * np.arange(N_CAMS)),
                        np.zeros(N_CAMS)], -1).astype(np.float32)
    poses = []
    for k in range(N_CAMS):
        mu = np.array([0, 0, 0, 0.02 * np.sin(0.5 * k), 0.03 * np.cos(0.4 * k),
                       0.01 * k / N_CAMS], np.float32)
        R, _ = _np(jlie.se3_exp(jnp.asarray(mu)))
        poses.append((R, (-R @ centers[k]).astype(np.float32)))
    anchor = rng.integers(0, N_CAMS, N_PTS)
    pts = (centers[anchor] + np.stack(
        [rng.uniform(-0.8, 1.2, N_PTS), rng.uniform(-0.7, 0.7, N_PTS),
         rng.uniform(3.0, 5.0, N_PTS)], -1)).astype(np.float32)

    meas_kf = np.zeros((N_PAD, O_MAX), np.int32)
    meas_uv = np.zeros((N_PAD, O_MAX, 2), np.float32)
    meas_valid = np.zeros((N_PAD, O_MAX), bool)
    for n in range(N_PTS):
        o = 0
        for k in range(anchor[n], min(anchor[n] + BAND + 1, N_CAMS)):
            R, t = poses[k]
            pc = R @ pts[n] + t
            px = np.asarray(jcam.project(cam, jnp.asarray(pc[:2] / pc[2])))
            if pc[2] <= 0.1 or not (0 <= px[0] < 640 and 0 <= px[1] < 480):
                continue
            meas_kf[n, o] = k
            meas_uv[n, o] = px + rng.normal(scale=noise_px, size=2)
            meas_valid[n, o] = True
            o += 1
    planted = np.zeros_like(meas_valid)
    flat = np.argwhere(meas_valid & (meas_kf != 0))
    for n, o in flat[rng.choice(len(flat), N_OUTLIERS, replace=False)]:
        meas_uv[n, o] += rng.uniform(30, 60, 2)
        planted[n, o] = True
    garbage = rng.choice(np.array([0, 3, K_PAD - 1, 99, -1], np.int32),
                         meas_kf.shape)
    meas_kf = np.where(meas_valid, meas_kf, garbage).astype(np.int32)

    cam_R = np.stack([p[0] for p in poses]
                     + [np.eye(3, dtype=np.float32)] * (K_PAD - N_CAMS))
    cam_t = np.stack([p[1] for p in poses]
                     + [np.zeros(3, np.float32)] * (K_PAD - N_CAMS))
    for k in range(1, N_CAMS):
        dmu = rng.normal(scale=perturb, size=6).astype(np.float32)
        R2, t2 = jlie.se3_mul(*jlie.se3_exp(jnp.asarray(dmu)),
                              jnp.asarray(cam_R[k]), jnp.asarray(cam_t[k]))
        cam_R[k], cam_t[k] = np.asarray(R2), np.asarray(t2)
    pts_pad = np.zeros((N_PAD, 3), np.float32)
    pts_pad[:N_PTS] = pts + rng.normal(scale=2 * perturb,
                                       size=pts.shape).astype(np.float32)
    cam_fixed = np.ones(K_PAD, bool)
    cam_fixed[1:N_CAMS] = False
    prob = jb.BAProblem(
        cam_R=cam_R, cam_t=cam_t, cam_fixed=cam_fixed,
        cam_valid=np.arange(K_PAD) < N_CAMS, points=pts_pad,
        point_valid=(np.arange(N_PAD) < N_PTS) & (meas_valid.sum(1) >= 2),
        meas_kf=meas_kf, meas_uv=meas_uv,
        meas_sqrt_inv_noise=np.ones((N_PAD, O_MAX), np.float32),
        meas_valid=meas_valid,
    )
    return prob, cam, planted


@pytest.fixture(scope="module")
def odo():
    prob, cam, planted = _odometry_problem(np.random.default_rng(12))
    tp = convert.ba_problem_from_numpy(prob, device="cpu")
    t_cam = convert.camera_from_numpy(_np(cam), device="cpu")
    tp_s, t_valid = tb._sanitized(tp)
    lin = tb._linearize(tp_s, t_cam, tp_s.cam_R, tp_s.cam_t, tp_s.points,
                        t_valid, tp_s.cam_fixed[tp_s.meas_kf.long()],
                        tb.MIN_SIGMA_SQ)
    return dict(prob=prob, cam=cam, planted=planted, tp=tp, t_cam=t_cam,
                tp_s=tp_s, lin=lin)


def _close(t, j, rtol, atol_share, msg=""):
    """t within rtol of j, plus an absolute slack of atol_share of j's
    largest magnitude (sums that cancel to near zero)."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=atol_share * float(np.abs(j).max()),
                               err_msg=msg)


def test_problem_is_an_odometry_band(odo):
    """The fixture is what the solver choice calls an odometry map: every
    co-observing pair within BAND slots, both packages agreeing."""
    prob, tp = odo["prob"], odo["tp"]
    valid = prob.meas_valid & prob.point_valid[:, None]
    off_t = tb.max_pair_offset(tp.meas_kf, torch.as_tensor(valid))
    assert off_t == jb.max_pair_offset(prob.meas_kf, valid) == BAND
    assert int(valid.sum()) > 1500
    assert tb.max_pair_offset(tp.meas_kf, torch.zeros_like(tp.meas_valid)) \
        == 0


def _random_blocks(seed, N=300, O=5, K=12):
    rng = np.random.default_rng(seed)
    kf = rng.integers(0, K, (N, O)).astype(np.int32)
    Y = rng.normal(size=(N, O, 6, 3)).astype(np.float32)
    W = rng.normal(size=(N, O, 6, 3)).astype(np.float32)
    eps_b = rng.normal(size=(N, 3)).astype(np.float32)
    return kf, Y, W, eps_b, K


def _wrapped_pairs(kf, Y, W, band):
    """What JAX's scatter adds for pairs more than `band` slots below the
    diagonal: `.at[ii, dd].add(mode="drop")` normalises a negative dd in
    [-(2 band + 1), -1] to dd + 2 band + 1 before the bounds test, so such a
    pair lands in a wrong block instead of being dropped (ROADMAP queue 3
    i). [K, 2 band + 1, 6, 6] in float64."""
    K, width = 12, 2 * band + 1
    T = np.einsum("noab,npcb->nopac", Y, W)
    ii = np.broadcast_to(kf[:, :, None], T.shape[:3])
    dd = np.broadcast_to(kf[:, None, :], T.shape[:3]) - ii + band
    hit = (dd < 0) & (dd >= -width)
    out = np.zeros((K, width, 6, 6))
    np.add.at(out, (ii[hit], dd[hit] + width), T[hit])
    return out


@pytest.mark.parametrize("band", [2, 11])
def test_band_assembly_and_dense_match_jax(band):
    """_schur_blocks_band on random blocks whose camera pairs reach offset
    11. Band 11 holds every pair: S_band, E_corr and _band_to_dense equal
    JAX's, and the dense form the scatter assembly, within rtol 1e-5 (sums
    of up to ~100 6x6 products in f32, in another order) plus 1e-5 of the
    largest entry. Band 2 drops the pairs outside it: the port drops them
    on both sides of the diagonal; JAX drops those above it and adds those
    up to 2 band + 1 columns below it into wrapped columns, so JAX's band
    equals the port's plus exactly those pairs, to the same tolerance."""
    kf, Y, W, eps_b, K = _random_blocks(3)
    jS, jE = jb._schur_blocks_band(jnp.asarray(kf), jnp.asarray(Y),
                                   jnp.asarray(W), jnp.asarray(eps_b), K,
                                   band, 64)
    tS, tE = tb._schur_blocks_band(_t(kf), _t(Y), _t(W), _t(eps_b), K, band,
                                   64)
    assert tS.shape == (K, 2 * band + 1, 6, 6)
    _close(tE, jE, 1e-5, 1e-5)
    t_scatter, _ = tb._schur_blocks_scatter(_t(kf), _t(Y), _t(W), _t(eps_b),
                                            K, 64)
    if band >= K - 1:
        _close(tS, jS, 1e-5, 1e-5)
        t_dense = tb._band_to_dense(tS, K, band)
        _close(t_dense, jb._band_to_dense(jS, K, band), 1e-5, 1e-5)
        _close(t_dense, t_scatter.numpy(), 1e-5, 1e-5)
        return
    wrapped = _wrapped_pairs(kf, Y, W, band)
    assert np.abs(wrapped).max() > 1.0
    _close(tS + torch.as_tensor(wrapped, dtype=torch.float32), jS, 1e-5,
           1e-5)
    # In band, the dense form is the scatter assembly's; outside, zero.
    t_dense = tb._band_to_dense(tS, K, band).permute(0, 2, 1, 3)
    off = torch.arange(K)[None, :] - torch.arange(K)[:, None]
    inside = (off.abs() <= band)[..., None, None]
    scatter = t_scatter.permute(0, 2, 1, 3)
    _close(torch.where(inside, t_dense, 0.0),
           torch.where(inside, scatter, 0.0).numpy(), 1e-5, 1e-5)
    assert float(torch.where(inside, 0.0, t_dense).abs().max()) == 0.0
    _close(tb._band_to_dense(tS, K, band),
           jb._band_to_dense(jnp.asarray(tS.numpy()), K, band), 1e-6, 1e-6)


def _solver_inputs(odo, lam=1e-3):
    lin, tp_s = odo["lin"], odo["tp_s"]
    Vinv, Y, U_star, free = tb._damped(lin, tp_s, lam)
    E_corr = tb._e_corr_scatter(tp_s.meas_kf, Y, lin["eps_b"], K_PAD)
    E = torch.where(free[:, None], lin["eps_a"] - E_corr, 0.0)
    S_band, E_band = tb._schur_blocks_band(tp_s.meas_kf, Y, lin["W"],
                                           lin["eps_b"], K_PAD, BAND, BLOCK)
    return dict(Vinv=Vinv, U_star=U_star, free=free, E=E, S_band=S_band,
                W=lin["W"], kf=tp_s.meas_kf)


def _j(x):
    return jnp.asarray(x.numpy())


def test_pcg_solvers_match_jax(odo):
    """_pcg_camera_solve and _band_pcg_solve against JAX on the same
    reduced system (the fixture's first linearisation, lambda 1e-3), each
    run to cg_tol 1e-6: x within rtol 1e-4 plus 1e-4 of its largest
    entry, and both solvers agree with each other and with a dense solve of
    the same system to that tolerance. A frozen camera gets no update."""
    s = _solver_inputs(odo)
    jx = jb._pcg_camera_solve(_j(s["U_star"]), _j(s["free"]), _j(s["kf"]),
                              _j(s["W"]), _j(s["Vinv"]), _j(s["E"]),
                              lambda v: v, 250, 1e-6)
    tx = tb._pcg_camera_solve(s["U_star"], s["free"], s["kf"], s["W"],
                              s["Vinv"], s["E"], 250, 1e-6)
    _close(tx, jx, 1e-4, 1e-4, "pcg")
    jxb = jb._band_pcg_solve(_j(s["U_star"]), _j(s["S_band"]), _j(s["free"]),
                             BAND, _j(s["E"]), 250, 1e-6)
    txb = tb._band_pcg_solve(s["U_star"], s["S_band"], s["free"], BAND,
                             s["E"], 250, 1e-6)
    _close(txb, jxb, 1e-4, 1e-4, "band_pcg")
    _close(txb, tx.numpy(), 1e-3, 1e-3, "band_pcg vs pcg")
    Sm, E, _, _ = tb._reduced_system(odo["lin"], odo["tp_s"], 1e-3, BLOCK)
    dense = torch.linalg.solve(Sm.double(), E.reshape(-1).double())
    _close(tx, dense.reshape(K_PAD, 6).float().numpy(), 1e-3, 1e-3,
           "pcg vs dense")
    assert float(tx[~s["free"]].abs().max()) == 0.0


def _every_iteration_cg(apply_S, prec, b, cg_iters, cg_tol):
    """JAX's while loop as a plain Python loop: test, then iterate."""
    thresh = (cg_tol * cg_tol) * torch.sum(b * b)
    x, r = torch.zeros_like(b), b
    z = prec(r)
    p, rz, i = z, torch.sum(r * z), 0
    while i < cg_iters and bool(torch.sum(r * r) > thresh):
        Ap = apply_S(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(denom == 0.0, 0.0,
                            rz / torch.where(denom == 0.0, 1.0, denom))
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_n = torch.sum(r * z)
        beta = torch.where(rz == 0.0, 0.0,
                           rz_n / torch.where(rz == 0.0, 1.0, rz))
        p = z + beta * p
        rz, i = rz_n, i + 1
    return x, i


@pytest.mark.parametrize("cg_tol,cg_iters", [(1e-4, 250), (0.0, 37)])
def test_chunked_cg_is_the_while_loop(odo, cg_tol, cg_iters):
    """The chunked loop with its frozen iterations gives bit for bit the
    iterate of a loop that tests every iteration, whether it stops on the
    tolerance or on cg_iters; it reads the device once per chunk of
    CG_CHUNK, and counts the iterations the while loop runs."""
    s = _solver_inputs(odo)
    free, kf, W, Vinv = s["free"], s["kf"], s["W"], s["Vinv"]
    Y = W @ Vinv[:, None]
    Minv = tb._block_jacobi(s["U_star"], free)
    fr = free[:, None]

    def apply_S(x):
        u = torch.sum((W.transpose(-1, -2) @ x[kf.long()][..., None])[..., 0],
                      dim=1)
        corr = torch.zeros_like(x).index_add_(
            0, kf.long().reshape(-1),
            (Y @ u[:, None, :, None])[..., 0].reshape(-1, 6))
        out = (s["U_star"] @ x[..., None])[..., 0] + 1e-9 * x - corr
        return torch.where(fr, out, x)

    def prec(r):
        return (Minv @ r[..., None])[..., 0]

    b = torch.where(fr, s["E"], 0.0)
    want, n_iter = _every_iteration_cg(apply_S, prec, b, cg_iters, cg_tol)
    assert 10 < n_iter <= cg_iters
    for chunk in (1, tb.CG_CHUNK):
        tb.HOST_READS["cg"] = 0
        tb.CG_STATS.update(solves=0, iterations=0)
        got = tb._cg_loop(apply_S, prec, b, cg_iters, cg_tol, chunk=chunk)
        assert torch.equal(got, want), chunk
        assert tb.CG_STATS == {"solves": 1, "iterations": n_iter}
        assert tb.HOST_READS["cg"] == max(1, -(-n_iter // chunk))
    # The solver itself takes the same path.
    x = tb._pcg_camera_solve(s["U_star"], free, kf, W, Vinv, s["E"],
                             cg_iters, cg_tol)
    assert torch.equal(x, want)


def _outcome(tp, t_cam, R, t, pts, meas_valid, ejected, sigma_sq):
    """(rms over the kept measurements, robust objective: Tukey scores at
    the result's sigma plus one per ejected measurement)."""
    kept = tp.replace(meas_valid=meas_valid)
    rms = float(tb.reprojection_rms(kept, t_cam, R, t, pts))
    sp, valid = tb._sanitized(kept)
    _, _, err_sq, z_bad = tb._project_all(t_cam, R, t, pts, sp)
    score = tme.objective_score(err_sq, sigma_sq)
    return rms, float(torch.sum(torch.where(valid & ~z_bad, score, 0.0))
                      + ejected.sum())


@pytest.mark.parametrize("assembly,solver", [
    ("band", "chol"), ("band", "band_pcg"), ("scatter", "pcg")])
def test_bundle_adjust_pair_matches_jax(odo, assembly, solver):
    """A whole run of each new (assembly, solver) pair against the same pair
    in JAX, 8 LM iterations: objective and rms within rtol 1e-3, the same
    ejected set, which holds the planted outliers; the rms falls to the
    noise level, the fixed camera stays; the CG runs report their
    iterations and reads. Both objectives are taken at JAX's final sigma:
    each result's own sigma is the median statistic of the state before
    its last step, and the packages' lambda schedules part (accepted steps
    differ), so the two sigmas differ by up to ~0.3% on this problem and
    are held to 1% alone."""
    prob, cam, tp, t_cam = odo["prob"], odo["cam"], odo["tp"], odo["t_cam"]
    kwargs = dict(max_iters=MAX_ITERS, point_block=BLOCK, assembly=assembly,
                  solver=solver, band_halfwidth=BAND, cg_iters=250,
                  cg_tol=1e-6)
    jres = _np(jb.bundle_adjust(jax.tree.map(jnp.asarray, prob), cam,
                                **kwargs))
    tb.HOST_READS.update(bundle_adjust=0, cg=0)
    tb.CG_STATS.update(solves=0, iterations=0)
    tres = tb.bundle_adjust(tp, t_cam, **kwargs)
    sigma_sq = _t(jres.sigma_squared)
    np.testing.assert_allclose(float(tres.sigma_squared), float(sigma_sq),
                               rtol=1e-2)
    t_out = _outcome(tp, t_cam, tres.cam_R, tres.cam_t, tres.points,
                     tres.meas_valid, tres.outlier_meas, sigma_sq)
    j_out = _outcome(tp, t_cam, _t(jres.cam_R), _t(jres.cam_t),
                     _t(jres.points), _t(jres.meas_valid),
                     _t(jres.outlier_meas), sigma_sq)
    np.testing.assert_allclose(t_out, j_out, rtol=1e-3)
    np.testing.assert_array_equal(tres.outlier_meas.numpy(),
                                  jres.outlier_meas)
    planted = odo["planted"] & prob.point_valid[:, None]
    assert tres.outlier_meas.numpy()[planted].all()
    rms0 = float(tb.reprojection_rms(tp, t_cam))
    assert rms0 > 2.0 and t_out[0] < 0.5, (rms0, t_out)
    assert torch.equal(tres.cam_t[0], tp.cam_t[0])
    cg_reads, stats = tb.HOST_READS["cg"], dict(tb.CG_STATS)
    if solver == "chol":
        assert cg_reads == 0 and stats["solves"] == 0
    else:
        # One solve per inner iteration; a handful of reads each.
        assert stats["solves"] == tb.HOST_READS["bundle_adjust"]
        assert stats["iterations"] >= 5 * stats["solves"]
        assert cg_reads <= stats["iterations"] // tb.CG_CHUNK \
            + stats["solves"]
        print(f"{assembly}+{solver}: {stats['solves']} solves, "
              f"{stats['iterations'] / stats['solves']:.1f} CG iterations "
              f"and {cg_reads / stats['solves']:.2f} reads per solve")
