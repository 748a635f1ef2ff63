"""Levenberg-Marquardt bundle adjustment with Schur complement.

Port of the JAX package's ``models/bundle.py`` (the reference's
jni/Bundle.{h,cc}; Hartley & Zisserman MVG Algorithm A6.4):

- per-measurement 2x6 camera (A) and 2x3 point (B) Jacobians with the
  sqrt-Tukey weight folded in (Do_LM_Step, Bundle.cc:241-321);
- robust sigma from the Tukey MAD estimator, at least 0.4
  (Bundle.cc:209-227);
- accumulators U (per camera), V (per point), eps_a, eps_b, W = A^T B;
- inner lambda loop: V* = V(1 + lambda*diag), the reduced camera system
  S = U* - sum_p W V*^-1 W^T over camera pairs (Bundle.cc:327-434), solved
  for the camera update, points back-substituted (Bundle.cc:437-462); a
  step is accepted iff the robust objective fell, lambda x0.3 on success
  and x(doubling factor) on failure (Bundle.cc:469-514, :609-617);
- convergence on a squared update below 1e-6, at most `max_iters` inner
  iterations in all (Bundle.cc:65-66);
- fixed and invalid cameras take no update (identity rows in the
  fixed-shape S);
- a measurement with z <= 0 or zero Tukey weight is ejected at the end of
  its LM step and reported (Bundle.cc:516-531, :620-640).

Measurements live in a point-major [N, O] table; U and eps_a are
``index_add_`` sums over it. The Schur correction is assembled from each
point's O x O camera-pair blocks, added into S by a flat pair index
(``_schur_blocks_scatter``); S is solved by a dense Cholesky
factorization. The JAX package's other assemblies and solvers (one-hot
contractions, block band, conjugate gradients) and its multi-device
reductions are not ported: their names raise NotImplementedError.

The two nested loops read the device once per inner iteration: three
flags (objective rose, objective fell, update below the limit) in one
transfer. ``HOST_READS`` counts those reads.
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.ops import mestimator as me
from visualslam_android_tpu_torch.ops import wls as wls_ops
from visualslam_android_tpu_torch.utils.tensors import TensorTree

MIN_SIGMA_SQ = 0.16  # (0.4)^2, Bundle.cc:224

# Device-to-host reads made by bundle_adjust's loop control, one per inner
# iteration. Callers set it to 0 and read it, as with ops/fast.LAUNCHES.
HOST_READS = {"bundle_adjust": 0}

# What bundle_adjust runs, and what waits: name -> ROADMAP queue 1 item.
_ASSEMBLIES = {"scatter": None, "onehot": None, "band": 11}
_SOLVERS = {"chol": None, "pcg": 11, "band_pcg": 11}
_SIGMA_MODES = {"gather": None, "hist": 12}
_REDUCE_MODES = {"psum": None, "halo": 12}


@dataclasses.dataclass(frozen=True)
class BAProblem(TensorTree):
    """Fixed-shape bundle problem."""

    cam_R: torch.Tensor      # [K, 3, 3]
    cam_t: torch.Tensor      # [K, 3]
    cam_fixed: torch.Tensor  # [K] bool (includes invalid slots)
    cam_valid: torch.Tensor  # [K] bool
    points: torch.Tensor     # [N, 3]
    point_valid: torch.Tensor  # [N] bool
    meas_kf: torch.Tensor    # [N, O] int32
    meas_uv: torch.Tensor    # [N, O, 2] level-0 pixels
    meas_sqrt_inv_noise: torch.Tensor  # [N, O] (1/2^level)
    meas_valid: torch.Tensor  # [N, O] bool


@dataclasses.dataclass(frozen=True)
class BAResult(TensorTree):
    cam_R: torch.Tensor
    cam_t: torch.Tensor
    points: torch.Tensor
    meas_valid: torch.Tensor      # with ejected measurements cleared
    outlier_meas: torch.Tensor    # [N, O] measurements ejected this run
    point_outliers: torch.Tensor  # [N] int32 ejected-obs count per point
    accepted: torch.Tensor        # [] int32 accepted LM steps
    converged: torch.Tensor       # [] bool
    sigma_squared: torch.Tensor   # [] final robust sigma^2


def _project_all(cam, R, t, pts, prob: BAProblem):
    """Project every measurement: (pc [N, O, 3], err [N, O, 2] noise-
    scaled, err_sq [N, O], z_bad [N, O]). prob.meas_kf must lie in
    [0, K)."""
    kf = prob.meas_kf.long()
    pc = (R[kf] @ pts[:, None, :, None])[..., 0] + t[kf]
    z_bad = pc[..., 2] <= 0
    safe_z = torch.where(z_bad, 1.0, pc[..., 2])
    px = cam_ops.project(cam, pc[..., :2] / safe_z[..., None])
    err = (prob.meas_uv - px) * prob.meas_sqrt_inv_noise[..., None]
    return pc, err, torch.sum(err * err, dim=-1), z_bad


def _jacobians(cam, pc, Rm, sqrt_w, sqrt_inv_noise, cam_fixed_m):
    """A [N, O, 2, 6], B [N, O, 2, 3] with sqrt-weight and noise folded in
    (Bundle.cc:269-302); A is zero for fixed cameras.

    With J = d pixel / d pc (the camera's 2x2 derivative times the 2x3
    derivative of the perspective division), a camera motion
    [translation, rotation] moves pc by [I | -[pc]x] and a point motion by
    R, so A = [J | pc x J] (row by row) and B = J R."""
    z_ok = pc[..., 2] > 0
    inv_z = 1.0 / torch.where(z_ok, pc[..., 2], 1.0)
    m = pc[..., :2] * inv_z[..., None]
    _, derivs = cam_ops.project_derivs(cam, m)  # [N, O, 2, 2]
    zero = torch.zeros_like(inv_z)
    persp = torch.stack([
        torch.stack([inv_z, zero, -m[..., 0] * inv_z], dim=-1),
        torch.stack([zero, inv_z, -m[..., 1] * inv_z], dim=-1),
    ], dim=-2)  # [N, O, 2, 3]
    J = (derivs @ persp) * (sqrt_w * sqrt_inv_noise)[..., None, None]
    A = torch.cat(
        [J, torch.linalg.cross(pc[..., None, :].expand_as(J), J, dim=-1)],
        dim=-1,
    )
    A = torch.where(cam_fixed_m[..., None, None], 0.0, A)
    return A, J @ Rm


def _e_corr_scatter(meas_kf, Y, eps_b, K):
    """E_corr [K, 6] = sum over measurements of Y eps_b, added per camera.
    Y is zero for bad and fixed measurements (the weights are folded into
    A and B), so dead slots add zeros."""
    e = (Y @ eps_b[:, None, :, None])[..., 0]  # [N, O, 6]
    return torch.zeros(K, 6, dtype=Y.dtype, device=Y.device).index_add_(
        0, meas_kf.reshape(-1).long(), e.reshape(-1, 6)
    )


def _schur_blocks_scatter(meas_kf, Y, W, eps_b, K, block: int):
    """The Schur correction S_corr [K, 6, K, 6] and E_corr [K, 6] from
    per-point camera-PAIR blocks (the reference's off-diagonal scripts,
    jni/Bundle.cc:400-426, :580-607): for each point, every O x O pair
    (o, p) adds Y[o] W[p]^T to the block (kf[o], kf[p]). O(N O^2) work,
    whatever K. Points go through in chunks of `block`, which bounds the
    [block, O, O, 6, 6] temporary. meas_kf must lie in [0, K)."""
    N, O = meas_kf.shape
    E_corr = _e_corr_scatter(meas_kf, Y, eps_b, K)
    kf = meas_kf.long()
    pairs = torch.zeros(K * K, 6, 6, dtype=Y.dtype, device=Y.device)
    for n0 in range(0, N, block):
        sl = slice(n0, n0 + block)
        # T[n, o, p] = Y[n, o] W[n, p]^T
        T = Y[sl, :, None] @ W[sl, None].transpose(-1, -2)
        flat = kf[sl, :, None] * K + kf[sl, None, :]  # ii * K + jj
        pairs.index_add_(0, flat.reshape(-1), T.reshape(-1, 6, 6))
    return pairs.view(K, K, 6, 6).permute(0, 2, 1, 3), E_corr


def max_pair_offset(meas_kf, meas_valid) -> int:
    """Largest |i - j| over co-observing camera pairs, read to the host
    (what decides whether a block-band assembly holds every pair)."""
    big = torch.iinfo(torch.int32).max
    kf = meas_kf.to(torch.int32)
    hi = torch.where(meas_valid, kf, -big).amax(dim=1)
    lo = torch.where(meas_valid, kf, big).amin(dim=1)
    span = torch.where(meas_valid.any(dim=1), hi - lo, 0)
    return int(span.max()) if span.numel() else 0


def _check_modes(axis_name, assembly, solver, sigma_mode, reduce_mode):
    if axis_name is not None:
        raise NotImplementedError(
            "bundle_adjust over a mesh axis (axis_name) is not ported: "
            "ROADMAP queue 1 item 12"
        )
    for kind, name, table in (("assembly", assembly, _ASSEMBLIES),
                              ("solver", solver, _SOLVERS),
                              ("sigma_mode", sigma_mode, _SIGMA_MODES),
                              ("reduce_mode", reduce_mode, _REDUCE_MODES)):
        if name not in table:
            raise ValueError(f"unknown {kind} {name!r}")
        if table[name] is not None:
            raise NotImplementedError(
                f"{kind}={name!r} is not ported: ROADMAP queue 1 item "
                f"{table[name]}"
            )


def _linearize(prob: BAProblem, cam, R, t, pts, meas_valid, cam_fixed_m,
               min_sigma_sq):
    """The first half of an LM step (Bundle.cc:209-321) at (R, t, pts):
    robust sigma, the objective, the ejection mask and the accumulators.
    Returns a dict of tensors."""
    K = R.shape[0]
    dtype, device = pts.dtype, pts.device
    pc, err, err_sq, z_bad = _project_all(cam, R, t, pts, prob)
    ok = meas_valid & ~z_bad
    sigma_sq = me.find_sigma_squared(err_sq.reshape(-1), ok.reshape(-1),
                                     me.TUKEY)
    sigma_sq = torch.clamp(sigma_sq, min=min_sigma_sq)
    sqrt_w = me.square_root_weight(err_sq, sigma_sq, me.TUKEY)
    bad = meas_valid & (z_bad | (sqrt_w == 0.0))
    good = meas_valid & ~bad
    n_bad = torch.sum(bad.to(dtype))
    current_error = torch.sum(torch.where(
        good, me.objective_score(err_sq, sigma_sq, me.TUKEY), 0.0)) + n_bad

    kf = prob.meas_kf.long()
    A, B = _jacobians(cam, pc, R[kf], torch.where(good, sqrt_w, 0.0),
                      prob.meas_sqrt_inv_noise, cam_fixed_m)
    gmask = good[..., None]
    eps = torch.where(gmask, err * sqrt_w[..., None], 0.0)[..., None]
    A = torch.where(gmask[..., None], A, 0.0)
    B = torch.where(gmask[..., None], B, 0.0)
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)

    kf_flat = kf.reshape(-1)
    U = torch.zeros(K, 6, 6, dtype=dtype, device=device).index_add_(
        0, kf_flat, (At @ A).reshape(-1, 6, 6))
    eps_a = torch.zeros(K, 6, dtype=dtype, device=device).index_add_(
        0, kf_flat, (At @ eps).reshape(-1, 6))
    return dict(
        A=A, B=B, eps=eps[..., 0], U=U, eps_a=eps_a,
        V=torch.sum(Bt @ B, dim=1),            # [N, 3, 3]
        eps_b=torch.sum(Bt @ eps, dim=1)[..., 0],  # [N, 3]
        W=At @ B,                              # [N, O, 6, 3]
        sigma_sq=sigma_sq, current_error=current_error, n_bad=n_bad,
        bad=bad, good=good,
    )


def _reduced_system(lin, prob: BAProblem, lam, point_block):
    """S [6K, 6K] and E [K, 6] of the reduced camera system at damping
    `lam` (Bundle.cc:327-434), with the inverse point blocks Vinv
    [N, 3, 3] the back-substitution needs."""
    K = prob.cam_R.shape[0]
    U, V, W = lin["U"], lin["V"], lin["W"]
    dtype, device = V.dtype, V.device
    eye3 = torch.eye(3, dtype=dtype, device=device)
    eye6 = torch.eye(6, dtype=dtype, device=device)
    # V* inverse: diagonal scaled by (1 + lambda); a point with no good
    # measurement has V = 0 and gets a zero inverse (Bundle.cc:333-349).
    Vs = V + lam * V * eye3
    singular = (V[:, 0, 0] * V[:, 1, 1] * V[:, 2, 2] == 0.0)[:, None, None]
    Vinv = torch.where(
        singular, 0.0, wls_ops.inv3x3(torch.where(singular, eye3, Vs)))
    Y = W @ Vinv[:, None]  # [N, O, 6, 3]

    free = prob.cam_valid & ~prob.cam_fixed
    S_corr, E_corr = _schur_blocks_scatter(prob.meas_kf, Y, W, lin["eps_b"],
                                           K, point_block)
    kk = torch.arange(K, device=device)
    S = -S_corr
    S[kk, :, kk, :] += U * (1.0 + lam * eye6)
    S = torch.where(free[:, None, None, None] & free[None, None, :, None],
                    S, 0.0)
    # Fixed and invalid cameras: identity rows, zero right-hand side.
    S[kk, :, kk, :] += torch.where(free[:, None, None], 0.0, eye6)
    E = torch.where(free[:, None], lin["eps_a"] - E_corr, 0.0)
    Sm = S.reshape(K * 6, K * 6) + 1e-9 * torch.eye(
        K * 6, dtype=dtype, device=device)
    return Sm, E, Vinv, free


def _back_substitute(lin, prob: BAProblem, cam, R, t, pts, cam_upd, Vinv,
                     free, update_conv):
    """The second half of an inner iteration (Bundle.cc:440-514): point
    updates from the camera update, the new state, its objective at the
    same sigma. Returns a dict of tensors, `flags` among them: [objective
    rose, objective fell, update below the limit]."""
    kf = prob.meas_kf.long()
    wtd = (lin["W"].transpose(-1, -2) @ cam_upd[kf][..., None])[..., 0]
    v3 = lin["eps_b"] - torch.sum(wtd, dim=1)
    pt_upd = (Vinv @ v3[..., None])[..., 0]
    pt_upd = torch.where(prob.point_valid[:, None], pt_upd, 0.0)
    upd_sq = torch.sum(cam_upd * cam_upd) + torch.sum(pt_upd * pt_upd)

    dR, dt = lie.se3_exp(cam_upd)
    R_new, t_new = lie.se3_mul(dR, dt, R, t)
    R_new = torch.where(free[:, None, None], R_new, R)
    t_new = torch.where(free[:, None], t_new, t)
    pts_new = pts + pt_upd

    # FindNewError (Bundle.cc:537-561): same sigma, +1 per z-bad.
    _, _, err_sq_new, z_bad_new = _project_all(cam, R_new, t_new, pts_new,
                                               prob)
    good = lin["good"]
    new_error = (
        torch.sum(torch.where(
            good & ~z_bad_new,
            me.objective_score(err_sq_new, lin["sigma_sq"], me.TUKEY), 0.0))
        + torch.sum((good & z_bad_new).to(pts.dtype)) + lin["n_bad"]
    )
    cur = lin["current_error"]
    flags = torch.stack([new_error > cur, new_error < cur,
                         upd_sq < update_conv])
    return dict(cam_upd=cam_upd, pt_upd=pt_upd, R_new=R_new, t_new=t_new,
                pts_new=pts_new, new_error=new_error, flags=flags)


def _solve_and_step(lin, prob: BAProblem, cam, R, t, pts, lam, point_block,
                    update_conv):
    """One inner iteration (Bundle.cc:327-514) at damping `lam`: assemble
    and solve the reduced system, then _back_substitute. The result also
    carries the system (S, E)."""
    K = prob.cam_R.shape[0]
    Sm, E, Vinv, free = _reduced_system(lin, prob, lam, point_block)
    # ridge=0: the reduced system already carries it. A factorization that
    # fails gives a NaN update, hence a NaN objective and a rejected step.
    cam_upd = wls_ops.solve_spd(Sm, E.reshape(-1), ridge=0.0).reshape(K, 6)
    step = _back_substitute(lin, prob, cam, R, t, pts, cam_upd, Vinv, free,
                            update_conv)
    return dict(step, S=Sm, E=E)


def _sanitized(prob: BAProblem):
    """(problem with meas_kf clamped into [0, K), measurement mask): a
    measurement counts only if it is valid, its point is, and its camera
    index names a slot. Dead slots may hold any index; index_add_ may
    not see it."""
    K = prob.cam_R.shape[0]
    in_range = (prob.meas_kf >= 0) & (prob.meas_kf < K)
    meas_valid = prob.meas_valid & prob.point_valid[:, None] & in_range
    return (prob.replace(meas_kf=torch.clamp(prob.meas_kf, 0, K - 1)),
            meas_valid)


def bundle_adjust(
    prob: BAProblem, cam: cam_ops.Camera,
    max_iters: int = 20, point_block: int = 1024,
    axis_name=None,
    assembly: str = "onehot", solver: str = "chol",
    cg_iters: int = 250, cg_tol: float = 1e-6,
    update_conv: float = 1e-6, min_sigma_sq: float = MIN_SIGMA_SQ,
    lambda_init: float = 1e-4, lambda_good: float = 0.3,
    lambda_factor_init: float = 2.0,
    band_halfwidth: int = 16,
    sigma_mode: str = "gather",
    reduce_mode: str = "psum",
    shard_rows: int = 0,
) -> BAResult:
    """Full Bundle::Compute (Bundle.cc:136-178) on one device. max_iters
    bounds the TOTAL of inner iterations (the reference's
    mgvnMaxIterations); run it again with a small budget to go on.

    The arguments are the JAX package's. Ported: assembly "scatter"
    ("onehot" names the same sums and runs the scatter form), solver
    "chol", sigma_mode "gather", reduce_mode "psum" without a mesh axis.
    Every other name the JAX package knows raises NotImplementedError;
    cg_iters, cg_tol, band_halfwidth and shard_rows belong to those and
    are not read."""
    _check_modes(axis_name, assembly, solver, sigma_mode, reduce_mode)
    dtype, device = prob.points.dtype, prob.points.device
    prob, meas_valid = _sanitized(prob)
    cam_fixed_m = prob.cam_fixed[prob.meas_kf.long()]

    R, t, pts = prob.cam_R, prob.cam_t, prob.points
    ejected = torch.zeros_like(meas_valid)
    accepted = torch.zeros((), dtype=torch.int32, device=device)
    converged_dev = torch.zeros((), dtype=torch.bool, device=device)
    sigma_sq = torch.full((), min_sigma_sq, dtype=dtype, device=device)
    lam, lam_factor = lambda_init, lambda_factor_init
    counter, converged = 0, False

    while not converged and counter < max_iters:
        lin = _linearize(prob, cam, R, t, pts, meas_valid, cam_fixed_m,
                         min_sigma_sq)
        # Inner lambda loop: raise the damping until the objective falls,
        # the update converges or the budget ends.
        while True:
            step = _solve_and_step(lin, prob, cam, R, t, pts, lam,
                                   point_block, update_conv)
            HOST_READS["bundle_adjust"] += 1
            worse, better, conv = step["flags"].tolist()
            converged_dev = converged_dev | step["flags"][2]
            converged = converged or conv
            if worse:
                lam, lam_factor = lam * lam_factor, lam_factor * 2.0
            counter += 1
            if not worse or converged or counter >= max_iters:
                break
        # Accept if improved (Bundle.cc:504-514).
        if better:
            lam, lam_factor = lam * lambda_good, lambda_factor_init
            R, t, pts = step["R_new"], step["t_new"], step["pts_new"]
            accepted = accepted + 1
        # Eject outliers (Bundle.cc:516-531).
        meas_valid = meas_valid & ~lin["bad"]
        ejected = ejected | lin["bad"]
        sigma_sq = lin["sigma_sq"]

    return BAResult(
        cam_R=R, cam_t=t, points=pts, meas_valid=meas_valid,
        outlier_meas=ejected,
        point_outliers=torch.sum(ejected.to(torch.int32), dim=-1),
        accepted=accepted, converged=converged_dev, sigma_squared=sigma_sq,
    )


def reprojection_rms(prob: BAProblem, cam: cam_ops.Camera,
                     R=None, t=None, pts=None):
    """Diagnostic: noise-scaled RMS reprojection error over the valid
    measurements."""
    R = prob.cam_R if R is None else R
    t = prob.cam_t if t is None else t
    pts = prob.points if pts is None else pts
    prob, meas_valid = _sanitized(prob)
    _, _, err_sq, z_bad = _project_all(cam, R, t, pts, prob)
    ok = meas_valid & ~z_bad
    n = torch.clamp(torch.sum(ok), min=1)
    return torch.sqrt(torch.sum(torch.where(ok, err_sq, 0.0)) / n)
