"""Two-view bootstrap: MLESAC homography estimation, Tukey-WLS refinement,
Faugeras-Lustman decomposition, and disambiguation.

Port of the JAX package's ``models/homography.py`` (the reference's
jni/HomographyInit.{h,cc}): matches are z=1 camera-plane correspondences
with per-match pixel-projection Jacobians (HomographyMatch,
HomographyInit.h:24-30); MLESAC with 300 trials of 4-point DLT
(BestHomographyFromMatches_MLESAC :216-262, HomographyFromMatches :73-128);
5 rounds of Tukey-weighted WLS refinement over the 9 homography entries
(RefineHomographyWithInliers :133-214); the 8-way Faugeras-Lustman
decomposition (DecomposeHomography :264-377); and the two-stage visibility
scoring + Sampson tie-break (ChooseBestDecomposition :405-500,
SampsonusError :383-403).

All trials run at once: one batched 9x9 ``eigh`` for the 300 DLTs and a
[300, M] score matrix. The trial indices are an argument, or are drawn
from the caller's ``torch.Generator``, so a test or a card-against-CPU
comparison can feed both sides the same draws. Eigen- and singular
vectors are defined up to sign, so H is defined up to sign and the order
of the 8 decompositions may differ between LAPACK and cuSOLVER; R and t
of the winner do not depend on it, and its plane only by the joint sign of
(normal, plane_d).
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.ops import mestimator as me
from visualslam_android_tpu_torch.utils.tensors import TensorTree, const


@dataclasses.dataclass(frozen=True)
class HomographyResult(TensorTree):
    success: torch.Tensor   # [] bool
    R: torch.Tensor         # [3, 3] second-from-first rotation
    t: torch.Tensor         # [3] second-from-first translation
    H: torch.Tensor         # [3, 3] refined homography
    inliers: torch.Tensor   # [M] bool
    normal: torch.Tensor    # [3] plane normal of the winning decomposition
    plane_d: torch.Tensor   # [] plane distance


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _dlt(first, second, weight=None):
    """Homography from >= 4 matches by DLT (HomographyFromMatches,
    HomographyInit.cc:73-128): the eigenvector of A^T A with the smallest
    eigenvalue, A the [2N x 9] system (a fixed 9x9 shape, so it batches).
    first/second [..., N, 2]; returns [..., 3, 3]."""
    x, y = first[..., 0], first[..., 1]
    u, v = second[..., 0], second[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    row0 = torch.stack([x, y, one, zero, zero, zero, -x * u, -y * u, -u], -1)
    row1 = torch.stack([zero, zero, zero, x, y, one, -x * v, -y * v, -v], -1)
    A = torch.cat([row0, row1], dim=-2)  # [..., 2N, 9]
    if weight is not None:
        A = A * torch.cat([weight, weight], dim=-1)[..., None]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    h = vecs[..., :, 0]
    return h.reshape(*h.shape[:-1], 3, 3)


def _transfer_error_sq(H, first, second, pixel_jac):
    """Squared pixel transfer error of second ~ H * first
    (IsHomographyInlier / MLESACScore, HomographyInit.cc:22-41). H
    [..., 3, 3] over matches [M, 2]; returns [..., M]."""
    v = torch.einsum("...ij,mj->...mi", H, _homogeneous(first))
    z = v[..., 2]
    bad = torch.abs(z) < 1e-12
    safe_z = torch.where(bad, 1.0, z)
    err = second - v[..., :2] / safe_z[..., None]
    perr = torch.einsum("mab,...mb->...ma", pixel_jac, err)
    e2 = torch.sum(perr * perr, dim=-1)
    return torch.where(bad, 1e12, e2)


def _refine(H, first, second, pixel_jac, inliers):
    """One Tukey-WLS refinement round (RefineHomographyWithInliers,
    HomographyInit.cc:133-214): additive 9-parameter update."""
    fh = _homogeneous(first)  # [M, 3]
    v = fh @ H.T
    z = v[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-12, 1.0, z)
    proj = v[:, :2] / safe_z[:, None]
    err = (pixel_jac @ (second - proj)[..., None])[..., 0]  # [M, 2]
    e2 = torch.sum(err * err, dim=-1)

    inv_z = 1.0 / safe_z
    # d proj / d H rows (HomographyInit.cc:158-182).
    zeros = torch.zeros_like(fh)
    jx = torch.cat(
        [fh * inv_z[:, None], zeros, -fh * (v[:, 0] * inv_z**2)[:, None]], -1
    )  # [M, 9]
    jy = torch.cat(
        [zeros, fh * inv_z[:, None], -fh * (v[:, 1] * inv_z**2)[:, None]], -1
    )
    J = pixel_jac @ torch.stack([jx, jy], dim=1)  # [M, 2, 9]

    sigma_sq = me.find_sigma_squared(e2, inliers, me.TUKEY)
    w = me.weight(e2, torch.clamp(sigma_sq, min=1e-12), me.TUKEY)
    w = torch.where(inliers, w, 0.0)
    Jw = J * w[:, None, None]
    A = torch.einsum("mak,mal->kl", Jw, J)
    b = torch.einsum("mak,ma->k", Jw, err)
    # The 9-parameter system is gauge-deficient (homography scale is
    # unobservable, J @ vec(H) = 0), so A has one ~zero eigenvalue that f32
    # accumulation noise can even turn negative. The reference solves it
    # in double with a unit prior (myWLS.h:29-62, HomographyInit.cc:186-205);
    # in f32, as in the JAX package: a truncated eigen-solve that inverts
    # only the directions f32 resolves, which gauge-fixes the update.
    lam, V = torch.linalg.eigh(A)
    lam_max = torch.clamp(lam[-1], min=1e-12)
    good = lam > 1e-6 * lam_max
    inv = torch.where(good, 1.0 / torch.where(good, lam, 1.0), 0.0)
    upd = V @ (inv * (V.T @ b))
    Hn = H + upd.reshape(3, 3)
    # Keep the gauge direction consistent across rounds.
    return Hn / torch.clamp(torch.linalg.matrix_norm(Hn), min=1e-12)


def _decompose(H):
    """Faugeras-Lustman 8-way decomposition (DecomposeHomography,
    HomographyInit.cc:264-377). Returns stacked (R [8, 3, 3], t [8, 3],
    n [8, 3], d [8], valid [])."""
    U, S, Vh = torch.linalg.svd(H)
    V = Vh.T
    d1, d2, d3 = torch.abs(S[0]), torch.abs(S[1]), torch.abs(S[2])
    s = torch.linalg.det(U) * torch.linalg.det(V)
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-20)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    valid = (d1 - d2 > 1e-7 * d1) & (d2 - d3 > 1e-7 * d1)

    e1 = const((1.0, -1.0, 1.0, -1.0), H.device, H.dtype)
    e3 = const((1.0, 1.0, -1.0, -1.0), H.device, H.dtype)
    zeros4 = torch.zeros_like(e1)
    ones4 = torch.ones_like(e1)

    def rot_y(c00, c02, c11, c20, c22):
        """[4, 3, 3] with the x/z block (c00, c02; c20, c22) and c11."""
        return torch.stack([
            torch.stack([c00, zeros4, c02], dim=-1),
            torch.stack([zeros4, c11, zeros4], dim=-1),
            torch.stack([c20, zeros4, c22], dim=-1),
        ], dim=-2)

    # Case d' = +d2 (HomographyInit.cc:305-340).
    sin_t = (d1 - d3) * x1 * x3 * e1 * e3 / d2
    cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2 * ones4
    Rp_pos = rot_y(cos_t, -sin_t, ones4, sin_t, cos_t)
    tp_pos = torch.stack([(d1 - d3) * x1 * e1, zeros4,
                          (d1 - d3) * -x3 * e3], dim=-1)
    # Case d' = -d2: Rp = -I with the x/z block replaced by
    # [cos, sin; sin, -cos] (HomographyInit.cc:344-351).
    sin_p = (d1 + d3) * x1 * x3 * e1 * e3 / d2
    cos_p = (d3 * x1 * x1 - d1 * x3 * x3) / d2 * ones4
    Rp_neg = rot_y(cos_p, sin_p, -ones4, sin_p, -cos_p)
    tp_neg = torch.stack([(d1 + d3) * x1 * e1, zeros4,
                          (d1 + d3) * x3 * e3], dim=-1)

    Rp = torch.cat([Rp_pos, Rp_neg])  # [8, 3, 3]
    tp = torch.cat([tp_pos, tp_neg])  # [8, 3]
    n4 = torch.stack([x1 * e1, zeros4, x3 * e3], dim=-1)
    n = torch.cat([n4, n4]) @ V.T
    R = s * (U @ Rp @ V.T)
    t = tp @ U.T
    d = torch.cat([s * d2 * ones4, s * -d2 * ones4])
    return R, t, n, d, valid


def _sampson_error(second, E, first):
    """SampsonusError (HomographyInit.cc:383-403), batched over matches."""
    f = _homogeneous(first)
    sd = _homogeneous(second)
    Ef = f @ E.T
    Etsd = sd @ E
    err = torch.sum(Ef * sd, dim=-1)
    denom = (torch.sum(Ef[:, :2] ** 2, dim=-1)
             + torch.sum(Etsd[:, :2] ** 2, dim=-1))
    return err * err / torch.clamp(denom, min=1e-20)


def _top_indices(score, k):
    """Indices of the k largest, ties to the lower index (``lax.top_k``'s
    rule, which ``torch.topk`` does not promise)."""
    return torch.sort(score, descending=True, stable=True)[1][:k]


def _pick(x, i):
    """x[i] for a 0-d index tensor, as a gather: plain indexing with a 0-d
    tensor would read the index back to the host."""
    return x.index_select(0, i.reshape(1))[0]


def compute(first, second, pixel_jac, match_valid, max_pixel_error=5.0,
            n_trials=300, refine_iters=5, trial_idx=None,
            generator=None) -> HomographyResult:
    """Full HomographyInit::Compute (HomographyInit.cc:43-71), batched.

    first/second [M, 2]: z=1-plane correspondences (padded, mask
    match_valid); pixel_jac [M, 2, 2]: projection derivatives at the
    second-view points (MapMaker.cc:224-231 fills these). trial_idx
    [n_trials, 4]: the matches of each MLESAC trial; when absent they are
    drawn uniformly from the valid matches, with replacement, from
    `generator` (of the inputs' device).
    """
    dtype = first.dtype
    max_err_sq = max_pixel_error * max_pixel_error

    # --- MLESAC (n_trials batched 4-point DLTs) ---
    if trial_idx is None:
        p = match_valid.to(dtype)
        p = p + (1.0 - torch.clamp(torch.sum(p), max=1.0))  # none valid
        trial_idx = torch.multinomial(
            p, n_trials * 4, replacement=True, generator=generator
        ).reshape(n_trials, 4)
    trial_idx = trial_idx.long()
    H_all = _dlt(first[trial_idx], second[trial_idx])  # [T, 3, 3]
    e2_all = _transfer_error_sq(H_all, first, second, pixel_jac)  # [T, M]
    scores = torch.sum(
        torch.where(match_valid[None], torch.clamp(e2_all, max=max_err_sq),
                    0.0),
        dim=-1,
    )
    H = _pick(H_all, torch.argmin(scores))

    # --- Inliers + refinement rounds (HomographyInit.cc:50-58) ---
    e2 = _transfer_error_sq(H, first, second, pixel_jac)
    inliers = match_valid & (e2 < max_err_sq)
    for _ in range(refine_iters):
        H = _refine(H, first, second, pixel_jac, inliers)

    # --- Decomposition (8 candidates) ---
    R8, t8, n8, d8, decomp_ok = _decompose(H)

    # --- Two-stage visibility scoring (ChooseBestDecomposition) ---
    fh = _homogeneous(first)
    # Stage 1: sign of (H row3 . x) / d.
    hrow3 = fh @ H[2]  # [M]
    vis1 = (hrow3[None, :] / d8[:, None]) > 0.0  # [8, M]
    score1 = torch.sum(vis1 & match_valid[None], dim=-1)
    top4 = _top_indices(score1, 4)
    # Stage 2 on the top 4: sign of (x . n) / d.
    xn = n8[top4] @ fh.T
    vis2 = (xn / d8[top4][:, None]) > 0.0
    score2 = torch.sum(vis2 & match_valid[None], dim=-1)
    order2 = _top_indices(score2, 2)
    i0, i1 = top4[order2[:1]][0], top4[order2[1:]][0]
    s0 = score2[order2[:1]][0].to(dtype)
    s1 = score2[order2[1:]][0].to(dtype)
    ratio = s1 / torch.clamp(s0, min=1.0)

    # Sampson tie-break (HomographyInit.cc:455-496).
    limit = max_err_sq * 4.0
    samp = []
    for i in (i0, i1):
        # E = [t]x R, column j = t x R[:, j].
        E = torch.linalg.cross(_pick(t8, i)[None].expand(3, 3),
                               _pick(R8, i).T).T
        se = _sampson_error(second, E, first)
        samp.append(torch.sum(
            torch.where(match_valid, torch.clamp(se, max=limit), 0.0)
        ))
    pick_second = (ratio >= 0.9) & (samp[1] < samp[0])
    win = torch.where(pick_second, i1, i0)

    success = decomp_ok & (torch.sum(inliers) >= 4)
    return HomographyResult(
        success=success, R=_pick(R8, win), t=_pick(t8, win), H=H,
        inliers=inliers, normal=_pick(n8, win), plane_d=_pick(d8, win),
    )
