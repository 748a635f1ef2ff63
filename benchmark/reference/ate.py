"""Similarity alignment (Umeyama) and the absolute trajectory error, the
standard monocular-SLAM metric (TUM-RGBD protocol); float64 numpy."""

from __future__ import annotations

import numpy as np


def umeyama(src, dst):
    """(s, R, t) minimising |dst - (s R src + t)|^2 over points [N, 3]."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s)
    return s, R, mu_d - s * R @ mu_s


def align_by_orientation(est_R, est_c, truth_R, truth_c):
    """(s, Q, c) with truth_c ~ s Q est_c + c, Q the chordal mean of the
    frames' R_truth^T R_est (camera-from-world rotations [N, 3, 3]), s and
    c by least squares on the centres [N, 3]."""
    M = np.einsum("nji,njk->ik", np.asarray(truth_R, np.float64),
                  np.asarray(est_R, np.float64))
    U, _, Vt = np.linalg.svd(M)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    Q = U @ S @ Vt
    p = np.asarray(est_c, np.float64) @ Q.T
    q = np.asarray(truth_c, np.float64)
    dp, dq = p - p.mean(0), q - q.mean(0)
    s = float((dp * dq).sum() / max((dp * dp).sum(), 1e-300))
    return s, Q, q.mean(0) - s * p.mean(0)


def apply(sim, x):
    s, R, t = sim
    return s * np.asarray(x, np.float64) @ R.T + t


def ate_rmse(est, truth):
    """(RMSE of the aligned estimates against the truth, the alignment)."""
    sim = umeyama(est, truth)
    err = apply(sim, est) - np.asarray(truth, np.float64)
    return float(np.sqrt((err ** 2).sum(-1).mean())), sim
