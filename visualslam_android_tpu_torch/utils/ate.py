"""Trajectory evaluation: similarity (Sim3) alignment and the absolute
trajectory error, the standard monocular-SLAM metric (TUM-RGBD protocol).

Port of the JAX package's ``utils/ate.py``, which is numpy only: the port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src, dst, with_scale=True):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: [N, 3]. Returns (s, R, t) with dst ~ s * R @ src + t.
    """
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
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_positions, gt_positions, with_scale=True):
    """Similarity-aligned absolute trajectory RMSE: (rmse,
    aligned_estimates)."""
    s, R, t = umeyama_alignment(est_positions, gt_positions, with_scale)
    est = np.asarray(est_positions, np.float64)
    aligned = (s * (R @ est.T)).T + t
    err = aligned - np.asarray(gt_positions, np.float64)
    return float(np.sqrt((err**2).sum(-1).mean())), aligned


def camera_centers(R_list, t_list):
    """Camera centers (-R^T t) from camera-from-world poses."""
    return np.stack(
        [-np.asarray(R).T @ np.asarray(t) for R, t in zip(R_list, t_list)]
    )
