"""Two-view triangulation.

Port of the JAX package's ``models/triangulate.py``
(MapMaker::ReprojectPoint, jni/MapMaker.cc:176-200): linear triangulation
via the null vector of the stacked 4x4 DLT system, batched over points.
"""

from __future__ import annotations

import torch


def triangulate(Ra, ta, Rb, tb, ma, mb):
    """Triangulate points seen at z=1-plane coords ma/mb [..., 2] from
    cameras A and B (camera-from-world R [..., 3, 3], t [..., 3]). Returns
    world points [..., 3].

    DLT rows (MapMaker.cc:176-200): for P = [R | t],
    [u * P_row3 - P_row1; v * P_row3 - P_row2] for each view. The
    eigenvector of A^T A with the smallest eigenvalue (a batched 4x4
    ``eigh``) is the homogeneous point.
    """
    Pa = torch.cat([Ra, ta[..., None]], dim=-1)  # [..., 3, 4]
    Pb = torch.cat([Rb, tb[..., None]], dim=-1)

    def rows(P, m):
        r0 = m[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = m[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return torch.stack([r0, r1], dim=-2)  # [..., 2, 4]

    A = torch.cat([rows(Pa, ma), rows(Pb, mb)], dim=-2)  # [..., 4, 4]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    Xh = vecs[..., :, 0]
    w = Xh[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / safe_w[..., None]


def depth_in_camera(R, t, X):
    """z-coordinate of world points X [..., 3] in camera (R, t)."""
    return (R @ X[..., None])[..., 2, 0] + t[..., 2]
