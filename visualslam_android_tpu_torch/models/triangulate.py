"""Two-view triangulation.

Port of the JAX package's ``models/triangulate.py``
(MapMaker::ReprojectPoint, jni/MapMaker.cc:176-200): linear triangulation
via the null vector of the stacked 4x4 DLT system, batched over points.
The JAX package takes it from a batched ``eigh``; on the card
``torch.linalg.eigh`` checks its error flag on the host, a synchronisation
per call, so the null vector comes from ``_null_vector``: inverse and
Rayleigh-quotient iteration in float64, with no host read.
"""

from __future__ import annotations

import torch

# _null_vector's steps: inverse iterations from the start column, then
# Rayleigh-quotient iterations (cubic convergence: the smallest
# eigenvector of A^T A to float64 rounding at baselines down to 1/2000 of
# the depth).
INVERSE_STEPS = 2
RAYLEIGH_STEPS = 3


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _null_vector(M):
    """Unit eigenvector of the smallest eigenvalue of the symmetric
    positive semi-definite M [..., 4, 4], in M's dtype, without a host
    read. In float64: the inverse of M + d I (d = 1e-12 trace + 1e-30, so
    an exactly singular M stays invertible); its column of largest norm
    starts INVERSE_STEPS inverse iterations, then RAYLEIGH_STEPS
    Rayleigh-quotient iterations (solve (M - rho I) y = x, rho = x^T M x).
    A step whose solve is not finite keeps the vector it had."""
    Md = M.double()
    eye = torch.eye(4, dtype=Md.dtype, device=Md.device)
    trace = torch.diagonal(Md, dim1=-2, dim2=-1).sum(-1)
    inv = torch.linalg.inv_ex(
        Md + (1e-12 * trace + 1e-30)[..., None, None] * eye).inverse
    col = torch.linalg.vector_norm(inv, dim=-2).argmax(dim=-1)
    x = _unit(torch.gather(
        inv, -1, col[..., None, None].expand(*inv.shape[:-1], 1))[..., 0])
    for _ in range(INVERSE_STEPS):
        x = _unit((inv @ x[..., None])[..., 0])
    for _ in range(RAYLEIGH_STEPS):
        rho = (x[..., None, :] @ Md @ x[..., :, None])[..., 0, 0]
        y = _unit(torch.linalg.solve_ex(
            Md - rho[..., None, None] * eye, x[..., None]).result[..., 0])
        x = torch.where(torch.isfinite(y).all(dim=-1, keepdim=True), y, x)
    return x.to(M.dtype)


def triangulate(Ra, ta, Rb, tb, ma, mb):
    """Triangulate points seen at z=1-plane coords ma/mb [..., 2] from
    cameras A and B (camera-from-world R [..., 3, 3], t [..., 3]). Returns
    world points [..., 3].

    DLT rows (MapMaker.cc:176-200): for P = [R | t],
    [u * P_row3 - P_row1; v * P_row3 - P_row2] for each view. The
    eigenvector of A^T A with the smallest eigenvalue (``_null_vector``)
    is the homogeneous point.
    """
    Pa = torch.cat([Ra, ta[..., None]], dim=-1)  # [..., 3, 4]
    Pb = torch.cat([Rb, tb[..., None]], dim=-1)

    def rows(P, m):
        r0 = m[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = m[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return torch.stack([r0, r1], dim=-2)  # [..., 2, 4]

    A = torch.cat([rows(Pa, ma), rows(Pb, mb)], dim=-2)  # [..., 4, 4]
    AtA = A.transpose(-1, -2) @ A
    Xh = _null_vector(AtA)
    w = Xh[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / safe_w[..., None]


def depth_in_camera(R, t, X):
    """z-coordinate of world points X [..., 3] in camera (R, t)."""
    return (R @ X[..., None])[..., 2, 0] + t[..., 2]
