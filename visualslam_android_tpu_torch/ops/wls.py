"""Weighted least-squares normal equations and small dense solves.

Port of the JAX package's ``ops/wls.py`` (the reference's ``myWLS<N>``,
jni/myWLS.h:29-66): J^T W J and J^T W e over all residuals at once with an
optional diagonal prior, solved by a Cholesky factorization; and the
closed-form 3x3 inverse that the subpixel Hessians and the bundle
adjustment's point blocks use.
"""

from __future__ import annotations

import torch


def solve_spd(A, b, ridge=1e-9):
    """Cholesky solve of a symmetric positive-definite system, batched:
    A [..., n, n], b [..., n]. A matrix that does not factor gives NaN, as
    the JAX package's does, and raises nothing."""
    n = A.shape[-1]
    A = A + ridge * torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.nan)


def solve_normal_equations(J, e, w=None, prior=0.0, ridge=1e-9):
    """Solve (J^T W J + prior*I) x = J^T W e over batched rows.

    J: [..., M, N] stacked Jacobian rows; e: [..., M] residuals; w:
    [..., M] weights (None for unit weights); prior: scalar diagonal prior
    (myWLS::add_prior, myWLS.h:29-33). Returns (x [..., N], A [..., N, N]),
    A being the prior-augmented information matrix, as myWLS exposes its
    accumulator."""
    Jw = J if w is None else J * w[..., None]
    A = Jw.transpose(-1, -2) @ J
    b = (Jw.transpose(-1, -2) @ e[..., None])[..., 0]
    n = J.shape[-1]
    A = A + (prior + ridge) * torch.eye(n, dtype=J.dtype, device=J.device)
    # A already carries the ridge.
    return solve_spd(A, b, ridge=0.0), A


def inv3x3(A):
    """Adjugate inverse of batched 3x3 matrices. Callers guard
    singular/masked entries themselves."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    safe = torch.where(torch.abs(det) < 1e-30, 1.0, det)
    inv = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return inv / safe[..., None, None]
