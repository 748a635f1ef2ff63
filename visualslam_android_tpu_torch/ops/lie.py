"""Batched Lie-group operations: SO(3), SE(3), SE(2).

Port of the JAX package's ``ops/lie.py`` (the reference's header-only
``mySO3/mySE3/mySE2``, jni/RT.h): exp/ln with Taylor branches near the
identity (RT.h:132-208, :318-383), inverse, composition and generator
fields (RT.h:285-295). Every op is batched over leading axes; branches are
``torch.where`` selections with safe denominators, as in the JAX package.

Conventions: rotations are 3x3 (2x2) matrices; SE(3) elements are (R, t)
pairs; tangent vectors follow PTAM's ordering mu = [translation, rotation].
"""

from __future__ import annotations

import torch

from visualslam_android_tpu_torch.utils.tensors import default_device

_EPS = 1e-8


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _matvec(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def hat3(w):
    """Skew-symmetric matrix of w[..., 3] (jni/RT.h:70-77)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee3(W):
    """Inverse of hat3."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq):
    """A = sin(t)/t, B = (1-cos(t))/t^2 with Taylor branches
    (jni/RT.h:132-163)."""
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, 1.0, theta_sq))
    safe_sq = torch.where(small, 1.0, theta_sq)
    a_big = torch.sin(theta) / theta
    b_big = (1.0 - torch.cos(theta)) / safe_sq
    a_small = 1.0 - theta_sq / 6.0 * (1.0 - theta_sq / 20.0)
    b_small = 0.5 * (1.0 - theta_sq / 12.0 * (1.0 - theta_sq / 30.0))
    return torch.where(small, a_small, a_big), torch.where(small, b_small, b_big)


def so3_exp(w):
    """Rodrigues formula: w[..., 3] -> R[..., 3, 3] (jni/RT.h:132-163)."""
    theta_sq = torch.sum(w * w, dim=-1)
    A, B = _sinc_coeffs(theta_sq)
    W = hat3(w)
    W2 = W @ W
    return _eye(3, w) + A[..., None, None] * W + B[..., None, None] * W2


def so3_ln(R):
    """Log map R[..., 3, 3] -> w[..., 3] (jni/RT.h:165-208), with the
    near-pi fallback through the symmetric part."""
    cos_angle = torch.clamp(
        0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0), -1.0, 1.0
    )
    Rt = R.transpose(-1, -2)
    w_asym = 0.5 * vee3(R - Rt)
    sin_angle = torch.linalg.vector_norm(w_asym, dim=-1)
    angle = torch.atan2(sin_angle, cos_angle)

    small = sin_angle < _EPS
    safe_sin = torch.where(small, 1.0, sin_angle)
    scale_reg = torch.where(small, 1.0 + angle * angle / 6.0, angle / safe_sin)
    w_reg = w_asym * scale_reg[..., None]

    Bm = 0.5 * (R + Rt) - cos_angle[..., None, None] * _eye(3, R)
    diag = torch.diagonal(Bm, dim1=-2, dim2=-1)
    denom = torch.clamp(1.0 - cos_angle, min=_EPS)
    axis_abs = torch.sqrt(torch.clamp(diag / denom[..., None], min=0.0))
    k = torch.argmax(axis_abs, dim=-1)
    sym = 0.5 * (Bm + Bm.transpose(-1, -2))
    idx = k[..., None, None].expand(*k.shape, 1, 3)
    row = torch.gather(sym, -2, idx)[..., 0, :]
    pivot = torch.gather(row, -1, k[..., None])
    axis_signed = torch.sign(pivot) * row / torch.clamp(
        torch.linalg.vector_norm(row, dim=-1, keepdim=True), min=_EPS
    )
    dot = torch.sum(axis_signed * w_asym, dim=-1, keepdim=True)
    axis_signed = torch.where(dot < 0, -axis_signed, axis_signed)
    w_pi = axis_signed * angle[..., None]

    near_pi = cos_angle < -0.9
    return torch.where(near_pi[..., None], w_pi, w_reg)


def _v_matrix(w):
    """Left Jacobian V of SE(3) exp (jni/RT.h:318-352)."""
    theta_sq = torch.sum(w * w, dim=-1)
    A, B = _sinc_coeffs(theta_sq)
    small = theta_sq < 1e-8
    c_big = (1.0 - A) / torch.where(small, 1.0, theta_sq)
    c_small = 1.0 / 6.0 * (1.0 - theta_sq / 20.0 * (1.0 - theta_sq / 42.0))
    C = torch.where(small, c_small, c_big)
    W = hat3(w)
    W2 = W @ W
    return _eye(3, w) + B[..., None, None] * W + C[..., None, None] * W2


def _v_inv_matrix(w):
    """Inverse left Jacobian, used by se3_ln (jni/RT.h:354-383)."""
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, 1.0, theta_sq))
    half = 0.5 * theta
    cot = torch.cos(half) / torch.where(small, 1.0, torch.sin(half))
    coef_big = (1.0 - 0.5 * theta * cot) / torch.where(small, 1.0, theta_sq)
    coef_small = 1.0 / 12.0 * (1.0 + theta_sq / 60.0 * (1.0 + theta_sq / 42.0))
    coef = torch.where(small, coef_small, coef_big)
    W = hat3(w)
    W2 = W @ W
    return _eye(3, w) - 0.5 * W + coef[..., None, None] * W2


def se3_exp(mu):
    """mu[..., 6] = [t(3), w(3)] -> (R[..., 3, 3], t[..., 3])."""
    rho, w = mu[..., :3], mu[..., 3:]
    return so3_exp(w), _matvec(_v_matrix(w), rho)


def se3_ln(R, t):
    """(R, t) -> mu[..., 6] = [t(3), w(3)] (jni/RT.h:354-383)."""
    w = so3_ln(R)
    rho = _matvec(_v_inv_matrix(w), t)
    return torch.cat([rho, w], dim=-1)


def se3_mul(Ra, ta, Rb, tb):
    """Composition a * b (apply b first): (RaRb, Ra tb + ta)."""
    return Ra @ Rb, _matvec(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se3_apply(R, t, x):
    """Transform points x[..., 3]."""
    return _matvec(R, x) + t


def se3_matrix(R, t):
    """Stack (R, t) into [..., 3, 4]."""
    return torch.cat([R, t[..., None]], dim=-1)


def se3_unstack(T):
    """[..., 3, 4] -> (R [..., 3, 3], t [..., 3])."""
    return T[..., :3], T[..., 3]


def se3_identity(batch_shape=(), dtype=torch.float32, device=None):
    """(R, t) of the identity, broadcast to batch_shape, on `device` (the
    CUDA card when None)."""
    device = default_device(device)
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    return R, torch.zeros(*batch_shape, 3, dtype=dtype, device=device)


# --- SO(2) / SE(2): SmallBlurryImage ESM alignment (jni/RT.h:416-489). ---


def so2_exp(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def so2_ln(R):
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


def _se2_ab(theta):
    small = torch.abs(theta) < 1e-6
    safe = torch.where(small, 1.0, theta)
    A = torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 * theta, (1.0 - torch.cos(safe)) / safe)
    return A, B


def se2_exp(mu):
    """mu[..., 3] = [tx, ty, theta] -> (R[..., 2, 2], t[..., 2])
    (mySE2::exp, jni/RT.h:491+)."""
    rho, theta = mu[..., :2], mu[..., 2]
    A, B = _se2_ab(theta)
    V = torch.stack(
        [torch.stack([A, -B], dim=-1), torch.stack([B, A], dim=-1)], dim=-2
    )
    return so2_exp(theta), _matvec(V, rho)


def se2_ln(R, t):
    theta = so2_ln(R)
    A, B = _se2_ab(theta)
    det = A * A + B * B
    Vinv = torch.stack(
        [torch.stack([A, B], dim=-1), torch.stack([-B, A], dim=-1)], dim=-2
    ) / det[..., None, None]
    return torch.cat([_matvec(Vinv, t), theta[..., None]], dim=-1)


def se2_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se2_mul(Ra, ta, Rb, tb):
    return Ra @ Rb, _matvec(Ra, tb) + ta


def se3_generator_field(pos_h, i):
    """Generator field i applied to homogeneous pos[..., 4] -> [..., 4]
    (mySE3::generator_field, jni/RT.h:285-295): 0-2 translations, 3-5
    rotations."""
    out = torch.zeros_like(pos_h)
    if i < 3:
        out[..., i] = pos_h[..., 3]
        return out
    j, k = (i - 3 + 1) % 3, (i - 3 + 2) % 3
    out[..., j] = -pos_h[..., k]
    out[..., k] = pos_h[..., j]
    return out
