"""Rigid motions and the ATAN (FOV) camera, written out plainly.

Poses are camera-from-world (R, t): x_cam = R x_world + t. The camera is
the reference app's ATAN model (jni/ATANCamera.cc:20-24, 133-164), with
its -0.5 pixel-centre offset. Everything here is elementwise arithmetic,
so no matrix-multiply precision setting (TF32) can change it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def hat(w):
    """[3] -> the skew matrix [3, 3] (float64 numpy)."""
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def se3_exp(mu):
    """mu = [rho(3), omega(3)] -> (R [3, 3], t [3]) in float64: Rodrigues'
    formula and t = V rho."""
    mu = np.asarray(mu, np.float64)
    rho, w = mu[:3], mu[3:]
    theta = float(np.linalg.norm(w))
    W = hat(w)
    if theta < 1e-8:
        A, B, C = 1.0, 0.5, 1.0 / 6.0
    else:
        A = np.sin(theta) / theta
        B = (1.0 - np.cos(theta)) / theta ** 2
        C = (1.0 - A) / theta ** 2
    R = np.eye(3) + A * W + B * (W @ W)
    V = np.eye(3) + B * W + C * (W @ W)
    return R, V @ rho


def look_at(position, target, up=(0.0, -1.0, 0.0)):
    """Camera-from-world (R, t) in float64 of a camera at `position`
    looking at `target` (z forward, x right, y down)."""
    pos = np.asarray(position, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return R, -R @ pos


def centers(R, t):
    """Camera centres -R^T t of poses R [n, 3, 3], t [n, 3] (numpy)."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    return -np.einsum("nji,nj->ni", R, t)


@dataclasses.dataclass(frozen=True)
class Camera:
    """ATAN camera at one image size, from the normalised parameters
    (fx, fy, cx, cy, w)."""

    fx: float
    fy: float
    cx: float
    cy: float
    w: float

    @classmethod
    def from_params(cls, params, width, height):
        fx, fy, cx, cy, w = (float(p) for p in params)
        return cls(fx * width, fy * height, cx * width - 0.5,
                   cy * height - 0.5, w)

    @property
    def two_tan_half_w(self):
        return 2.0 * np.tan(self.w / 2.0)

    def project(self, m):
        """Camera-plane points m [..., 2] -> pixels [..., 2]."""
        r = torch.sqrt(m[..., 0] ** 2 + m[..., 1] ** 2)
        if abs(self.w) < 1e-5:
            factor = torch.ones_like(r)
        else:
            safe = torch.where(r < 1e-3, torch.ones_like(r), r)
            factor = torch.where(
                r < 1e-3, torch.ones_like(r),
                torch.atan(safe * self.two_tan_half_w) / (safe * self.w))
        return torch.stack([self.cx + self.fx * factor * m[..., 0],
                            self.cy + self.fy * factor * m[..., 1]], dim=-1)

    def unproject(self, px):
        """Pixels px [..., 2] -> camera-plane points [..., 2]."""
        dx = (px[..., 0] - self.cx) / self.fx
        dy = (px[..., 1] - self.cy) / self.fy
        r_dist = torch.sqrt(dx * dx + dy * dy)
        if abs(self.w) < 1e-5:
            factor = torch.ones_like(r_dist)
        else:
            tiny = r_dist < 1e-10
            safe = torch.where(tiny, torch.ones_like(r_dist), r_dist)
            r = torch.tan(safe * self.w) / self.two_tan_half_w
            factor = torch.where(tiny, torch.ones_like(r_dist), r / safe)
        return torch.stack([factor * dx, factor * dy], dim=-1)


def transform(R, t, x):
    """R [..., 3, 3] x [..., 3] + t [..., 3], elementwise (no matmul)."""
    return (R * x[..., None, :]).sum(-1) + t


def transform_inverse(R, t, x):
    """R^T (x - t), elementwise."""
    d = x - t
    return (R * d[..., :, None]).sum(-2)
