"""Batched ATAN/FOV (Devernay-Faugeras) camera model.

Port of the JAX package's ``ops/camera.py`` (the reference's
``ATANCamera``, jni/ATANCamera.{h,cc}): project / unproject between the
z=1 camera plane and distorted pixels (ATANCamera.cc:133-164), the 2x2
projection Jacobian (ATANCamera.cc:198-231), the largest visible radius,
the one-pixel distance and the in-image test. The JAX package takes the
Jacobian by forward-mode AD; here it is written out in closed form (same
function, same branches).
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.utils.tensors import (
    TensorTree,
    default_device,
)

_EPS = 1e-9


def _safe_norm(v):
    """L2 norm over the last axis, well defined at v = 0."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-18)


@dataclasses.dataclass(frozen=True)
class Camera(TensorTree):
    """FOV camera. Normalized intrinsics as in ATANCamera.cc:20-24, scaled
    by the image size (ATANCamera.cc:37-129)."""

    focal: torch.Tensor           # [2] (fx * W, fy * H)
    center: torch.Tensor          # [2] (cx * W - 0.5, cy * H - 0.5)
    w: torch.Tensor               # [] FOV distortion parameter omega
    two_tan_half_w: torch.Tensor  # [] 2 * tan(w / 2)
    size: torch.Tensor            # [2] (W, H) as float


def make_camera(params, width: int, height: int, device=None,
                dtype=torch.float32) -> Camera:
    """Camera from normalized (fx, fy, cx, cy, w) and an image size, with
    the -0.5 pixel-center offset of ATANCamera::RefreshParams, on `device`
    (the CUDA card when None)."""
    device = default_device(device)
    fx, fy, cx, cy, w = [torch.tensor(p, dtype=dtype, device=device)
                         for p in params]
    return Camera(
        focal=torch.stack([fx * width, fy * height]),
        center=torch.stack([cx * width - 0.5, cy * height - 0.5]),
        w=w,
        two_tan_half_w=2.0 * torch.tan(w / 2.0),
        size=torch.tensor([width, height], dtype=dtype, device=device),
    )


def scale_camera(cam: Camera, factor: float) -> Camera:
    """Camera for a pyramid level: intrinsics scaled by `factor`."""
    return Camera(
        focal=cam.focal * factor,
        center=(cam.center + 0.5) * factor - 0.5,
        w=cam.w,
        two_tan_half_w=cam.two_tan_half_w,
        size=cam.size * factor,
    )


def _rtrans(cam: Camera, r):
    """Distortion factor and its derivative d factor / d r
    (ATANCamera.h:136-143): factor(r) = atan(r * 2tan(w/2)) / (r * w),
    with the w->0 / r->0 limits (factor 1, derivative 0)."""
    small = (torch.abs(cam.w) < 1e-5) | (r < 0.001)
    safe_r = torch.where(r < 0.001, 1.0, r)
    safe_w = torch.where(torch.abs(cam.w) < 1e-5, 1.0, cam.w)
    rt = safe_r * cam.two_tan_half_w
    num = torch.atan(rt)
    den = safe_r * safe_w
    factor = num / den
    dnum = cam.two_tan_half_w / (1.0 + rt * rt)
    dfactor = dnum / den - num * safe_w / (den * den)
    return (torch.where(small, 1.0, factor),
            torch.where(small, 0.0, dfactor))


def _invrtrans(cam: Camera, r_dist):
    """Distorted radius -> undistorted radius (ATANCamera.h:145-150)."""
    w_small = torch.abs(cam.w) < 1e-5
    safe = torch.where(w_small, 1.0, cam.two_tan_half_w)
    r = torch.tan(r_dist * cam.w) / safe
    return torch.where(w_small, r_dist, r)


def project(cam: Camera, m):
    """Camera-plane point m[..., 2] -> pixel [..., 2]
    (ATANCamera.cc:133-145)."""
    factor, _ = _rtrans(cam, _safe_norm(m))
    return cam.center + cam.focal * (factor[..., None] * m)


def unproject(cam: Camera, v):
    """Pixel v[..., 2] -> camera-plane point [..., 2]
    (ATANCamera.cc:149-164)."""
    dist = (v - cam.center) / cam.focal
    r_dist = _safe_norm(dist)
    r = _invrtrans(cam, r_dist)
    tiny = r_dist < _EPS
    factor = torch.where(tiny, 1.0, r / torch.where(tiny, 1.0, r_dist))
    return factor[..., None] * dist


def project_derivs(cam: Camera, m):
    """(pixel [..., 2], d pixel / d m [..., 2, 2]): the Jacobian of
    ATANCamera::GetProjectionDerivs (ATANCamera.cc:198-231).
    d(factor * m)/dm = factor * I + f'(r) m m^T / r."""
    r = _safe_norm(m)
    factor, dfactor = _rtrans(cam, r)
    px = cam.center + cam.focal * (factor[..., None] * m)
    outer = m[..., :, None] * m[..., None, :] * (dfactor / r)[..., None, None]
    eye = torch.eye(2, dtype=m.dtype, device=m.device)
    jac = cam.focal[:, None] * (factor[..., None, None] * eye + outer)
    return px, jac


def in_image(cam: Camera, v, border=0.0):
    """Pixel inside the frame with a border margin (in_image_with_border,
    vision/ImageHandler.cpp:120-122)."""
    return torch.all((v >= border) & (v < cam.size - border), dim=-1)


def one_pixel_dist(cam: Camera):
    """Camera-plane distance of one pixel at the image center
    (ATANCamera's mdOnePixelDist)."""
    c = cam.center
    step = torch.stack([torch.ones_like(c[0]), torch.zeros_like(c[0])])
    return torch.linalg.vector_norm(unproject(cam, c + step)
                                    - unproject(cam, c))


def largest_radius_in_image(cam: Camera):
    """Largest undistorted camera-plane radius visible in the image
    (ATANCamera's mdLargestRadius)."""
    W1, H1 = cam.size[0] - 1.0, cam.size[1] - 1.0
    zero = torch.zeros_like(W1)
    corners = torch.stack([
        torch.stack([zero, zero]), torch.stack([W1, zero]),
        torch.stack([zero, H1]), torch.stack([W1, H1]),
    ])
    m = unproject(cam, corners)
    return torch.max(torch.linalg.vector_norm(m, dim=-1))


def gl_frustum(cam: Camera, near=0.01, far=100.0):
    """OpenGL-style 4x4 projection matrix of the camera's linear part (the
    capability of ATANCamera's MakeUFBLinearFrustumMatrix; the distortion
    is left out, as the reference's GL path leaves it), on the camera's
    device."""
    fx, fy = cam.focal[0], cam.focal[1]
    cx, cy = cam.center[0], cam.center[1]
    W, H = cam.size[0], cam.size[1]
    left = -near * cx / fx
    right = near * (W - cx) / fx
    top = -near * cy / fy
    bottom = near * (H - cy) / fy
    zero = torch.zeros_like(fx)
    return torch.stack([
        torch.stack([2 * near / (right - left), zero,
                     (right + left) / (right - left), zero]),
        torch.stack([zero, 2 * near / (bottom - top),
                     (bottom + top) / (bottom - top), zero]),
        torch.stack([zero, zero, zero - (far + near) / (far - near),
                     zero - 2 * far * near / (far - near)]),
        torch.stack([zero, zero, zero - 1.0, zero]),
    ])
