"""Synthetic rendered scenes: a textured world plane rendered through the
ATAN camera from any pose (exact inverse warp).

Port of the parts of the JAX package's ``utils/synthetic.py`` that the
tracking slice uses. The texture is drawn with numpy from the caller's
``numpy.random.Generator`` in the same order as the JAX package, so one
seed gives the same scene in both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import image as img_ops
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.utils.tensors import (
    TensorTree,
    default_device,
)


@dataclasses.dataclass(frozen=True)
class PlanarScene(TensorTree):
    """A textured plane z = depth (world frame), texture sampled at
    (x, y) * px_per_m + center."""

    texture: torch.Tensor  # [Ht, Wt] f32 in [0, 255]
    depth: float
    px_per_m: float

    def world_to_tex(self, xy_w):
        Ht, Wt = self.texture.shape
        return xy_w * self.px_per_m + torch.tensor(
            [Wt / 2.0, Ht / 2.0], dtype=xy_w.dtype, device=xy_w.device
        )


def make_planar_scene(rng, depth=4.0, tex_size=1024, px_per_m=160.0,
                      n_blobs=400, blur=1.0, device=None) -> PlanarScene:
    """Corner-rich random texture: rectangles of random intensity, on
    `device` (the CUDA card when None)."""
    device = default_device(device)
    tex = np.full((tex_size, tex_size), 128.0, np.float32)
    for _ in range(n_blobs):
        x = rng.integers(0, tex_size - 40)
        y = rng.integers(0, tex_size - 40)
        w = int(rng.integers(6, 40))
        h = int(rng.integers(6, 40))
        tex[y: y + h, x: x + w] = rng.uniform(0, 255)
    tex += rng.uniform(0, 4, tex.shape).astype(np.float32)
    tex = np.clip(tex, 0, 255)
    t = img_ops.gaussian_blur(torch.from_numpy(tex).to(device), blur)
    return PlanarScene(texture=t, depth=depth, px_per_m=px_per_m)


def _pixel_rays(cam, px):
    m = cam_ops.unproject(cam, px)
    return torch.cat([m, torch.ones_like(m[..., :1])], dim=-1)


def render(scene: PlanarScene, cam: cam_ops.Camera, R, t, shape_hw):
    """Render the plane from camera pose (R, t) = camera-from-world: for
    every pixel, unproject to a ray, intersect the plane, sample the
    texture bilinearly; rays behind the camera or off the texture read
    mid-gray."""
    H, W = shape_hw
    device = scene.texture.device
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    px = torch.stack([xs, ys], dim=-1).to(torch.float32).reshape(-1, 2)
    ray_c = _pixel_rays(cam, px)
    C = -(R.T @ t)
    d = ray_c @ R  # R^T applied to each ray
    s = (scene.depth - C[2]) / d[:, 2]
    Xw = C[None, :] + s[:, None] * d
    uv = scene.world_to_tex(Xw[:, :2])
    vals = img_ops.bilinear_sample(scene.texture, uv)
    Ht, Wt = scene.texture.shape
    ok = ((s > 0) & (uv[:, 0] >= 0) & (uv[:, 1] >= 0)
          & (uv[:, 0] < Wt - 1) & (uv[:, 1] < Ht - 1))
    return torch.where(ok, vals, 128.0).reshape(H, W)


def plane_point_from_pixel(scene: PlanarScene, cam: cam_ops.Camera, R, t,
                           px):
    """Ground-truth world point(s) seen at pixel(s) px from pose (R, t)."""
    ray_c = _pixel_rays(cam, px)
    C = -(R.T @ t)
    d = ray_c @ R
    s = (scene.depth - C[..., 2]) / d[..., 2]
    return C + s[..., None] * d


def look_at_pose(position, target=(0.0, 0.0, 4.0), up=(0.0, -1.0, 0.0),
                 device=None):
    """Camera-from-world (R, t) for a camera at `position` looking at
    `target` (z forward, x right, y down); computed in float64 numpy and
    placed on `device` (the CUDA card when None)."""
    device = default_device(device)
    pos = np.asarray(position, np.float64)
    tgt = np.asarray(target, np.float64)
    fwd = tgt - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1).T  # camera-from-world
    t = -R @ pos
    return (torch.tensor(R, dtype=torch.float32, device=device),
            torch.tensor(t, dtype=torch.float32, device=device))


def sideways_pose(R0, t0, s):
    """Pose at parameter s (0 at the start, 1 at the end) of the bootstrap
    camera path: a sideways translation of 0.55 m with a slight pan and
    rise, composed on (R0, t0). A good homography baseline over a plane
    4 m away."""
    mu = torch.tensor(
        [0.55 * s, 0.08 * np.sin(2 * s), 0.05 * s, 0.0, 0.12 * s, 0.0],
        dtype=R0.dtype, device=R0.device,
    )
    dR, dt = lie.se3_exp(mu)
    return lie.se3_mul(dR, dt, R0, t0)
