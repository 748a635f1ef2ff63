"""Synthetic rendered scenes: a textured world plane rendered through the
ATAN camera from any pose (exact inverse warp).

Port of the JAX package's ``utils/synthetic.py``, plus ``degrade``, the
sensor degradations of its ``tools/make_tum_synthetic.py``. Textures, noise
and structure are drawn with numpy from the caller's
``numpy.random.Generator`` in the same order as the JAX package, so one
seed gives the same scene in both. The photograph behind
``make_photo_scene`` ships with the package as a grey PNG
(``data/grace_hopper_L.png``), so no image library is needed to read it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import image as img_ops
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.utils import imageio
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


PHOTO_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "data", "grace_hopper_L.png")


def make_photo_scene(depth=4.0, px_per_m=160.0, tile=2, photo_path=None,
                     device=None) -> PlanarScene:
    """Planar scene textured with a real photograph (natural texture
    statistics: smooth shading, low-contrast regions, photographic noise),
    mirror-tiled tile x tile times so that no seam is a step. The default
    photograph is the package's ``data/grace_hopper_L.png``; any grey or
    colour PNG / PNM is read through ``utils/imageio.read_gray``. On
    `device` (the CUDA card when None)."""
    device = default_device(device)
    g = imageio.read_gray(photo_path or PHOTO_PATH).astype(np.float32)
    row = np.concatenate([g, g[:, ::-1]] * tile, axis=1)
    full = np.concatenate([row, row[::-1]] * tile, axis=0)
    return PlanarScene(texture=torch.from_numpy(full).to(device),
                       depth=depth, px_per_m=px_per_m)


def apply_sensor_effects(img, rng, exposure_gain=1.0, exposure_bias=0.0,
                         noise_std=2.0, blur_sigma=0.0):
    """Camera realism for a rendered frame, on the frame's device: exposure
    drift (gain, bias), optional defocus blur (``ops/image.gaussian_blur``),
    Gaussian read noise drawn from the host's `rng` (one draw of the
    frame's shape, as the JAX package draws it), clipped to [0, 255]."""
    out = img.to(torch.float32) * float(exposure_gain) + float(exposure_bias)
    if blur_sigma > 0:
        out = img_ops.gaussian_blur(out, float(blur_sigma))
    if noise_std > 0:
        noise = rng.normal(scale=noise_std, size=tuple(out.shape))
        out = out + torch.from_numpy(noise.astype(np.float32)).to(out.device)
    return torch.clamp(out, 0.0, 255.0)


def degrade(img, k, rng, strength=1.0):
    """Frame k's sensor degradations of the TUM-format stand-in sequence
    (``tools/make_tum_synthetic.py:27-47``), in float64 numpy: a slow
    sinusoidal exposure gain and offset, a defocus blur whose sigma sweeps
    0-1.1 px over the sequence, ~12% vignetting at the corners and Gaussian
    sensor noise from `rng`. Returns [h, w] float64 in [0, 255]."""
    from scipy import ndimage

    h, w = img.shape
    out = np.asarray(img, np.float64)
    gain = 1.0 + 0.18 * strength * np.sin(0.13 * k)
    offset = 10.0 * strength * np.sin(0.07 * k + 1.0)
    out = out * gain + offset
    sigma = strength * (0.55 + 0.55 * np.sin(0.21 * k + 2.0))
    if sigma > 0.05:
        out = ndimage.gaussian_filter(out, sigma)
    ys, xs = np.mgrid[0:h, 0:w]
    r2 = ((xs - w / 2) / (w / 2)) ** 2 + ((ys - h / 2) / (h / 2)) ** 2
    out = out * (1.0 - 0.12 * strength * r2)
    out = out + rng.normal(scale=2.0 * strength, size=out.shape)
    return np.clip(out, 0, 255)


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


def random_structure(rng, n_points, depth_range=(3.0, 6.0), xy_range=2.0,
                     device=None):
    """Random 3D points [n_points, 3] for estimation-only tests, on
    `device` (the CUDA card when None)."""
    device = default_device(device)
    xy = rng.uniform(-xy_range, xy_range, size=(n_points, 2))
    z = rng.uniform(*depth_range, size=(n_points, 1))
    return torch.tensor(np.concatenate([xy, z], axis=-1),
                        dtype=torch.float32, device=device)
