"""The scene the benchmark films and the paths its camera takes.

A scene is a textured plane z = depth_m in the world frame: rectangles of
random grey on a mid-grey ground, uniform noise, a Gaussian blur (the
statistics of the port's ``utils/synthetic.make_planar_scene``, drawn
here from the run's seed). A path gives the camera's pose at each of its
frames: pose k = exp(mu(s)) * look_at(start, target), s = k / s_divisor,
each of the six components of mu (translation, then rotation) a linear
term in s plus sines (the shape of the port's ``bench.py`` sweep and of
``tools/run_large_map_slam.py``'s traverse). The renderer is the exact
inverse warp through the ATAN camera, batched over frames, in elementwise
arithmetic only.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import geometry

GREY = 128.0  # what a ray that misses the texture reads


def blur_taps(sigma: float):
    """Normalised Gaussian taps, radius max(1, round(3 sigma))."""
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur(img, sigma: float):
    """Separable Gaussian blur with edge-replicate padding, as shifted
    elementwise sums."""
    if sigma <= 0:
        return img
    taps = blur_taps(sigma)
    r = len(taps) // 2
    for dim in (0, 1):
        n = img.shape[dim]
        pad = torch.cat([img.narrow(dim, 0, 1).expand(
            *((r, -1) if dim == 0 else (-1, r))), img,
            img.narrow(dim, n - 1, 1).expand(
                *((r, -1) if dim == 0 else (-1, r)))], dim=dim)
        acc = torch.zeros_like(img)
        for j, w in enumerate(taps):
            acc = acc + float(w) * pad.narrow(dim, j, n)
        img = acc
    return img


def make_texture(scene: dict, seed: int, device) -> torch.Tensor:
    """The scene's texture [height, width] f32 in [0, 255] on `device`,
    drawn from `seed`: n_blobs rectangles of sides in blob_px, each of one
    uniform grey, painted in order; uniform noise in [0, noise); blurred."""
    rng = np.random.default_rng([seed, 0x7e87])
    height, width = scene["texture_px"]
    lo, hi = scene["blob_px"]
    n = scene["n_blobs"]
    xs = rng.integers(0, width - hi, n)
    ys = rng.integers(0, height - hi, n)
    ws = rng.integers(lo, hi, n)
    hs = rng.integers(lo, hi, n)
    vals = rng.uniform(0.0, 255.0, n)
    tex = np.full((height, width), scene["background"], np.float32)
    for x, y, w, h, v in zip(xs, ys, ws, hs, vals):
        tex[y:y + h, x:x + w] = v
    tex += rng.uniform(0.0, scene["noise"], tex.shape).astype(np.float32)
    np.clip(tex, 0.0, 255.0, out=tex)
    return blur(torch.from_numpy(tex).to(device), scene["blur_sigma"])


def path_pose(path: dict, k: int):
    """Camera-from-world (R, t), float64 numpy, at frame k of the path."""
    s = k / path["s_divisor"]
    mu = np.asarray(path["linear"], np.float64) * s
    for comp, amp, freq in path["sines"]:
        mu[comp] += amp * np.sin(freq * s)
    R0, t0 = geometry.look_at(path["start"], path["target"])
    dR, dt = geometry.se3_exp(mu)
    return dR @ R0, dR @ t0 + dt


def path_poses(path: dict, n: int):
    """(R [n, 3, 3], t [n, 3]) float64 of the path's first n frames."""
    poses = [path_pose(path, k) for k in range(n)]
    return (np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses]))


def pixel_rays(cam: geometry.Camera, height: int, width: int, device):
    """The ray (mx, my, 1) [H W, 3] through each pixel centre, f32."""
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device, dtype=torch.float32),
        torch.arange(width, device=device, dtype=torch.float32),
        indexing="ij")
    m = cam.unproject(torch.stack([xs, ys], dim=-1).reshape(-1, 2))
    return torch.cat([m, torch.ones_like(m[:, :1])], dim=-1)


def bilinear(tex, u, v):
    """Bilinear samples of tex at (u, v); positions must lie in
    [0, W - 1) x [0, H - 1)."""
    H, W = tex.shape
    x0 = torch.clamp(torch.floor(u), 0, W - 2)
    y0 = torch.clamp(torch.floor(v), 0, H - 2)
    fx = torch.clamp(u - x0, 0.0, 1.0)
    fy = torch.clamp(v - y0, 0.0, 1.0)
    i = (y0.long() * W + x0.long())
    flat = tex.reshape(-1)
    i00, i01 = flat[i], flat[i + 1]
    i10, i11 = flat[i + W], flat[i + W + 1]
    top = (1 - fx) * i00 + fx * i01
    bot = (1 - fx) * i10 + fx * i11
    return (1 - fy) * top + fy * bot


def tex_coords(scene: dict, xw, yw, tex_shape):
    """Texture pixel of world plane point (xw, yw): the texture's centre
    lies at world centre_m."""
    height, width = tex_shape
    ppm = scene["px_per_m"]
    cx, cy = scene["center_m"]
    return ((xw - cx) * ppm + width / 2.0, (yw - cy) * ppm + height / 2.0)


def render(tex, scene: dict, cam: geometry.Camera, R, t, height: int,
           width: int, chunk: int = 16):
    """Frames [B, H, W] f32 of the plane from poses R [B, 3, 3], t [B, 3]
    (tensors on tex's device): each pixel's ray meets the plane and reads
    the texture bilinearly; a ray behind the camera or off the texture
    reads GREY."""
    rays = pixel_rays(cam, height, width, tex.device)
    Ht, Wt = tex.shape
    out = []
    for b0 in range(0, R.shape[0], chunk):
        Rb, tb = R[b0:b0 + chunk], t[b0:b0 + chunk]
        C = -(Rb * tb[:, :, None]).sum(1)                    # [b, 3]
        d = (Rb[:, None, :, :] * rays[None, :, :, None]).sum(2)  # R^T ray
        s = (scene["depth_m"] - C[:, None, 2]) / d[..., 2]
        xw = C[:, None, 0] + s * d[..., 0]
        yw = C[:, None, 1] + s * d[..., 1]
        u, v = tex_coords(scene, xw, yw, (Ht, Wt))
        ok = (s > 0) & (u >= 0) & (v >= 0) & (u < Wt - 1) & (v < Ht - 1)
        vals = bilinear(tex, torch.where(ok, u, 0.0), torch.where(ok, v, 0.0))
        out.append(torch.where(ok, vals, GREY).reshape(-1, height, width))
    return torch.cat(out)
