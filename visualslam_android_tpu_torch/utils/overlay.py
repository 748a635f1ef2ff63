"""Debug and AR overlays: FAST corners, bootstrap trails, tracked points
by level, map points by their own grey level, and the ground grid.

Port of the JAX package's ``utils/overlay.py`` (the reference's overlays:
level colours, jni/KeyFrame.cc:116-130; Tracker::drawFast,
jni/Tracker.cc:148-155; trails, :322-336; found points, :580-588;
Tracker::RenderGrid, :178-216). Every overlay is one vectorised
rasterisation on the tensors' own device: dots are one scatter over a
[M, d, d] stamp, segments are S samples along all segments at once. Images
come out as f32 RGB [H, W, 3] in [0, 1].
"""

from __future__ import annotations

import torch

from visualslam_android_tpu_torch.ops import camera as cam_ops

# gavLevelColors (jni/KeyFrame.cc:122-127), one RGB row per pyramid level.
LEVEL_COLORS = (
    (1.0, 0.0, 0.0),   # level 0: red
    (1.0, 1.0, 0.0),   # level 1: yellow
    (0.0, 1.0, 0.0),   # level 2: green
    (0.0, 0.0, 0.7),   # level 3: blue
)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _ensure_rgb(img):
    img = torch.as_tensor(img).to(torch.float32)
    if img.ndim == 2:
        img = img[..., None].expand(*img.shape, 3)
    # [0, 255] or [0, 1] inputs.
    return img * torch.where(img.max() > 1.5, 1.0 / 255.0, 1.0)


def draw_dots(img_rgb, xy, colors, mask, radius: int = 2):
    """Filled (2r+1)^2 square dots at xy [M, 2] (x, y) with colours
    [M, 3] (or one [3]); mask [M] leaves a dot out. A pixel under several
    dots takes their mean colour."""
    img = torch.as_tensor(img_rgb).to(torch.float32)
    dev = img.device
    H, W = img.shape[:2]
    xy = _f32(xy, dev)
    M = xy.shape[0]
    colors = _f32(colors, dev).expand(M, 3)
    r = torch.arange(-radius, radius + 1, device=dev)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    cy = torch.round(xy[:, 1]).long()[:, None] + dy.reshape(1, -1)
    cx = torch.round(xy[:, 0]).long()[:, None] + dx.reshape(1, -1)
    ok = (torch.as_tensor(mask, device=dev).to(torch.bool)[:, None]
          & (cy >= 0) & (cy < H) & (cx >= 0) & (cx < W))
    # Masked pixels go to a dead row past the image.
    flat = torch.where(ok, cy * W + cx, H * W).reshape(-1)
    canvas = torch.zeros(H * W + 1, 3, device=dev).index_add_(
        0, flat, colors[:, None, :].expand(M, ok.shape[1], 3).reshape(-1, 3))
    hit = torch.zeros(H * W + 1, device=dev).index_add_(
        0, flat, ok.to(torch.float32).reshape(-1))
    canvas, hit = canvas[:-1].view(H, W, 3), hit[:-1].view(H, W)
    out = canvas / torch.clamp(hit, min=1.0)[..., None]
    return torch.where((hit > 0)[..., None], out, img)


def draw_segments(img_rgb, p0, p1, colors, mask, samples: int = 64,
                  thickness: int = 1):
    """M segments p0 -> p1 ([M, 2] each, x/y): `samples` points along each,
    all at once, stamped (2 thickness - 1) wide."""
    img = torch.as_tensor(img_rgb).to(torch.float32)
    dev = img.device
    p0, p1 = _f32(p0, dev), _f32(p1, dev)
    ts = torch.linspace(0.0, 1.0, samples, device=dev)
    pts = p0[:, None, :] + ts[None, :, None] * (p1 - p0)[:, None, :]
    M = p0.shape[0]
    m = torch.as_tensor(mask, device=dev).to(torch.bool)[:, None]
    return draw_dots(
        img, pts.reshape(-1, 2),
        _f32(colors, dev)[:, None, :].expand(M, samples, 3).reshape(-1, 3),
        m.expand(M, samples).reshape(-1), radius=thickness - 1)


def draw_fast_corners(img_rgb, corners_xy, mask, color=(1.0, 0.0, 1.0)):
    """Tracker::drawFast: level-0 FAST corners [M, 2] (x, y), mask [M]."""
    img = _ensure_rgb(img_rgb)
    return draw_dots(img, corners_xy, _f32(color, img.device), mask,
                     radius=1)


def draw_corner_mask(img_rgb, corner_mask, color=(1.0, 0.0, 1.0)):
    """The same overlay from the tracker's dense [H, W] corner mask."""
    img = _ensure_rgb(img_rgb)
    cm = torch.as_tensor(corner_mask, device=img.device).to(torch.bool)
    return torch.where(cm[..., None], _f32(color, img.device), img)


def draw_trails(img_rgb, from_xy, to_xy, mask):
    """Bootstrap trails: a green segment from each trail's origin to its
    current match, a red dot at the match."""
    img = _ensure_rgb(img_rgb)
    M = from_xy.shape[0]
    green = _f32((0.0, 1.0, 0.0), img.device).expand(M, 3)
    red = _f32((1.0, 0.0, 0.0), img.device).expand(M, 3)
    img = draw_segments(img, from_xy, to_xy, green, mask)
    return draw_dots(img, to_xy, red, mask, radius=1)


def draw_found_points(img_rgb, pos_xy, level, mask):
    """Points found by TrackMap, coloured by search level."""
    img = _ensure_rgb(img_rgb)
    level = torch.as_tensor(level, device=img.device).long().clamp(0, 3)
    colors = _f32(LEVEL_COLORS, img.device)[level]
    return draw_dots(img, pos_xy, colors, mask, radius=2)


def draw_map_points_colored(img_rgb, pos_xy, color_gray, mask,
                            radius: int = 2):
    """Dots in each point's own source grey level (PointStore.color_gray)."""
    img = _ensure_rgb(img_rgb)
    g = torch.clamp(_f32(color_gray, img.device) / 255.0, 0.0, 1.0)
    return draw_dots(img, pos_xy, torch.stack([g, g, g], dim=-1), mask,
                     radius=radius)


def render_grid(img_rgb, cam: cam_ops.Camera, R, t, half_cells: int = 8,
                cell: float = 0.1):
    """Tracker::RenderGrid: the z = 0 plane's (2 half_cells + 1)^2
    lattice through the pose (R, t), both line families in black, 2 px."""
    img = _ensure_rgb(img_rgb)
    dev = img.device
    n = 2 * half_cells + 1
    ij = torch.arange(n, dtype=torch.float32, device=dev) - half_cells
    gx, gy = torch.meshgrid(ij * cell, ij * cell, indexing="ij")
    pw = torch.stack([gx, gy, torch.zeros_like(gx)], dim=-1).reshape(-1, 3)
    pc = pw @ _f32(R, dev).T + _f32(t, dev)
    z = torch.clamp(pc[:, 2], min=0.001)  # clamped as the reference does
    px = cam_ops.project(cam, pc[:, :2] / z[:, None]).reshape(n, n, 2)
    a = torch.cat([px[:, :-1].reshape(-1, 2), px[:-1, :].reshape(-1, 2)])
    b = torch.cat([px[:, 1:].reshape(-1, 2), px[1:, :].reshape(-1, 2)])
    M = a.shape[0]
    return draw_segments(img, a, b, torch.zeros(M, 3, device=dev),
                         torch.ones(M, dtype=torch.bool, device=dev),
                         thickness=2)
