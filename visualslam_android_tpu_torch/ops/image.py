"""Dense image ops: pyramid, bilinear sampling, Shi-Tomasi scoring,
Gaussian blur, integer-centered patches, and per-point gathers from
pyramid levels.

Port of the JAX package's ``ops/image.py`` (the reference's
jni/vision/ImageHandler.cpp and the pyramid of jni/KeyFrame.cc:20-23).
Images are f32 tensors in [0, 255]; points are (x, y) = (column, row);
tensors index as img[y, x].

The JAX package reads per-point windows through tile-row gathers
(``extract_regions``) and bilinear samples as matmuls
(``separable_bilinear``), both workarounds for the TPU's slow gathers. The
port gathers directly: ``flatten_levels`` packs a pyramid (optionally
stacked over keyframes) into one flat buffer, and ``gather_levels`` /
``bilinear_levels`` read any (level, keyframe, x, y) from it, with 0 for
reads outside the image (the zero padding the JAX regions have).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from visualslam_android_tpu_torch.utils.tensors import default_device


def half_sample(img):
    """2x2 block mean (the reference's half-size resize,
    jni/KeyFrame.cc:20-23)."""
    H, W = img.shape[-2:]
    x = img[..., : H - H % 2, : W - W % 2]
    x = x.reshape(*x.shape[:-2], H // 2, 2, W // 2, 2)
    return x.mean(dim=(-3, -1))


def make_pyramid(img, n_levels=4):
    """List of n_levels images, level 0 = input (KeyFrame.cc:18-23)."""
    levels = [img]
    for _ in range(n_levels - 1):
        levels.append(half_sample(levels[-1]))
    return levels


def bilinear_sample(img, xy):
    """Bilinear sample at xy[..., 2] float positions (ImageHandler.cpp:3-19:
    floor + fractional blend). Out-of-range coordinates are clamped;
    callers mask validity separately."""
    H, W = img.shape[-2:]
    x, y = xy[..., 0], xy[..., 1]
    lx = torch.clamp(torch.floor(x).long(), 0, W - 2)
    ly = torch.clamp(torch.floor(y).long(), 0, H - 2)
    fx = torch.clamp(x - lx, 0.0, 1.0)
    fy = torch.clamp(y - ly, 0.0, 1.0)
    i00 = img[..., ly, lx]
    i01 = img[..., ly, lx + 1]
    i10 = img[..., ly + 1, lx]
    i11 = img[..., ly + 1, lx + 1]
    top = (1 - fx) * i00 + fx * i01
    bot = (1 - fx) * i10 + fx * i11
    return (1 - fy) * top + fy * bot


def in_image_with_border(shape_hw, xy, border):
    """(x, y) strictly inside [border, W-border) x [border, H-border)
    (ImageHandler.cpp:120-122)."""
    H, W = shape_hw
    x, y = xy[..., 0], xy[..., 1]
    return (x >= border) & (y >= border) & (x < W - border) & (y < H - border)


def affine_warp_patch(img, M, in_center, out_half_size, default=0.0):
    """A warped square patch: out(i, j) = img(in_center + M @ d) with
    d = (j, i) - out_center, the reference's ``transform_image``
    (ImageHandler.cpp:21-113) for centered square patches (its only use,
    PatchFinder.cc:79-125). Batched over leading axes of M [..., 2, 2] and
    in_center [..., 2]. Returns (patch [..., n, n], n_outside [...]), the
    reference's out-of-image count; outside reads take `default`."""
    n = 2 * out_half_size + 1
    offs = patch_grid(out_half_size, img.device, M.dtype)  # [n*n, 2]
    src = in_center[..., None, :] + offs @ M.transpose(-1, -2)
    H, W = img.shape[-2:]
    valid = ((src[..., 0] >= 0) & (src[..., 1] >= 0)
             & (src[..., 0] < W - 1) & (src[..., 1] < H - 1))
    vals = torch.where(valid, bilinear_sample(img, src), default)
    return (vals.reshape(*vals.shape[:-1], n, n),
            torch.sum(~valid, dim=-1))


def patch_grid(half_size, device=None, dtype=torch.float32):
    """[(2h+1)^2, 2] grid of (x, y) offsets centered on 0, row-major, on
    `device` (the CUDA card when None)."""
    device = default_device(device)
    r = torch.arange(-half_size, half_size + 1, device=device)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(dtype)


def _box_sum(x, half):
    """Sliding-window sum over a (2*half+1)^2 box, zero-padded."""
    k = 2 * half + 1
    ones = torch.ones(1, 1, k, k, dtype=x.dtype, device=x.device)
    return F.conv2d(x[None, None], ones, padding=half)[0, 0]


def shi_tomasi_dense(img, half_box=3):
    """Dense Shi-Tomasi (min eigenvalue) score map
    (FindShiTomasiScoreAtPoint, ImageHandler.cpp:124-155): central
    differences without the 1/2 factor, box sums over (2*half_box+1)^2,
    normalized by 2 * n_pixels. Border values are approximate; callers
    mask with a border >= half_box + 1."""
    dx = torch.zeros_like(img)
    dx[:, 1:-1] = img[:, 2:] - img[:, :-2]
    dy = torch.zeros_like(img)
    dy[1:-1, :] = img[2:, :] - img[:-2, :]
    n2 = 2.0 * (2 * half_box + 1) ** 2
    xx = _box_sum(dx * dx, half_box) / n2
    yy = _box_sum(dy * dy, half_box) / n2
    xy = _box_sum(dx * dy, half_box) / n2
    tr = xx + yy
    det = xx * yy - xy * xy
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    return 0.5 * (tr - disc)


def blur_kernel(sigma: float, radius: int, like):
    x = torch.arange(-radius, radius + 1, dtype=like.dtype, device=like.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def separable_blur(img, k):
    """Separable blur of img[H, W] with the 1-D kernel k, edge-replicate
    padding (OpenCV's default border), x then y."""
    radius = (k.shape[0] - 1) // 2

    def conv1d(im):
        imp = F.pad(im[None], (radius, radius), mode="replicate")[0]
        out = torch.zeros_like(im)
        for i in range(2 * radius + 1):
            out = out + k[i] * imp[:, i:i + im.shape[1]]
        return out

    return conv1d(conv1d(img).T).T


def gaussian_blur(img, sigma: float, truncate: float = 3.0):
    """Separable Gaussian blur (the SmallBlurryImage's,
    jni/SmallBlurryImage.cc:20-55), edge-replicate padding."""
    if sigma <= 0:
        return img
    radius = max(1, int(truncate * sigma + 0.5))
    return separable_blur(img, blur_kernel(sigma, radius, img))


def extract_window(img, center_xy, half_size):
    """Axis-aligned integer-centered windows as one direct gather, with
    their top-left corners: (windows [..., n, n], top_left [..., 2]),
    n = 2 * half_size + 1, for centers center_xy [..., 2] (truncated to
    integers). The window origin is clamped into the image, so a center
    closer than half_size to the border reads a shifted window (callers
    mask)."""
    n = 2 * half_size + 1
    H, W = img.shape[-2:]
    c = center_xy.long()
    x0 = torch.clamp(c[..., 0] - half_size, 0, W - n)
    y0 = torch.clamp(c[..., 1] - half_size, 0, H - n)
    r = torch.arange(n, device=img.device)
    win = img[(y0[..., None, None] + r[:, None]),
              (x0[..., None, None] + r[None, :])]
    return win, torch.stack([x0, y0], dim=-1)


def extract_patch(img, center_xy, half_size):
    """extract_window without the corners: [..., n, n]."""
    return extract_window(img, center_xy, half_size)[0]


# ---------------------------------------------------------------------------
# Per-point gathers from a flattened pyramid
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _level_meta(shapes, device):
    """(offsets [L], hw [L, 2]) for levels of the given shapes. Cached, so
    the per-frame path makes no host-to-device copy (which would wait for
    the stream)."""
    offsets, total = [], 0
    for shape in shapes:
        offsets.append(total)
        total += math.prod(shape)
    hw = [shape[-2:] for shape in shapes]
    return (torch.tensor(offsets, device=device),
            torch.tensor(hw, device=device))


def flatten_levels(levels):
    """Pack pyramid levels ([H_l, W_l] or keyframe stacks [K, H_l, W_l])
    into (flat [sum], offsets [L], hw [L, 2]) for gather_levels."""
    shapes = tuple(tuple(lv.shape) for lv in levels)
    offsets, hw = _level_meta(shapes, levels[0].device)
    flat = torch.cat([lv.reshape(-1) for lv in levels])
    return flat, offsets, hw


def gather_levels(stack, level, kf, x, y):
    """Read stack (from flatten_levels) at integer (x, y) of `level` in
    keyframe `kf` (0 for a single frame); all index tensors broadcast.
    Reads outside the image return 0."""
    flat, offsets, hw = stack
    H, W = hw[level, 0], hw[level, 1]
    inside = (x >= 0) & (y >= 0) & (x < W) & (y < H)
    idx = offsets[level] + (kf * H + y) * W + x
    vals = flat[torch.where(inside, idx, 0)]
    return torch.where(inside, vals, 0.0)


def bilinear_levels(stack, level, kf, xy):
    """4-tap bilinear read of stack at float xy[..., 2]; taps outside the
    image read 0. Blends columns first, then across, the order in which
    the JAX package's separable form (w_y^T . slab . w_x) sums."""
    x, y = xy[..., 0], xy[..., 1]
    fx0, fy0 = torch.floor(x), torch.floor(y)
    fx, fy = x - fx0, y - fy0
    lx, ly = fx0.long(), fy0.long()
    i00 = gather_levels(stack, level, kf, lx, ly)
    i01 = gather_levels(stack, level, kf, lx + 1, ly)
    i10 = gather_levels(stack, level, kf, lx, ly + 1)
    i11 = gather_levels(stack, level, kf, lx + 1, ly + 1)
    left = (1 - fy) * i00 + fy * i10
    right = (1 - fy) * i01 + fy * i11
    return left * (1 - fx) + right * fx
