"""Batched patch matching: warp and search level, warped templates, coarse
ZMSSD search over FAST corners, inverse-composition subpixel refinement.

Port of the parts of the JAX package's ``ops/match.py`` that the tracker
runs (the reference's ``PatchFinder``, jni/PatchFinder.{h,cc}):

1. warp matrix + search level from the view change
   (CalcSearchLevelAndWarpMatrix, PatchFinder.cc:31-68);
2. warped 11x11 templates (MakeTemplateCoarseCont :79-125) with their sums
   and inverse-composition Hessians (:153-166, :242-267);
3. coarse ZMSSD search over FAST corners within a radius
   (FindPatchCoarse :170-235; max SSD = 500 * patch_px);
4. subpixel iteration (IterateSubPixToConvergence :272-350);
5. for the bootstrap: unwarped templates (MakeTemplateCoarseNoWarp
   :130-148) and the MiniPatch trail search (jni/MiniPatch.cc).

Every stage runs over all points at once, with per-point search levels
handled by gathers from a flattened pyramid (``image.flatten_levels``).
Where the JAX package cuts tile-aligned G x G regions per point, the coarse
search here reads a direct Wn x Wn window, Wn = 2 * (max_range + half_patch)
+ 1; every candidate within the search radius lies inside it. Argmin scans
row-major and the first minimum wins, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from visualslam_android_tpu_torch.ops import image as img_ops
from visualslam_android_tpu_torch.ops import wls as wls_ops
from visualslam_android_tpu_torch.utils.tensors import TensorTree

N_LEVELS = 4

# Half-extent of the source area a warped template may sample: samples
# farther than TEMPLATE_SLAB_HALF - 1 from the source center mark the
# template bad (the JAX package's slab bound, kept for parity).
TEMPLATE_SLAB_HALF = 16

# Subpixel travel budget in level pixels: points that move farther than
# SUBPIX_TRAVEL - 1 from their coarse match fail (the JAX package's slab
# bound, kept for parity).
SUBPIX_TRAVEL = 6


def calc_search_level_and_warp(pc, motion_right, motion_down, cam_derivs,
                               n_levels=N_LEVELS, det_lo=0.25, det_hi=3.0):
    """Batched CalcSearchLevelAndWarpMatrix (PatchFinder.cc:31-68).

    pc [..., 3]: point in the current camera frame; motion_right/down
    [..., 3]: the point's source-pixel displacement vectors rotated into
    the current camera; cam_derivs [..., 2, 2]: projection derivatives.
    Returns (warp_inv [..., 2, 2], search_level [...], good [...]).
    """
    inv_z = 1.0 / pc[..., 2]

    def in_plane(motion):
        return torch.stack(
            [(motion[..., 0] - pc[..., 0] * motion[..., 2] * inv_z) * inv_z,
             (motion[..., 1] - pc[..., 1] * motion[..., 2] * inv_z) * inv_z],
            dim=-1,
        )

    col_r = (cam_derivs @ in_plane(motion_right)[..., None])[..., 0]
    col_d = (cam_derivs @ in_plane(motion_down)[..., None])[..., 0]
    warp_inv = torch.stack([col_r, col_d], dim=-1)  # columns = right, down
    det = (warp_inv[..., 0, 0] * warp_inv[..., 1, 1]
           - warp_inv[..., 0, 1] * warp_inv[..., 1, 0])
    # Smallest level l with det * 0.25^l <= det_hi (PatchFinder.cc:56-60).
    lv = torch.zeros(det.shape, dtype=torch.int32, device=det.device)
    d = det
    for _ in range(n_levels - 1):
        step = d > det_hi
        lv = lv + step.to(torch.int32)
        d = torch.where(step, d * 0.25, d)
    good = (d <= det_hi) & (d >= det_lo)
    return warp_inv, lv, good


@dataclasses.dataclass(frozen=True)
class Templates(TensorTree):
    """Per-point warped search templates and precomputed statistics."""

    data: torch.Tensor     # [N, P, P] warped template pixels
    t_sum: torch.Tensor    # [N]
    t_sumsq: torch.Tensor  # [N]
    grad_x: torch.Tensor   # [N, P-2, P-2] interior x-gradients (0.5 factor)
    grad_y: torch.Tensor   # [N, P-2, P-2]
    h_inv: torch.Tensor    # [N, 3, 3] inverse-composition (JTJ)^-1
    bad: torch.Tensor      # [N] template touched outside the source image

    def lanes(self, sl):
        """Templates of the lanes selected by `sl` (slice or index)."""
        return Templates(*(getattr(self, f.name)[sl]
                           for f in dataclasses.fields(self)))


def finalize_templates(data, bad) -> Templates:
    """Template sums (MakeTemplateSums, PatchFinder.cc:153-166) and the
    inverse-composition Hessian (MakeSubPixTemplate :242-267)."""
    t_sum = torch.sum(data, dim=(-2, -1))
    t_sumsq = torch.sum(data * data, dim=(-2, -1))
    gx = 0.5 * (data[:, 1:-1, 2:] - data[:, 1:-1, :-2])
    gy = 0.5 * (data[:, 2:, 1:-1] - data[:, :-2, 1:-1])
    J = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    J = J.reshape(data.shape[0], -1, 3)
    H = J.transpose(1, 2) @ J
    eye = torch.eye(3, dtype=data.dtype, device=data.device)
    h_inv = wls_ops.inv3x3(H + 1e-6 * eye)
    return Templates(data, t_sum, t_sumsq, gx, gy, h_inv, bad)


def _warp_m2(warp_inv, search_level):
    """m2 = inv(warp_inv) * 2^search_level: source pixels per template
    pixel (MakeTemplateCoarseCont, PatchFinder.cc:84-90)."""
    det = (warp_inv[:, 0, 0] * warp_inv[:, 1, 1]
           - warp_inv[:, 0, 1] * warp_inv[:, 1, 0])
    safe_det = torch.where(torch.abs(det) < 1e-12, 1.0, det)
    inv = torch.stack(
        [torch.stack([warp_inv[:, 1, 1], -warp_inv[:, 0, 1]], dim=-1),
         torch.stack([-warp_inv[:, 1, 0], warp_inv[:, 0, 0]], dim=-1)],
        dim=-2,
    ) / safe_det[:, None, None]
    return inv * (2.0 ** search_level.to(inv.dtype))[:, None, None]


def make_templates_warped_multilevel(source_pyramids, source_kf,
                                     source_level, source_center, warp_inv,
                                     search_level, half_patch=5) -> Templates:
    """Batched MakeTemplateCoarseCont (PatchFinder.cc:79-125) for points
    whose source patches live in different pyramid levels of different
    keyframes. source_pyramids: tuple over levels of [K, H_l, W_l]
    keyframe stacks; source_center [N, 2] in source-level coords.

    Each template pixel is a 4-tap bilinear read of the source level at
    center + m2 @ offset; the template is bad if any sample leaves the
    source image or the +-TEMPLATE_SLAB_HALF square around the center.
    """
    n = 2 * half_patch + 1
    dtype = source_center.dtype
    m2 = _warp_m2(warp_inv, search_level)
    offs = img_ops.patch_grid(half_patch, source_center.device, dtype)
    src = source_center[:, None, :] + offs @ m2.transpose(1, 2)  # [N, n*n, 2]
    stack = img_ops.flatten_levels(source_pyramids)
    level = source_level.long()[:, None]
    hw = stack[2][level]  # [N, 1, 2] (H, W)
    d = torch.abs(src - source_center[:, None, :])
    valid = (
        (src[..., 0] >= 0) & (src[..., 1] >= 0)
        & (src[..., 0] < hw[..., 1] - 1) & (src[..., 1] < hw[..., 0] - 1)
        & (d[..., 0] <= TEMPLATE_SLAB_HALF - 1)
        & (d[..., 1] <= TEMPLATE_SLAB_HALF - 1)
    )
    vals = img_ops.bilinear_levels(stack, level, source_kf.long()[:, None], src)
    data = torch.where(valid, vals, 0.0).reshape(-1, n, n)
    bad = torch.any(~valid, dim=-1)
    return finalize_templates(data, bad)


def make_templates_nowarp(source_imgs, source_kf, source_center,
                          half_patch=5) -> Templates:
    """Batched MakeTemplateCoarseNoWarp (PatchFinder.cc:130-148): plain
    axis-aligned patch copy at integer source positions. source_imgs
    [K, H, W] keyframe stack of one level; source_kf [N]; source_center
    [N, 2] in that level's coords, rounded. Reads clamp to the image; a
    patch closer than half_patch + 1 to the border is marked bad."""
    H, W = source_imgs.shape[-2:]
    c = torch.round(source_center).long()
    cx, cy = c[:, 0], c[:, 1]
    bad = ~((cx >= half_patch + 1) & (cy >= half_patch + 1)
            & (cx < W - half_patch - 1) & (cy < H - half_patch - 1))
    r = torch.arange(-half_patch, half_patch + 1, device=source_imgs.device)
    xs = torch.clamp(cx[:, None, None] + r[None, None, :], 0, W - 1)
    ys = torch.clamp(cy[:, None, None] + r[None, :, None], 0, H - 1)
    data = source_imgs[source_kf.long()[:, None, None], ys, xs]
    return finalize_templates(data, bad)


@dataclasses.dataclass(frozen=True)
class CoarseResult(TensorTree):
    found: torch.Tensor      # [N] bool
    pos_level: torch.Tensor  # [N, 2] best corner, LEVEL-0 coords
    best_ssd: torch.Tensor   # [N]


def _window_sums(windows, P):
    """Sum over every P x P window of windows [N, S, S] -> [N, S-P+1, ...]."""
    ones = torch.ones(1, 1, P, P, dtype=windows.dtype, device=windows.device)
    return F.conv2d(windows[:, None], ones)[:, 0]


def _kf_index(kf_idx, n_dims):
    """A per-point keyframe index broadcast against [N, ...] index tensors
    of n_dims dimensions (0 for a single frame)."""
    if kf_idx is None:
        return 0
    return kf_idx.long().reshape((-1,) + (1,) * (n_dims - 1))


def find_patch_coarse_multilevel(pyramid, corner_masks, templates: Templates,
                                 pred_zero, search_level, radius_zero, active,
                                 max_range: int, half_patch: int = 5,
                                 max_ssd_per_px: int = 500,
                                 kf_idx=None) -> CoarseResult:
    """FindPatchCoarse (PatchFinder.cc:170-235) over all search levels in
    one pass. pred_zero [N, 2] level-0 predictions; radius_zero [N] level-0
    radius (<= max_range), scaled to the search level with ceil as the
    reference's integer level ranges (Tracker.cc:635-641). Candidates are
    FAST corners within the radius that support a full patch inside the
    image. Returns found and the matched position in level-0 coords.

    With kf_idx [N], the pyramid and corner masks are keyframe stacks
    [K, H_l, W_l] and each point searches its own keyframe (the
    (point, keyframe)-pair form re-find runs on).
    """
    N = templates.data.shape[0]
    P = 2 * half_patch + 1
    n_pix = P * P
    dtype, device = pred_zero.dtype, pred_zero.device
    win_half = max_range + half_patch
    Wn = 2 * win_half + 1
    n_off = Wn - P + 1

    level = search_level.long()
    scale = 2.0 ** search_level.to(dtype)
    pred_level = (pred_zero + 0.5) / scale[:, None] - 0.5  # LevelNPos
    origin = torch.round(pred_level).long() - win_half  # [N, 2]
    r = torch.arange(Wn, device=device)
    xs = origin[:, 0, None, None] + r[None, None, :]
    ys = origin[:, 1, None, None] + r[None, :, None]
    lv = level[:, None, None]
    img_stack = img_ops.flatten_levels(pyramid)
    mask_stack = img_ops.flatten_levels(
        tuple(m.to(dtype) for m in corner_masks)
    )
    kf = _kf_index(kf_idx, 3)
    windows = img_ops.gather_levels(img_stack, lv, kf, xs, ys)  # [N, Wn, Wn]
    mask_windows = img_ops.gather_levels(mask_stack, lv, kf, xs, ys)

    sum_i = _window_sums(windows, P)
    sumsq_i = _window_sums(windows * windows, P)
    cross = F.conv2d(windows[None], templates.data[:, None], groups=N)[0]
    ssd = (sumsq_i + templates.t_sumsq[:, None, None] - 2.0 * cross
           - (templates.t_sum[:, None, None] - sum_i) ** 2 / n_pix)

    hw = img_stack[2][level]  # [N, 2] (H, W)
    o = torch.arange(n_off, device=device)
    cx = origin[:, 0, None, None] + o[None, None, :] + half_patch
    cy = origin[:, 1, None, None] + o[None, :, None] + half_patch
    is_corner = mask_windows[:, half_patch:half_patch + n_off,
                             half_patch:half_patch + n_off] > 0.5
    dx = cx.to(dtype) - pred_level[:, 0, None, None]
    dy = cy.to(dtype) - pred_level[:, 1, None, None]
    radius_level = torch.ceil(radius_zero / scale)
    in_radius = dx * dx + dy * dy <= (radius_level ** 2)[:, None, None]
    in_img = (
        (cx >= half_patch) & (cy >= half_patch)
        & (cx < hw[:, 1, None, None] - half_patch)
        & (cy < hw[:, 0, None, None] - half_patch)
    )
    valid = (is_corner & in_radius & in_img
             & (active & ~templates.bad)[:, None, None])

    ssd_m = torch.where(valid, ssd, torch.inf).reshape(N, -1)
    best_ssd, best = torch.min(ssd_m, dim=-1)
    bx = origin[:, 0] + best % n_off + half_patch
    by = origin[:, 1] + best // n_off + half_patch
    pos_level = torch.stack([bx, by], dim=-1).to(dtype)
    pos_zero = (pos_level + 0.5) * scale[:, None] - 0.5  # LevelZeroPos
    return CoarseResult(
        found=(best_ssd < max_ssd_per_px * n_pix) & active,
        pos_level=pos_zero,
        best_ssd=best_ssd,
    )


@dataclasses.dataclass(frozen=True)
class SubpixResult(TensorTree):
    converged: torch.Tensor  # [N] bool
    pos_zero: torch.Tensor   # [N, 2] refined position, LEVEL-0 coords


def _subpix_loop(stack, lv, hw, scale, templates: Templates, pos_zero,
                 active, max_iters, half_patch, conv_limit,
                 kf=0) -> SubpixResult:
    """The inverse-composition iterations shared by iterate_subpix and
    iterate_subpix_multilevel. stack: image.flatten_levels output; lv
    [N, 1] each point's level in it; hw [N, 2] that level's (H, W);
    scale [N, 1] level-0 pixels per pixel of the point's level; kf 0 or
    [N, 1] each point's keyframe in a stack."""
    N = pos_zero.shape[0]
    dtype, device = pos_zero.dtype, pos_zero.device
    center0 = (pos_zero + 0.5) / scale - 0.5

    inner = img_ops.patch_grid(half_patch - 1, device, dtype)
    gx = templates.grad_x.reshape(N, -1)
    gy = templates.grad_y.reshape(N, -1)
    tmpl_inner = templates.data[:, 1:-1, 1:-1].reshape(N, -1)

    pos = pos_zero
    mean_diff = torch.zeros(N, dtype=dtype, device=device)
    converged = torch.zeros(N, dtype=torch.bool, device=device)
    failed = torch.zeros(N, dtype=torch.bool, device=device)
    for _ in range(max_iters):
        center_l = (pos + 0.5) / scale - 0.5
        ci = torch.round(center_l)
        travel = torch.abs(center_l - center0)
        # Off-edge check with border half_patch+1 (PatchFinder.cc:299-303)
        # against the point's own level, plus the travel bound.
        off_edge = ~(
            (ci[:, 0] >= half_patch + 1) & (ci[:, 1] >= half_patch + 1)
            & (ci[:, 0] < hw[:, 1] - half_patch - 1)
            & (ci[:, 1] < hw[:, 0] - half_patch - 1)
            & (travel[:, 0] <= SUBPIX_TRAVEL - 1)
            & (travel[:, 1] <= SUBPIX_TRAVEL - 1)
        )
        failed = failed | (off_edge & ~converged & active)

        target = img_ops.bilinear_levels(
            stack, lv, kf, center_l[:, None, :] + inner[None]
        )
        diff = target - tmpl_inner + mean_diff[:, None]
        acc = torch.stack([torch.sum(diff * gx, dim=-1),
                           torch.sum(diff * gy, dim=-1),
                           torch.sum(diff, dim=-1)], dim=-1)
        update = (templates.h_inv @ acc[..., None])[..., 0]
        live = active & ~converged & ~failed
        pos = pos - torch.where(live[:, None], update[:, :2] * scale, 0.0)
        mean_diff = torch.where(live, mean_diff - update[:, 2], mean_diff)
        upd_sq = torch.sum(update[:, :2] ** 2, dim=-1)
        converged = converged | (live & (upd_sq < conv_limit * conv_limit))
    return SubpixResult(converged=converged & ~failed, pos_zero=pos)


def iterate_subpix_multilevel(pyramid, templates: Templates, pos_zero,
                              search_level, active, max_iters: int = 10,
                              half_patch: int = 5, conv_limit: float = 0.03,
                              kf_idx=None) -> SubpixResult:
    """IterateSubPixToConvergence (PatchFinder.cc:272-350) over all search
    levels in one pass: a fixed number of inverse-composition iterations
    with per-point converged / failed masks. Updates are scaled back by
    the level scale as in the reference (:339). With kf_idx [N], the
    pyramid levels are keyframe stacks [K, H_l, W_l] and each point refines
    in its own keyframe."""
    level = search_level.long()
    scale = (2.0 ** search_level.to(pos_zero.dtype))[:, None]
    stack = img_ops.flatten_levels(pyramid)
    return _subpix_loop(stack, level[:, None], stack[2][level], scale,
                        templates, pos_zero, active, max_iters, half_patch,
                        conv_limit, kf=_kf_index(kf_idx, 2))


def iterate_subpix(img, templates: Templates, pos_zero, search_level, active,
                   max_iters: int = 10, half_patch: int = 5,
                   conv_limit: float = 0.03) -> SubpixResult:
    """IterateSubPixToConvergence on ONE pyramid level image `img`;
    search_level [N] only sets the scale between pos_zero (level-0
    coords) and `img`'s pixels."""
    N = pos_zero.shape[0]
    scale = (2.0 ** search_level.to(pos_zero.dtype))[:, None]
    stack = img_ops.flatten_levels((img,))
    lv = torch.zeros(N, 1, dtype=torch.long, device=pos_zero.device)
    return _subpix_loop(stack, lv, stack[2][lv[:, 0]], scale, templates,
                        pos_zero, active, max_iters, half_patch, conv_limit)


# ---------------------------------------------------------------------------
# MiniPatch: unwarped 9x9 SSD tracker for the bootstrap trails
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MiniPatchResult(TensorTree):
    found: torch.Tensor  # [N] bool
    pos: torch.Tensor    # [N, 2] best corner; meaningful where found


def find_minipatch(img, corner_mask, patches, pos, active,
                   search_range: int = 10, half_patch: int = 4,
                   max_ssd: int = 100000) -> MiniPatchResult:
    """Batched MiniPatch::FindPatch (jni/MiniPatch.cc:32-70): plain SSD of
    patches [N, P, P] over the FAST corners in a SQUARE box of radius
    search_range around pos [N, 2] (level-0 coords) whose patch lies inside
    the image. max_ssd defaults to the tracker's trail override
    (jni/Tracker.cc:226-227).

    Each trail reads a direct window of side 2 * (search_range +
    half_patch) + 1 around round(pos) and takes the squared difference at
    every offset (an unfold and a subtraction: no convolution, so nothing
    can run in TF32). Candidates scan row-major in image coordinates and
    the first minimum wins, as in the JAX package; where nothing is found,
    `pos` is the window's first candidate and means nothing."""
    N = patches.shape[0]
    P = 2 * half_patch + 1
    H, W = img.shape
    dtype, device = img.dtype, img.device
    win_half = search_range + half_patch
    Wn = 2 * win_half + 1
    n_off = Wn - P + 1

    origin = torch.round(pos).long() - win_half  # [N, 2]
    r = torch.arange(Wn, device=device)
    xs = origin[:, 0, None, None] + r[None, None, :]
    ys = origin[:, 1, None, None] + r[None, :, None]
    inside = (xs >= 0) & (ys >= 0) & (xs < W) & (ys < H)
    xc, yc = torch.clamp(xs, 0, W - 1), torch.clamp(ys, 0, H - 1)
    windows = torch.where(inside, img[yc, xc], 0.0)  # [N, Wn, Wn]

    cols = F.unfold(windows[:, None], P)  # [N, P*P, n_off*n_off]
    d = cols - patches.reshape(N, P * P, 1)
    ssd = torch.sum(d * d, dim=1)  # [N, n_off*n_off]

    o = torch.arange(n_off, device=device)
    cx = origin[:, 0, None, None] + o[None, None, :] + half_patch
    cy = origin[:, 1, None, None] + o[None, :, None] + half_patch
    in_img = ((cx >= half_patch) & (cy >= half_patch)
              & (cx < W - half_patch) & (cy < H - half_patch))
    is_corner = corner_mask[torch.clamp(cy, 0, H - 1),
                            torch.clamp(cx, 0, W - 1)]
    dx = torch.abs(cx.to(dtype) - pos[:, 0, None, None])
    dy = torch.abs(cy.to(dtype) - pos[:, 1, None, None])
    in_box = torch.maximum(dx, dy) <= search_range  # square, not circle
    valid = is_corner & in_box & in_img & active[:, None, None]

    ssd_m = torch.where(valid.reshape(N, -1), ssd, torch.inf)
    best_ssd, best = torch.min(ssd_m, dim=-1)
    bx = origin[:, 0] + best % n_off + half_patch
    by = origin[:, 1] + best // n_off + half_patch
    return MiniPatchResult(found=best_ssd < max_ssd,
                           pos=torch.stack([bx, by], dim=-1).to(dtype))


def sample_minipatches(img, pos, half_patch=4):
    """Batched MiniPatch::SampleFromImage (jni/MiniPatch.cc:73-83):
    integer-centered patches [N, P, P] at pos [N, 2]."""
    return img_ops.extract_patch(img, pos, half_patch)
