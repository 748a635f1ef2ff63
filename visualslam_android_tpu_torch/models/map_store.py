"""Fixed-shape struct-of-tensors map storage.

Port of the JAX package's ``models/map_store.py`` (the reference's
``Map`` / ``MapPoint`` / ``KeyFrame`` data model, jni/Map.h,
jni/MapPoint.h:22-69, jni/KeyFrame.h:74-97). Points and keyframes live in
padded slots with validity masks; measurements are a point-major
[N, O_max] table. Each store is a dataclass of tensors with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.utils.tensors import (
    TensorTree,
    default_device,
)

# Measurement sources (KeyFrame.h:60 enum).
SRC_TRACKER = 0
SRC_REFIND = 1
SRC_ROOT = 2
SRC_TRAIL = 3
SRC_EPIPOLAR = 4

_dc = dataclasses.dataclass(frozen=True)


@_dc
class FrameData(TensorTree):
    """Per-frame front-end products (MakeKeyFrame_Lite,
    jni/KeyFrame.cc:5-51): pyramid + dense FAST corner masks/scores."""

    pyramid: Tuple[torch.Tensor, ...]       # [H_l, W_l] f32, level 0..3
    corner_mask: Tuple[torch.Tensor, ...]   # [H_l, W_l] bool
    corner_score: Tuple[torch.Tensor, ...]  # [H_l, W_l] f32


@_dc
class FrameExtras(TensorTree):
    """MakeKeyFrame_Rest products (jni/KeyFrame.cc:53-101)."""

    nonmax_mask: Tuple[torch.Tensor, ...]  # [H_l, W_l] bool
    cand_xy: Tuple[torch.Tensor, ...]      # [C_l, 2] int32 level coords
    cand_valid: Tuple[torch.Tensor, ...]   # [C_l] bool
    cand_score: Tuple[torch.Tensor, ...]   # [C_l] f32 Shi-Tomasi scores
    sbi_template: torch.Tensor             # [h_sbi, w_sbi]
    sbi_jacs: torch.Tensor                 # [h_sbi, w_sbi, 2]


@_dc
class KeyFrameStore(TensorTree):
    """K padded keyframe slots."""

    valid: torch.Tensor        # [K] bool
    fixed: torch.Tensor        # [K] bool
    R: torch.Tensor            # [K, 3, 3] camera-from-world rotation
    t: torch.Tensor            # [K, 3]
    pyramid: Tuple[torch.Tensor, ...]      # [K, H_l, W_l]
    corner_mask: Tuple[torch.Tensor, ...]  # [K, H_l, W_l] bool
    cand_xy: Tuple[torch.Tensor, ...]      # [K, C_l, 2] int32
    cand_valid: Tuple[torch.Tensor, ...]   # [K, C_l] bool
    depth_mean: torch.Tensor   # [K]
    depth_sigma: torch.Tensor  # [K]
    sbi_template: torch.Tensor  # [K, h_sbi, w_sbi]
    sbi_jacs: torch.Tensor      # [K, h_sbi, w_sbi, 2]

    @property
    def n_slots(self):
        return self.valid.shape[0]

    def count(self):
        return torch.sum(self.valid.to(torch.int32))


@_dc
class PointStore(TensorTree):
    """N padded map-point slots (MapPoint.h:22-69)."""

    valid: torch.Tensor          # [N] slot in use
    bad: torch.Tensor            # [N] flagged bad
    pos_w: torch.Tensor          # [N, 3]
    source_kf: torch.Tensor      # [N] int32
    source_level: torch.Tensor   # [N] int32
    center: torch.Tensor         # [N, 2] source-level coords
    center_nc: torch.Tensor      # [N, 3] unit ray to patch center
    right_nc: torch.Tensor       # [N, 3] unit ray one pixel right
    down_nc: torch.Tensor        # [N, 3] unit ray one pixel down
    normal_nc: torch.Tensor      # [N, 3] patch plane normal
    pixel_right_w: torch.Tensor  # [N, 3] world-frame one-pixel-right
    pixel_down_w: torch.Tensor   # [N, 3] world-frame one-pixel-down
    inlier_count: torch.Tensor   # [N] int32
    outlier_count: torch.Tensor  # [N] int32
    color_gray: torch.Tensor     # [N] f32 0..255

    @property
    def n_slots(self):
        return self.valid.shape[0]

    def live(self):
        return self.valid & ~self.bad

    def count(self):
        return torch.sum(self.live().to(torch.int32))


@_dc
class MeasStore(TensorTree):
    """Point-major measurement table: up to O observations per point."""

    kf: torch.Tensor      # [N, O] int32 observing keyframe slot
    uv: torch.Tensor      # [N, O, 2] level-0 pixel position
    level: torch.Tensor   # [N, O] int32 pyramid level
    source: torch.Tensor  # [N, O] int32 SRC_* enum
    subpix: torch.Tensor  # [N, O] bool
    valid: torch.Tensor   # [N, O] bool

    def count(self):
        return torch.sum(self.valid.to(torch.int32))


@_dc
class SLAMMap(TensorTree):
    """The whole map (jni/Map.h:29-31) plus its measurement table."""

    points: PointStore
    keyframes: KeyFrameStore
    meas: MeasStore
    good: torch.Tensor  # [] bool


def empty_map(config: SLAMConfig, device=None,
              dtype=torch.float32) -> SLAMMap:
    """An empty map on `device` (the CUDA card when None)."""
    device = default_device(device)
    tc, mc = config.tracker, config.mapmaker
    N = tc.max_map_points
    K = mc.max_keyframes
    O = config.bundle.max_obs_per_point
    shapes = tc.pyramid_shapes
    sbi_h, sbi_w = shapes[-1][0] // 2, shapes[-1][1] // 2
    i32, b = torch.int32, torch.bool

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    points = PointStore(
        valid=z(N, dt=b), bad=z(N, dt=b), pos_w=z(N, 3),
        source_kf=z(N, dt=i32), source_level=z(N, dt=i32),
        center=z(N, 2), center_nc=z(N, 3), right_nc=z(N, 3),
        down_nc=z(N, 3), normal_nc=z(N, 3),
        pixel_right_w=z(N, 3), pixel_down_w=z(N, 3),
        inlier_count=z(N, dt=i32), outlier_count=z(N, dt=i32),
        color_gray=z(N),
    )
    keyframes = KeyFrameStore(
        valid=z(K, dt=b), fixed=z(K, dt=b),
        R=torch.eye(3, dtype=dtype, device=device).expand(K, 3, 3).clone(),
        t=z(K, 3),
        pyramid=tuple(z(K, h, w) for h, w in shapes),
        corner_mask=tuple(z(K, h, w, dt=b) for h, w in shapes),
        cand_xy=tuple(z(K, c, 2, dt=i32) for c in tc.max_corners_per_level),
        cand_valid=tuple(z(K, c, dt=b) for c in tc.max_corners_per_level),
        depth_mean=torch.ones(K, dtype=dtype, device=device),
        depth_sigma=torch.ones(K, dtype=dtype, device=device),
        sbi_template=z(K, sbi_h, sbi_w),
        sbi_jacs=z(K, sbi_h, sbi_w, 2),
    )
    meas = MeasStore(
        kf=z(N, O, dt=i32), uv=z(N, O, 2), level=z(N, O, dt=i32),
        source=z(N, O, dt=i32), subpix=z(N, O, dt=b), valid=z(N, O, dt=b),
    )
    return SLAMMap(points=points, keyframes=keyframes, meas=meas,
                   good=torch.zeros((), dtype=b, device=device))


def refresh_pixel_vectors(points: PointStore,
                          kfs: KeyFrameStore) -> PointStore:
    """Batched MapPoint::RefreshPixelVectors (jni/MapPoint.cc:4-29): world
    displacement vectors for one source pixel right/down, induced by the
    patch plane (normal facing the source camera)."""
    src = points.source_kf.long()
    R = kfs.R[src]  # [N, 3, 3]
    t = kfs.t[src]
    plane_c = (R @ points.pos_w[..., None])[..., 0] + t
    cam_height = torch.abs(torch.sum(plane_c * points.normal_nc, dim=-1))

    def on_plane(ray):
        rate = torch.abs(torch.sum(ray * points.normal_nc, dim=-1))
        rate = torch.clamp(rate, min=1e-10)
        return ray * (cam_height / rate)[:, None]

    center_p = on_plane(points.center_nc)
    Rt = R.transpose(-1, -2)
    right_w = (Rt @ (on_plane(points.right_nc) - center_p)[..., None])[..., 0]
    down_w = (Rt @ (on_plane(points.down_nc) - center_p)[..., None])[..., 0]
    return points.replace(pixel_right_w=right_w, pixel_down_w=down_w)


def first_free_slot(valid):
    """Index of the first unused slot (or 0 for an all-True array: callers
    check capacity with `valid.all()`)."""
    return torch.argmin(valid.to(torch.int32))


def add_measurement(meas: MeasStore, point_idx, kf_idx, uv, level, source,
                    subpix) -> MeasStore:
    """A copy of `meas` with one measurement in the first free
    observation slot of `point_idx` (unchanged if the point's O slots are
    full)."""
    row_valid = meas.valid[point_idx]
    slot = first_free_slot(row_valid)
    ok = ~torch.all(row_valid)

    def upd(arr, val):
        val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
        out = arr.clone()
        out[point_idx, slot] = torch.where(ok, val, arr[point_idx, slot])
        return out

    return MeasStore(
        kf=upd(meas.kf, kf_idx), uv=upd(meas.uv, uv),
        level=upd(meas.level, level), source=upd(meas.source, source),
        subpix=upd(meas.subpix, subpix), valid=upd(meas.valid, ok),
    )


def meas_kf_mask(meas: MeasStore, kf_idx):
    """[N, O] mask of measurements belonging to keyframe kf_idx."""
    return meas.valid & (meas.kf == kf_idx)


def point_observed_in(meas: MeasStore, kf_idx):
    """[N] mask of points with a valid measurement in keyframe kf_idx."""
    return torch.any(meas_kf_mask(meas, kf_idx), dim=-1)
