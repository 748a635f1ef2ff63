"""Map construction and maintenance: what the tracking step and the
stereo bootstrap run.

Port of parts of the JAX package's ``models/mapmaker.py`` (the reference's
jni/MapMaker.cc): keyframe distances and the keyframe-need tests
(:705-773, :1098-1101), HandleBadPoints (:140-164), batched measurement
insertion, packing of new points into free slots, the global map
transforms (:440-467) and CalcPlaneAligner (:1104-1231). Epipolar search,
re-find and the bundle-adjustment glue are not ported yet.

Functions here return new stores and leave their inputs as they were,
except where a docstring says IN PLACE.
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models import keyframe as kf_mod
from visualslam_android_tpu_torch.models import map_store
from visualslam_android_tpu_torch.models.map_store import (
    SRC_EPIPOLAR,
    SRC_ROOT,
    SLAMMap,
)
from visualslam_android_tpu_torch.ops import image as img_ops
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.ops.levels import level_scale
from visualslam_android_tpu_torch.utils.tensors import TensorTree, const


def keyframe_distances(kfs, R, t):
    """Linear distance from pose (R, t) to every keyframe's camera center
    (KeyFrameLinearDist, MapMaker.cc:705-710). Invalid slots -> +inf."""
    c = -(kfs.R.transpose(-1, -2) @ kfs.t[..., None])[..., 0]
    c0 = -(R.T @ t)
    d = torch.linalg.vector_norm(c - c0[None], dim=-1)
    return torch.where(kfs.valid, d, torch.inf)


def closest_keyframe(kfs, R, t):
    """(index, distance) of the nearest valid keyframe."""
    d = keyframe_distances(kfs, R, t)
    dmin, idx = torch.min(d, dim=0)
    return idx, dmin


def need_new_keyframe(kfs, R, t, scene_depth_mean, wiggle_depth_norm,
                      max_kf_dist_mult=0.2):
    """NeedNewKeyFrame (MapMaker.cc:763-773; the port's mult is 0.2)."""
    _, d = closest_keyframe(kfs, R, t)
    d = d / torch.clamp(scene_depth_mean, min=1e-6)
    return d > max_kf_dist_mult * wiggle_depth_norm


def dist_to_nearest_excessive(kfs, R, t, wiggle_scale, factor=10.0):
    """IsDistanceToNearestKeyFrameExcessive (MapMaker.cc:1098-1101)."""
    _, d = closest_keyframe(kfs, R, t)
    return d > wiggle_scale * factor


def handle_bad_points(slam_map: SLAMMap, config: SLAMConfig):
    """HandleBadPoints (MapMaker.cc:140-164): a point with more than
    max_outliers outliers and more outliers than inliers goes bad; bad
    points lose their measurements and their slot. Returns
    (new map, newly_bad [N]); the input map is not modified."""
    pts, meas = slam_map.points, slam_map.meas
    newly_bad = (
        pts.valid
        & (pts.outlier_count > config.mapmaker.max_outliers)
        & (pts.outlier_count > pts.inlier_count)
    )
    bad = pts.bad | newly_bad
    meas = meas.replace(valid=meas.valid & ~bad[:, None])
    pts = pts.replace(bad=torch.zeros_like(bad), valid=pts.valid & ~bad)
    return slam_map.replace(points=pts, meas=meas), newly_bad


# ---------------------------------------------------------------------------
# Batched measurement insertion
# ---------------------------------------------------------------------------

# Eviction value order for full measurement rows (higher = keep longer),
# index = SRC_* enum. SRC_ROOT is never evicted (losing it kills the
# point's template source, MapMaker.cc:932-937); re-findable SRC_REFIND
# goes first. The reference's per-keyframe std::map never drops
# observations (jni/KeyFrame.h:86): this is its fixed-capacity analog.
_EVICT_VALUE = (1, 0, 9, 3, 2)


def add_measurements_batch(meas, point_mask, kf_idx, uv, level, source: int,
                           subpix: bool):
    """Insert one measurement per selected point into that point's first
    free observation slot. kf_idx and level are ints or [N] tensors; uv
    [N, 2].

    When a point's row is full, the lowest-value oldest slot is evicted
    (value order _EVICT_VALUE; slots fill in order, so the first minimum
    is the oldest), unless the incoming measurement's value is lower than
    everything present: then the incoming one is dropped. SRC_ROOT slots
    are never evicted. Returns a new MeasStore."""
    N, O = meas.valid.shape
    device = meas.valid.device
    free_slot = torch.argmin(meas.valid.to(torch.int32), dim=1)  # [N]
    full = torch.all(meas.valid, dim=1)

    value_lut = const(_EVICT_VALUE, device, torch.int32)
    slot_value = torch.where(
        meas.valid & (meas.source != SRC_ROOT),
        value_lut[torch.clamp(meas.source, 0, len(_EVICT_VALUE) - 1).long()],
        torch.iinfo(torch.int32).max,
    )  # [N, O]
    min_value, evict_slot = torch.min(slot_value, dim=1)  # first min: oldest
    incoming = _EVICT_VALUE[min(max(source, 0), len(_EVICT_VALUE) - 1)]
    can_evict = full & (incoming >= min_value)

    slot = torch.where(full, evict_slot, free_slot)
    ok = point_mask & (~full | can_evict)
    rows = torch.arange(N, device=device)

    def upd(arr, val):
        if not isinstance(val, torch.Tensor):
            val = torch.full((N,), val, dtype=arr.dtype, device=device)
        cur = arr[rows, slot]
        mask = ok if cur.dim() == 1 else ok[:, None]
        out = arr.clone()
        out[rows, slot] = torch.where(mask, val.to(arr.dtype), cur)
        return out

    return map_store.MeasStore(
        kf=upd(meas.kf, kf_idx), uv=upd(meas.uv, uv),
        level=upd(meas.level, level), source=upd(meas.source, source),
        subpix=upd(meas.subpix, subpix), valid=upd(meas.valid, ok),
    )


# ---------------------------------------------------------------------------
# New points from two-view matches (MapMaker.cc:262-339, :648-703)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpipolarResult(TensorTree):
    success: torch.Tensor    # [C] bool
    pos_w: torch.Tensor      # [C, 3] triangulated world position
    src_uv: torch.Tensor     # [C, 2] level-0 position in the source KF
    target_uv: torch.Tensor  # [C, 2] level-0 position in the target KF


def insert_new_points(slam_map: SLAMMap, cam, res: EpipolarResult,
                      src_kf: int, target_kf: int, level: int, max_new: int):
    """Pack successful candidates into free point slots with SRC_ROOT
    (source keyframe) + SRC_EPIPOLAR (target keyframe) measurements: the
    r-th success goes to the r-th free slot, up to max_new and the number
    of free slots. Returns (map, new_point_mask [N]).

    The JAX package scatters each candidate to its slot and drops the rest
    out of range; here each slot gathers its candidate instead (no
    duplicate indices, no data-dependent shape, nothing read back)."""
    pts, meas = slam_map.points, slam_map.meas
    C = res.success.shape[0]

    free = ~pts.valid  # [N]
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    n_take = torch.clamp(torch.sum(res.success),
                         max=torch.clamp(torch.sum(free), max=max_new))
    # cand_of_rank[r] = index of the r-th successful candidate.
    cand_of_rank = torch.sort((~res.success).to(torch.int8), stable=True)[1]
    new_mask = free & (free_rank < n_take)
    src = cand_of_rank[torch.clamp(free_rank, 0, C - 1).long()]  # [N]

    cand_lvl_xy = (res.src_uv + 0.5) / level_scale(level) - 0.5
    c_nc, r_nc, d_nc, n_nc = kf_mod.candidate_rays(cam, cand_lvl_xy, level)
    color = img_ops.bilinear_sample(
        slam_map.keyframes.pyramid[level][src_kf], cand_lvl_xy
    )

    def put(arr, val):
        if not isinstance(val, torch.Tensor):
            return torch.where(new_mask, val, arr)
        mask = new_mask if val.dim() == 1 else new_mask[:, None]
        return torch.where(mask, val[src].to(arr.dtype), arr)

    pts = pts.replace(
        valid=put(pts.valid, True), bad=put(pts.bad, False),
        pos_w=put(pts.pos_w, res.pos_w),
        source_kf=put(pts.source_kf, src_kf),
        source_level=put(pts.source_level, level),
        center=put(pts.center, cand_lvl_xy),
        center_nc=put(pts.center_nc, c_nc), right_nc=put(pts.right_nc, r_nc),
        down_nc=put(pts.down_nc, d_nc), normal_nc=put(pts.normal_nc, n_nc),
        inlier_count=put(pts.inlier_count, 0),
        outlier_count=put(pts.outlier_count, 0),
        # Bilinear source-level intensity at creation (the capability of
        # KeyFrame.cc:82-93 / MapMaker.cc:661-663).
        color_gray=put(pts.color_gray, color),
    )

    # Clear the measurement rows of the new points, then add the two.
    meas = meas.replace(valid=meas.valid & ~new_mask[:, None])
    zero_uv = torch.zeros_like(meas.uv[:, 0])
    meas = add_measurements_batch(
        meas, new_mask, src_kf, put(zero_uv, res.src_uv), level, SRC_ROOT,
        True,
    )
    meas = add_measurements_batch(
        meas, new_mask, target_kf, put(zero_uv, res.target_uv), level,
        SRC_EPIPOLAR, True,
    )
    pts = map_store.refresh_pixel_vectors(pts, slam_map.keyframes)
    return slam_map.replace(points=pts, meas=meas), new_mask


# ---------------------------------------------------------------------------
# Global map transforms (MapMaker.cc:440-467)
# ---------------------------------------------------------------------------


def apply_global_transformation(slam_map: SLAMMap, R_new, t_new) -> SLAMMap:
    """ApplyGlobalTransformationToMap: keyframe poses right-multiplied by
    the inverse, points transformed forward."""
    kfs, pts = slam_map.keyframes, slam_map.points
    Ri, ti = lie.se3_inverse(R_new, t_new)
    R2, t2 = lie.se3_mul(kfs.R, kfs.t, Ri.expand_as(kfs.R),
                         ti.expand_as(kfs.t))
    kfs = kfs.replace(R=R2, t=t2)
    pts = pts.replace(pos_w=pts.pos_w @ R_new.T + t_new)
    return slam_map.replace(
        keyframes=kfs, points=map_store.refresh_pixel_vectors(pts, kfs)
    )


def apply_global_scale(slam_map: SLAMMap, scale) -> SLAMMap:
    kfs, pts = slam_map.keyframes, slam_map.points
    kfs = kfs.replace(t=kfs.t * scale)
    pts = pts.replace(pos_w=pts.pos_w * scale)
    return slam_map.replace(
        keyframes=kfs, points=map_store.refresh_pixel_vectors(pts, kfs)
    )


# ---------------------------------------------------------------------------
# CalcPlaneAligner (MapMaker.cc:1104-1231)
# ---------------------------------------------------------------------------


def calc_plane_aligner(slam_map: SLAMMap, config: SLAMConfig, trial_idx=None,
                       generator=None):
    """RANSAC dominant plane -> SE3 putting it at z = 0. Returns (R, t,
    valid): valid is False when the map has fewer than 10 points (the
    reference returns identity then). trial_idx [plane_ransac_trials, 3]:
    the point slots of each trial; when absent they are drawn uniformly
    from the live points, with replacement, from `generator` (of the map's
    device)."""
    mc = config.mapmaker
    pts = slam_map.points
    live = pts.live()
    dtype, device = pts.pos_w.dtype, pts.pos_w.device

    if trial_idx is None:
        p = live.to(dtype)
        p = p + (1.0 - torch.clamp(torch.sum(p), max=1.0))  # none live
        trial_idx = torch.multinomial(
            p, mc.plane_ransac_trials * 3, replacement=True,
            generator=generator,
        ).reshape(mc.plane_ransac_trials, 3)
    tri = pts.pos_w[trial_idx.long()]  # [T, 3, 3]
    mean = torch.mean(tri, dim=1)
    nrm = torch.linalg.cross(tri[:, 2] - tri[:, 0], tri[:, 1] - tri[:, 0])
    nlen = torch.linalg.vector_norm(nrm, dim=-1)
    nrm = nrm / torch.clamp(nlen, min=1e-12)[:, None]
    degenerate = nlen < 1e-12

    diff = pts.pos_w[None] - mean[:, None]  # [T, N, 3]
    nd = torch.abs(torch.einsum("tnc,tc->tn", diff, nrm))
    nd = torch.clamp(nd, max=mc.plane_inlier_threshold)
    score = torch.sum(torch.where(live[None], nd, 0.0), dim=-1)
    score = torch.where(degenerate, torch.inf, score)
    best = torch.argmin(score).reshape(1)
    bmean, bnorm = mean[best][0], nrm[best][0]

    d = torch.abs((pts.pos_w - bmean) @ bnorm)
    inlier = live & (d < mc.plane_inlier_threshold)
    w = inlier.to(dtype)
    nin = torch.clamp(torch.sum(w), min=1.0)
    mean_in = torch.sum(pts.pos_w * w[:, None], dim=0) / nin
    centered = (pts.pos_w - mean_in) * w[:, None]
    cov = centered.T @ centered
    _, evecs = torch.linalg.eigh(cov)
    normal = evecs[:, 0]  # min-variance direction
    normal = torch.where(normal[2] > 0, -normal, normal)

    # Rotation with z-row = normal (MapMaker.cc:1210-1224).
    row0 = const((1.0, 0.0, 0.0), device, dtype)
    row0 = row0 - normal * torch.dot(row0, normal)
    row0 = row0 / torch.clamp(torch.linalg.vector_norm(row0), min=1e-12)
    row1 = torch.linalg.cross(normal, row0)
    R = torch.stack([row0, row1, normal])
    t = -(R @ mean_in)
    return R, t, torch.sum(live) >= 10
