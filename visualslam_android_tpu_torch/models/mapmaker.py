"""Map maintenance on the tracking path: keyframe distances, the
keyframe-need tests and HandleBadPoints.

Port of the parts of the JAX package's ``models/mapmaker.py`` that
``frame_step`` runs (the reference's jni/MapMaker.cc:140-164, :705-773,
:1098-1101). The rest of the mapmaker is not ported yet.
"""

from __future__ import annotations

import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models.map_store import SLAMMap


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
