"""Frame front-end: build FrameData / FrameExtras and insert keyframes.

Port of the JAX package's ``models/keyframe.py``: MakeKeyFrame_Lite
(jni/KeyFrame.cc:5-51: pyramid + per-level FAST at 10/15/15/10),
MakeKeyFrame_Rest (jni/KeyFrame.cc:53-101: nonmax suppression, Shi-Tomasi
candidates with score > 70 and border 10, SBI + jacs) and the scene-depth
refresh (MapMaker::RefreshSceneDepth, jni/MapMaker.cc:1236-1252).
"""

from __future__ import annotations

import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models import map_store
from visualslam_android_tpu_torch.models.map_store import (
    FrameData,
    FrameExtras,
    KeyFrameStore,
    SLAMMap,
)
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import fast, image, sbi
from visualslam_android_tpu_torch.ops.levels import level_zero_pos
from visualslam_android_tpu_torch.utils.tensors import const


def make_frame(img, config: SLAMConfig) -> FrameData:
    """MakeKeyFrame_Lite (jni/KeyFrame.cc:5-51): pyramid + dense FAST
    corner masks at the reference's per-level thresholds. Makes one FAST
    launch for all levels of the frame."""
    tc = config.tracker
    pyramid = tuple(lvl.contiguous()
                    for lvl in image.make_pyramid(img, tc.n_levels))
    masks, scores = fast.detect_levels(pyramid, tc.fast_thresholds)
    return FrameData(pyramid=pyramid, corner_mask=masks, corner_score=scores)


def make_frames(imgs, config: SLAMConfig) -> FrameData:
    """make_frame for S frames at once (one per camera stream): imgs
    [S, H, W] -> a FrameData whose tensors carry the leading stream axis.
    Makes ONE FAST launch for all streams and levels, where the JAX
    package's vmap of make_frame runs one kernel call per stream."""
    tc = config.tracker
    pyramid = tuple(lvl.contiguous()
                    for lvl in image.make_pyramid(imgs, tc.n_levels))
    masks, scores = fast.detect_levels_streams(pyramid, tc.fast_thresholds)
    return FrameData(pyramid=pyramid, corner_mask=masks, corner_score=scores)


def make_frame_extras(frame: FrameData, config: SLAMConfig) -> FrameExtras:
    """MakeKeyFrame_Rest (jni/KeyFrame.cc:53-101): nonmax corners
    re-scored with barrier 10 (KeyFrame.cc:62; one fused FAST launch for
    all levels), Shi-Tomasi candidates (score > 70, border 10), SBI +
    jacs."""
    tc, mc = config.tracker, config.mapmaker
    nonmax = fast.nonmax_levels(
        tuple(lvl.contiguous() for lvl in frame.pyramid),
        tuple(cm.contiguous() for cm in frame.corner_mask), 10,
    )
    cand_xy, cand_valid, cand_score = [], [], []
    for lvl_idx, (lvl, kept) in enumerate(zip(frame.pyramid, nonmax)):
        st = image.shi_tomasi_dense(lvl, 3)
        xy, valid = fast.top_k_corners(
            kept & (st > mc.shi_tomasi_threshold), st,
            tc.max_corners_per_level[lvl_idx], border=mc.candidate_border,
        )
        cand_xy.append(xy)
        cand_valid.append(valid)
        sc = st[xy[:, 1].long(), xy[:, 0].long()]
        cand_score.append(torch.where(valid, sc, 0.0))
    s = sbi.make_sbi(frame.pyramid[-1], tc.sbi_blur)
    return FrameExtras(
        nonmax_mask=nonmax, cand_xy=tuple(cand_xy),
        cand_valid=tuple(cand_valid), cand_score=tuple(cand_score),
        sbi_template=s.template, sbi_jacs=s.jacs,
    )


def insert_keyframe(kfs: KeyFrameStore, slot: int, frame: FrameData,
                    extras: FrameExtras, R, t,
                    fixed=False) -> KeyFrameStore:
    """Write a keyframe into `slot`. Updates the store's tensors IN PLACE
    (the JAX package's functional update copies the whole store) and
    returns the same store."""
    # fill_ takes the value as a kernel argument; assigning a Python
    # scalar would copy it from host memory, which waits for the stream.
    kfs.valid[slot].fill_(True)
    kfs.fixed[slot].fill_(fixed)
    kfs.R[slot] = R
    kfs.t[slot] = t
    for dst, src in zip(kfs.pyramid, frame.pyramid):
        dst[slot] = src
    for dst, src in zip(kfs.corner_mask, frame.corner_mask):
        dst[slot] = src
    for dst, src in zip(kfs.cand_xy, extras.cand_xy):
        dst[slot] = src
    for dst, src in zip(kfs.cand_valid, extras.cand_valid):
        dst[slot] = src
    kfs.sbi_template[slot] = extras.sbi_template
    kfs.sbi_jacs[slot] = extras.sbi_jacs
    return kfs


def refresh_scene_depth(slam_map: SLAMMap, kf_idx: int) -> SLAMMap:
    """Batched MapMaker::RefreshSceneDepth (jni/MapMaker.cc:1236-1252):
    mean/sigma of the camera-z of the points measured in this KF. Writes
    the keyframe's depth stats IN PLACE and returns the same map."""
    pts, kfs, meas = slam_map.points, slam_map.keyframes, slam_map.meas
    observed = map_store.point_observed_in(meas, kf_idx) & pts.live()
    z = (pts.pos_w @ kfs.R[kf_idx].T + kfs.t[kf_idx])[:, 2]
    w = observed.to(z.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(w * z) / n
    sq = torch.sum(w * z * z) / n
    kfs.depth_mean[kf_idx] = mean
    kfs.depth_sigma[kf_idx] = torch.sqrt(torch.clamp(sq - mean * mean,
                                                     min=1e-12))
    return slam_map


def candidate_rays(cam: cam_ops.Camera, cand_xy, level: int):
    """Unit rays for new map points made from candidates (MapPoint
    v3Center_NC / right / down, jni/MapMaker.cc:300-320). cand_xy [C, 2]
    level coords; returns (center_nc, right_nc, down_nc, normal_nc), each
    [C, 3], normal = (0, 0, -1)."""
    scale = 2.0 ** level
    zero = level_zero_pos(cand_xy.to(torch.float32), level)

    def ray(px):
        m = cam_ops.unproject(cam, px)
        v = torch.cat([m, torch.ones_like(m[..., :1])], dim=-1)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    center = ray(zero)
    dev, dt = zero.device, zero.dtype
    normal = const((0.0, 0.0, -1.0), dev, dt).expand_as(center)
    return (center, ray(zero + const((scale, 0.0), dev, dt)),
            ray(zero + const((0.0, scale), dev, dt)), normal)
