"""A rendered planar scene with a ground-truth fixed map: the state the
tracking step runs against in tests, ``chip_smoke.py`` and benchmarks.

Port of ``small_config``, ``full_config`` and ``build_fixed_map`` from the
JAX package's ``utils/fixtures.py``. The map is built on the given device
directly.
"""

from __future__ import annotations

import torch

from visualslam_android_tpu_torch.config import (
    MapMakerConfig,
    SLAMConfig,
    TrackerConfig,
)
from visualslam_android_tpu_torch.models import keyframe as kf_mod
from visualslam_android_tpu_torch.models import map_store
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.utils import synthetic
from visualslam_android_tpu_torch.utils.tensors import default_device


def small_config(width=320, height=240) -> SLAMConfig:
    return SLAMConfig(
        tracker=TrackerConfig(
            width=width, height=height,
            max_map_points=256,
            max_corners_per_level=(256, 128, 64, 32),
        ),
        mapmaker=MapMakerConfig(max_keyframes=4),
    )


def full_config() -> SLAMConfig:
    """Reference-scale frames (800x480, jni/jni_part.cpp:41), a 2048-slot
    map and 32 keyframe slots."""
    return SLAMConfig(
        tracker=TrackerConfig(max_map_points=2048),
        mapmaker=MapMakerConfig(max_keyframes=32),
    )


def build_fixed_map(config: SLAMConfig, rng, per_level=(60, 40, 24, 12),
                    depth=4.0, px_per_m=120.0, device=None):
    """One-keyframe map with exact ground-truth plane points made from the
    keyframe's Shi-Tomasi candidates (up to per_level[l] at level l).

    Built on `device` (the CUDA card when None). Returns (slam_map, cam,
    scene, (R0, t0), n_points).
    """
    device = default_device(device)
    tc = config.tracker
    cam = cam_ops.make_camera(config.camera.params(), tc.width, tc.height,
                              device=device)
    scene = synthetic.make_planar_scene(rng, depth=depth, px_per_m=px_per_m,
                                        device=device)
    R0, t0 = synthetic.look_at_pose((0.0, 0.0, 0.0), target=(0, 0, depth),
                                    device=device)
    img0 = synthetic.render(scene, cam, R0, t0, (tc.height, tc.width))
    frame0 = kf_mod.make_frame(img0, config)
    extras0 = kf_mod.make_frame_extras(frame0, config)

    slam_map = map_store.empty_map(config, device=device)
    kf_mod.insert_keyframe(slam_map.keyframes, 0, frame0, extras0, R0, t0,
                           fixed=True)

    pts, meas = slam_map.points, slam_map.meas
    slot = 0
    for lvl in range(tc.n_levels):
        n_valid = int(extras0.cand_valid[lvl].sum())
        n_take = min(per_level[lvl], n_valid, pts.n_slots - slot)
        if n_take <= 0:
            continue
        xy = extras0.cand_xy[lvl][:n_take].float()  # [n, 2] level coords
        zero_xy = (xy + 0.5) * (1 << lvl) - 0.5
        sl = slice(slot, slot + n_take)
        pts.valid[sl] = True
        pts.pos_w[sl] = synthetic.plane_point_from_pixel(
            scene, cam, R0, t0, zero_xy
        )
        pts.source_kf[sl] = 0
        pts.source_level[sl] = lvl
        pts.center[sl] = xy
        (pts.center_nc[sl], pts.right_nc[sl], pts.down_nc[sl],
         pts.normal_nc[sl]) = kf_mod.candidate_rays(cam, xy, lvl)
        meas.kf[sl, 0] = 0
        meas.uv[sl, 0] = zero_xy
        meas.level[sl, 0] = lvl
        meas.source[sl, 0] = map_store.SRC_ROOT
        meas.subpix[sl, 0] = True
        meas.valid[sl, 0] = True
        slot += n_take
    pts = map_store.refresh_pixel_vectors(pts, slam_map.keyframes)
    slam_map = slam_map.replace(points=pts,
                                good=torch.ones_like(slam_map.good))
    slam_map = kf_mod.refresh_scene_depth(slam_map, 0)
    return slam_map, cam, scene, (R0, t0), slot
