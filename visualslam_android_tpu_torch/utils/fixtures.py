"""A rendered planar scene with a ground-truth fixed map: the state the
tracking step runs against in tests, ``chip_smoke.py`` and benchmarks.

Port of ``small_config``, ``full_config``, ``build_fixed_map`` and
``build_band_ba_map`` from the JAX package's ``utils/fixtures.py``. The map
is built on the given device directly.
"""

from __future__ import annotations

import numpy as np
import torch

from visualslam_android_tpu_torch.config import (
    BundleConfig,
    MapMakerConfig,
    SLAMConfig,
    TrackerConfig,
)
from visualslam_android_tpu_torch.models import keyframe as kf_mod
from visualslam_android_tpu_torch.models import map_store
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import lie
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


def build_band_ba_map(rng, n_kf=512, n_pts=30000, obs_per_pt=4,
                      width=64, height=48, noise_px=0.3,
                      pose_perturb=0.004, point_perturb=0.01, device=None):
    """A KITTI-scale band-diagonal bundle problem as a full SLAMMap (JAX
    ``fixtures.py:42-149``): n_kf keyframes 0.1 m apart along a straight
    path (all R = I), points at depth 3.6-6, each observed by the
    obs_per_pt cameras nearest its x coordinate, so the reduced camera
    system is band-sparse as on an odometry run. Ground-truth geometry with
    noise_px of pixel noise; every pose but keyframe 0's and every point
    perturbed. The numpy draws are the JAX package's, in its order, so one
    seed gives the same map.

    Built on `device` (the CUDA card when None). Returns (config,
    slam_map, cam, adjust_mask)."""
    device = default_device(device)
    config = SLAMConfig(
        tracker=TrackerConfig(
            width=width, height=height,
            max_map_points=n_pts,
            max_corners_per_level=(64, 32, 16, 8),
        ),
        mapmaker=MapMakerConfig(max_keyframes=n_kf),
        bundle=BundleConfig(max_obs_per_point=obs_per_pt),
    )
    cam = cam_ops.make_camera(config.camera.params(), width, height,
                              device=device)

    spacing = 0.1
    cam_x = spacing * np.arange(n_kf)
    pts = np.stack([rng.uniform(-0.5, cam_x[-1] + 0.5, n_pts),
                    rng.uniform(-1.2, 1.2, n_pts),
                    rng.uniform(3.6, 6.0, n_pts)], axis=-1).astype(np.float32)
    # Each point sees the obs_per_pt cameras nearest its x coordinate
    # (R = I, t = -center).
    k0 = np.clip(np.round(pts[:, 0] / spacing).astype(int) - obs_per_pt // 2,
                 0, n_kf - obs_per_pt)
    kf_idx = k0[:, None] + np.arange(obs_per_pt)[None, :]  # [N, O]
    centers = np.stack([cam_x, np.zeros(n_kf), np.zeros(n_kf)],
                       -1).astype(np.float32)
    pc = pts[:, None, :] - centers[kf_idx]  # [N, O, 3]
    m = torch.from_numpy(pc[..., :2] / pc[..., 2:]).to(device)
    px = cam_ops.project(cam, m.reshape(-1, 2)).cpu().numpy().reshape(
        n_pts, obs_per_pt, 2)
    in_img = ((px[..., 0] >= 1) & (px[..., 0] < width - 1)
              & (px[..., 1] >= 1) & (px[..., 1] < height - 1))
    px = px + rng.normal(scale=noise_px, size=px.shape).astype(np.float32)

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    sm = map_store.empty_map(config, device=device)
    dmu = rng.normal(scale=pose_perturb, size=(n_kf, 6)).astype(np.float32)
    dmu[0] = 0.0
    R_init, t_init = lie.se3_mul(
        *lie.se3_exp(dev(dmu)),
        torch.eye(3, device=device).expand(n_kf, 3, 3), dev(-centers))
    fixed = torch.zeros(n_kf, dtype=torch.bool, device=device)
    fixed[0] = True
    kfs = sm.keyframes.replace(
        valid=torch.ones(n_kf, dtype=torch.bool, device=device),
        fixed=fixed, R=R_init, t=t_init,
        depth_mean=torch.full((n_kf,), 4.5, device=device),
        depth_sigma=torch.full((n_kf,), 0.8, device=device),
    )
    pts_init = pts + rng.normal(scale=point_perturb,
                                size=pts.shape).astype(np.float32)
    points = sm.points.replace(
        valid=torch.ones(n_pts, dtype=torch.bool, device=device),
        pos_w=dev(pts_init), source_kf=dev(kf_idx[:, 0], torch.int32))
    source = np.full((n_pts, obs_per_pt), map_store.SRC_EPIPOLAR, np.int32)
    source[:, 0] = map_store.SRC_ROOT
    meas = sm.meas.replace(
        kf=dev(kf_idx, torch.int32), uv=dev(px),
        level=torch.zeros((n_pts, obs_per_pt), dtype=torch.int32,
                          device=device),
        source=dev(source), valid=dev(in_img))
    sm = sm.replace(keyframes=kfs, points=points, meas=meas,
                    good=torch.ones((), dtype=torch.bool, device=device))
    return config, sm, cam, kfs.valid & ~kfs.fixed


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
