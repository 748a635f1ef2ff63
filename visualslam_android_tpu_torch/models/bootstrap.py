"""The stereo bootstrap: from a first frame and a sideways camera motion to
the two-keyframe map that ``frame_step`` tracks on.

Port of the host-side glue of the JAX package's ``SLAMSystem``
(``models/slam.py``: ``_trail_start``, ``_trail_advance``,
``_init_from_stereo``; the reference's Tracker::TrackForInitialMap,
jni/Tracker.cc:206-346, and MapMaker::InitFromStereo,
jni/MapMaker.cc:204-376) as plain functions over an explicit trail state.
It is the seed of the facade's port, not the facade: the caller owns the
phase logic (when to start trails, when to attempt the initialisation).

The path: ``trail_start`` samples MiniPatches at the first frame's best
level-0 Shi-Tomasi candidates; ``trail_advance`` follows them frame by
frame; ``init_from_stereo`` fits the homography between the trails' first
and current positions, inserts the two keyframes, triangulates the trail
matches into map points, runs 5 rounds of global bundle adjustment,
refreshes the scene depth, grows the map from keyframe 1 by epipolar
search at levels 0, 3, 1, 2, bundle-adjusts until convergence (4 rounds at
most) and aligns the dominant plane with z = 0.

The host reads the device where the reference's loop decides something:
the trail count per frame, homography success and baseline length, the
number of triangulated points, convergence and map health once per
bundle-adjustment round (besides bundle_adjust's own loop control), and the
final depth and point count.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models import frame_step as fstep
from visualslam_android_tpu_torch.models import homography
from visualslam_android_tpu_torch.models import keyframe as kf_mod
from visualslam_android_tpu_torch.models import map_store, mapmaker
from visualslam_android_tpu_torch.models.map_store import (
    FrameData,
    FrameExtras,
    SLAMMap,
)
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import match
from visualslam_android_tpu_torch.utils.tensors import TensorTree


@dataclasses.dataclass(frozen=True)
class TrailState(TensorTree):
    """The bootstrap trails (Tracker::mlTrails, jni/Tracker.cc:264-291)."""

    frame: FrameData      # the first frame, which becomes keyframe 0
    extras: FrameExtras   # its MakeKeyFrame_Rest products
    patches: torch.Tensor   # [T, P, P] MiniPatches sampled in the first frame
    init_pos: torch.Tensor  # [T, 2] level-0 positions in the first frame
    cur_pos: torch.Tensor   # [T, 2] positions in the latest frame
    valid: torch.Tensor     # [T] bool, trail still alive


@dataclasses.dataclass(frozen=True)
class StereoInit:
    """What init_from_stereo made. When `ok`, (slam_map, R, t, velocity,
    msd, depth, wiggle_depth_norm, new_points, failure_mask) is the state
    frame_step takes for the next frame, and never_retry goes with
    failure_mask to the mapping stages; otherwise `reason` says which of
    the reference's aborts fired and the state fields are None."""

    ok: bool
    reason: str
    homography: Optional[homography.HomographyResult] = None
    R2: Optional[torch.Tensor] = None   # keyframe 1 before plane alignment
    t2: Optional[torch.Tensor] = None
    n_ok: int = 0                       # trail matches triangulated
    n_points: int = 0                   # live map points at the end
    slam_map: Optional[SLAMMap] = None
    R: Optional[torch.Tensor] = None
    t: Optional[torch.Tensor] = None
    velocity: Optional[torch.Tensor] = None
    msd: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None
    wiggle_depth_norm: Optional[torch.Tensor] = None
    new_points: Optional[torch.Tensor] = None    # [N] the new-point queue
    never_retry: Optional[torch.Tensor] = None   # [N, K] ejected for good
    failure_mask: Optional[torch.Tensor] = None  # [N, K] ejected, retryable
    ba_rounds: Tuple[int, int] = (0, 0)  # rounds run: fixed, to convergence
    ba_converged: bool = False


# The StereoInit reason of a bootstrap whose bundle adjustment left a
# non-finite map: the facade answers it with a full reset.
NON_FINITE = "bundle adjustment left a non-finite map"

# InitFromStereo's schedule (MapMaker.cc:346-367): 5 global rounds of 10
# iterations, growth at these levels, then rounds of 20 until one converges.
N_INIT_BA_ROUNDS = 5
INIT_GROW_LEVELS = (0, 3, 1, 2)
MAX_CONV_BA_ROUNDS = 4


def init_point_slots(config: SLAMConfig) -> int:
    """The point slots the bootstrap's map can reach: the trails and four
    growths of max_epi_candidates, rounded up to 256, within the map's
    capacity. New points fill the lowest free slots, so the whole map lies
    in this prefix and the bootstrap's bundle adjustment runs on it."""
    tc = config.tracker
    reach = tc.max_trails + 4 * config.mapmaker.max_epi_candidates
    return min(tc.max_map_points, -(-reach // 256) * 256)


def _global_ba(slam_map: SLAMMap, never_retry, failure_mask, cam,
               config: SLAMConfig, max_iters: int, cap):
    """One global bundle-adjustment round on the prefix `cap`; reads the
    device once. Returns (slam_map, never_retry, failure_mask, converged,
    map_ok), the last two as host bools. Raises if the map has left the
    prefix, which the slot allocation order rules out."""
    sm, failure_mask, never_retry, conv, map_ok = fstep.ba_round(
        slam_map, 1, never_retry, failure_mask, cam, config,
        max_iters=max_iters, assembly="scatter", solver="chol",
        mode="global", cap=cap,
    )
    in_prefix = ~(torch.any(sm.points.valid[cap[0]:])
                  | torch.any(sm.keyframes.valid[cap[1]:]))
    conv, map_ok, in_prefix = torch.stack([conv, map_ok, in_prefix]).tolist()
    if not in_prefix:
        raise RuntimeError(
            f"the bootstrap map has left its first {cap[0]} point slots or "
            f"{cap[1]} keyframe slots: the prefix bundle adjustment would "
            "miss part of it"
        )
    return sm, never_retry, failure_mask, conv, map_ok


@contextlib.contextmanager
def _no_stage(name):
    yield


def trail_start(frame: FrameData, config: SLAMConfig) -> TrailState:
    """TrailTracking_Start (Tracker.cc:264-291): MiniPatches at the best
    Shi-Tomasi candidates of level 0, up to max_trails of them."""
    extras = kf_mod.make_frame_extras(frame, config)
    n = min(config.tracker.max_trails, extras.cand_xy[0].shape[0])
    pos = extras.cand_xy[0][:n].to(torch.float32)
    patches = match.sample_minipatches(frame.pyramid[0], pos,
                                       config.patch.mini_half_patch)
    return TrailState(frame=frame, extras=extras, patches=patches,
                      init_pos=pos, cur_pos=pos,
                      valid=extras.cand_valid[0][:n])


def trail_advance(trails: TrailState, frame: FrameData,
                  prev_frame: FrameData, config: SLAMConfig):
    """One frame of TrailTracking_Advance: (trails, count). `count` stays
    on the device; the caller reads it for the < min_trails_to_continue
    reset (Tracker.cc:245-248)."""
    pos, good, count = fstep.trail_advance_step(
        frame, prev_frame, trails.patches, trails.cur_pos, trails.valid,
        config,
    )
    return trails.replace(cur_pos=pos, valid=good), count


def init_from_stereo(trails: TrailState, frame_second: FrameData, cam,
                     config: SLAMConfig, homography_trial_idx=None,
                     plane_trial_idx=None, generator=None,
                     timer=None) -> StereoInit:
    """InitFromStereo (MapMaker.cc:204-376) from the trails' first and
    current positions, `frame_second` being the frame the trails were last
    advanced in. The MLESAC and plane-RANSAC draws are the optional
    `homography_trial_idx` [mlesac_trials, 4] and `plane_trial_idx`
    [plane_ransac_trials, 3], else they come from `generator`. A
    utils/profiling.StageTimer `timer` times the stages (init_homography,
    init_points, init_ba5, init_grow, init_ba_conv, init_plane_tail)."""
    cfg, mc = config, config.mapmaker
    stage = timer.stage if timer is not None else _no_stage
    device = trails.cur_pos.device
    extras_second = kf_mod.make_frame_extras(frame_second, cfg)
    a, b, valid = trails.init_pos, trails.cur_pos, trails.valid

    # ---- homography (MapMaker.cc:214-247) ----
    with stage("init_homography"):
        m_a = cam_ops.unproject(cam, a)
        m_b = cam_ops.unproject(cam, b)
        _, jac = cam_ops.project_derivs(cam, m_b)
        res = homography.compute(
            m_a, m_b, jac, valid, max_pixel_error=mc.max_pixel_error,
            n_trials=mc.mlesac_trials,
            refine_iters=mc.homography_refine_iters,
            trial_idx=homography_trial_idx, generator=generator,
        )
        # One read for the two host decisions (success, zero baseline).
        success, t_mag = torch.stack([
            res.success.to(torch.float32), torch.linalg.vector_norm(res.t)
        ]).tolist()
    if success <= 0.5:
        return StereoInit(False, "homography failed", homography=res)
    if t_mag == 0.0:
        return StereoInit(False, "zero baseline", homography=res)
    R2 = res.R
    t2 = res.t * (mc.wiggle_scale / t_mag)

    # ---- the two keyframes and the trail points (MapMaker.cc:249-339) ----
    with stage("init_points"):
        sm = map_store.empty_map(cfg, device=device)
        kf_mod.insert_keyframe(
            sm.keyframes, 0, trails.frame, trails.extras,
            torch.eye(3, device=device), torch.zeros(3, device=device),
            fixed=True,
        )
        kf_mod.insert_keyframe(sm.keyframes, 1, frame_second, extras_second,
                               R2, t2, fixed=False)
        sm, n_ok_dev = fstep.init_points_step(sm, frame_second, m_a, a, b,
                                              valid, R2, t2, cam, cfg)
        n_ok = int(n_ok_dev)
    if n_ok < 10:
        return StereoInit(False, "fewer than 10 points", homography=res,
                          R2=R2, t2=t2, n_ok=n_ok)

    # ---- 5x BundleAdjustAll (MapMaker.cc:346-347) ----
    N, K = cfg.tracker.max_map_points, mc.max_keyframes
    never_retry = torch.zeros(N, K, dtype=torch.bool, device=device)
    failure_mask = torch.zeros(N, K, dtype=torch.bool, device=device)
    cap = (init_point_slots(cfg), 2)
    non_finite = StereoInit(False, NON_FINITE, homography=res, R2=R2, t2=t2,
                            n_ok=n_ok)
    with stage("init_ba5"):
        for _ in range(N_INIT_BA_ROUNDS):
            sm, never_retry, failure_mask, _, map_ok = _global_ba(
                sm, never_retry, failure_mask, cam, cfg, 10, cap)
            if not map_ok:
                return non_finite
    sm = kf_mod.refresh_scene_depth(sm, 0)
    sm = kf_mod.refresh_scene_depth(sm, 1)
    depth = sm.keyframes.depth_mean[0].clone()
    wiggle = mc.wiggle_scale / torch.clamp(depth, min=1e-6)

    # ---- epipolar growth from keyframe 1 (MapMaker.cc:355-358) ----
    new_points = torch.zeros(N, dtype=torch.bool, device=device)
    with stage("init_grow"):
        for level in INIT_GROW_LEVELS:
            sm, new_points = fstep.add_map_points_step(sm, new_points, cam,
                                                       1, level, cfg)

    # ---- BA until converged (MapMaker.cc:363-367) ----
    converged, conv_rounds = False, 0
    with stage("init_ba_conv"):
        while not converged and conv_rounds < MAX_CONV_BA_ROUNDS:
            sm, never_retry, failure_mask, converged, map_ok = _global_ba(
                sm, never_retry, failure_mask, cam, cfg, 20, cap)
            conv_rounds += 1
            if not map_ok:
                return non_finite

    # ---- dominant-plane alignment (MapMaker.cc:369-372) ----
    # Applied as a masked transform (identity when the RANSAC found no
    # plane), so plane_ok is not read back.
    with stage("init_plane_tail"):
        Rp, tp, plane_ok = mapmaker.calc_plane_aligner(
            sm, cfg, trial_idx=plane_trial_idx, generator=generator
        )
        Rp = torch.where(plane_ok, Rp, torch.eye(3, device=device))
        tp = torch.where(plane_ok, tp, torch.zeros(3, device=device))
        sm = mapmaker.apply_global_transformation(sm, Rp, tp)
        sm = sm.replace(good=torch.ones_like(sm.good))
        # One last read, for the host's mirrors (depth, point count).
        _, n_points = torch.stack([
            sm.keyframes.depth_mean[0], sm.points.count().to(torch.float32)
        ]).tolist()
    return StereoInit(
        True, "", homography=res, R2=R2, t2=t2, n_ok=n_ok,
        n_points=int(n_points), slam_map=sm,
        R=sm.keyframes.R[1].clone(), t=sm.keyframes.t[1].clone(),
        velocity=torch.zeros(6, device=device),
        msd=torch.zeros((), device=device), depth=depth,
        wiggle_depth_norm=wiggle, new_points=new_points,
        never_retry=never_retry, failure_mask=failure_mask,
        ba_rounds=(N_INIT_BA_ROUNDS, conv_rounds), ba_converged=converged,
    )
