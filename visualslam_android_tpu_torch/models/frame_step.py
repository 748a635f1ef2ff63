"""The per-frame tracking step: the reference's TrackFrame
(jni/Tracker.cc:76-146) against an existing map.

Port of ``frame_step`` and the ``STAT_*`` layout of its packed stats
vector from the JAX package's ``models/frame_step.py``: pyramid + FAST
front-end, SBI build, ESM rotation prior, motion model, TrackMap,
motion-model update, inlier/outlier bookkeeping, HandleBadPoints
(jni/MapMaker.cc:140-164) and the quality / keyframe tests. The stats
vector carries every scalar a host control loop reads, so the host reads
the device once per frame.

Also the bootstrap-phase stages of the same JAX module:
``bootstrap_frontend`` (MakeKeyFrame_Lite + SBI), ``trail_advance_step``
(TrailTracking_Advance, jni/Tracker.cc:294-346) and ``init_points_step``
(InitFromStereo's point building, jni/MapMaker.cc:262-339); and its
mapping stages: ``ba_round`` (BundleAdjustRecent / BundleAdjustAll,
jni/MapMaker.cc:776-960), ``add_map_points_step`` (AddSomeMapPoints,
jni/MapMaker.cc:427-437), ``integrate_keyframe`` (the first stage of
AddKeyFrameFromTopOfQueue, jni/MapMaker.cc:481-506) and the budgeted
re-find stages ``refind_newly`` / ``refind_failures`` (ReFindNewlyMade /
ReFindFromFailureQueue, jni/MapMaker.cc:1061-1095).
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models import bundle as bundle_mod
from visualslam_android_tpu_torch.models import keyframe as kf_mod
from visualslam_android_tpu_torch.models import mapmaker
from visualslam_android_tpu_torch.models import tracker as tracker_mod
from visualslam_android_tpu_torch.models import triangulate
from visualslam_android_tpu_torch.models.map_store import (
    SRC_REFIND,
    SRC_TRACKER,
    SRC_TRAIL,
    FrameData,
    SLAMMap,
)
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import match
from visualslam_android_tpu_torch.ops import sbi as sbi_ops
from visualslam_android_tpu_torch.utils.tensors import TensorTree

N_LEVELS = 4

# Packed per-frame stats vector layout (indices into FrameStepOut.stats).
STAT_QUALITY = 0          # assess_tracking_quality code (0/1/2)
STAT_DIST_EXCESSIVE = 1   # IsDistanceToNearestKeyFrameExcessive
STAT_NEED_KF = 2          # NeedNewKeyFrame
STAT_DID_COARSE = 3
STAT_DEPTH = 4            # scene depth mean after this frame
STAT_VEL_MAG = 5
STAT_VEL_MSD = 6
STAT_N_FOUND = 7
STAT_N_POINTS = 8         # post-HandleBadPoints
STAT_N_KEYFRAMES = 9
STAT_N_MEAS = 10
STAT_ANY_FAILURE = 11     # failure queue nonempty (as of frame start)
STAT_ANY_NEW = 12         # new-point queue nonempty (post bad-point cull)
STAT_ANY_NEWLY_BAD = 13
STAT_PENDING_CONV = 14    # passthrough of last BA's convergence scalar
STAT_PENDING_OK = 15      # passthrough of last BA's finite-map scalar
STAT_FOUND_L0 = 16        # .. STAT_FOUND_L0 + N_LEVELS
STAT_POSE_R = STAT_FOUND_L0 + N_LEVELS   # 9 floats, row-major
STAT_POSE_T = STAT_POSE_R + 9            # 3 floats
STATS_LEN = STAT_POSE_T + 3


@dataclasses.dataclass(frozen=True)
class FrameStepOut(TensorTree):
    slam_map: SLAMMap            # inlier/outlier counts updated, bad culled
    R: torch.Tensor              # [3, 3] tracked pose
    t: torch.Tensor              # [3]
    velocity: torch.Tensor       # [6] updated motion model
    msd: torch.Tensor            # [] scene-depth-scaled |v|
    depth: torch.Tensor          # [] scene depth mean
    sbi: sbi_ops.SBI             # this frame's SBI (next frame's prior)
    frame: FrameData             # kept for the keyframe queue
    found: torch.Tensor          # [N]
    found_pos: torch.Tensor      # [N, 2]
    search_level: torch.Tensor   # [N]
    did_subpix: torch.Tensor     # [N]
    new_points: torch.Tensor     # [N] new-point queue, bad-culled
    stats: torch.Tensor          # [STATS_LEN] f32


def frame_step(img, slam_map: SLAMMap, cam, R, t, velocity, msd, depth_mean,
               wiggle_depth_norm, sbi_last: sbi_ops.SBI, new_points,
               failure_mask, pending, config: SLAMConfig,
               use_prior: bool = True, forced_coarse: bool = False,
               uniforms=None, generator=None, graphs=None) -> FrameStepOut:
    """The complete per-frame hot path.

    use_prior=False on a relocalization frame (pose from the relocalizer,
    Tracker.cc:169-174); forced_coarse=True on that frame and the
    just-recovered one. uniforms / generator feed track_map's two random
    selections (see tracker.track_map). The input map is not modified:
    the returned map shares the keyframe store and carries new point and
    measurement tensors.

    graphs: a step_graph.StepGraphs to run the step through (the facade's:
    a CUDA graph replay from static buffers on the card, reused buffers on
    the CPU; the same results). The outputs are then valid until its next
    step, but the state, which comes back in the buffers that step reads.
    """
    if graphs is not None:
        return graphs.step(
            _frame_step, img, slam_map, cam, R, t, velocity, msd,
            depth_mean, wiggle_depth_norm, sbi_last, new_points,
            failure_mask, pending, config, use_prior=use_prior,
            forced_coarse=forced_coarse, uniforms=uniforms,
            generator=generator)
    return _frame_step(img, slam_map, cam, R, t, velocity, msd, depth_mean,
                       wiggle_depth_norm, sbi_last, new_points, failure_mask,
                       pending, config, use_prior=use_prior,
                       forced_coarse=forced_coarse, uniforms=uniforms,
                       generator=generator)


def _frame_step(img, slam_map: SLAMMap, cam, R, t, velocity, msd, depth_mean,
                wiggle_depth_norm, sbi_last: sbi_ops.SBI, new_points,
                failure_mask, pending, config: SLAMConfig,
                use_prior: bool = True, forced_coarse: bool = False,
                uniforms=None, generator=None) -> FrameStepOut:
    tc = config.tracker
    f32 = torch.float32

    frame = kf_mod.make_frame(img, config)
    sbi_cur = sbi_ops.make_sbi(frame.pyramid[-1], tc.sbi_blur)

    if use_prior:
        sbi_rot = tracker_mod.calc_sbi_rotation(
            sbi_cur.template, sbi_last, cam, tc.sbi_esm_iters
        )
        R1, t1 = tracker_mod.apply_motion_model(R, t, velocity, sbi_rot,
                                                True)
    else:
        R1, t1 = R, t

    out = tracker_mod.track_map(
        frame, slam_map, cam, R1, t1, msd, config, recovered=forced_coarse,
        uniforms=uniforms, generator=generator,
    )

    depth_new = torch.where(out.depth_stats_valid, out.scene_depth_mean,
                            depth_mean)
    velocity2, mag, msd2 = tracker_mod.update_motion_model(
        out.R, out.t, R1, t1, velocity, depth_new, tc.motion_decay
    )

    # Inlier/outlier bookkeeping + HandleBadPoints (every frame, as in
    # every pass of the reference's run() loop, MapMaker.cc:116).
    pts = slam_map.points
    pts = pts.replace(inlier_count=pts.inlier_count + out.inlier_inc,
                      outlier_count=pts.outlier_count + out.outlier_inc)
    sm, newly_bad = mapmaker.handle_bad_points(slam_map.replace(points=pts),
                                               config)
    new_points2 = new_points & ~newly_bad

    quality = tracker_mod.assess_tracking_quality(
        out.attempted_per_level, out.found_per_level,
        tc.quality_good, tc.quality_lost,
    )
    dist_exc = mapmaker.dist_to_nearest_excessive(
        sm.keyframes, out.R, out.t,
        config.mapmaker.wiggle_scale, config.mapmaker.kf_distance_factor,
    )
    need_kf = mapmaker.need_new_keyframe(
        sm.keyframes, out.R, out.t, depth_new, wiggle_depth_norm,
        config.mapmaker.max_kf_dist_mult,
    )

    scalars = [
        quality, dist_exc, need_kf, out.did_coarse, depth_new, mag, msd2,
        torch.sum(out.found), sm.points.count(), sm.keyframes.count(),
        sm.meas.count(), torch.any(failure_mask), torch.any(new_points2),
        torch.any(newly_bad), pending[0], pending[1],
    ]
    stats = torch.cat([
        torch.stack([s.to(f32) for s in scalars]),
        out.found_per_level.to(f32), out.R.reshape(-1), out.t,
    ])

    return FrameStepOut(
        slam_map=sm, R=out.R, t=out.t, velocity=velocity2, msd=msd2,
        depth=depth_new, sbi=sbi_cur, frame=frame,
        found=out.found, found_pos=out.found_pos,
        search_level=out.search_level, did_subpix=out.did_subpix,
        new_points=new_points2, stats=stats,
    )


def bootstrap_frontend(img, config: SLAMConfig):
    """make_frame + make_sbi for a frame of the bootstrap phase, which runs
    outside frame_step: (FrameData, SBI)."""
    frame = kf_mod.make_frame(img, config)
    return frame, sbi_ops.make_sbi(frame.pyramid[-1], config.tracker.sbi_blur)


def trail_advance_step(frame: FrameData, prev_frame: FrameData, patches,
                       cur_pos, valid, config: SLAMConfig):
    """TrailTracking_Advance (Tracker.cc:294-346): forward MiniPatch search
    in `frame`, then a backwards search from the match in `prev_frame`
    that must come back within 2 px^2 of the start (the married-match
    test). Returns (new_pos [T, 2], good [T], count []); a host loop reads
    only `count` (the < min_trails reset, Tracker.cc:245-248)."""
    tc = config.tracker
    search = dict(search_range=tc.trail_search_range,
                  half_patch=config.patch.mini_half_patch,
                  max_ssd=tc.trail_max_ssd)
    fwd = match.find_minipatch(frame.pyramid[0], frame.corner_mask[0],
                               patches, cur_pos, valid, **search)
    back_patches = match.sample_minipatches(
        frame.pyramid[0], fwd.pos, config.patch.mini_half_patch
    )
    bwd = match.find_minipatch(prev_frame.pyramid[0],
                               prev_frame.corner_mask[0], back_patches,
                               fwd.pos, valid & fwd.found, **search)
    d = bwd.pos - cur_pos
    married = torch.sum(d * d, dim=-1) <= 2.0
    good = valid & fwd.found & bwd.found & married
    new_pos = torch.where(good[:, None], fwd.pos, cur_pos)
    return new_pos, good, torch.sum(good.to(torch.int32))


def init_points_step(slam_map: SLAMMap, frame_second: FrameData, m_a, a, b,
                     valid, R2, t2, cam, config: SLAMConfig):
    """InitFromStereo's point building (MapMaker.cc:262-339): per-trail
    subpixel alignment in the second view, two-view triangulation, and
    packing of the survivors into point slots with SRC_ROOT + SRC_TRAIL
    measurements. The map holds keyframe 0 at the identity and keyframe 1
    at (R2, t2); a/b [T, 2] are the trails' first and current level-0
    positions, m_a the first ones on the z=1 plane. Returns (slam_map,
    n_ok []): a host loop reads only n_ok (the < 10 abort,
    MapMaker.cc:313-316)."""
    cfg = config
    T = a.shape[0]
    device = a.device
    level0 = torch.zeros(T, dtype=torch.int32, device=device)
    tmpl = match.make_templates_nowarp(
        slam_map.keyframes.pyramid[0], level0, a, cfg.patch.half_patch_size
    )
    sp = match.iterate_subpix(
        frame_second.pyramid[0], tmpl, b, level0, valid & ~tmpl.bad,
        max_iters=cfg.patch.subpix_max_iters,
        half_patch=cfg.patch.half_patch_size,
        conv_limit=cfg.patch.subpix_converged,
    )
    ok = valid & ~tmpl.bad & sp.converged
    m_b2 = cam_ops.unproject(cam, sp.pos_zero)
    eye = torch.eye(3, dtype=a.dtype, device=device)
    pos_w = triangulate.triangulate(
        eye.expand(T, 3, 3), torch.zeros(T, 3, dtype=a.dtype, device=device),
        R2.expand(T, 3, 3), t2.expand(T, 3), m_a, m_b2,
    )
    ok = ok & (pos_w[:, 2] > 0.0)  # (MapMaker.cc:313-316)

    res = mapmaker.EpipolarResult(success=ok, pos_w=pos_w, src_uv=a,
                                  target_uv=sp.pos_zero)
    sm, new_mask = mapmaker.insert_new_points(
        slam_map, cam, res, 0, 1, 0, cfg.tracker.max_map_points
    )
    # The second measurement is a trail match, not an epipolar one
    # (MapMaker.cc:331).
    meas = sm.meas
    fix = new_mask[:, None] & (meas.kf == 1) & meas.valid
    meas = meas.replace(source=torch.where(fix, SRC_TRAIL, meas.source))
    return sm.replace(meas=meas), torch.sum(ok.to(torch.int32))


# ---------------------------------------------------------------------------
# Bundle adjustment round (MapMaker.cc:776-960)
# ---------------------------------------------------------------------------


def _obs_mask_to_point_kf(obs_mask, meas_kf, K):
    """[N, O] measurement mask -> [N, K] point-keyframe mask."""
    out = torch.zeros(obs_mask.shape[0], K, dtype=torch.int32,
                      device=obs_mask.device)
    out.scatter_add_(1, torch.clamp(meas_kf.long(), 0, K - 1),
                     obs_mask.to(torch.int32))
    return out > 0


def ba_round(slam_map: SLAMMap, newest_kf, never_retry, failure_mask, cam,
             config: SLAMConfig, max_iters: int, assembly: str, solver: str,
             mode: str, cap: tuple = ()):
    """One BundleAdjustRecent (mode "local") or BundleAdjustAll ("global"):
    adjust-set selection, LM bundle adjustment, write-back and routing of
    the ejected measurements (MapMaker.cc:801-851, :917-959). Returns
    (slam_map, failure_mask, never_retry, converged, map_ok); the two
    scalars stay on the device.

    cap=(n_points, n_cams) runs the LM loop on the first n_points point
    slots and n_cams keyframe slots only, for a caller that knows the map
    to lie there (the bootstrap: two keyframes, and point slots fill lowest
    first). Whatever lies past the prefix (and a measurement of a prefix
    point by a keyframe past it) takes no part in that run and stays in
    the map as it was."""
    kfs = slam_map.keyframes
    if mode == "local":
        adjust = mapmaker.local_ba_adjust_mask(slam_map, newest_kf, config)
    elif mode == "global":
        adjust = kfs.valid & ~kfs.fixed
    else:
        raise ValueError(f"unknown bundle adjustment mode {mode!r}")
    prob = mapmaker.build_ba_problem(slam_map, adjust, config)
    bc = config.bundle
    N, K = prob.points.shape[0], kfs.n_slots
    cap_n, cap_k = cap if cap else (N, K)
    # What this run holds: valid measurements whose keyframe index names a
    # slot of the run (the JAX package clamps the index instead; a dead
    # slot may hold any), of points inside the run.
    held = prob.meas_valid & (prob.meas_kf >= 0) & (prob.meas_kf < cap_k)
    if cap:
        held = torch.cat([held[:cap_n], torch.zeros_like(held[cap_n:])])
    prob = prob.replace(meas_valid=held)
    prob_run = prob
    if cap:
        prob_run = bundle_mod.BAProblem(
            cam_R=prob.cam_R[:cap_k], cam_t=prob.cam_t[:cap_k],
            cam_fixed=prob.cam_fixed[:cap_k],
            cam_valid=prob.cam_valid[:cap_k],
            points=prob.points[:cap_n], point_valid=prob.point_valid[:cap_n],
            meas_kf=prob.meas_kf[:cap_n], meas_uv=prob.meas_uv[:cap_n],
            meas_sqrt_inv_noise=prob.meas_sqrt_inv_noise[:cap_n],
            meas_valid=held[:cap_n],
        )
    res = bundle_mod.bundle_adjust(
        prob_run, cam, max_iters=max_iters, point_block=bc.point_block,
        assembly=assembly, solver=solver, band_halfwidth=bc.band_halfwidth,
        cg_iters=bc.cg_iters, cg_tol=bc.cg_tol,
        update_conv=bc.update_convergence,
        min_sigma_sq=bc.min_tukey_sigma ** 2,
        lambda_init=bc.lambda_init, lambda_good=bc.lambda_good,
        lambda_factor_init=bc.lambda_factor_init,
    )
    if cap:
        # Back to full shapes: nothing past the prefix was held.
        def cat(a, b):
            return torch.cat([a, b], dim=0)

        rest = torch.zeros_like(held[cap_n:])
        res = res.replace(
            cam_R=cat(res.cam_R, prob.cam_R[cap_k:]),
            cam_t=cat(res.cam_t, prob.cam_t[cap_k:]),
            points=cat(res.points, prob.points[cap_n:]),
            meas_valid=cat(res.meas_valid, rest),
            outlier_meas=cat(res.outlier_meas, rest),
            point_outliers=cat(res.point_outliers,
                               rest[:, 0].to(res.point_outliers.dtype)),
        )
    sm, retry, never, _ = mapmaker.apply_ba_result(slam_map, prob, res,
                                                   config)
    failure_mask = failure_mask | _obs_mask_to_point_kf(retry, prob.meas_kf,
                                                        K)
    never_retry = never_retry | _obs_mask_to_point_kf(never, prob.meas_kf, K)
    map_ok = (torch.all(torch.isfinite(res.cam_t))
              & torch.all(torch.isfinite(res.points)))
    return sm, failure_mask, never_retry, res.converged, map_ok


# ---------------------------------------------------------------------------
# AddSomeMapPoints (MapMaker.cc:427-437), the target chosen on the device
# ---------------------------------------------------------------------------


def _add_map_points_body(slam_map: SLAMMap, new_points, cam, src_kf: int,
                         level: int, config: SLAMConfig):
    kfs = slam_map.keyframes
    d = mapmaker.keyframe_distances(kfs, kfs.R[src_kf], kfs.t[src_kf])
    d = torch.where(torch.arange(kfs.n_slots, device=d.device) == src_kf,
                    torch.inf, d)
    # Invalid slots and src_kf itself are at +inf: a finite minimum names a
    # valid keyframe other than src_kf. Otherwise everything is gated off.
    dmin, target = torch.min(d, dim=0)
    enabled = torch.isfinite(dmin)

    sm = mapmaker.thin_candidates(
        slam_map, src_kf, level, config.mapmaker.thin_candidates_radius
    )
    cand_xy, cand_ok = mapmaker.select_top_candidates(
        sm.keyframes.cand_xy[level][src_kf].to(kfs.t.dtype),
        sm.keyframes.cand_valid[level][src_kf] & enabled,
        config.mapmaker.max_epi_candidates,
    )
    res = mapmaker.epipolar_search_cands(sm, src_kf, target, cam, level,
                                         config, cand_xy, cand_ok)
    sm, new_mask = mapmaker.insert_new_points(
        sm, cam, res, src_kf, target, level,
        config.mapmaker.max_epi_candidates,
    )
    return sm, new_points | new_mask


def add_map_points_step(slam_map: SLAMMap, new_points, cam, src_kf: int,
                        level: int, config: SLAMConfig):
    """AddSomeMapPoints for keyframe `src_kf` (a host int) at `level`:
    thin its candidates, search the best of them along their epipolar
    lines in the nearest other keyframe, and insert the matches as new
    points. Returns (slam_map, new_points [N] with the new ones set)."""
    return _add_map_points_body(slam_map, new_points, cam, src_kf, level,
                                config)


# ---------------------------------------------------------------------------
# AddKeyFrameFromTopOfQueue (MapMaker.cc:481-506), first stage
# ---------------------------------------------------------------------------


def integrate_keyframe(slam_map: SLAMMap, new_points, never_retry,
                       failure_mask, frame: FrameData, R, t, found, found_pos,
                       level, subpix, slot: int, cam, config: SLAMConfig):
    """MakeKeyFrame_Rest + insertion into keyframe slot `slot` (a host int)
    + the tracker's measurements of this frame as SRC_TRACKER + the scene
    depth refresh + ReFindInSingleKeyFrame (MapMaker.cc:497). found,
    found_pos, level, subpix [N] are what track_map returned for the frame.

    The epipolar growth (AddSomeMapPoints at levels 3, 0, 1, 2) is not
    part of it: the facade runs each level as a mapping task of its own.
    The keyframe store is written IN PLACE (see keyframe.insert_keyframe).
    Returns (slam_map, new_points, never_retry, failure_mask)."""
    extras = kf_mod.make_frame_extras(frame, config)
    kf_mod.insert_keyframe(slam_map.keyframes, slot, frame, extras, R, t,
                           fixed=False)
    meas = mapmaker.add_measurements_batch(slam_map.meas, found, slot,
                                           found_pos, level, SRC_TRACKER,
                                           subpix)
    sm = kf_mod.refresh_scene_depth(slam_map.replace(meas=meas), slot)

    mask = sm.points.valid & ~never_retry[:, slot]
    sm, found_rf, never_new = mapmaker.refind_in_keyframe(sm, slot, cam, mask,
                                                          config)
    never_retry = never_retry.clone()
    never_retry[:, slot] |= never_new
    failure_mask = failure_mask.clone()
    failure_mask[:, slot] &= ~found_rf
    return sm, new_points, never_retry, failure_mask


# ---------------------------------------------------------------------------
# ReFindNewlyMade / ReFindFromFailureQueue (MapMaker.cc:1061-1095), budgeted:
# the pending (keyframe, point) pairs are compacted to at most
# refind_pair_budget per call (leftovers stay queued).
#
# n_kf (a host int) is the number of keyframe slots in use: slots fill in
# order and are never freed, so no pair names a later slot, and the work
# runs over the first n_kf rows only.
# ---------------------------------------------------------------------------


def _pending_pairs(slam_map: SLAMMap, point_mask_kn):
    """Fold point and keyframe validity and the existing observations into
    the [n, N] pending mask of the first n keyframe slots."""
    pts, kfs, meas = slam_map.points, slam_map.keyframes, slam_map.meas
    n = point_mask_kn.shape[0]
    k = torch.arange(n, device=meas.kf.device)
    already = torch.any(
        meas.valid[None] & (meas.kf[None] == k[:, None, None]), dim=-1)
    return (point_mask_kn & pts.live()[None] & ~already
            & kfs.valid[:n, None])


def _refind_pending_step(slam_map: SLAMMap, pending, cam,
                         config: SLAMConfig):
    """Search the first refind_pair_budget pairs of `pending` [n, N] in
    row-major order and insert what is found, keyframe by keyframe in slot
    order (slot allocation and eviction depend on that order). Returns
    (slam_map, processed [n, N], found [n, N]).

    The pairs are listed without a host read: a running count over the
    flattened mask ranks the pending pairs, and each of the first Q writes
    its flat index into its rank's entry; entries past the count hold 0
    and are not ok (jnp.nonzero's size / fill_value)."""
    n, N = pending.shape
    device = pending.device
    Q = min(config.mapmaker.refind_pair_budget, n * N)
    flat = pending.reshape(-1)
    rank = torch.cumsum(flat.to(torch.int32), 0) - 1
    spare = n * N
    idx = torch.zeros(Q + 1, dtype=torch.long, device=device)
    idx.scatter_(0, torch.where(flat & (rank < Q), rank, Q).long(),
                 torch.arange(n * N, device=device))
    idx = idx[:Q]
    pair_ok = torch.arange(Q, device=device) < torch.sum(flat)
    found_q, pos_q, lvl_q, sp_q = mapmaker.refind_pairs(
        slam_map, idx % N, idx // N, pair_ok, cam, config)

    dst = torch.where(pair_ok, idx, spare)

    def dense(val):
        out = torch.zeros((spare + 1,) + val.shape[1:], dtype=val.dtype,
                          device=device)
        return out.index_copy_(0, dst, val)[:spare].reshape(
            (n, N) + val.shape[1:])

    processed, found_kn = dense(pair_ok), dense(found_q)
    pos_kn, lvl_kn, sp_kn = dense(pos_q), dense(lvl_q), dense(sp_q)
    meas = slam_map.meas
    for k in range(n):
        meas = mapmaker.add_measurements_batch(meas, found_kn[k], k,
                                               pos_kn[k], lvl_kn[k],
                                               SRC_REFIND, sp_kn[k])
    return slam_map.replace(meas=meas), processed, found_kn


def refind_newly(slam_map: SLAMMap, new_points, never_retry, failure_mask,
                 cam, config: SLAMConfig, n_kf: int):
    """ReFindNewlyMade: search the new points [N] in the keyframes that do
    not observe them yet. A point leaves the new-point queue once no
    searchable pair of it remains; a pair searched and not found goes to
    never_retry; a pair found leaves the failure queue. Returns (slam_map,
    new_points, never_retry, failure_mask)."""
    n, N = n_kf, new_points.shape[0]
    pending = _pending_pairs(
        slam_map, new_points[None].expand(n, N) & ~never_retry[:, :n].T)
    sm, processed, found_kn = _refind_pending_step(slam_map, pending, cam,
                                                   config)
    remaining = pending & ~processed
    never_retry = never_retry.clone()
    never_retry[:, :n] |= (processed & ~found_kn).T
    failure_mask = failure_mask.clone()
    failure_mask[:, :n] &= ~found_kn.T
    return (sm, new_points & torch.any(remaining, dim=0), never_retry,
            failure_mask)


def refind_failures(slam_map: SLAMMap, never_retry, failure_mask, cam,
                    config: SLAMConfig, n_kf: int):
    """ReFindFromFailureQueue: search the failure queue's (point, keyframe)
    pairs. A searched pair leaves the queue whatever the outcome (bundle
    adjustment ejections fill it again) and goes to never_retry if not
    found; a pair that cannot be searched (dead point, already observed,
    never-retry) is dropped; only pairs over the budget stay queued.
    Returns (slam_map, never_retry, failure_mask)."""
    n = n_kf
    pending = _pending_pairs(
        slam_map, failure_mask[:, :n].T & ~never_retry[:, :n].T)
    sm, processed, found_kn = _refind_pending_step(slam_map, pending, cam,
                                                   config)
    never_retry = never_retry.clone()
    never_retry[:, :n] |= (processed & ~found_kn).T
    queued = torch.zeros_like(failure_mask)
    queued[:, :n] = (pending & ~processed).T
    return sm, never_retry, queued
