"""Per-frame tracking: PVS projection, coarse/fine patch search, robust
Gauss-Newton pose update, motion model, SBI rotation prior, quality
assessment.

Port of the JAX package's ``models/tracker.py`` (the reference's
jni/Tracker.cc): PVS construction (Tracker.cc:369-392), the coarse stage
(:404-490), the fine stage (:495-577), CalcPoseUpdate (:683-774, Tukey
with MAD sigma, prior 100), the decaying-velocity motion model (:781-820),
AssessTrackingQuality (:832-878) and CalcSBIRotation (:885-893).

As in the JAX package, track_map runs over all N point slots with masks;
the random coarse subset and fine budget are chosen by random priorities.
Those two uniform draws (JAX's ``jax.random.uniform`` at the same points)
come from the caller: either as ``uniforms=(rand_pri, rand2)`` or from the
caller's ``torch.Generator``. Selection sorts are stable, so ties go to the
lower slot index as ``lax.top_k`` / ``jnp.argsort`` break them. No step
reads a device value back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models.map_store import FrameData, SLAMMap
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import lie, match
from visualslam_android_tpu_torch.ops import mestimator as me
from visualslam_android_tpu_torch.ops import sbi as sbi_ops
from visualslam_android_tpu_torch.utils.tensors import TensorTree

N_LEVELS = 4

QUALITY_GOOD = 2
QUALITY_DODGY = 1
QUALITY_BAD = 0


@dataclasses.dataclass(frozen=True)
class TrackOutputs(TensorTree):
    R: torch.Tensor              # [3, 3] updated camera-from-world
    t: torch.Tensor              # [3]
    found: torch.Tensor          # [N] measurement success per point slot
    found_pos: torch.Tensor      # [N, 2] level-0 positions
    search_level: torch.Tensor   # [N] int32
    did_subpix: torch.Tensor     # [N]
    attempted_per_level: torch.Tensor  # [4] int32
    found_per_level: torch.Tensor      # [4] int32
    inlier_inc: torch.Tensor     # [N] int32
    outlier_inc: torch.Tensor    # [N] int32
    scene_depth_mean: torch.Tensor
    scene_depth_sigma: torch.Tensor
    depth_stats_valid: torch.Tensor  # [] bool (>20 found, Tracker.cc:619)
    did_coarse: torch.Tensor     # [] bool


def _to_cam(R, t, pts_w):
    return pts_w @ R.T + t


def project_points(cam, pts_w, R, t, image_size):
    """Batched TrackerData::Project (jni/TrackerData.h:69-95)."""
    return project_camera_points(cam, _to_cam(R, t, pts_w), image_size)


def project_camera_points(cam, pc, image_size):
    """project_points from camera-frame points pc [N, 3]: (pc, pixel,
    projection derivatives, in front, within the lens radius and inside
    the image)."""
    z_ok = pc[:, 2] > 0.001
    safe_z = torch.where(z_ok, pc[:, 2], 1.0)
    m = pc[:, :2] / safe_z[:, None]
    radius = cam_ops.largest_radius_in_image(cam)
    r_ok = torch.sum(m * m, dim=-1) <= radius * radius
    px, derivs = cam_ops.project_derivs(cam, m)
    in_img = ((px[:, 0] >= 0) & (px[:, 1] >= 0)
              & (px[:, 0] <= image_size[0]) & (px[:, 1] <= image_size[1]))
    return pc, px, derivs, z_ok & r_ok & in_img


def _project_guarded(cam, R, t, pts_w):
    """Projection with z guarded to 1 where z <= 1e-6 (the GN loops)."""
    pc = _to_cam(R, t, pts_w)
    safe_z = torch.where(pc[:, 2] > 1e-6, pc[:, 2], 1.0)
    px, derivs = cam_ops.project_derivs(cam, pc[:, :2] / safe_z[:, None])
    return pc, px, derivs


def _point_jacobian(pc, derivs):
    """Batched TrackerData::CalcJacobian (jni/TrackerData.h:104-132):
    d pixel / d mu for mu = [trans(3), rot(3)]; z guarded so empty slots
    at the camera center cannot produce inf."""
    safe_z = torch.where(torch.abs(pc[:, 2]) > 1e-6, pc[:, 2], 1.0)
    inv_z = 1.0 / safe_z
    x, y, z = pc[:, 0], pc[:, 1], safe_z
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    motions = [
        (one, zero, zero), (zero, one, zero), (zero, zero, one),
        (zero, -z, y), (z, zero, -x), (-y, x, zero),
    ]
    cols = []
    for mx, my, mz in motions:
        dm = torch.stack([(mx - x * mz * inv_z) * inv_z,
                          (my - y * mz * inv_z) * inv_z], dim=-1)
        cols.append((derivs @ dm[..., None])[..., 0])
    return torch.stack(cols, dim=-1)  # [N, 2, 6]


def _search_multi_level(frame: FrameData, templates, pred_zero,
                        search_level, active, radius_zero, max_range: int,
                        subpix_mask, subpix_iters: int, subpix_conv=0.03):
    """Coarse ZMSSD + subpixel over all four search levels
    (SearchForPoints, Tracker.cc:629-674)."""
    res = match.find_patch_coarse_multilevel(
        frame.pyramid, frame.corner_mask, templates, pred_zero,
        search_level, radius_zero, active, max_range=max_range,
    )
    found = res.found
    pos_zero = torch.where(active[:, None], res.pos_level, pred_zero)
    did_subpix = torch.zeros_like(found)
    if subpix_iters > 0:
        sres = match.iterate_subpix_multilevel(
            frame.pyramid, templates, pos_zero, search_level,
            active & found & subpix_mask, max_iters=subpix_iters,
            conv_limit=subpix_conv,
        )
        # Subpix failure voids the measurement (Tracker.cc:661-666).
        attempted = found & subpix_mask
        found = torch.where(attempted, sres.converged, found)
        did_subpix = attempted & sres.converged
        pos_zero = torch.where(did_subpix[:, None], sres.pos_zero, pos_zero)
    return found, pos_zero, did_subpix


def _calc_pose_update(err, jac, sqrt_inv_noise, found, override_sigma: float,
                      prior=100.0):
    """CalcPoseUpdate (Tracker.cc:683-774): err [N, 2] = found - image
    position, jac [N, 2, 6]. Tukey weights with MAD sigma, or the fixed
    sigma^2 `override_sigma` when it is > 0; WLS with a diagonal prior.
    Returns (update [6], weights [N])."""
    e_scaled = err * sqrt_inv_noise[:, None]
    err_sq = torch.sum(e_scaled * e_scaled, dim=-1)
    if override_sigma > 0:
        sigma_sq = torch.full_like(err_sq[0], override_sigma)
    else:
        sigma_sq = me.find_sigma_squared(err_sq, found, me.TUKEY)
    w = me.weight(err_sq, torch.clamp(sigma_sq, min=1e-12), me.TUKEY)
    w = torch.where(found, w, 0.0)
    Js = jac * sqrt_inv_noise[:, None, None]  # [N, 2, 6]
    Jw = (Js * w[:, None, None]).reshape(-1, 6)
    A = Jw.T @ Js.reshape(-1, 6)
    b = Jw.T @ e_scaled.reshape(-1)
    A = A + prior * torch.eye(6, dtype=err.dtype, device=err.device)
    update = torch.linalg.solve_ex(A, b)[0]
    update = torch.where(torch.any(found), update, 0.0)
    return update, w


def _stable_desc(key):
    """Indices sorting `key` descending; ties keep the lower index first
    (the tie order of lax.top_k)."""
    return torch.sort(key, descending=True, stable=True).indices


def track_map(frame: FrameData, slam_map: SLAMMap, cam, R, t,
              velocity_msd_mag, config: SLAMConfig, recovered: bool = False,
              uniforms=None, generator=None) -> TrackOutputs:
    """TrackMap (Tracker.cc:358-626) over all point slots.

    uniforms: optional (rand_pri [N], rand2 [N]) in [0, 1), the coarse
    and fine selection priorities; drawn from `generator` when absent.
    """
    tc = config.tracker
    pts = slam_map.points
    N = pts.n_slots
    dtype, device = R.dtype, R.device
    image_size = (float(tc.width), float(tc.height))
    if uniforms is None:
        uniforms = tuple(
            torch.rand(N, generator=generator, dtype=dtype, device=device)
            for _ in range(2)
        )
    rand_pri, rand2 = uniforms

    live = pts.live()

    # ---- PVS (Tracker.cc:369-392) ----
    pc, px, derivs, proj_ok = project_points(cam, pts.pos_w, R, t,
                                             image_size)
    motion_right = pts.pixel_right_w @ R.T
    motion_down = pts.pixel_down_w @ R.T
    warp_inv, search_level, warp_ok = match.calc_search_level_and_warp(
        pc, motion_right, motion_down, derivs,
        det_lo=config.patch.warp_det_lo, det_hi=config.patch.warp_det_hi,
    )
    pvs = live & proj_ok & warp_ok
    sqrt_inv_noise = 1.0 / (2.0 ** search_level.to(dtype))

    # ---- Coarse set selection (Tracker.cc:423-466) ----
    coarse_max = tc.coarse_max * (2 if recovered else 1)
    coarse_range = tc.coarse_range * (2 if recovered else 1)
    high = pvs & (search_level >= N_LEVELS - 2)
    n_high = torch.sum(high)
    # Rank: level 3 before level 2, then random (Tracker.cc:437-460).
    rank_key = torch.where(
        high, (search_level == N_LEVELS - 1).to(dtype) + rand_pri * 0.999,
        -1.0,
    )
    C = min(coarse_max, N)
    top_idx = _stable_desc(rank_key)[:C]
    try_coarse = (
        ((velocity_msd_mag >= tc.coarse_min_velocity) & (not tc.disable_coarse))
        | recovered
    ) & (n_high > tc.coarse_min)
    # Out-of-place writes throughout, so the function also runs under
    # torch.func.vmap (parallel/replicated_tracking.stream_step).
    coarse_sel = torch.zeros(N, dtype=torch.bool, device=device).index_fill(
        0, top_idx, True)
    coarse_sel = coarse_sel & high & try_coarse

    # ---- Fine set selection (Tracker.cc:495-538) ----
    top_level = pvs & (search_level == N_LEVELS - 1) & ~coarse_sel
    rest = pvs & (search_level < N_LEVELS - 1) & ~coarse_sel
    n_so_far = torch.sum(coarse_sel) + torch.sum(top_level)
    budget = torch.clamp(tc.max_patches_per_frame - n_so_far, min=0)
    rest_key = torch.where(rest, rand2, -1.0)
    order = torch.sort(-rest_key, stable=True).indices
    rank_of = torch.empty(N, dtype=torch.long, device=device).scatter(
        0, order, torch.arange(N, device=device))
    f_active = top_level | (rest & (rank_of < budget))

    # Compact the fine set into F lanes (actives first, random order).
    F = min(N, -(-(tc.max_patches_per_frame + 256) // 256) * 256)
    fine_lane_key = torch.where(f_active, 1.0 + rand2, rand2 - 2.0)
    fine_idx = _stable_desc(fine_lane_key)[:F]
    f_lane_on = f_active[fine_idx]

    # ---- Templates for the C + F searched lanes ----
    u_idx = torch.cat([top_idx, fine_idx])
    templates_u = match.make_templates_warped_multilevel(
        slam_map.keyframes.pyramid, pts.source_kf[u_idx],
        pts.source_level[u_idx], pts.center[u_idx],
        warp_inv[u_idx], search_level[u_idx], 5,
    )
    c_templates = templates_u.lanes(slice(0, C))
    f_templates = templates_u.lanes(slice(C, None))

    # ---- Coarse search + 10 GN iterations (Tracker.cc:462-490) ----
    c_lane_sel = coarse_sel[top_idx]
    cc_found, cc_pos, cc_subpix = _search_multi_level(
        frame, c_templates, px[top_idx], search_level[top_idx], c_lane_sel,
        torch.full((C,), float(coarse_range), dtype=dtype, device=device),
        coarse_range, torch.ones(C, dtype=torch.bool, device=device),
        tc.coarse_sub_pix_its, subpix_conv=config.patch.subpix_converged,
    )
    cc_found = cc_found & c_lane_sel & ~c_templates.bad
    did_coarse = try_coarse & (torch.sum(cc_found) >= tc.coarse_min)

    pos_w_c = pts.pos_w[top_idx]
    sin_c = sqrt_inv_noise[top_idx]
    coarse_mask = cc_found & did_coarse
    R1, t1 = R, t
    for i in range(tc.pose_update_iters):
        pc_i, px_i, derivs_i = _project_guarded(cam, R1, t1, pos_w_c)
        upd, _ = _calc_pose_update(
            cc_pos - px_i, _point_jacobian(pc_i, derivs_i), sin_c,
            coarse_mask, 1.0 if i > 5 else 0.0, prior=tc.pose_prior,
        )
        dR, dt = lie.se3_exp(upd)
        R1, t1 = lie.se3_mul(dR, dt, R1, t1)

    # ---- Fine search on the F lanes (Tracker.cc:495-538) ----
    fine_range = torch.where(did_coarse, float(tc.fine_range_rest),
                             float(tc.fine_range_top)).to(dtype)
    pos_w_u = pts.pos_w[u_idx]
    sin_u = sqrt_inv_noise[u_idx]
    level_u = search_level[u_idx]
    # Re-project the searched lanes at the post-coarse pose.
    pc2_u, px2_u, derivs2_u = _project_guarded(cam, R1, t1, pos_w_u)
    subpix_lane = f_lane_on
    if not tc.subpix_all_levels:
        subpix_lane = f_lane_on & (level_u[C:] == N_LEVELS - 1)
    f_found, f_pos, f_subpix = _search_multi_level(
        frame, f_templates, px2_u[C:], level_u[C:], f_lane_on,
        torch.where(f_lane_on, fine_range, 0.0),
        tc.fine_range_top, subpix_lane, 8,  # 8 its (Tracker.cc:505)
        subpix_conv=config.patch.subpix_converged,
    )
    f_found = f_found & f_lane_on & ~f_templates.bad

    in_set_u = torch.cat([c_lane_sel, f_lane_on])
    found_u = torch.cat([cc_found, f_found])
    found_pos_u = torch.cat([cc_pos, f_pos], dim=0)

    # ---- Fine 10 GN iterations with linear updates (Tracker.cc:543-577) --
    Rf, tf = R1, t1
    v_image = px2_u
    jac = _point_jacobian(pc2_u, derivs2_u)
    last_update = torch.zeros(6, dtype=dtype, device=device)
    inlier_inc_u = outlier_inc_u = None
    n_it = tc.pose_update_iters
    for it in range(n_it):
        if it != 0:
            if it in (4, n_it - 1):  # nonlinear reprojection
                pc_i, v_image, derivs_i = _project_guarded(cam, Rf, tf,
                                                           pos_w_u)
                jac = _point_jacobian(pc_i, derivs_i)
            else:
                v_image = v_image + (jac @ last_update)
        upd, w = _calc_pose_update(
            found_pos_u - v_image, jac, sin_u, found_u,
            16.0 if it > 5 else 0.0, prior=tc.pose_prior,
        )
        if it == n_it - 1:
            outlier_inc_u = (found_u & (w == 0.0)).to(torch.int32)
            inlier_inc_u = (found_u & (w > 0.0)).to(torch.int32)
        dR, dt = lie.se3_exp(upd)
        Rf, tf = lie.se3_mul(dR, dt, Rf, tf)
        last_update = upd

    # ---- Accounting (attempted/found per level; Tracker.cc:645-656) ----
    attempted_u = in_set_u & ~templates_u.bad
    levels = torch.arange(N_LEVELS, device=device)
    at_level = level_u[None, :] == levels[:, None]  # [4, U]
    att_l = torch.sum(attempted_u[None] & at_level, dim=-1).to(torch.int32)
    fnd_l = torch.sum(found_u[None] & at_level, dim=-1).to(torch.int32)

    # ---- Scene depth from tracked features (Tracker.cc:609-625) ----
    zf = _to_cam(Rf, tf, pos_w_u)[:, 2]
    wf = found_u.to(dtype)
    nf = torch.sum(wf)
    mean = torch.sum(wf * zf) / torch.clamp(nf, min=1.0)
    sq = torch.sum(wf * zf * zf) / torch.clamp(nf, min=1.0)
    sigma = torch.sqrt(torch.clamp(sq - mean * mean, min=1e-12))

    # ---- Scatter lane results back to the N point slots ----
    # The blocks' active sets are disjoint on points (fine excludes
    # coarse_sel; without try_coarse the coarse block is inactive).
    def scatter(base, val_c, val_f):
        out = base
        for idx, val, on in ((fine_idx, val_f, f_lane_on),
                             (top_idx, val_c, c_lane_sel)):
            cur = out[idx]
            m = on if cur.dim() == 1 else on[:, None]
            out = out.index_put((idx,), torch.where(m, val, cur))
        return out

    zeros_b = torch.zeros(N, dtype=torch.bool, device=device)
    zeros_i = torch.zeros(N, dtype=torch.int32, device=device)
    return TrackOutputs(
        R=Rf, t=tf,
        found=scatter(zeros_b, cc_found, f_found),
        found_pos=scatter(px, cc_pos, f_pos),
        search_level=search_level,
        did_subpix=scatter(zeros_b, cc_subpix & cc_found, f_subpix),
        attempted_per_level=att_l, found_per_level=fnd_l,
        inlier_inc=scatter(zeros_i, inlier_inc_u[:C], inlier_inc_u[C:]),
        outlier_inc=scatter(zeros_i, outlier_inc_u[:C], outlier_inc_u[C:]),
        scene_depth_mean=mean, scene_depth_sigma=sigma,
        depth_stats_valid=nf > 20,
        did_coarse=did_coarse,
    )


# ---------------------------------------------------------------------------
# Motion model + SBI prior + quality
# ---------------------------------------------------------------------------


def apply_motion_model(R, t, velocity, sbi_rot, use_sbi):
    """ApplyMotionModel (Tracker.cc:781-798): pose <- exp(v) * pose, with
    the SBI rotation replacing the rotational velocity (and zeroing the
    in-plane translation) when use_sbi: a Python bool, or a bool tensor
    chosen on the device (a stream's first frame has no SBI prior)."""
    v = torch.cat([torch.zeros_like(velocity[:2]), velocity[2:3],
                   sbi_rot[3:]])
    if isinstance(use_sbi, torch.Tensor):
        v = torch.where(use_sbi, v, velocity)
    elif not use_sbi:
        v = velocity
    dR, dt = lie.se3_exp(v)
    return lie.se3_mul(dR, dt, R, t)


def update_motion_model(R_new, t_new, R_start, t_start, velocity,
                        scene_depth_mean, decay=0.9):
    """UpdateMotionModel (Tracker.cc:802-820): v <- decay * (0.5 motion +
    0.5 v); returns (velocity, |v|, scene-depth-scaled |v|)."""
    Ri, ti = lie.se3_inverse(R_start, t_start)
    Rm, tm = lie.se3_mul(R_new, t_new, Ri, ti)
    v = decay * (0.5 * lie.se3_ln(Rm, tm) + 0.5 * velocity)
    inv_depth = 1.0 / torch.clamp(scene_depth_mean, min=1e-6)
    v_scaled = torch.cat([v[:3] * inv_depth, v[3:]])
    return (v, torch.linalg.vector_norm(v),
            torch.linalg.vector_norm(v_scaled))


def calc_sbi_rotation(sbi_cur_template, sbi_last: sbi_ops.SBI,
                      cam: cam_ops.Camera, n_iters=6):
    """CalcSBIRotation (Tracker.cc:885-893): ESM-align this frame's SBI to
    the last frame's and lift the SE(2) to a rotation; returns mu [6]."""
    se2, _ = sbi_ops.esm_align(sbi_cur_template, sbi_last, n_iters)
    Rr, tr = sbi_ops.se3_from_se2(se2, cam, tuple(sbi_cur_template.shape))
    return lie.se3_ln(Rr, tr)


def assess_tracking_quality(attempted_per_level, found_per_level,
                            quality_good=0.3, quality_lost=0.13):
    """AssessTrackingQuality (Tracker.cc:832-878), without the
    distance-to-map check. Returns the int quality code."""
    ta = torch.sum(attempted_per_level)
    tf = torch.sum(found_per_level)
    la = torch.sum(attempted_per_level[2:])
    lf = torch.sum(found_per_level[2:])
    frac = tf / torch.clamp(ta, min=1)
    lfrac = torch.where(la > 10, lf / torch.clamp(la, min=1), frac)
    bad = (tf == 0) | (ta == 0) | (lfrac < quality_lost)
    return torch.where(bad, QUALITY_BAD,
                       torch.where(frac > quality_good, QUALITY_GOOD,
                                   QUALITY_DODGY))
