"""Map construction and maintenance: what the tracking step, the stereo
bootstrap and bundle adjustment run.

Port of parts of the JAX package's ``models/mapmaker.py`` (the reference's
jni/MapMaker.cc): keyframe distances and the keyframe-need tests
(:705-773, :1098-1101), HandleBadPoints (:140-164), batched measurement
insertion, ThinCandidates (:393-422), the batched epipolar search
(AddPointEpipolar, :525-703), packing of new points into free slots, the
global map transforms (:440-467), CalcPlaneAligner (:1104-1231) and the
bundle-adjustment glue (:776-960: problem construction, the local adjust
set, write-back with outlier routing) and ReFind (:967-1095: over an
explicit (point, keyframe) pair list, over all points in one keyframe,
the one-keyframe search core a point shard runs, and the all-keyframes
oracle).

Functions here return new stores and leave their inputs as they were,
except where a docstring says IN PLACE.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models import bundle as bundle_mod
from visualslam_android_tpu_torch.models import keyframe as kf_mod
from visualslam_android_tpu_torch.models import map_store, triangulate
from visualslam_android_tpu_torch.models import tracker as tracker_mod
from visualslam_android_tpu_torch.models.map_store import (
    SRC_EPIPOLAR,
    SRC_REFIND,
    SRC_ROOT,
    SRC_TRACKER,
    SLAMMap,
)
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import image as img_ops
from visualslam_android_tpu_torch.ops import lie, match
from visualslam_android_tpu_torch.ops.levels import level_scale, level_zero_pos
from visualslam_android_tpu_torch.utils.tensors import TensorTree, const

# Per-row capacity of the epipolar search's target-corner list (the
# fixed-shape analog of the reference's vCornerRowLUT,
# jni/KeyFrame.cc:43-49): an image row with more corners keeps its first
# 32 by x. The epipolar band is a few level-pixels wide, so a line crosses
# a row in a handful of pixels and 32 kept corners hold every plausible
# match.
EPI_CORNERS_PER_ROW = 32


def _slot_index(idx, device):
    """A keyframe slot given as a host int or a 0-d tensor -> a [1] long
    tensor for index_select. Indexing with a 0-d CUDA tensor would read it
    back to the host; this does not."""
    if isinstance(idx, torch.Tensor):
        return idx.reshape(1).long()
    return const((idx,), device, torch.long)


def _slot(x, idx):
    """x[idx] for a slot index made by _slot_index."""
    return x.index_select(0, idx)[0]


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
# ThinCandidates (MapMaker.cc:393-422)
# ---------------------------------------------------------------------------


def _disk(radius: int, device, dtype):
    """[1, 1, 2r-1, 2r-1] kernel of ones where dx^2 + dy^2 < r^2."""
    o = torch.arange(-(radius - 1), radius, device=device)
    return ((o[:, None] ** 2 + o[None, :] ** 2) < radius * radius).to(
        dtype)[None, None]


def thin_candidates(slam_map: SLAMMap, kf_idx: int, level: int, radius=10):
    """Clear the candidate slots of keyframe `kf_idx` at `level` that lie
    within `radius` (level pixels) of a measurement of that keyframe at
    the same or the next-higher level: strictly dx^2 + dy^2 < radius^2 on
    rounded positions, the reference's squared-distance test
    (MapMaker.cc:404-416).

    The busy positions are marked in a level-sized mask, the mask is
    dilated by the disk (one convolution of 0/1 values, exact in f32) and
    read at the candidates. Returns a new map; the input keeps its
    candidate masks."""
    kfs, meas = slam_map.keyframes, slam_map.meas
    H, W = kfs.pyramid[level].shape[-2:]
    busy = (meas.valid & (meas.kf == kf_idx)
            & ((meas.level == level) | (meas.level == level + 1)))  # [N, O]
    xy = torch.round(meas.uv / level_scale(level)).long()
    bx, by = torch.clamp(xy[..., 0], min=0), torch.clamp(xy[..., 1], min=0)
    # Positions off the level mark nothing: they go to one spare element.
    inside = busy & (bx < W) & (by < H)
    flat = torch.zeros(H * W + 1, dtype=kfs.R.dtype, device=busy.device)
    flat.index_fill_(0, torch.where(inside, by * W + bx, H * W).reshape(-1),
                     1.0)
    r = int(radius)
    near = F.conv2d(flat[:H * W].view(1, 1, H, W),
                    _disk(r, flat.device, flat.dtype), padding=r - 1)[0, 0]
    cand = kfs.cand_xy[level][kf_idx].long()  # [C, 2]
    blocked = near[torch.clamp(cand[:, 1], 0, H - 1),
                   torch.clamp(cand[:, 0], 0, W - 1)] > 0.5
    cv = list(kfs.cand_valid)
    cv[level] = cv[level].clone()
    cv[level][kf_idx] = cv[level][kf_idx] & ~blocked
    return slam_map.replace(keyframes=kfs.replace(cand_valid=tuple(cv)))


# ---------------------------------------------------------------------------
# New points from two-view matches (MapMaker.cc:262-339, :648-703)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpipolarResult(TensorTree):
    success: torch.Tensor    # [C] bool
    pos_w: torch.Tensor      # [C, 3] triangulated world position
    src_uv: torch.Tensor     # [C, 2] level-0 position in the source KF
    target_uv: torch.Tensor  # [C, 2] level-0 position in the target KF


def select_top_candidates(cand_xy, cand_ok, max_n: int):
    """The `max_n` best valid candidates as a fixed slab. Candidate slots
    are stored in descending Shi-Tomasi order, so a stable valid-first sort
    keeps that ranking. It bounds the epipolar search's C axis before the
    search: insert_new_points takes max_epi_candidates successes at most."""
    if cand_ok.shape[0] <= max_n:
        return cand_xy, cand_ok
    order = torch.sort((~cand_ok).to(torch.int8), stable=True)[1][:max_n]
    return cand_xy[order], cand_ok[order]


def epipolar_search(slam_map: SLAMMap, src_kf, target_kf, cam, level: int,
                    config: SLAMConfig) -> EpipolarResult:
    """Batched epipolar point search: the best valid candidates of src_kf
    at `level` (max_epi_candidates at most) against the corners of
    target_kf at the same level."""
    kfs = slam_map.keyframes
    src = _slot_index(src_kf, kfs.t.device)
    cand_xy, cand_ok = select_top_candidates(
        _slot(kfs.cand_xy[level], src).to(kfs.t.dtype),
        _slot(kfs.cand_valid[level], src),
        config.mapmaker.max_epi_candidates,
    )
    return epipolar_search_cands(slam_map, src_kf, target_kf, cam, level,
                                 config, cand_xy, cand_ok)


def _row_corner_list(cm, per_row: int):
    """The first `per_row` set pixels of each row of the mask cm [H, W], by
    x: (cx [H*B], cy [H*B], corner_ok [H*B]) with B = min(per_row, W). A
    running count along the row ranks the corners; each kept corner writes
    its x into its rank's column and every other pixel into a spare column,
    so nothing is sorted and nothing is read back. Slots past a row's count
    hold x = 0 and are not ok."""
    H, W = cm.shape
    B = min(per_row, W)
    device = cm.device
    rank = torch.cumsum(cm.to(torch.int32), dim=1) - 1
    col = torch.where(cm & (rank < B), rank, B).long()
    xs = torch.arange(W, device=device).expand(H, W)
    cx = torch.zeros(H, B + 1, dtype=torch.long, device=device)
    cx.scatter_(1, col, xs)
    cx = cx[:, :B].reshape(-1)
    cy = torch.arange(H, device=device)[:, None].expand(H, B).reshape(-1)
    count = torch.sum(cm, dim=1)
    corner_ok = (torch.arange(B, device=device)[None] < count[:, None])
    return cx, cy, corner_ok.reshape(-1)


def epipolar_search_cands(slam_map: SLAMMap, src_kf, target_kf, cam,
                          level: int, config: SLAMConfig, cand_xy,
                          cand_ok) -> EpipolarResult:
    """epipolar_search over an explicit candidate slab cand_xy [C, 2]
    (level coords, float), cand_ok [C]. src_kf and target_kf are host ints
    or 0-d tensors."""
    mc, pc_cfg = config.mapmaker, config.patch
    kfs = slam_map.keyframes
    dtype, device = kfs.t.dtype, kfs.t.device
    scale = level_scale(level)
    src, tgt = _slot_index(src_kf, device), _slot_index(target_kf, device)

    C = cand_xy.shape[0]
    root = level_zero_pos(cand_xy, level)  # [C, 2] level-0
    Rs, ts = _slot(kfs.R, src), _slot(kfs.t, src)
    Rt, tt = _slot(kfs.R, tgt), _slot(kfs.t, tgt)

    # Source rays (normalized) rotated into the target camera.
    m_src = cam_ops.unproject(cam, root)
    ray_sc = torch.cat([m_src, torch.ones(C, 1, dtype=dtype, device=device)],
                       dim=-1)
    ray_sc = ray_sc / torch.linalg.vector_norm(ray_sc, dim=-1, keepdim=True)
    line_dir = ray_sc @ (Rt @ Rs.T).T

    # Depth range clamp (MapMaker.cc:552-568).
    d_mean = _slot(kfs.depth_mean, src)
    d_sigma = _slot(kfs.depth_sigma, src)
    start_d = torch.clamp(d_mean - d_sigma, min=mc.wiggle_scale)
    end_d = torch.clamp(d_mean + d_sigma,
                        max=mc.epipolar_depth_max_factor * mc.wiggle_scale)
    cam_center_tc = Rt @ -(Rs.T @ ts) + tt
    ray_start = cam_center_tc[None] + start_d * line_dir
    ray_end = cam_center_tc[None] + end_d * line_dir

    ok = (cand_ok & (ray_end[:, 2] > ray_start[:, 2])
          & (ray_end[:, 2] > 0.0))
    # Nudge starts behind the camera (MapMaker.cc:577-579).
    need_nudge = ray_start[:, 2] <= 0.0
    safe_dz = torch.where(torch.abs(line_dir[:, 2]) < 1e-12, 1e-12,
                          line_dir[:, 2])
    nudge = (0.001 - ray_start[:, 2]) / safe_dz
    ray_start = torch.where(need_nudge[:, None],
                            ray_start + line_dir * nudge[:, None], ray_start)

    a2 = ray_start[:, :2] / ray_start[:, 2:3]
    b2 = ray_end[:, :2] / ray_end[:, 2:3]
    along = a2 - b2
    seg_len_sq = torch.sum(along * along, dim=-1)
    ok = ok & (seg_len_sq >= 1e-8)
    along = along / torch.sqrt(torch.clamp(seg_len_sq, min=1e-20))[:, None]
    normal = torch.stack([along[:, 1], -along[:, 0]], dim=-1)
    norm_dist = torch.sum(a2 * normal, dim=-1)
    ok = ok & (torch.abs(norm_dist) <= cam_ops.largest_radius_in_image(cam))
    proj_a = torch.sum(along * a2, dim=-1)
    proj_b = torch.sum(along * b2, dim=-1)
    min_len = torch.clamp(torch.minimum(proj_a, proj_b) - 0.05, -2.0, 2.0)
    max_len = torch.clamp(torch.maximum(proj_a, proj_b) + 0.05, -2.0, 2.0)

    # Templates: no-warp patches at the candidates (MapMaker.cc:604-609).
    hp = pc_cfg.half_patch_size
    tmpl = match.make_templates_nowarp(kfs.pyramid[level], src.expand(C),
                                       cand_xy, hp)
    ok = ok & ~tmpl.bad

    # Target corners: a list capped per image row (the reference scans the
    # corners near the line, MapMaker.cc:527-540, :611-634). Each corner's
    # patch is gathered once; the candidate x corner cross term is one
    # [C, P^2] x [P^2, M] product, and the epipolar band a [C, M] mask.
    img_t = _slot(kfs.pyramid[level], tgt)
    H, W = img_t.shape
    n_pix = (2 * hp + 1) ** 2
    # A ZMSSD patch must lie inside the image: interior corners only.
    cm = torch.zeros(H, W, dtype=torch.bool, device=device)
    cm[hp:H - hp, hp:W - hp] = _slot(kfs.corner_mask[level],
                                     tgt)[hp:H - hp, hp:W - hp]
    cx, cy, corner_ok = _row_corner_list(cm, EPI_CORNERS_PER_ROW)

    czero = level_zero_pos(torch.stack([cx, cy], dim=-1).to(dtype), level)
    implane_m = cam_ops.unproject(cam, czero)  # [M, 2]
    dist_diff = norm_dist[:, None] - normal @ implane_m.T
    max_dd = cam_ops.one_pixel_dist(cam) * (4.0 + 1.0 * scale)
    along_proj = along @ implane_m.T
    band = ((dist_diff * dist_diff <= max_dd * max_dd)
            & (along_proj >= min_len[:, None])
            & (along_proj <= max_len[:, None]) & corner_ok[None])  # [C, M]

    # ZMSSD by expansion: sum I^2 + sum T^2 - 2 I.T - (sum T - sum I)^2/n.
    # The corners are interior, so the sums over their gathered patches are
    # the image's window sums there.
    r = torch.arange(-hp, hp + 1, device=device)
    patches = img_t[(cy[:, None, None] + r[None, :, None]).clamp(0, H - 1),
                    (cx[:, None, None] + r[None, None, :]).clamp(0, W - 1)]
    patches = patches.reshape(-1, n_pix)  # [M, P^2]
    sum_m = torch.sum(patches, dim=1)
    sumsq_m = torch.sum(patches * patches, dim=1)
    cross = tmpl.data.reshape(C, -1) @ patches.T
    ssd = (sumsq_m[None] + tmpl.t_sumsq[:, None] - 2.0 * cross
           - (tmpl.t_sum[:, None] - sum_m[None]) ** 2 / n_pix)
    ssd = torch.where(band & ok[:, None], ssd, torch.inf)
    best_ssd, best = torch.min(ssd, dim=1)  # [C]
    ok = ok & (best_ssd < pc_cfg.max_ssd_per_pixel * n_pix)
    best_zero = level_zero_pos(
        torch.stack([cx[best], cy[best]], dim=-1).to(dtype), level)

    # Subpixel refinement in the target (MapMaker.cc:636-646).
    sp = match.iterate_subpix(
        img_t, tmpl, best_zero,
        torch.full((C,), level, dtype=torch.int32, device=device), ok,
        max_iters=pc_cfg.subpix_max_iters, half_patch=hp,
        conv_limit=pc_cfg.subpix_converged,
    )
    ok = ok & sp.converged

    # Triangulate from both world poses; the point must lie in front of
    # both cameras (as MapMaker.cc:313-316 asks of the stereo init).
    m_t = cam_ops.unproject(cam, sp.pos_zero)
    Rs_b, ts_b = Rs.expand(C, 3, 3), ts.expand(C, 3)
    Rt_b, tt_b = Rt.expand(C, 3, 3), tt.expand(C, 3)
    pos_w = triangulate.triangulate(Rs_b, ts_b, Rt_b, tt_b, m_src, m_t)
    ok = (ok & (triangulate.depth_in_camera(Rs_b, ts_b, pos_w) > 0)
          & (triangulate.depth_in_camera(Rt_b, tt_b, pos_w) > 0))
    return EpipolarResult(success=ok, pos_w=pos_w, src_uv=root,
                          target_uv=sp.pos_zero)


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
# ReFind (MapMaker.cc:967-1095)
# ---------------------------------------------------------------------------


def _refind_geometry(cam, R, t, pos_w, right_w, down_w, config: SLAMConfig):
    """The points at poses (R, t) (one pose [3, 3] / [3] or one per point):
    (px [Q, 2] level-0 projection, warp_inv [Q, 2, 2], search_level [Q],
    ok [Q]: projects into the image and has a usable warp)."""
    tc, pc_cfg = config.tracker, config.patch
    Q = pos_w.shape[0]
    # One pose is spread over the points, so the products are the
    # per-pair form's.
    R, t = R.expand(Q, 3, 3).contiguous(), t.expand(Q, 3).contiguous()
    pc, px, derivs, proj_ok = tracker_mod.project_camera_points(
        cam, (R @ pos_w[..., None])[..., 0] + t,
        (float(tc.width), float(tc.height)))
    motion_right = (R @ right_w[..., None])[..., 0]
    motion_down = (R @ down_w[..., None])[..., 0]
    warp_inv, search_level, warp_ok = match.calc_search_level_and_warp(
        pc, motion_right, motion_down, derivs,
        det_lo=pc_cfg.warp_det_lo, det_hi=pc_cfg.warp_det_hi,
    )
    return px, warp_inv, search_level, proj_ok & warp_ok


def _refind_match(pyramid, corner_mask, tmpl, px, search_level, active,
                  config: SLAMConfig, kf_idx=None):
    """Coarse search radius 4 (MapMaker.cc:1014) against the level images,
    subpixel (8 iterations, :1022) when the search level is above 0; the
    reference keeps a measurement whose subpixel step does not converge
    (:1028), at the coarse position. pyramid / corner_mask: one frame's
    levels, or keyframe stacks with kf_idx [Q]. Returns (found, pos_zero,
    did_subpix)."""
    hp, pc_cfg = config.patch.half_patch_size, config.patch
    res = match.find_patch_coarse_multilevel(
        pyramid, corner_mask, tmpl, px, search_level,
        torch.full_like(px[:, 0], 4.0), active, max_range=4, half_patch=hp,
        kf_idx=kf_idx,
    )
    found = res.found & active
    pos_zero = torch.where(found[:, None], res.pos_level, px)
    sub_sel = found & (search_level > 0)
    sp = match.iterate_subpix_multilevel(
        pyramid, tmpl, pos_zero, search_level, sub_sel, max_iters=8,
        half_patch=hp, conv_limit=pc_cfg.subpix_converged, kf_idx=kf_idx,
    )
    pos_zero = torch.where((sub_sel & sp.converged)[:, None], sp.pos_zero,
                           pos_zero)
    return found, pos_zero, sub_sel


def refind_templates(pyramid, source_kf, source_level, center, warp_inv,
                     search_level, config: SLAMConfig):
    """The first half of ReFind_Common: the points' warped templates from
    their source keyframes (pyramid: the keyframe stacks) for the warps
    _refind_geometry gives at the target pose."""
    return match.make_templates_warped_multilevel(
        pyramid, source_kf, source_level, center, warp_inv, search_level,
        config.patch.half_patch_size,
    )


def _refind_search_core(pts, tmpl, R, t, target_pyramid, target_corner_mask,
                        cam, active, config: SLAMConfig):
    """The search half of ReFind_Common against ONE target keyframe (JAX
    ``mapmaker.py:578-660``): the points of `pts` (a point-major store,
    maybe a shard) projected at its pose (R [3, 3], t [3]), their ready
    warped templates `tmpl` matched in its pyramid and corner masks (one
    frame's levels) as refind_pairs matches them. Every input is
    per-point or of one frame, so the core runs on a point shard without
    the keyframe store. Returns (found, pos_zero, search_level, did_subpix),
    each [N]."""
    px, _, search_level, ok = _refind_geometry(
        cam, R, t, pts.pos_w, pts.pixel_right_w, pts.pixel_down_w, config)
    active = active & ok & ~tmpl.bad
    found, pos_zero, did_subpix = _refind_match(
        target_pyramid, target_corner_mask, tmpl, px, search_level, active,
        config)
    return found, pos_zero, search_level, did_subpix


def _refind_search(slam_map: SLAMMap, kf_idx, cam, active,
                   config: SLAMConfig):
    """ReFind search of the `active` points against keyframe `kf_idx` (a
    host int or 0-d tensor) of the map: templates at its pose, then
    _refind_search_core on its frame (JAX ``mapmaker.py:662``)."""
    pts, kfs = slam_map.points, slam_map.keyframes
    k = _slot_index(kf_idx, kfs.t.device)
    R, t = _slot(kfs.R, k), _slot(kfs.t, k)
    _, warp_inv, search_level, _ = _refind_geometry(
        cam, R, t, pts.pos_w, pts.pixel_right_w, pts.pixel_down_w, config)
    tmpl = refind_templates(kfs.pyramid, pts.source_kf, pts.source_level,
                            pts.center, warp_inv, search_level, config)
    return _refind_search_core(
        pts, tmpl, R, t, tuple(_slot(p, k) for p in kfs.pyramid),
        tuple(_slot(c, k) for c in kfs.corner_mask), cam, active, config)


def refind_pairs(slam_map: SLAMMap, pair_pt, pair_kf, pair_ok, cam,
                 config: SLAMConfig):
    """ReFind_Common over an explicit (point, keyframe) pair list [Q]:
    project point pair_pt[q] into keyframe pair_kf[q], warp its template
    from its source keyframe (refind_templates), then search that
    keyframe's level images as _refind_search_core does (_refind_match on
    the keyframe stacks). Returns (found, pos_zero, search_level,
    did_subpix), each [Q]."""
    pts, kfs = slam_map.points, slam_map.keyframes
    pt, kf = pair_pt.long(), pair_kf.long()
    R, t = kfs.R[kf], kfs.t[kf]  # [Q, 3, 3], [Q, 3]
    px, warp_inv, search_level, ok = _refind_geometry(
        cam, R, t, pts.pos_w[pt], pts.pixel_right_w[pt], pts.pixel_down_w[pt],
        config)
    tmpl = refind_templates(kfs.pyramid, pts.source_kf[pt],
                            pts.source_level[pt], pts.center[pt], warp_inv,
                            search_level, config)
    active = pair_ok & ok & ~tmpl.bad
    found, pos_zero, sub_sel = _refind_match(
        kfs.pyramid, kfs.corner_mask, tmpl, px, search_level, active, config,
        kf_idx=kf)
    return found, pos_zero, search_level, sub_sel


def refind_in_keyframe(slam_map: SLAMMap, kf_idx: int, cam, point_mask,
                       config: SLAMConfig):
    """ReFind_Common over the `point_mask` points in keyframe `kf_idx` (a
    host int; ReFindInSingleKeyFrame, MapMaker.cc:967-1058): the live points
    it does not observe yet are searched there (_refind_search), and a
    SRC_REFIND measurement is added for each one found. Returns (slam_map,
    found [N], never_retry_new [N]: searched and not found)."""
    pts, meas = slam_map.points, slam_map.meas
    already = map_store.point_observed_in(meas, kf_idx)
    active = point_mask & pts.live() & ~already
    found, pos_zero, search_level, did_subpix = _refind_search(
        slam_map, kf_idx, cam, active, config)
    meas = add_measurements_batch(meas, found, kf_idx, pos_zero, search_level,
                                  SRC_REFIND, did_subpix)
    return slam_map.replace(meas=meas), found, active & ~found


def refind_in_keyframes_batched(slam_map: SLAMMap, cam, point_mask_kn,
                                config: SLAMConfig):
    """ReFindNewlyMade / ReFindFromFailureQueue over ALL keyframes (JAX
    ``mapmaker.py:705-756``, the oracle of the sharded re-find tests):
    point_mask_kn [K, N] selects each keyframe's points (keyframe validity,
    the live mask and the points it already observes are folded in here).
    Every keyframe is searched first (_refind_search, one keyframe at a
    time, where the JAX package maps over chunks of 4 to bound its
    memory), then measurements are inserted keyframe by keyframe in slot
    order, so slot allocation and eviction are the per-keyframe loop's.
    Returns (slam_map, found_kn [K, N], never_retry_new_kn [K, N])."""
    pts, kfs, meas = slam_map.points, slam_map.keyframes, slam_map.meas
    K = kfs.n_slots
    already = torch.stack([map_store.point_observed_in(meas, k)
                           for k in range(K)])
    active = (point_mask_kn & pts.live()[None] & ~already
              & kfs.valid[:, None])
    found, pos_zero, search_level, did_subpix = (
        torch.stack(parts) for parts in zip(*(
            _refind_search(slam_map, k, cam, active[k], config)
            for k in range(K))))
    for k in range(K):
        meas = add_measurements_batch(meas, found[k], k, pos_zero[k],
                                      search_level[k], SRC_REFIND,
                                      did_subpix[k])
    return slam_map.replace(meas=meas), found, active & ~found


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


# ---------------------------------------------------------------------------
# Bundle-adjustment set selection, problem construction and write-back
# (MapMaker.cc:776-960)
# ---------------------------------------------------------------------------


def build_ba_problem(slam_map: SLAMMap, adjust_mask,
                     config: SLAMConfig) -> bundle_mod.BAProblem:
    """BAProblem over the keyframes in `adjust_mask` [K] (free), every
    other valid keyframe fixed; its points are those the adjust set
    observes (the rest are excluded through point_valid)."""
    pts, kfs, meas = slam_map.points, slam_map.keyframes, slam_map.meas
    obs_in_adjust = meas.valid & adjust_mask[meas.kf.long()]
    pt_in = torch.any(obs_in_adjust, dim=1) & pts.live()
    # Fixed: valid keyframes outside the adjust set (a non-observer only
    # adds empty rows to S) and the permanently fixed first keyframe.
    fixed = kfs.valid & (~adjust_mask | kfs.fixed)
    noise = 2.0 ** meas.level.to(pts.pos_w.dtype)
    return bundle_mod.BAProblem(
        cam_R=kfs.R, cam_t=kfs.t, cam_fixed=fixed | ~kfs.valid,
        cam_valid=kfs.valid, points=pts.pos_w, point_valid=pt_in,
        meas_kf=meas.kf, meas_uv=meas.uv,
        meas_sqrt_inv_noise=torch.where(meas.valid, 1.0 / noise, 1.0),
        meas_valid=meas.valid & pt_in[:, None],
    )


def local_ba_adjust_mask(slam_map: SLAMMap, newest_kf, config: SLAMConfig):
    """BundleAdjustRecent's adjust set [K]: the newest keyframe and its 4
    nearest neighbours (MapMaker.cc:801-824); equally near ones go by the
    lower slot. Callers skip local BA below local_ba_min_kfs keyframes, as
    the reference does."""
    kfs = slam_map.keyframes
    newest = _slot_index(newest_kf, kfs.t.device)
    d = keyframe_distances(kfs, _slot(kfs.R, newest), _slot(kfs.t, newest))
    d = d.index_fill(0, newest, torch.inf)
    nearest = torch.sort(d, stable=True).indices[
        :config.mapmaker.local_ba_neighbors]
    mask = torch.zeros(kfs.n_slots, dtype=torch.bool, device=d.device)
    mask[torch.cat([newest, nearest])] = True
    return mask & kfs.valid & ~kfs.fixed


def apply_ba_result(slam_map: SLAMMap, prob: bundle_mod.BAProblem,
                    res: bundle_mod.BAResult, config: SLAMConfig):
    """Write a BAResult back into the map and route the ejected
    measurements (MapMaker.cc:906-959): a point dies if it lost a
    measurement and keeps 2 or fewer, or if its SRC_ROOT measurement was
    ejected; ejected SRC_TRACKER / SRC_EPIPOLAR measurements of surviving
    points may be retried, the others never. `prob` is the problem as
    build_ba_problem made it; `res` may come from a run on a part of it.
    Returns (map, retry [N, O], never [N, O], point_dies [N])."""
    pts, kfs, meas = slam_map.points, slam_map.keyframes, slam_map.meas
    kfs = kfs.replace(R=res.cam_R, t=res.cam_t)
    ej = res.outlier_meas
    remaining = torch.sum(res.meas_valid.to(torch.int32), dim=1)
    root_ejected = torch.any(ej & (meas.source == SRC_ROOT), dim=1)
    point_dies = pts.valid & (
        (torch.any(ej, dim=1) & (remaining <= 2)) | root_ejected
    )
    survives = ~point_dies[:, None]
    retry = ej & survives & ((meas.source == SRC_TRACKER)
                             | (meas.source == SRC_EPIPOLAR))
    never = ej & ~retry & survives
    # Only what the problem held can have been ejected: a measurement the
    # problem left out (its point is seen by no adjusted keyframe, or the
    # run covered a prefix of the slots) stays as it was.
    kept = (meas.valid & ~prob.meas_valid) | res.meas_valid
    meas = meas.replace(valid=kept & survives)
    pts = pts.replace(pos_w=res.points, valid=pts.valid & ~point_dies)
    pts = map_store.refresh_pixel_vectors(pts, kfs)
    return (slam_map.replace(points=pts, keyframes=kfs, meas=meas), retry,
            never, point_dies)
