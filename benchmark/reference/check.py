"""The comparison that decides ``correct``.

The program's outputs are judged against what the benchmark itself made:
the truth poses of the path it rendered, the plane it textured, the
frames it handed in. Every number is computed here from the outputs and
that truth alone, and each compared number is held to its limit (the
workload file's ``limits``; a number passes when it is at most its
limit). Lower is better for every number:

- ``ate_pct``: RMSE of the tracked frames' camera centres after a
  similarity alignment to the truth, as a share of the truth path's
  extent (the diagonal of its bounding box), over the window's tracked
  frames;
- ``reproj_px``: median reprojection error of the map's valid
  measurements under its keyframe poses and points (what bundle
  adjustment minimises), in pixels of each measurement's pyramid level;
- ``fast_mismatch``: pixels whose FAST-10 corner flag differs from this
  segment test on the same frame, over every checked frame and level;
- ``fast_score_err``: the largest difference of the corner score where
  both flag a corner;
- ``nonmax_mismatch``: pixels whose nonmax flag (``fast_nonmax_levels``:
  the corners re-scored at barrier 10, thinned to 3x3 maxima) differs
  from this one, over every level of the keyframes the window made;
- ``map_plane_pct``: the median distance of the map's live points from
  the textured plane, as a share of its depth, under the similarity
  whose rotation comes from the poses' orientations.

Informational numbers (no cell compares them): ``nonmax_tie_gap``, the
largest |margin| of a mismatched nonmax flag (``nonmax_numbers``);
``tracked_pct`` of the window's frames that were not blank,
``covered_frames`` (the window's blank frames, which the system owes a
lost result), ``map_points``, ``measurements``, ``fast_frames``, ``nonmax_frames`` and
``kf_image_mismatch`` (keyframes whose stored image is not the frame the
check takes for them: 0 when the check reads the right corners).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import ate, fast, geometry


def trajectory_numbers(est_R, est_t, truth_R, truth_t):
    """(ate_pct, the map-to-world similarity) of tracked poses against the
    truth poses of the same frames (numpy [n, 3, 3], [n, 3]). The ATE
    aligns the centres alone (Umeyama); the similarity that carries the map
    into the world takes its rotation from the poses' orientations (the
    chordal mean of R_truth^T R_est), which a path that runs nearly
    straight leaves determined, and its scale and shift from the centres."""
    est_c = geometry.centers(est_R, est_t)
    truth_c = geometry.centers(truth_R, truth_t)
    if (len(est_c) < 3 or not np.isfinite(est_c).all()
            or not np.isfinite(est_R).all()):
        return math.inf, None
    rmse, _ = ate.ate_rmse(est_c, truth_c)
    extent = float(np.linalg.norm(truth_c.max(0) - truth_c.min(0)))
    return 100.0 * rmse / max(extent, 1e-9), ate.align_by_orientation(
        est_R, est_c, truth_R, truth_c)


def map_plane_pct(points_w, sim, depth_m: float):
    """Median |z - depth| / depth (%) of map points [P, 3] carried into the
    world by the similarity `sim`."""
    if sim is None or len(points_w) == 0:
        return math.inf
    z = ate.apply(sim, points_w)[:, 2]
    if not np.isfinite(z).all():
        return math.inf
    return 100.0 * float(np.median(np.abs(z - depth_m))) / depth_m


def reprojection_px(cam: geometry.Camera, kf_R, kf_t, points_w, meas_point,
                    meas_kf, meas_uv, meas_level):
    """Median reprojection error of the measurements (point index, keyframe
    index, level-0 pixel, level) in pixels of their level; float64."""
    if len(meas_point) == 0:
        return math.inf
    R = torch.from_numpy(np.asarray(kf_R, np.float64))[meas_kf]
    t = torch.from_numpy(np.asarray(kf_t, np.float64))[meas_kf]
    x = torch.from_numpy(np.asarray(points_w, np.float64))[meas_point]
    xc = geometry.transform(R, t, x)
    m = xc[:, :2] / xc[:, 2:3]
    px = cam.project(m)
    err = torch.linalg.vector_norm(
        px - torch.from_numpy(np.asarray(meas_uv, np.float64)), dim=-1)
    err = err / torch.from_numpy(2.0 ** np.asarray(meas_level, np.float64))
    err = torch.where((xc[:, 2] > 0) & torch.isfinite(err), err, math.inf)
    return float(torch.median(err))


def fast_numbers(frames, thresholds):
    """(mismatched corner flags, largest score gap) over frames, each
    (image [H, W] as handed in, the program's masks, its scores) per
    level (None where the program keeps no scores), against this segment
    test in float32."""
    mismatch, score_err = 0, 0.0
    for img, masks, scores in frames:
        ref = fast.corners(img, thresholds)
        for (r_mask, r_score), mask, score in zip(ref, masks, scores):
            mask = mask.to(r_mask.device)
            mismatch += int((mask != r_mask).sum())
            both = mask & r_mask
            if score is not None and bool(both.any()):
                gap = (score.to(r_score.device).float()
                       - r_score.float()).abs()[both].max()
                score_err = max(score_err, float(gap))
    return mismatch, score_err


def nonmax_numbers(frames, thresholds, dtype=torch.float32):
    """(mismatched nonmax flags, the largest |margin| among them) over
    frames, each (image [H, W] as handed in, the program's nonmax masks
    per level), against this nonmax in `dtype`. A pixel's margin is the
    reference's score less its strongest neighbouring corner's: near 0
    where a flag rests on a tie that a score's last bits decide. inf
    without a frame, or for a frame whose image is None (not one the
    benchmark handed in)."""
    if not frames:
        return math.inf, math.inf
    mismatch, gap = 0, 0.0
    for img, masks in frames:
        if img is None:
            return math.inf, math.inf
        for (ref, margin), mask in zip(fast.nonmax(img, thresholds,
                                                   dtype=dtype), masks):
            differ = mask.to(ref.device) != ref
            mismatch += int(differ.sum())
            if bool(differ.any()):
                gap = max(gap, float(margin[differ].abs().max()))
    return float(mismatch), gap


def judge(numbers: dict, limits: dict):
    """(correct, checks): each limited number beside its limit; a number
    that is missing or not finite fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        finite = value is not None and math.isfinite(value)
        ok = ok and finite and value <= limit
        checks[name] = {"value": value if finite else None, "limit": limit}
    return ok, checks
