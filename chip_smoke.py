"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port's main paths at the reference's full size (800x480
frames, a 2048-slot map, 32 keyframe slots) and checks them: the per-frame
tracking step on a fixture map; the stereo bootstrap that builds a map from
a sideways camera motion (trails, homography, triangulation, bundle
adjustment, epipolar growth, plane alignment) and then tracks on it; and
bundle adjustment at the map's full capacities.

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels (csrc/fast.cu) with nvcc and prints
   what ptxas reports for each;
3. kernels vs plain, on an 800x480 frame's four pyramid levels, each timed
   with CUDA events (median of 50), eager and as CUDA-graph replays (device
   time), beside its bound (bytes moved over the memory rate, or f32
   operations over the f32 rate, whichever is longer):
   - fast_detect, one launch per level: masks equal to the plain PyTorch
     version, scores within 1e-3, at arc lengths 9 and 10;
   - fast_detect_levels, the four levels in one launch: the same checks,
     and bit-equal to the single-level launches;
   - fast_nonmax_levels, the barrier-10 rescore fused with the 3x3 nonmax:
     bit-equal to nonmax_3x3 on the detect kernel's score, and equal to its
     plain version except at counted near-ties of two plain scores. Its
     bound counts what this frame's corners ask for: the corner mask read,
     the nonmax mask written, and the 32-byte sectors of the image under
     the rings of the corners that have a neighbouring corner;
4. slice: builds the 2048-slot fixed map of ``bench.py`` on the card,
   renders its 100 chained frames there and runs ``frame_step`` over them,
   chaining pose, velocity, SBI and map; every frame must find more than
   50 points with quality not BAD, stay within the pose-error bound of the
   rendered ground truth, and launch fast_detect_levels exactly once;
5. card vs CPU: the first 5 frames again on the CPU through the plain
   path, from the same state with the same random draws;
6. timing: three warm passes over the 100 frames (frames/s and their
   range), and the split between the front-end (make_frame) and the rest;
7. bootstrap: renders a 29-frame sideways path on the card; trail_start on
   frame 0, trail_advance over frames 1..6, the full init_from_stereo on
   frame 6 (5 rounds of global bundle adjustment, epipolar growth at levels
   0, 3, 1, 2, bundle adjustment until it converges), then frame_step over
   the 22 remaining frames on the map it built. At least 200 trails must
   survive, the homography must succeed and recover the rendered motion
   (rotation within 0.01 rad, translation direction within 3 degrees), at
   least 100 points must triangulate; the reprojection rms must fall over
   the 5 rounds; the growths must add points at each of levels 0-3; every
   pose and point must be finite, every live point in the prefix the
   bundle adjustment runs on and in front of keyframe 0, and on z = 0 after
   the plane alignment; the last rounds must converge within 4; every
   tracked frame must be GOOD and follow the rendered motion; and the path
   must launch fast_detect_levels once per frame and fast_nonmax_levels
   once per keyframe, and nothing through the single-image wrapper. The
   stages of init_from_stereo are timed from here (synchronised host clock
   around each), and the device-to-host reads of each round are counted;
8. bootstrap card vs CPU: the same frames and the same MLESAC and
   plane-RANSAC draws through the plain path on the CPU: (R2, t2) within
   1e-3, n_ok within 2%; after bundle adjustment and growth, by outcome:
   point count within 5%, rms within 10%, keyframe 1's pose within 5e-3.
   The card's run is the second in the process: its stage times are the
   warm ones, with the growth split by level into thinning, corner list,
   ZMSSD, subpixel and triangulation;
9. bundle adjustment at full state size: a problem made from a seed with
   numpy at the map's capacities (32 cameras, one fixed; 2048 points; up to
   16 observations each; 0.3 px of noise; 5% of the measurements moved by
   30-60 px): bundle_adjust(max_iters=20) on the card must bring the rms
   to the noise level and eject the moved measurements, and agree with the
   same run on the CPU by objective and rms; one LM iteration is timed by
   stage with CUDA events.

Any failed check raises and the script exits non-zero. The last two lines
of standard output are a JSON object describing the kernels (`launches`
is the sum over phases 4, 7 and 9, `launches_by_path` gives each) and the
``{"ok": true, "device": ...}`` line. It imports no jax.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 100
N_CPU_FRAMES = 5
SCORE_ATOL = 1e-3      # kernel vs plain score; sums of 16 terms in f32
POSE_ATOL = 1e-4       # card vs CPU pose (R entries, t in m)
FOUND_AGREE = 0.98     # card vs CPU: share of points either side found
# Pose-error bounds against the rendered ground truth over the 100-frame
# chain, from CPU runs of the same trajectory (see CHANGES.md): the worst
# frame there stays below a fifth of these.
MAX_T_ERR = 0.02       # m
MAX_R_ERR = 0.01       # rad
N_TIMED_PASSES = 3     # warm passes over the chain, for the run-to-run range
# A fused-nonmax pixel may differ from the plain version only where two
# plain scores lie this close: each kernel score is within SCORE_ATOL of
# its plain value, so a comparison of two can flip within twice that.
NEAR_TIE = 2 * SCORE_ATOL
# The bootstrap phase: frame 0 starts the trails, frames 1..6 advance them,
# frame 6 is the second keyframe, 22 more frames are tracked on the new map.
N_TRAIL_FRAMES = 6
N_TRACK_FRAMES = 22
# Tracked motion since keyframe 1 against the rendered truth, in the map's
# scale (baseline = 0.1): bounds from CPU runs of the same path (see
# CHANGES.md); the map comes from an unrefined homography, so they are wider
# than the fixture map's.
BOOT_TRACK_R_ERR = 0.02  # rad
BOOT_TRACK_T_ERR = 0.02  # map units
# The finished bootstrap against the same run on the CPU, by outcome (the
# accept tests of ~130 LM iterations may fall differently on the two
# devices; see tests/test_torch_bundle.py).
BOOT_POINTS_AGREE = 0.05   # relative difference of the point counts
BOOT_RMS_AGREE = 0.10      # relative difference of the final rms
BOOT_POSE_ATOL = 5e-3      # keyframe 1 (R entries, t in map units)
# The full-size bundle adjustment: noise 0.3 px per axis gives an rms of
# 0.42 px; the run must end below BA_RMS_AFTER from above BA_RMS_BEFORE.
BA_SEED = 5
BA_NOISE_PX = 0.3
BA_OUTLIER_SHARE = 0.05
BA_RMS_BEFORE = 2.0
BA_RMS_AFTER = 0.6
BA_EJECTED_SHARE = 0.95    # of the moved measurements
BA_AGREE = 0.02            # card vs CPU: objective and rms, relative
# Published peaks of one H100 SXM: HBM3 rate and f32 rate outside the tensor
# cores.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _event_ms(run, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms(fn, reps=50, inner=20):
    """(eager, device) ms of one call of fn, each the median of `reps`
    CUDA-event samples. eager brackets one call as issued from Python, so
    it includes the host's launch gaps; device replays a CUDA graph of
    `inner` back-to-back calls and divides, which leaves the device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    eager = _event_ms(fn, reps)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return eager, _event_ms(graph.replay, reps) / inner


def trajectory(R0, t0, n_frames):
    """bench.py's smooth camera path: pose k = exp(mu_k) * (R0, t0)."""
    from visualslam_android_tpu_torch.ops import lie

    poses = []
    for k in range(n_frames):
        s = k / n_frames
        mu = torch.tensor(
            [0.05 * np.sin(6.28 * s), 0.02 * np.sin(4.4 * s), 0.03 * s,
             0.02 * np.sin(5.1 * s), 0.04 * np.sin(6.28 * s),
             0.01 * np.sin(3.3 * s)],
            dtype=torch.float32, device=R0.device,
        )
        dR, dt = lie.se3_exp(mu)
        poses.append(lie.se3_mul(dR, dt, R0, t0))
    return poses


def rot_angle(Ra, Rb):
    """Angle of Ra Rb^T, from its sine and cosine (an arccos of the trace
    alone rounds every angle below ~5e-4 rad to 0 in f32)."""
    D = Ra @ Rb.T
    s = 0.5 * torch.linalg.vector_norm(torch.stack(
        [D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]]))
    return float(torch.atan2(s, (torch.trace(D) - 1.0) / 2.0))


def level_images(device, fixtures, synthetic, image):
    """The four pyramid levels of one rendered 800x480 frame."""
    from visualslam_android_tpu_torch.ops import camera as cam_ops

    config = fixtures.full_config()
    tc = config.tracker
    cam = cam_ops.make_camera(config.camera.params(), tc.width, tc.height,
                              device=device)
    scene = synthetic.make_planar_scene(np.random.default_rng(3),
                                        px_per_m=240.0, device=device)
    R0, t0 = synthetic.look_at_pose((0.0, 0.0, 0.0), device=device)
    img = synthetic.render(scene, cam, R0, t0, (tc.height, tc.width))
    return [lvl.contiguous() for lvl in
            image.make_pyramid(img, tc.n_levels)], tc.fast_thresholds


def detect_bound_ms(n_pixels):
    """Least time for FAST on n_pixels: 9 bytes per pixel (f32 read, bool
    and f32 write) over the memory rate, against 131 f32 operations per
    pixel (16 ring terms of 2 compares, 2 subtractions, 2 max, 2 adds;
    hi, lo and the final max) over the f32 rate."""
    return bound_ms(9 * n_pixels, 131 * n_pixels)


def bound_ms(n_bytes, n_ops):
    by_bytes = 1e3 * n_bytes / H100_BYTES_PER_S
    by_ops = 1e3 * n_ops / H100_F32_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def phase_detect(levels, thresholds, fast):
    """The single-level wrapper against its plain version on each of the
    four level shapes, and both timed."""
    max_err, rows = 0.0, []
    for lvl, (level, thresh) in enumerate(zip(levels, thresholds)):
        for t, arc in ((thresh, 10), (10, 10), (thresh, 9), (10, 9)):
            m_k, s_k = fast.detect(level, t, arc)
            m_p, s_p = fast.detect_reference(level, t, arc)
            torch.cuda.synchronize()
            check(torch.equal(m_k, m_p),
                  f"FAST mask differs at level {lvl} t={t} arc={arc}: "
                  f"{int((m_k != m_p).sum())} pixels")
            err = float(torch.max(torch.abs(s_k - s_p)))
            check(err <= SCORE_ATOL,
                  f"FAST score differs by {err} at level {lvl} t={t}")
            max_err = max(max_err, err)
        eager, ms = cuda_ms(lambda: fast.detect(level, thresh))
        plain_eager, plain_ms = cuda_ms(
            lambda: fast.detect_reference(level, thresh)
        )
        n = int(fast.detect_reference(level, thresh)[0].sum())
        rows.append((tuple(level.shape), thresh, ms, plain_ms, eager,
                     plain_eager, n))
    return max_err, rows


def phase_detect_levels(levels, thresholds, fast):
    """All four levels in one launch against the plain version per level."""
    max_err = 0.0
    for arc in (10, 9):
        masks, scores = fast.detect_levels(levels, thresholds, arc)
        torch.cuda.synchronize()
        for lvl, (level, t, m_k, s_k) in enumerate(
                zip(levels, thresholds, masks, scores)):
            m_p, s_p = fast.detect_reference(level, t, arc)
            check(torch.equal(m_k, m_p),
                  f"detect_levels mask differs at level {lvl} arc={arc}: "
                  f"{int((m_k != m_p).sum())} pixels")
            err = float(torch.max(torch.abs(s_k - s_p)))
            check(err <= SCORE_ATOL,
                  f"detect_levels score differs by {err} at level {lvl}")
            max_err = max(max_err, err)
            # The single-level wrapper is the same kernel: same bits.
            m_1, s_1 = fast.detect(level, t, arc)
            check(torch.equal(m_1, m_k) and torch.equal(s_1, s_k),
                  f"detect and detect_levels differ at level {lvl}")
    eager, ms = cuda_ms(lambda: fast.detect_levels(levels, thresholds))
    plain_eager, plain_ms = cuda_ms(
        lambda: [fast.detect_reference(lv, t)
                 for lv, t in zip(levels, thresholds)]
    )
    return max_err, ms, plain_ms, eager, plain_eager


def phase_nonmax_levels(levels, thresholds, fast):
    """The fused barrier-10 rescore + 3x3 nonmax against (a) nonmax_3x3 on
    the detect kernel's own barrier-10 score, which it must equal bit for
    bit, and (b) its plain version, from which it may differ only where
    the plain scores of a pixel and of its largest neighbouring corner lie
    within NEAR_TIE of each other (each score is within SCORE_ATOL of its
    plain value). Returns a dict: the measured mask differences (as counts
    and as the largest |difference| of the masks read as 0/1), the times,
    and what this run's corners make the function read and compute."""
    cmasks, _ = fast.detect_levels(levels, thresholds)
    fused = fast.nonmax_levels(levels, cmasks)
    plain = fast.nonmax_levels_reference(levels, cmasks)
    torch.cuda.synchronize()
    out = {"differ_from_unfused": 0, "near_tie_pixels": 0, "max_abs_err": 0.0,
           "corners": 0, "scores_needed": 0, "image_sectors": 0}
    for lvl, (level, cm, f_k, f_p) in enumerate(
            zip(levels, cmasks, fused, plain)):
        want = fast.nonmax_3x3(cm, fast.detect(level, 10)[1])
        n_unfused = int((f_k != want).sum())
        out["differ_from_unfused"] += n_unfused
        check(n_unfused == 0,
              f"fused nonmax differs from nonmax_3x3 on the kernel's score "
              f"at level {lvl}: {n_unfused} pixels")
        s = torch.where(cm, fast.detect_reference(level, 10)[1], -1.0)
        pad = torch.nn.functional.pad(s, (1, 1, 1, 1), value=-1.0)
        H, W = s.shape
        neigh = torch.stack([pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                             for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                             if (dx, dy) != (0, 0)]).max(dim=0).values
        near = torch.abs(s - neigh) < NEAR_TIE
        differ = f_k != f_p
        other = int((differ & ~near).sum())
        check(other == 0,
              f"fused nonmax differs from its plain version at {other} "
              f"pixels of level {lvl} that are no near-tie")
        out["near_tie_pixels"] += int(differ.sum())
        out["max_abs_err"] = max(out["max_abs_err"], float(
            (f_k.float() - f_p.float()).abs().max()))
        check(int(f_k.sum()) > 0, f"no nonmax corner at level {lvl}")
        # What this run's data asks for: a corner with no neighbouring
        # corner is kept without a score; every other corner needs its ring
        # score once, i.e. its centre and 16 ring pixels read.
        needs = cm & (neigh >= 0)
        out["corners"] += int(cm.sum())
        out["scores_needed"] += int(needs.sum())
        out["image_sectors"] += ring_sectors(needs, fast.RING_OFFSETS)
    out["eager_ms"], out["ms"] = cuda_ms(
        lambda: fast.nonmax_levels(levels, cmasks))
    out["plain_eager_ms"], out["plain_ms"] = cuda_ms(
        lambda: fast.nonmax_levels_reference(levels, cmasks))
    return out


def ring_sectors(needs, ring_offsets):
    """Distinct 32-byte sectors of a contiguous f32 image that hold the
    centre or a ring pixel (clamped to the image) of a pixel set in
    `needs`."""
    H, W = needs.shape
    ys, xs = torch.nonzero(needs, as_tuple=True)
    touched = torch.zeros(-(-H * W // 8) * 8, dtype=torch.bool,
                          device=needs.device)
    for dx, dy in ((0, 0), *ring_offsets):
        y = torch.clamp(ys + dy, 0, H - 1)
        x = torch.clamp(xs + dx, 0, W - 1)
        touched[y * W + x] = True
    return int(touched.view(-1, 8).any(dim=1).sum())


def run_chain(frame_step, frames, state, config, uniforms, cam):
    """frame_step over `frames`, chaining pose, velocity, SBI and map.
    Returns per-frame (R, t, found, stats) and the final state."""
    N = config.tracker.max_map_points
    K = config.mapmaker.max_keyframes
    device = frames[0].device
    new_points = torch.zeros(N, dtype=torch.bool, device=device)
    failure = torch.zeros(N, K, dtype=torch.bool, device=device)
    pending = torch.zeros(2, device=device)
    wiggle = torch.ones((), device=device)
    sm, R, t, v, msd, depth, sbi = state
    outs = []
    for k, img in enumerate(frames):
        o = frame_step.frame_step(
            img, sm, cam, R, t, v, msd, depth, wiggle, sbi, new_points,
            failure, pending, config, uniforms=(uniforms[k, 0],
                                                uniforms[k, 1]),
        )
        sm, R, t, v, msd, depth, sbi = (o.slam_map, o.R, o.t, o.velocity,
                                        o.msd, o.depth, o.sbi)
        new_points = o.new_points
        outs.append((o.R, o.t, o.found, o.stats))
    return outs


def bootstrap_frames(device, config, synthetic, cam_ops):
    """The bootstrap scene: camera, truth poses and rendered frames of the
    sideways path (frame 0 starts the trails, frame N_TRAIL_FRAMES is the
    second keyframe, N_TRACK_FRAMES more are tracked on the new map)."""
    tc = config.tracker
    cam = cam_ops.make_camera(config.camera.params(), tc.width, tc.height,
                              device=device)
    scene = synthetic.make_planar_scene(np.random.default_rng(21), depth=4.0,
                                        px_per_m=240.0, device=device)
    R0, t0 = synthetic.look_at_pose((0.0, 0.0, 0.0), device=device)
    n = N_TRAIL_FRAMES + 1 + N_TRACK_FRAMES
    poses = [synthetic.sideways_pose(R0, t0, k / (n - 1)) for k in range(n)]
    frames = [synthetic.render(scene, cam, R, t, (tc.height, tc.width))
              for R, t in poses]
    return cam, poses, frames


def run_trails(frames, config, bootstrap, frame_step):
    """trail_start on frame 0 and trail_advance over the next
    N_TRAIL_FRAMES frames: (trails, second frame, its SBI, counts)."""
    prev, sbi = frame_step.bootstrap_frontend(frames[0], config)
    trails = bootstrap.trail_start(prev, config)
    counts = [int(trails.valid.sum())]
    for img in frames[1:N_TRAIL_FRAMES + 1]:
        frame, sbi = frame_step.bootstrap_frontend(img, config)
        trails, count = bootstrap.trail_advance(trails, frame, prev, config)
        counts.append(int(count))
        check(counts[-1] >= config.tracker.min_trails_to_continue,
              f"trails died: {counts}")
        prev = frame
    return trails, prev, sbi, counts


def track_on(init, sbi, frames, cam, config, frame_step, generator):
    """frame_step over `frames` from the state init_from_stereo made.
    Returns per-frame (R, t, stats)."""
    N = config.tracker.max_map_points
    K = config.mapmaker.max_keyframes
    device = frames[0].device
    new_points = torch.zeros(N, dtype=torch.bool, device=device)
    failure = torch.zeros(N, K, dtype=torch.bool, device=device)
    pending = torch.zeros(2, device=device)
    sm, R, t, v, msd, depth = (init.slam_map, init.R, init.t, init.velocity,
                               init.msd, init.depth)
    outs = []
    for img in frames:
        o = frame_step.frame_step(
            img, sm, cam, R, t, v, msd, depth, init.wiggle_depth_norm, sbi,
            new_points, failure, pending, config, generator=generator,
        )
        sm, R, t, v, msd, depth, sbi, new_points = (
            o.slam_map, o.R, o.t, o.velocity, o.msd, o.depth, o.sbi,
            o.new_points)
        outs.append((o.R, o.t, o.stats))
    return outs


def relative_pose(Ra, ta, Rb, tb):
    """b-from-a: (Rb Ra^T, tb - Rb Ra^T ta)."""
    R = Rb @ Ra.T
    return R, tb - R @ ta


def angle_between(a, b):
    c = torch.dot(a, b) / (torch.linalg.vector_norm(a)
                           * torch.linalg.vector_norm(b))
    return float(torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0))))


def points_by_source(slam_map):
    """{source pixel: world position} of the live map points."""
    pts = slam_map.points
    live = pts.live().cpu().numpy()
    center = pts.center.cpu().numpy()[live]
    pos = pts.pos_w.cpu().numpy()[live]
    return {tuple(c): p for c, p in zip(center, pos)}


def check_finished_map(init, rec, config, bootstrap):
    """What bundle adjustment and growth must have done to the map
    init_from_stereo returns, from the stage record `rec`."""
    first = rec["rounds"][0]
    last = rec["rounds"][bootstrap.N_INIT_BA_ROUNDS - 1]
    check(len(rec["rounds"]) == sum(init.ba_rounds),
          f"{len(rec['rounds'])} BA rounds timed, {init.ba_rounds} reported")
    check(last["rms_after"] < first["rms_before"],
          f"the 5 BA rounds did not lower the rms: {first['rms_before']} -> "
          f"{last['rms_after']}")
    check(init.ba_converged and init.ba_rounds[1] <= 4,
          f"bundle adjustment did not converge in 4 rounds: {init.ba_rounds}")
    sm = init.slam_map
    pts, kfs = sm.points, sm.keyframes
    live = pts.live()
    check(bool(torch.isfinite(kfs.R).all() and torch.isfinite(kfs.t).all()
               and torch.isfinite(pts.pos_w[live]).all()),
          "a pose or a live point is not finite")
    check(init.n_points > init.n_ok,
          f"growth added nothing: {init.n_points} points from {init.n_ok} "
          f"trail points")
    per_level = [int((live & (pts.source_level == lvl)).sum())
                 for lvl in range(config.tracker.n_levels)]
    check(all(n > 0 for n in per_level),
          f"a pyramid level has no point: {per_level}")
    n_prefix = bootstrap.init_point_slots(config)
    check(not bool(live[n_prefix:].any()),
          f"a live point lies past the first {n_prefix} slots")
    print(f"bootstrap: {init.n_points} points after growth (levels "
          f"{per_level}; {init.n_ok} from trails), BA rounds {init.ba_rounds}"
          f", rms {first['rms_before']:.4f} -> {last['rms_after']:.4f} over "
          f"the first 5 and {rec['rounds'][-1]['rms_after']:.4f} at the end")


def phase_bootstrap(device, card, fast, bootstrap, frame_step, tracker,
                    fixtures, synthetic, cam_ops):
    """The stereo bootstrap at full width on the card, then tracking on the
    map it built; returns what the card-against-CPU phase compares and the
    launch counts of this path."""
    config = fixtures.full_config()
    mc = config.mapmaker
    cam, poses, frames = bootstrap_frames(device, config, synthetic, cam_ops)
    gen = torch.Generator(device=device).manual_seed(0)
    # The rendered input must be corner-rich (checked before the counts are
    # set to 0: these launches are not the path's).
    for k in (0, N_TRAIL_FRAMES):
        n_corners = int(fast.detect(frames[k], 10)[0].sum())
        check(n_corners >= 1000,
              f"bootstrap frame {k} shows only {n_corners} FAST corners")
    torch.cuda.synchronize()
    for name in fast.LAUNCHES:
        fast.LAUNCHES[name] = 0

    t_wall = time.perf_counter()
    trails, second, sbi, counts = run_trails(frames, config, bootstrap,
                                             frame_step)
    with timed_stages(bootstrap) as rec:
        init = bootstrap.init_from_stereo(trails, second, cam, config,
                                          generator=gen)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t_wall
    print(f"bootstrap: trails {counts}, ok={init.ok} {init.reason!r}, "
          f"n_ok {init.n_ok}, points {init.n_points}, {boot_s:.3f} s in all "
          f"(stage timers and their rms readings included); first-call "
          f"stage ms {fmt_stages(rec)}  [{card}]")
    print_rounds(rec, card)
    check(counts[-1] >= 200, f"only {counts[-1]} trails at the second touch")
    check(init.ok, f"init_from_stereo failed: {init.reason}")
    check(bool(init.homography.success), "homography not successful")
    check_finished_map(init, rec, config, bootstrap)

    R_true, t_true = relative_pose(*poses[0], *poses[N_TRAIL_FRAMES])
    r_err = rot_angle(init.R2, R_true)
    t_deg = angle_between(init.t2, t_true)
    print(f"bootstrap: rotation error {r_err:.6f} rad, translation "
          f"direction error {t_deg:.4f} deg, |t2| "
          f"{float(torch.linalg.vector_norm(init.t2)):.6f}")
    check(r_err < 0.01, f"bootstrap rotation off by {r_err} rad")
    check(t_deg < 3.0, f"bootstrap translation direction off by {t_deg} deg")
    check(init.n_ok >= 100, f"only {init.n_ok} points triangulated")
    pts = init.slam_map.points
    live = pts.live()
    z_cam0 = pts.pos_w @ init.slam_map.keyframes.R[0].T \
        + init.slam_map.keyframes.t[0]
    check(bool((z_cam0[live][:, 2] > 0).all()),
          "a map point lies behind keyframe 0")
    z = pts.pos_w[live][:, 2].abs()
    share = float((z < mc.plane_inlier_threshold).float().mean())
    print(f"bootstrap: after plane alignment |z| max {float(z.max()):.6f}, "
          f"{100 * share:.2f}% of the points within "
          f"{mc.plane_inlier_threshold}")
    check(share >= 0.9, f"only {share} of the points lie on the plane z = 0")

    outs = track_on(init, sbi, frames[N_TRAIL_FRAMES + 1:], cam, config,
                    frame_step, gen)
    torch.cuda.synchronize()
    launches = dict(fast.LAUNCHES)
    stats = torch.stack([o[2] for o in outs]).cpu().numpy()
    n_found = stats[:, frame_step.STAT_N_FOUND]
    quality = stats[:, frame_step.STAT_QUALITY]
    # Tracked motion since keyframe 1 against the rendered truth, the
    # truth's translation brought to the map's scale (|t2| = wiggle_scale).
    scale = mc.wiggle_scale / float(torch.linalg.vector_norm(t_true))
    kf = init.slam_map.keyframes
    worst_r = worst_t = 0.0
    for (R, t, _), pose in zip(outs, poses[N_TRAIL_FRAMES + 1:]):
        R_rel, t_rel = relative_pose(kf.R[1], kf.t[1], R, t)
        R_want, t_want = relative_pose(*poses[N_TRAIL_FRAMES], *pose)
        worst_r = max(worst_r, rot_angle(R_rel, R_want))
        worst_t = max(worst_t, float(torch.linalg.vector_norm(
            t_rel - scale * t_want)))
    share = n_found / init.n_points
    print(f"bootstrap: {len(outs)} frames tracked on the new map of "
          f"{init.n_points} points: found min {n_found.min():.0f} mean "
          f"{n_found.mean():.1f} ({100 * share.min():.1f}%-"
          f"{100 * share.max():.1f}% of the map; the trail-point map without "
          f"bundle adjustment and growth gave 75-98% of 861), quality min "
          f"{quality.min():.0f}, motion since keyframe 1 off by at most "
          f"{worst_r:.6f} rad, {worst_t:.6f} map units")
    check(bool(np.all(n_found > 50)),
          f"a frame found <= 50 points on the new map: {n_found.tolist()}")
    check(bool(np.all(quality == tracker.QUALITY_GOOD)),
          f"a frame did not track GOOD on the new map: {quality.tolist()}")
    check(worst_r < BOOT_TRACK_R_ERR and worst_t < BOOT_TRACK_T_ERR,
          f"tracking on the new map drifted: {worst_r} rad, {worst_t}")
    n_front = N_TRAIL_FRAMES + 1 + N_TRACK_FRAMES
    check(launches["fast_detect_levels"] == n_front,
          f"fast_detect_levels launched {launches['fast_detect_levels']} "
          f"times over {n_front} frames")
    check(launches["fast_nonmax_levels"] == 2,
          f"fast_nonmax_levels launched {launches['fast_nonmax_levels']} "
          f"times, expected one per keyframe")
    check(launches["fast_detect"] == 0,
          f"the single-image wrapper launched {launches['fast_detect']} "
          f"times on a path that gives all levels to one launch")
    return config, cam, frames, trails, second, init, launches


def map_rms(slam_map, cam, config, mapmaker, bundle):
    """Noise-scaled reprojection rms of the map's global bundle problem."""
    kfs = slam_map.keyframes
    prob = mapmaker.build_ba_problem(slam_map, kfs.valid & ~kfs.fixed, config)
    return float(bundle.reprojection_rms(prob, cam))


@contextlib.contextmanager
def timed_stages(bootstrap, fine=False):
    """Times the stages of init_from_stereo from outside it. While the
    context is open, the functions the bootstrap module reaches run between
    two device synchronisations and their host-clock milliseconds land in
    the yielded record:

    - ``ms``: homography (homography.compute), init_points
      (init_points_step), init_ba5 and init_ba_conv (the bundle-adjustment
      rounds of 10 and of 20 iterations, summed), init_grow (the four
      add_map_points_step calls, summed), plane_aligner;
    - ``rounds``: per bundle-adjustment round its stage, ms, device-to-host
      reads (bundle_adjust's loop control plus the round's own one), the
      map's rms before and after (taken outside the timed window) and
      whether it converged;
    - ``grow``: per level its ms and the points it added; with `fine`, also
      the ms of its thinning, corner list, subpixel refinement,
      triangulation, whole search and insertion (the search's remainder is
      the ZMSSD with its templates and epipolar geometry)."""
    from visualslam_android_tpu_torch.models import bundle

    fstep, mapmaker = bootstrap.fstep, bootstrap.mapmaker
    rec = {"ms": {}, "rounds": [], "grow": {}}
    level = [None]  # the growth level in progress

    def clocked(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def add(stage, ms):
        rec["ms"][stage] = rec["ms"].get(stage, 0.0) + ms

    def stage(name, fn):
        def run(*args, **kwargs):
            out, ms = clocked(fn, *args, **kwargs)
            add(name, ms)
            return out
        return run

    def ba_round(fn):
        def run(slam_map, never, failure, cam, config, max_iters, cap):
            name = "init_ba5" if max_iters == 10 else "init_ba_conv"
            rms0 = map_rms(slam_map, cam, config, mapmaker, bundle)
            reads0 = bundle.HOST_READS["bundle_adjust"]
            out, ms = clocked(fn, slam_map, never, failure, cam, config,
                              max_iters, cap)
            add(name, ms)
            rec["rounds"].append({
                "stage": name, "ms": ms, "converged": out[3],
                "host_reads": bundle.HOST_READS["bundle_adjust"] - reads0 + 1,
                "rms_before": rms0,
                "rms_after": map_rms(out[0], cam, config, mapmaker, bundle)})
            return out
        return run

    def growth(fn):
        def run(slam_map, new_points, cam, src_kf, lvl, config):
            n0 = int(new_points.sum())
            level[0] = lvl
            out, ms = clocked(fn, slam_map, new_points, cam, src_kf, lvl,
                              config)
            level[0] = None
            add("init_grow", ms)
            rec["grow"][lvl] = {"ms": ms, "new": int(out[1].sum()) - n0}
            return out
        return run

    def within_growth(name, fn):
        def run(*args, **kwargs):
            if level[0] is None:
                return fn(*args, **kwargs)
            out, ms = clocked(fn, *args, **kwargs)
            rec["grow"].setdefault(("parts", level[0]), {})[name] = ms
            return out
        return run

    patches = [
        (bootstrap.homography, "compute", lambda f: stage("homography", f)),
        (fstep, "init_points_step", lambda f: stage("init_points", f)),
        (mapmaker, "calc_plane_aligner", lambda f: stage("plane_aligner", f)),
        (bootstrap, "_global_ba", ba_round),
        (fstep, "add_map_points_step", growth),
    ]
    if fine:
        patches += [
            (mapmaker, name, lambda f, n=name: within_growth(n, f))
            for name in ("thin_candidates", "_row_corner_list",
                         "epipolar_search_cands", "insert_new_points")
        ] + [
            (mapmaker.match, "iterate_subpix",
             lambda f: within_growth("iterate_subpix", f)),
            (mapmaker.triangulate, "triangulate",
             lambda f: within_growth("triangulate", f)),
        ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for (mod, attr, wrap), (_, _, fn) in zip(patches, saved):
        setattr(mod, attr, wrap(fn))
    try:
        yield rec
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def fmt_stages(rec):
    return ", ".join(f"{k} {v:.3f}" for k, v in rec["ms"].items())


def print_rounds(rec, card):
    for i, r in enumerate(rec["rounds"]):
        print(f"  BA round {i} ({r['stage']}): {r['ms']:.3f} ms, "
              f"{r['host_reads']} host reads, rms {r['rms_before']:.4f} -> "
              f"{r['rms_after']:.4f}, converged {r['converged']}  [{card}]")
    for lvl in bootstrap_levels(rec):
        g = rec["grow"][lvl]
        line = f"  growth level {lvl}: {g['ms']:.3f} ms, {g['new']} new points"
        parts = rec["grow"].get(("parts", lvl))
        if parts:
            search = parts["epipolar_search_cands"]
            inner = (parts["_row_corner_list"] + parts["iterate_subpix"]
                     + parts["triangulate"])
            line += (f"; thinning {parts['thin_candidates']:.3f}, corner list "
                     f"{parts['_row_corner_list']:.3f}, ZMSSD with templates "
                     f"and geometry {search - inner:.3f}, subpixel "
                     f"{parts['iterate_subpix']:.3f}, triangulation "
                     f"{parts['triangulate']:.3f}, insertion "
                     f"{parts['insert_new_points']:.3f} ms")
        print(f"{line}  [{card}]")


def bootstrap_levels(rec):
    return [k for k in rec["grow"] if not isinstance(k, tuple)]


def phase_bootstrap_cpu(config, cam, card, frames, trails, second, init_card,
                        bootstrap, frame_step):
    """Card against CPU for the bootstrap: the same frames and the same
    MLESAC / plane-RANSAC draws through the plain path on the CPU. The
    stages before bundle adjustment are compared value by value, the
    finished map by outcome."""
    from visualslam_android_tpu_torch.models import bundle

    mc = config.mapmaker
    gen = torch.Generator().manual_seed(1)
    p = trails.valid.float().cpu()
    hom_idx = torch.multinomial(p, mc.mlesac_trials * 4, replacement=True,
                                generator=gen).reshape(-1, 4)
    # New points fill slots from 0, so the first slots are live on both
    # sides even if a few trails differ.
    n_sure = int(0.95 * init_card.n_ok)
    plane_idx = torch.randint(0, n_sure, (mc.plane_ransac_trials, 3),
                              generator=gen)
    dev = trails.cur_pos.device
    with timed_stages(bootstrap, fine=True) as rec:
        card_init = bootstrap.init_from_stereo(
            trails, second, cam, config, homography_trial_idx=hom_idx.to(dev),
            plane_trial_idx=plane_idx.to(dev))
    torch.cuda.synchronize()
    check(card_init.ok,
          f"card bootstrap with explicit draws failed: {card_init.reason}")
    print(f"bootstrap again in the same process: stage ms {fmt_stages(rec)}"
          f"  [{card}]")
    print_rounds(rec, card)
    t_cpu = time.perf_counter()
    cpu_frames = [f.cpu() for f in frames[:N_TRAIL_FRAMES + 1]]
    c_trails, c_second, _, c_counts = run_trails(cpu_frames, config,
                                                 bootstrap, frame_step)
    cpu_cam = cam.to("cpu")
    cpu = bootstrap.init_from_stereo(
        c_trails, c_second, cpu_cam, config,
        homography_trial_idx=hom_idx, plane_trial_idx=plane_idx)
    check(cpu.ok, f"CPU bootstrap failed: {cpu.reason}")
    cpu_s = time.perf_counter() - t_cpu
    d_R = float(torch.max(torch.abs(card_init.R2.cpu() - cpu.R2)))
    d_t = float(torch.max(torch.abs(card_init.t2.cpu() - cpu.t2)))
    print(f"bootstrap card vs CPU: trails {int(trails.valid.sum())} / "
          f"{c_counts[-1]}, max |R2 diff| {d_R:.3e}, max |t2 diff| {d_t:.3e},"
          f" n_ok {card_init.n_ok} / {cpu.n_ok} (CPU {cpu_s:.1f} s)")
    check(d_R <= 1e-3 and d_t <= 1e-3,
          f"card and CPU disagree on (R2, t2): {d_R}, {d_t}")
    check(abs(card_init.n_ok - cpu.n_ok) <= 0.02 * cpu.n_ok,
          f"card and CPU n_ok differ: {card_init.n_ok} vs {cpu.n_ok}")

    rms_card = map_rms(card_init.slam_map, cam, config, bootstrap.mapmaker,
                       bundle)
    rms_cpu = map_rms(cpu.slam_map, cpu_cam, config, bootstrap.mapmaker,
                      bundle)
    d_pose = max(float(torch.max(torch.abs(card_init.R.cpu() - cpu.R))),
                 float(torch.max(torch.abs(card_init.t.cpu() - cpu.t))))
    a, b = (points_by_source(card_init.slam_map),
            points_by_source(cpu.slam_map))
    common = sorted(set(a) & set(b))
    d_p = float(np.median([np.max(np.abs(a[c] - b[c])) for c in common]))
    print(f"bootstrap card vs CPU after BA and growth: points "
          f"{card_init.n_points} / {cpu.n_points}, BA rounds "
          f"{card_init.ba_rounds} / {cpu.ba_rounds}, rms {rms_card:.4f} / "
          f"{rms_cpu:.4f}, keyframe 1 pose diff {d_pose:.3e}, {len(common)} "
          f"common points, median position diff {d_p:.3e}")
    check(abs(card_init.n_points - cpu.n_points)
          <= BOOT_POINTS_AGREE * cpu.n_points,
          f"card and CPU point counts differ: {card_init.n_points} vs "
          f"{cpu.n_points}")
    check(abs(rms_card - rms_cpu) <= BOOT_RMS_AGREE * rms_cpu,
          f"card and CPU rms differ: {rms_card} vs {rms_cpu}")
    check(d_pose <= BOOT_POSE_ATOL,
          f"card and CPU disagree on keyframe 1's pose by {d_pose}")
    check(len(common) >= 0.9 * min(card_init.n_points, cpu.n_points),
          f"card and CPU made different points: {len(common)} in common")
    check(card_init.ba_converged and cpu.ba_converged,
          "bundle adjustment did not converge on the card or on the CPU")


def make_ba_problem(config, seed, bundle, cam_ops, lie, synthetic):
    """A bundle problem at the map's capacities, made with numpy from a
    seed on the CPU: every keyframe slot holds a camera on a sideways arc
    looking at a cloud of points 3.5-6 m away (camera 0 fixed), every point
    slot a point seen by up to max_obs_per_point of the cameras that have
    it in the image, at pyramid levels 0-2 with BA_NOISE_PX of noise per
    level-pixel; BA_OUTLIER_SHARE of the measurements are moved by 30-60
    px. Cameras 1.. and all points start perturbed. Returns (problem,
    camera, moved [N, O] bool)."""
    rng = np.random.default_rng(seed)
    tc = config.tracker
    K, N = config.mapmaker.max_keyframes, tc.max_map_points
    O = config.bundle.max_obs_per_point
    cam = cam_ops.make_camera(config.camera.params(), tc.width, tc.height,
                              device="cpu")
    poses = [synthetic.look_at_pose(
        (-1.2 + 2.4 * k / (K - 1), 0.1 * np.sin(k), 0.0),
        target=(0.0, 0.0, 4.5), device="cpu") for k in range(K)]
    R = torch.stack([p[0] for p in poses])
    t = torch.stack([p[1] for p in poses])
    pts = torch.from_numpy(np.stack(
        [rng.uniform(-2.0, 2.0, N), rng.uniform(-1.2, 1.2, N),
         rng.uniform(3.5, 6.0, N)], -1).astype(np.float32))
    pc = torch.einsum("kij,nj->nki", R, pts) + t  # [N, K, 3]
    px = cam_ops.project(cam, pc[..., :2] / pc[..., 2:3])
    seen = (pc[..., 2] > 0.1) & cam_ops.in_image(cam, px, border=5.0)
    # Up to O of the cameras that see a point, drawn at random.
    order = torch.from_numpy(
        np.argsort(np.where(seen.numpy(), rng.uniform(size=(N, K)), 2.0),
                   axis=1)[:, :O].astype(np.int64))
    meas_valid = torch.gather(seen, 1, order)
    level = torch.from_numpy(rng.integers(0, 3, (N, O)).astype(np.float32))
    noise = torch.from_numpy(
        rng.normal(scale=BA_NOISE_PX, size=(N, O, 2)).astype(np.float32))
    uv = torch.gather(px, 1, order[..., None].expand(N, O, 2)) \
        + noise * (2.0 ** level)[..., None]
    moved = meas_valid & torch.from_numpy(
        rng.uniform(size=(N, O)) < BA_OUTLIER_SHARE)
    jump = torch.from_numpy(rng.uniform(30, 60, (N, O, 2)).astype(np.float32))
    uv = torch.where(moved[..., None], uv + jump, uv)

    dmu = torch.from_numpy(rng.normal(scale=0.01, size=(K, 6)).astype(
        np.float32))
    dmu[0] = 0.0
    R0, t0 = lie.se3_mul(*lie.se3_exp(dmu), R, t)
    pts0 = pts + torch.from_numpy(
        rng.normal(scale=0.02, size=(N, 3)).astype(np.float32))
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    prob = bundle.BAProblem(
        cam_R=R0, cam_t=t0, cam_fixed=fixed,
        cam_valid=torch.ones(K, dtype=torch.bool), points=pts0,
        point_valid=meas_valid.sum(1) >= 2,
        meas_kf=order.to(torch.int32), meas_uv=uv,
        meas_sqrt_inv_noise=2.0 ** -level, meas_valid=meas_valid,
    )
    return prob, cam, moved & prob.point_valid[:, None]


def ba_outcome(prob, cam, res, bundle, mestimator):
    """(rms over the kept measurements, robust objective) of a result: the
    Tukey scores at the result's sigma plus one per ejected measurement,
    which is what bundle_adjust minimises."""
    kept = prob.replace(meas_valid=res.meas_valid)
    rms = float(bundle.reprojection_rms(kept, cam, res.cam_R, res.cam_t,
                                        res.points))
    _, _, err_sq, z_bad = bundle._project_all(
        cam, res.cam_R, res.cam_t, res.points, bundle._sanitized(kept)[0])
    score = mestimator.objective_score(err_sq, res.sigma_squared)
    ok = res.meas_valid & ~z_bad
    return rms, float(torch.sum(torch.where(ok, score, 0.0))
                      + res.outlier_meas.sum())


def event_ms(fn, reps=10):
    """Median CUDA-event milliseconds of one eager call of fn (host launch
    gaps included: this is what the call costs as the port makes it), and
    its last result."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def phase_ba_full(device, card, config, bundle, cam_ops, lie, mestimator,
                  synthetic, wls):
    """Bundle adjustment at the map's full capacities on the card: outcome,
    card against CPU, and one LM iteration timed by stage."""
    bc = config.bundle
    prob_cpu, cam_cpu, moved = make_ba_problem(config, BA_SEED, bundle,
                                               cam_ops, lie, synthetic)
    prob, cam = prob_cpu.to(device), cam_cpu.to(device)
    N, O = prob.meas_valid.shape
    K = prob.cam_R.shape[0]
    n_meas, n_moved = int(prob_cpu.meas_valid.sum()), int(moved.sum())
    rms0 = float(bundle.reprojection_rms(prob, cam))
    kwargs = dict(max_iters=20, point_block=bc.point_block,
                  assembly="scatter", solver="chol")

    runs = []
    for _ in range(2):  # first call, and again
        bundle.HOST_READS["bundle_adjust"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bundle.bundle_adjust(prob, cam, **kwargs)
        torch.cuda.synchronize()
        runs.append((1e3 * (time.perf_counter() - t0),
                     bundle.HOST_READS["bundle_adjust"]))
    rms1, obj1 = ba_outcome(prob, cam, res, bundle, mestimator)
    ejected = res.outlier_meas.cpu()
    hit = int((ejected & moved).sum())
    print(f"full-size BA: {K} cameras, {int(prob_cpu.point_valid.sum())} of "
          f"{N} points, {n_meas} measurements ({n_moved} moved); rms "
          f"{rms0:.4f} -> {rms1:.4f}, {int(res.accepted)} steps accepted, "
          f"converged {bool(res.converged)}, ejected {int(ejected.sum())} "
          f"({hit} of the moved ones); first call {runs[0][0]:.3f} ms, again "
          f"{runs[1][0]:.3f} ms for {runs[1][1]} iterations = host reads "
          f"({runs[1][0] / runs[1][1]:.3f} ms each)  [{card}]")
    check(rms0 > BA_RMS_BEFORE, f"the problem starts at rms {rms0}")
    check(rms1 < BA_RMS_AFTER, f"full-size BA ended at rms {rms1}")
    check(hit >= BA_EJECTED_SHARE * n_moved,
          f"only {hit} of {n_moved} moved measurements were ejected")
    check(bool(torch.isfinite(res.cam_t).all()
               and torch.isfinite(res.points).all()),
          "full-size BA left a non-finite state")
    check(torch.equal(res.cam_R[0], prob.cam_R[0])
          and torch.equal(res.cam_t[0], prob.cam_t[0]),
          "full-size BA moved the fixed camera")

    t0 = time.perf_counter()
    res_cpu = bundle.bundle_adjust(prob_cpu, cam_cpu, **kwargs)
    cpu_s = time.perf_counter() - t0
    rms_c, obj_c = ba_outcome(prob_cpu, cam_cpu, res_cpu, bundle, mestimator)
    differ = int((ejected != res_cpu.outlier_meas).sum())
    print(f"full-size BA card vs CPU: rms {rms1:.4f} / {rms_c:.4f}, objective "
          f"{obj1:.3f} / {obj_c:.3f}, ejected sets differ at {differ} "
          f"measurements (CPU {cpu_s:.1f} s)")
    check(abs(rms1 - rms_c) <= BA_AGREE * rms_c,
          f"card and CPU rms differ: {rms1} vs {rms_c}")
    check(abs(obj1 - obj_c) <= BA_AGREE * obj_c,
          f"card and CPU objectives differ: {obj1} vs {obj_c}")
    check(differ <= 0.01 * n_meas,
          f"card and CPU eject different measurements: {differ}")

    # One LM iteration at the problem's first state, stage by stage.
    sp, valid = bundle._sanitized(prob)
    fixed_m = sp.cam_fixed[sp.meas_kf.long()]
    lam = bc.lambda_init
    ms_lin, lin = event_ms(lambda: bundle._linearize(
        sp, cam, sp.cam_R, sp.cam_t, sp.points, valid, fixed_m,
        bundle.MIN_SIGMA_SQ))
    ms_schur, (Sm, E, Vinv, free) = event_ms(lambda: bundle._reduced_system(
        lin, sp, lam, bc.point_block))
    ms_solve, upd = event_ms(lambda: wls.solve_spd(Sm, E.reshape(-1),
                                                   ridge=0.0))
    ms_back, _ = event_ms(lambda: bundle._back_substitute(
        lin, sp, cam, sp.cam_R, sp.cam_t, sp.points, upd.reshape(K, 6), Vinv,
        free, bc.update_convergence))
    print(f"full-size BA, one LM iteration by stage (CUDA events around the "
          f"eager calls, median of 10): projection + sigma + Jacobians + "
          f"accumulators {ms_lin:.3f} ms, Schur assembly {ms_schur:.3f} ms "
          f"([{N}, {O}, {O}, 6, 6] pair blocks into [{6 * K}, {6 * K}]), "
          f"Cholesky solve {ms_solve:.3f} ms, back-substitution + "
          f"re-projection {ms_back:.3f} ms; sum "
          f"{ms_lin + ms_schur + ms_solve + ms_back:.3f} ms  [{card}]")


def main():
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: chip_smoke needs a GPU")
    import visualslam_android_tpu_torch  # noqa: F401  (sets TF32 off)
    from visualslam_android_tpu_torch.models import bootstrap, bundle
    from visualslam_android_tpu_torch.models import frame_step
    from visualslam_android_tpu_torch.models import keyframe as kf_mod
    from visualslam_android_tpu_torch.models import tracker
    from visualslam_android_tpu_torch.ops import camera as cam_ops
    from visualslam_android_tpu_torch.ops import cuda_build, fast, image, lie
    from visualslam_android_tpu_torch.ops import mestimator, wls
    from visualslam_android_tpu_torch.ops import sbi as sbi_ops
    from visualslam_android_tpu_torch.utils import fixtures, synthetic

    check("jax" not in sys.modules, "the port imported jax")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # ---- 1. device ----
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} ({torch.cuda.device_count()} visible), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build ----
    t_build = time.perf_counter()
    lib = fast.build_kernel()
    print(f"build: {lib} in {time.perf_counter() - t_build:.3f} s")
    for line in cuda_build.build_log("fast.cu").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  {line.strip()}")

    # ---- 3. kernels vs plain ----
    levels, thresholds = level_images(device, fixtures, synthetic, image)
    n_pixels = sum(lv.numel() for lv in levels)
    max_err, rows = phase_detect(levels, thresholds, fast)
    for shape, thresh, ms, plain_ms, eager, plain_eager, n in rows:
        print(f"fast level {shape} t={thresh}: device kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms; eager call kernel {eager:.5f} ms, "
              f"plain {plain_eager:.5f} ms; {n} corners  [{card}]")
    print(f"fast max |score - plain| = {max_err}")
    lv_err, lv_ms, lv_plain, lv_eager, lv_plain_eager = phase_detect_levels(
        levels, thresholds, fast)
    lv_bound, lv_by = detect_bound_ms(n_pixels)
    print(f"fast 4 levels in one launch: device kernel {lv_ms:.5f} ms, "
          f"plain {lv_plain:.5f} ms; eager call kernel {lv_eager:.5f} ms, "
          f"plain {lv_plain_eager:.5f} ms; bound {lv_bound:.5f} ms by "
          f"{lv_by}; max |score - plain| = {lv_err}  [{card}]")
    nm = phase_nonmax_levels(levels, thresholds, fast)
    # Corner mask read and nonmax mask written (2 bytes a pixel), and the
    # image sectors under the rings of the corners that need a score; 99
    # f32 operations per such score.
    nm_bytes = 2 * n_pixels + 32 * nm["image_sectors"]
    nm_bound, nm_by = bound_ms(nm_bytes, 99 * nm["scores_needed"])
    print(f"fast rescore + nonmax, 4 levels in one launch: device kernel "
          f"{nm['ms']:.5f} ms, plain {nm['plain_ms']:.5f} ms; eager call "
          f"kernel {nm['eager_ms']:.5f} ms, plain {nm['plain_eager_ms']:.5f} "
          f"ms; bound {nm_bound:.5f} ms by {nm_by}: {nm_bytes} bytes "
          f"({nm['image_sectors']} image sectors; reading the whole image "
          f"would make {6 * n_pixels}), {nm['scores_needed']} ring scores "
          f"for {nm['corners']} corners; {nm['differ_from_unfused']} pixels "
          f"differ from nonmax_3x3 on the kernel's score, "
          f"{nm['near_tie_pixels']} (all near-ties) from the plain version, "
          f"max |mask difference| {nm['max_abs_err']}  [{card}]")

    # ---- 4. the tracking slice on the fixture map ----
    config = fixtures.full_config()
    tc = config.tracker
    t_map = time.perf_counter()
    sm, cam, scene, (R0, t0), n_pts = fixtures.build_fixed_map(
        config, np.random.default_rng(7), per_level=(900, 500, 300, 120),
        px_per_m=240.0, device=device,
    )
    poses = trajectory(R0, t0, N_FRAMES)
    frames = [synthetic.render(scene, cam, R, t, (tc.height, tc.width))
              for R, t in poses]
    sbi0 = sbi_ops.make_sbi(kf_mod.make_frame(frames[0], config).pyramid[-1],
                            tc.sbi_blur)
    gen = torch.Generator().manual_seed(0)
    uniforms = torch.rand(N_FRAMES, 2, tc.max_map_points, generator=gen)
    uniforms_dev = uniforms.to(device)
    zero = torch.zeros((), device=device)
    state0 = (sm, R0, t0, torch.zeros(6, device=device), zero,
              zero + 4.0, sbi0)
    torch.cuda.synchronize()
    print(f"fixed map: {n_pts} points, {N_FRAMES} frames rendered in "
          f"{time.perf_counter() - t_map:.3f} s")

    for key in fast.LAUNCHES:
        fast.LAUNCHES[key] = 0
    outs = run_chain(frame_step, frames, state0, config, uniforms_dev, cam)
    torch.cuda.synchronize()
    chain_launches = dict(fast.LAUNCHES)
    check(chain_launches == {"fast_detect": 0, "fast_detect_levels": N_FRAMES,
                             "fast_nonmax_levels": 0},
          f"FAST launches over {N_FRAMES} tracked frames: {chain_launches}, "
          f"expected one fast_detect_levels per frame and nothing else")
    stats = torch.stack([o[3] for o in outs]).cpu().numpy()
    n_found = stats[:, frame_step.STAT_N_FOUND]
    quality = stats[:, frame_step.STAT_QUALITY]
    t_err = [float(torch.linalg.vector_norm(o[1] - p[1]))
             for o, p in zip(outs, poses)]
    r_err = [rot_angle(o[0], p[0]) for o, p in zip(outs, poses)]
    print(f"slice: found min {n_found.min():.0f} mean {n_found.mean():.1f}, "
          f"quality min {quality.min():.0f}, max |t err| {max(t_err):.6f} m, "
          f"max rot err {max(r_err):.6f} rad")
    check(bool(np.all(n_found > 50)),
          f"a frame found <= 50 points: {n_found.tolist()}")
    check(bool(np.all(quality != tracker.QUALITY_BAD)),
          f"a frame tracked BAD: {quality.tolist()}")
    check(max(t_err) < MAX_T_ERR and max(r_err) < MAX_R_ERR,
          f"pose error above bound: t {max(t_err)} m, rot {max(r_err)} rad")

    # ---- 5. card vs CPU ----
    cpu = torch.device("cpu")
    state_cpu = tuple(s.to(cpu) for s in state0)
    t_cpu = time.perf_counter()
    outs_cpu = run_chain(frame_step, [f.cpu() for f in
                                      frames[:N_CPU_FRAMES]],
                         state_cpu, config, uniforms, cam.to(cpu))
    worst_pose, worst_agree = 0.0, 1.0
    for (Rg, tg, fg, _), (Rc, tcpu, fc, _) in zip(outs, outs_cpu):
        worst_pose = max(worst_pose,
                         float(torch.max(torch.abs(Rg.cpu() - Rc))),
                         float(torch.max(torch.abs(tg.cpu() - tcpu))))
        fg = fg.cpu()
        either = fg | fc
        agree = float((fg == fc)[either].float().mean()) if bool(
            either.any()) else 1.0
        worst_agree = min(worst_agree, agree)
    print(f"card vs CPU over {N_CPU_FRAMES} frames: max pose diff "
          f"{worst_pose:.3e}, min found agreement {worst_agree:.4f} "
          f"(CPU {time.perf_counter() - t_cpu:.1f} s)")
    check(worst_pose <= POSE_ATOL, f"card and CPU poses differ: {worst_pose}")
    check(worst_agree >= FOUND_AGREE,
          f"card and CPU found sets agree on {worst_agree} < {FOUND_AGREE}")

    # ---- 6. timing (warm passes) ----
    fps = []
    for _ in range(N_TIMED_PASSES):
        torch.cuda.synchronize()
        t_wall = time.perf_counter()
        run_chain(frame_step, frames, state0, config, uniforms_dev, cam)
        torch.cuda.synchronize()
        fps.append(N_FRAMES / (time.perf_counter() - t_wall))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for img in frames:
        kf_mod.make_frame(img, config)
    b.record()
    b.synchronize()
    front_ms = a.elapsed_time(b) / N_FRAMES
    frame_ms = 1000.0 / statistics.median(fps)
    print(f"timing: {N_TIMED_PASSES} warm passes of {N_FRAMES} frames: "
          f"{', '.join(f'{f:.3f}' for f in fps)} frames/s (median "
          f"{statistics.median(fps):.3f}, {frame_ms:.3f} ms/frame)"
          f"; make_frame {front_ms:.4f} ms/frame, rest "
          f"{frame_ms - front_ms:.3f} ms/frame  [{card}]")
    del frames, outs, state0, sm

    # ---- 7. the stereo bootstrap, then tracking on its map ----
    (b_config, b_cam, b_frames, trails, second, init,
     boot_launches) = phase_bootstrap(device, card, fast, bootstrap,
                                      frame_step, tracker, fixtures,
                                      synthetic, cam_ops)

    # ---- 8. bootstrap: card vs CPU ----
    phase_bootstrap_cpu(b_config, b_cam, card, b_frames, trails, second,
                        init, bootstrap, frame_step)
    del b_frames, trails, second, init

    # ---- 9. bundle adjustment at full state size ----
    for key in fast.LAUNCHES:
        fast.LAUNCHES[key] = 0
    phase_ba_full(device, card, b_config, bundle, cam_ops, lie, mestimator,
                  synthetic, wls)
    ba_launches = dict(fast.LAUNCHES)

    one_frame_ms = sum(r[2] for r in rows)
    one_frame_plain = sum(r[3] for r in rows)
    source = "visualslam_android_tpu_torch/csrc/fast.cu"
    replaces = "visualslam_android_tpu/ops/fast_pallas.py:50"

    def row(name, **measured):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": (chain_launches[name] + boot_launches[name]
                             + ba_launches[name]),
                "launches_by_path": {"chain": chain_launches[name],
                                     "bootstrap": boot_launches[name],
                                     "ba_full_size": ba_launches[name]},
                "library_ms": None, **measured}

    print(json.dumps({"kernels": [
        row("fast_detect", max_abs_err=max_err, ms=one_frame_ms,
            plain_ms=one_frame_plain, bound_ms=lv_bound, bound_by=lv_by,
            note="the single-image wrapper: fast_detect_levels' kernel with "
                 "one level descriptor, one launch per level, times summed "
                 "over the four levels; on no path since the levels go in "
                 "one launch, kept for callers with one image"),
        row("fast_detect_levels", max_abs_err=lv_err, ms=lv_ms,
            plain_ms=lv_plain, bound_ms=lv_bound, bound_by=lv_by),
        row("fast_nonmax_levels", max_abs_err=nm["max_abs_err"],
            differ_from_unfused=nm["differ_from_unfused"],
            near_tie_pixels=nm["near_tie_pixels"], ms=nm["ms"],
            plain_ms=nm["plain_ms"], bound_ms=nm_bound, bound_by=nm_by),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
