"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port's main paths at the reference's full size (800x480
frames, a 2048-slot map, 32 keyframe slots) and checks them: the per-frame
tracking step on a fixture map; the stereo bootstrap that builds a map from
a sideways camera motion (trails, homography, triangulation, bundle
adjustment, epipolar growth, plane alignment) and then tracks on it;
bundle adjustment at the map's full capacities and at 128 keyframe slots
through every solver; full SLAM through the facade at the default and at
the large-map configuration; the command line on the four TUM-format
sequences; four camera streams tracked together in one batched program;
the slow tier: bundle adjustment at 512 keyframes, a 200-frame drift
audit and a run on a real photograph with sensor effects; and the
multi-device paths (sharded bundle adjustment, sharded re-find and
epipolar search, replicated tracking) on one rank over NCCL and on four
ranks sharing the card over gloo.

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels (csrc/fast.cu, csrc/segsum.cu), one
   nvcc per source, started together, and prints what ptxas reports for
   each kernel (registers, spill bytes); a spill fails it;
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
18. (run right after phase 3) the segmented-sum kernel of bundle
   adjustment's scatter sums (csrc/segsum.cu, ops/scatter.segmented_sum)
   at phase 9's shapes: U and the CG product over the measurement table's
   camera index and the first point chunk's camera-pair sum, at 32 and at
   128 keyframe slots, and at 128 slots the chunk's block band; each on
   the indices and kept terms bundle_adjust's plans take, with seeded
   values onto a seeded out: bit-equal to the order-exact plain version
   (segmented_sum_ordered_reference), to the kernel's first version
   (segmented_sum_rowblock, one block per row) and to the kernel's other
   path, within 1e-5 of each row's sum of |terms| of the plain version in
   index order, two launches bit-equal, rows without terms untouched; no
   kernel of segsum.cu spills registers (ptxas's report, printed in phase
   2); timed as CUDA-graph replays (median of 50) against the first
   version in turns (first, new, other path twice, new, first), for the
   point chunks also with the L2 flushed by a 64 MB read before each
   launch, beside its bound, the plain version and the two library calls
   that compute the same sum (index_put_(accumulate=True) and
   index_add_). Every path that runs bundle adjustment (phases 7-12,
   14-16, and 17's ranks) must launch it; its launches are counted per
   path, and by width (F = 6 / 36) and kernel path (short / long);
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
   ZMSSD, subpixel and triangulation. Then the last tracked frame of phase
   7 becomes keyframe 2 of the map it tracked on, on the card and on the
   CPU from copies of the same inputs: integrate_keyframe, growth at levels
   3, 0, 1, 2 (which must insert points on both), one refind_newly and one
   local bundle adjustment round, compared by outcome;
9. bundle adjustment at full state size: a problem made from a seed with
   numpy at the map's capacities (32 cameras, one fixed; 2048 points; up to
   16 observations each; 0.3 px of noise; 5% of the measurements moved by
   30-60 px): bundle_adjust(max_iters=20) on the card must bring the rms
   to the noise level and eject the moved measurements, and agree with the
   same run on the CPU by objective and rms; one LM iteration is timed by
   stage with CUDA events. Then an odometry-style problem at 128 keyframe
   slots (2048 points, 16 observations each from consecutive cameras, so
   co-observation offsets stay within the band of 16; seed 6) runs 10 LM
   iterations through each (assembly, solver) path: scatter + chol, band +
   chol, band + band_pcg, scatter + pcg, on the card and on the CPU. Each
   must reach the noise level and eject the moved measurements, agree
   with the CPU by objective, rms and ejected set, and with scatter + chol
   by rms and by objective at one sigma; CG iterations and reads per solve
   and one LM iteration by stage are printed;
10. full SLAM through the facade (models/slam.SLAMSystem) at
   the default SLAMConfig (800x480, 4096 point slots, 64 keyframe slots),
   on bench.py's 120-frame synthetic sequence (seed 11, px_per_m 240) with
   touches at frames 0 and 6, then 4 blank frames and the camera back at
   the pose of frame 100 for 8 frames. The bootstrap must finish by frame
   8, more than 90 of the 120 frames must track, keyframes must be added
   after the bootstrap's two, the ATE must stay under 2% of the
   trajectory's span, every task the scheduler reaches must run, tracking
   must be lost on the blank frames, relocalize on the first real frame
   after them and track GOOD after;
   no result may hold a NaN; fast_detect_levels must launch once per
   front-end run and fast_nonmax_levels once per keyframe inserted, and
   no synchronising call may come from triangulation. This checked run is
   in sync mode; each mapping task is timed from here between two device
   synchronisations, and the facade's device-to-host reads are counted per
   tracked frame.
   The first keyframe integration (integrate_keyframe, growth at levels 3,
   0, 1, 2, one refind_newly, one local bundle adjustment round) and the
   relocalization are then replayed from a copy of their inputs on the
   card and on the CPU and compared by outcome. On this sequence the growth
   there inserts nothing on either side (the scene lies past the epipolar
   depth cap of its 3 cm bootstrap baseline), so phase 8's replay is the
   one that holds growth on the card to the CPU. After the checks the same
   facade goes on for 10 frames, nothing wrapped, under torch.profiler: the
   device's busy share. Then the sequence runs three more times, each from
   a fresh facade with the same seed and no synchronisation between
   mapping tasks: in sync mode, which must equal the checked run bit for
   bit; pipelined at depth 1 (SLAMSystem(pipelined=True), run_slam's
   default), which must deliver every frame id once and in order with a
   placeholder only on the call after the bootstrap, and equal the
   checked run frame for frame, matched by frame_id, poses bit for bit;
   and pipelined at depth 3 (bench.py's protocol), which must deliver
   likewise (three placeholders) and meet every bound above, the
   relocalization on a real frame after the blanks (the host's decisions
   trail by three frames). For each mode (and the checked run): frames/s,
   the host's wait in the stats read per tracked frame (a blocking read
   in sync mode, the wait on the pinned copy's CUDA event pipelined) and
   the synchronising calls per tracked frame with no mapping work, which
   must be the frame's reads but for the pipelined stats read. Every
   facade replays its tracking step as CUDA graphs (models/step_graph.py),
   captured on its first tracked frame, whose synchronisations (one per
   capture) are reported apart; each run prints its step_graph_counts,
   and FAST's wrapper calls expected are one a front-end run plus the
   step's three eager warm-ups and six captures, less one a replay (a
   replay runs the recorded kernel with no wrapper call; phase 19 counts
   the kernel in the replays);
19. (run right after phase 10's modes) the tracking step's CUDA graphs
   against the eager step: a facade 24 frames into phase 10's sequence
   gives the state, the next frame and draws from a seed are the inputs;
   each variant (use_prior, forced_coarse) runs eagerly and through a new
   StepGraphs (its first call captures all six graphs, timed), and every
   output (stats, pose, found masks, map) must be bit-equal; then each
   graph's replay is timed by CUDA events (median of 50) beside the eager
   step (host clock to a synchronisation, median of 5), and 5 replays of
   each run under torch.profiler (after one in its warm-up step), which
   must see fast_levels_kernel once a replay: the device activities a
   replay holds, their summed time and the share of the replay's span,
   traced and untraced, that their union covers;
11. the large-map facade: tools/run_large_map_slam.py's configuration
   (800x480, max_keyframes 128 above dense_solver_max_cams 64,
   min_frames_between_kfs 4) pipelined at depth 3, as the tool runs it,
   over its traverse (a 4096^2
   texture, 12 m sideways, 600 frames rendered on the card), touches at
   frames 0 and 6. Every bundle adjustment after the bootstrap must go
   through band + band_pcg or scatter + pcg (the choices and rounds are
   printed by path), no NaN may be left in the map, more than 60% of the
   frames must track, every frame id must be delivered once and in order,
   and the map must hold more keyframes than phase 10's; frames/s, points,
   CG iterations and reads per tracked frame are printed, tracked, lost
   and points beside the JAX package's record of the tool (a TPU run,
   context only), and the FAST launches must equal front-end runs and
   keyframes;
12. the command line: tools/make_tum_synthetic.py's 120-frame sequence
   (seed 33) in the four variants of artifacts/ATE_r5.json (clean and
   degraded, 640x480 and 800x480; the degradations are the tool's, through
   utils/synthetic.degrade), each rendered by the port on the card and
   written as PNG files with rgb.txt and groundtruth.txt into a temporary
   directory, then ``run_slam --dataset tum --root <dir> --frames 120
   --width <w> --height 480 --json`` (the first also ``--save-map
   <file>``) through run_slam.main on the card, pipelined at depth 1 (its
   default). Each report must name the
   frame reader that ran, more than 90 frames must track, at least 2
   keyframes, the ATE must stay under 2% of the trajectory's span (printed
   beside the JAX package's figures: artifacts/ATE_r5.json, a TPU run, and
   its run_slam on the CPU on the tool's files; reported, not claimed),
   FAST must launch once per front-end run and once per keyframe, and the
   saved map must load back equal to the live one;
13. multi-stream tracking (parallel/replicated_tracking.stream_step), run
   right after phase 6 on phase 4's map and frames as bench.py's
   multistream_4x_aggregate_fps runs it: 4 streams, stream s at step k on
   frame (k + 7 s) % 100, all starting at frame 0's pose with the SBI
   primed from frame 0, 3 warm-up steps and the timed pass over the 100
   frames, with fixed draws per stream. First fast_detect_levels with the
   stream in its grid, on the four levels of 4 different frames: masks
   bit-equal to the plain version and to one single-frame launch per
   stream, scores within 1e-3, timed (CUDA-graph replay, median of 50)
   beside its bound and the four single-frame launches. Then every stream
   must find more than 50 points and not be BAD at the last step, and end
   within phase 4's pose bound of the rendered pose of the frame it saw;
   the path must launch fast_detect_levels once per step (not once per
   stream); each stream over the first 5 steps must equal stream_step at
   S = 1 on its frames and draws (n_found and quality equal, R and t within
   1e-4); the first 3 steps on the CPU through the plain path must agree
   with the card (poses within 1e-4, n_found within 2%, quality equal); and
   a step must make no synchronising call. Printed: each stream's minimum
   found and BAD steps, the aggregate frames/s beside phase 6's one-stream
   figure, launches per step and the device's busy share under
   torch.profiler at S = 4 and S = 1, and the count of vmap fallbacks;
14. bundle adjustment at 512 keyframes (tests/test_scale_ba.py on the
   card): fixtures.build_band_ba_map (seed 5, 512 keyframes, 30,000
   points, 4 consecutive observations each, poses and points perturbed)
   and mapmaker.build_ba_problem on the card, more than 80,000
   measurements. pcg (4 LM iterations, 200 CG iterations, tolerance 1e-6)
   must bring the rms from above 1 to below 0.45, accept a step, stay
   finite and leave camera 0 alone; band + chol at the config's band
   half-width (3 iterations) must reach rms 0.45, every co-observing pair
   within the band. Then the file's cross-checks, 3 iterations each: at 96
   keyframes / 4,000 points pcg against scatter + chol and band_pcg
   against band + chol, at 64 keyframes / 3,000 points the histogram sigma
   against the exact one through band_pcg: each pair's rms within 0.05,
   and each run on the card against the same run on the CPU by the
   objective at the card run's sigma (within 5e-3). Printed: ms per LM
   iteration by solver, CG iterations and host reads per solve,
   torch.cuda.max_memory_allocated;
15. the drift audit (tests/test_drift.py through the facade on the card):
   320x240, 512 point slots, 12 keyframe slots, 200 frames of a
   back-and-forth sweep with pan over the planar scene (seed 21), touches
   at frames 0 and 6. Tracking by frame 8 and never lost after it, no BAD
   frame, ATE under 2.5% of the span, the median error of the last quarter
   under 3 x max(the first quarter's, 0.002), the final point count above
   half the running maximum, at least 4 keyframes, more measurements than
   points, a median of more than 60 points found over the last 40 frames;
16. the real-photo run (tests/test_real_texture.py through the facade on
   the card): the same configuration, 80 frames of make_photo_scene (the
   package's grey photograph, mirror-tiled, 200 px/m) with exposure
   drift, read noise and defocus blur on every 7th frame
   (apply_sensor_effects, seed 13), touches at frames 0 and 8. Tracking by
   frame 12 and never lost after it, no BAD frame, at least 3 keyframes,
   more than 100 points, and the ATE under 7.5% of the span: that file's
   4.5% is not met by the JAX package itself on these frames (6.10% on the
   CPU). Phases 15 and 16 also require a finite map and FAST launched once
   per front-end run and once per keyframe;
17. the multi-device paths (parallel/mesh, sharded_ba, sharded_mapping,
   replicated_tracking.replicated_step_fn), run right after phase 13 on
   phase 4's map and frames. After the FAST library is built here, every
   leg runs on spawned ranks (parallel/mesh.run_ranks) at D = 1 over NCCL
   (device transport) and at D = 4 ranks sharing the card over gloo (host
   transport), and is held against the single-device function on the
   card: (1) sharded BA, scatter + chol, on phase 9's 128-slot problem (20
   LM iterations, to the optimum); (2) band_pcg with the histogram sigma
   on phase 14's 512-keyframe / 30,000-point problem (5 LM iterations); (3)
   sharded_bundle_adjust_halo on it, held against leg 2's run; each by the
   objective at the reference's sigma (rtol 1e-4), rms (1%), poses (5e-3
   of the trajectory's length), at least one accepted step, every rank
   holding the same cameras, and one LM step's collectives by site equal
   to sharded_ba.comm_bytes_per_lm_step (the scalars: port_scalar_bytes);
   (4) both sharded re-finds in a second keyframe rendered at
   __graft_entry__.py's motion: found and never-retry sets and the
   measurement mask equal to refind_in_keyframe's (and to
   refind_in_keyframes_batched's keyframe-1 row), uv within 1e-4; (5)
   sharded_epipolar_search at levels 0-2 (candidates thinned at radius
   3): success sets equal to epipolar_search's, pos_w and target_uv within
   1e-3, at least 32 successes over the levels; (6) replicated_step_fn at
   S = 4 for 20 steps (after 2 untimed): n_found and quality equal to
   stream_step's on the card, R and t within 1e-4, one FAST launch per
   rank per step. Printed: each leg's wall time and ms per LM iteration,
   the payload bytes against the model, the host copies, the backend and
   transport, and each collective's median time alone (4 bytes and 2.36 MB
   a rank).

Any failed check raises and the script exits non-zero. The last two lines
of standard output are a JSON object describing the kernels (`launches`
is the sum over phases 4, 7, 9-17 (phase 10's mode runs as "slam_modes"),
`launches_by_path` gives
each, phase 17's as "sharded" (this process: the second keyframe) and
"sharded_ranks" (the ranks' launches, summed); the row
fast_detect_levels_streams is the same kernel's stream-gridded launch,
counted on the streams path and by the ranks; the row segmented_sum
gives the 128-slot pair chunk's figures and every case of phase 18 under
"cases") and the ``{"ok": true, "device": ...}`` line. It imports no
jax.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
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
# Full SLAM (phase 10): bench.py's _full_slam_fps sequence and its bound on
# tracked frames, test_slam.py's ATE bound, its relocalization pattern.
SLAM_FRAMES = 120
SLAM_MIN_TRACKED = 90        # of SLAM_FRAMES
SLAM_BOOT_BY = 8             # first tracking frame at the latest
SLAM_ATE_SHARE = 0.02        # of the trajectory's span
SLAM_BLANKS = 4
SLAM_RETURN_TO = 100         # the frame whose pose the camera comes back to
SLAM_AFTER = 8               # frames shown after the blanks
SLAM_DEPTHS = (1, 3)         # phase 10's pipelined runs (3: bench.py's)
# A keyframe integration replayed on the card and on the CPU, by outcome:
# measurement counts within 1%, the (point, keyframe) pairs with a
# measurement agreeing on 98% of those either side has, the points the four
# growth levels add within 2, the rms after a local bundle adjustment within
# BOOT_RMS_AGREE; the relocalizer's pose within 1e-4.
KF_MEAS_AGREE = 0.01
KF_PAIRS_AGREE = 0.98
KF_NEW_POINTS_SLACK = 2
RELOC_POSE_ATOL = 1e-4
# Phase 9, extended: bundle adjustment at 128 keyframe slots, an
# odometry-style problem whose co-observing pairs lie within the band.
BIG_K, BIG_N, BIG_O, BIG_BAND = 128, 2048, 16, 16
BIG_SEED = 6
BIG_MAX_ITERS = 10
BIG_PAIRS = (("scatter", "chol"), ("band", "chol"), ("band", "band_pcg"),
             ("scatter", "pcg"))
BIG_DENSE_AGREE = 0.02   # each path vs scatter + chol: objective and rms
# Phase 11: the large-map facade (tools/run_large_map_slam.py).
LARGE_FRAMES = 600        # frames of the traverse (the tool's count)
LARGE_RUN = 600           # of them, run through the facade from frame 0
# Along the traverse a keyframe is queued every 5 frames and takes 5 mapping
# tasks, so the queue never empties and bundle adjustment waits; the camera
# then holds still at the last pose for LARGE_HOLD frames while it drains.
LARGE_HOLD = 40
LARGE_MIN_TRACKED = 0.6   # share of the frames
LARGE_DEPTH = 3           # the tool's pipeline depth
# The JAX package's record of the tool's run (artifacts/
# LARGE_MAP_SLAM_r5.json, a TPU run at depth 3): context, not a bar.
LARGE_JAX_TPU = {"frames": 600, "tracked": 479, "map_points": 323,
                 "keyframes": 91}
# Phase 12: run_slam on the four TUM-format sequences of
# tools/make_tum_synthetic.py (clean and degraded, 640x480 and 800x480, 120
# frames each), the variants of artifacts/ATE_r5.json.
TUM_FRAMES = 120
TUM_MIN_TRACKED = 90
TUM_ATE_SHARE = 0.02
TUM_VARIANTS = (("clean", 640), ("degraded", 640), ("clean", 800),
                ("degraded", 800))
# Reported beside the port's ATE, not bounds: artifacts/ATE_r5.json, the JAX
# package's run_slam on a TPU (m, % of the span), and the JAX package's
# run_slam on the CPU at the same preset on the tool's own files (m).
TUM_JAX_TPU = {"clean_640x480": (0.00909, 1.09),
               "degraded_640x480": (0.00818, 0.98),
               "clean_800x480": (0.00886, 1.06),
               "degraded_800x480": (0.01076, 1.28)}
TUM_JAX_CPU = {"clean_640x480": 0.00098, "degraded_640x480": 0.00233,
               "clean_800x480": 0.00037, "degraded_800x480": 0.00177}
# Phase 14: tests/test_scale_ba.py at 512 keyframes / 30,000 points, and its
# 96- and 64-keyframe cross-checks, with that file's bounds.
BA512_SEED = 5
BA512_RMS_BEFORE = 1.0
BA512_RMS_AFTER = 0.45
BA512_PATHS_AGREE = 0.05      # |rms difference| between two paths
# Card against the CPU on the small problems, by the objective at the card
# run's sigma: two f32 solvers in different orders part the LM path by up
# to 3e-4 of the objective after 1-3 steps (the port against the JAX
# package on the CPU, tests/test_torch_slow_tier.py).
BA512_CPU_AGREE = 5e-3
# Phases 15 and 16: tests/test_drift.py (200 frames, seed 21) and
# tests/test_real_texture.py (80 frames of the photograph, seed 13), each
# with its file's bounds.
DRIFT_FRAMES = 200
DRIFT_BOOT_BY = 8
DRIFT_ATE_SHARE = 0.025
PHOTO_FRAMES = 80
PHOTO_BOOT_BY = 12
# Not tests/test_real_texture.py's 4.5%: the JAX package itself reads 6.10%
# of the span on these frames on the CPU, which fails that bound (ROADMAP
# queue 3, reference fault j); the port reads 6.08-6.30% on the CPU.
PHOTO_ATE_SHARE = 0.075
# Phase 19: the tracking step's CUDA graphs (models/step_graph.py) against
# the eager step, on the state of a facade STEP_GRAPH_FRAMES frames into
# phase 10's sequence and that sequence's next frame, with draws from
# STEP_GRAPH_SEED; STEP_GRAPH_REPS timed replays of each graph, STEP_EAGER_REPS
# eager steps.
STEP_GRAPH_FRAMES = 24
STEP_GRAPH_SEED = 19
STEP_GRAPH_REPS = 50
STEP_EAGER_REPS = 5
# Replays of each graph under torch.profiler: what a replay holds.
STEP_TRACED_REPS = 5
# After phase 10's checked run, its facade goes on for PROFILE_FRAMES frames
# with nothing wrapped, under torch.profiler: the device's busy share.
PROFILE_FRAMES = 10
# Phase 13: multi-stream tracking as bench.py's multistream_4x_aggregate_fps
# runs it: S streams, stream s at step k on frame (k + 7 s) % 100, three
# warm-up steps on frames 0-2, then the timed pass over the 100 frames.
STREAMS = 4
STREAM_OFFSET = 7
STREAM_WARMUP = 3
STREAM_SINGLE_STEPS = 5     # streams against S = 1 stream_step
STREAM_CPU_STEPS = 3        # card against the CPU
STREAM_PROFILE_STEPS = 5
STREAM_SINGLE_ATOL = 1e-4   # tests/test_replicated_tracking.py's atol
# Phase 17: the multi-device paths. Each (ranks, backend, transport) runs
# every leg; on one card the four ranks share it over gloo through host
# memory (NCCL refuses two ranks on one device).
SHARDED_RUNS = ((1, "nccl", "device"), (4, "gloo", "host"))
SHARDED_TIMEOUT = 480        # s, each set of ranks
SHARDED_THREADS = 2          # torch CPU threads per rank
SHARDED_BA128_ITERS = 20     # LM iterations of leg 1 (to the optimum)
SHARDED_BA_ITERS = 5         # LM iterations of legs 2 and 3 (512 keyframes)
SHARDED_BA_KW = dict(solver="band_pcg", band_halfwidth=16, sigma_mode="hist",
                     point_block=1024, cg_iters=300, cg_tol=1e-7)
SHARDED_OBJ_RTOL = 1e-4      # objective at one sigma
SHARDED_RMS_RTOL = 0.01
SHARDED_POSE_SHARE = 5e-3    # of the trajectory's length
SHARDED_UV_ATOL = 1e-4       # re-found measurements, px
SHARDED_EPI_ATOL = 1e-3      # epipolar pos_w and target_uv
# The second keyframe of legs 4-5: __graft_entry__.py:165-177's motion.
SHARDED_KF1_MU = (0.22, 0.02, 0.0, 0.0, 0.05, 0.0)
SHARDED_EPI_LEVELS = (0, 1, 2)
SHARDED_STEPS = 20           # leg 6
# f32 elements of the collectives timed alone: one scalar, and leg 1's
# dense Schur correction (128 cameras: 2.36 MB).
SHARDED_PROBE_FLOATS = (1, (6 * BIG_K) ** 2)
SHARDED_WARMUP = 2
# Published peaks of one H100 SXM: HBM3 rate and f32 rate outside the tensor
# cores.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


# Phase 18: the segmented-sum kernel against its plain versions. The
# order-exact one and the kernel's first version make the same additions:
# bit-equal. The plain version in index order adds each row's terms in
# another order (one after another, against chains and a tree): each
# element within SEGSUM_RTOL of its row's sum of |terms| (f32 rounding of
# up to ~1000 terms).
SEGSUM_RTOL = 1e-5
SEGSUM_SEED = 18
SEGSUM_FLUSH_BYTES = 64 << 20  # read between launches to flush the L2

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
    Returns per-frame (R, t, stats) and the last frame's whole output."""
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
    return outs, o


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

    outs, last = track_on(init, sbi, frames[N_TRAIL_FRAMES + 1:], cam,
                          config, frame_step, gen)
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
    # integrate_keyframe's inputs for the last tracked frame as keyframe 2
    # of the map it tracked on (replayed by phase 8).
    kf_args = (last.slam_map, init.new_points, init.never_retry,
               init.failure_mask, last.frame, last.R, last.t, last.found,
               last.found_pos, last.search_level, last.did_subpix, 2, cam,
               config)
    return config, cam, frames, trails, second, init, launches, kf_args


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
    return rms, objective_at(prob, cam, res, res.sigma_squared, bundle,
                             mestimator)


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

    # One LM iteration at the problem's first state, stage by stage, with
    # the scatter sums' plans made once, as bundle_adjust makes them.
    sp, valid = bundle._sanitized(prob)
    fixed_m = sp.cam_fixed[sp.meas_kf.long()]
    lam = bc.lambda_init
    ms_plans, plans = event_ms(lambda: bundle._make_plans(
        sp.meas_kf, K, bc.point_block))
    ms_lin, lin = event_ms(lambda: bundle._linearize(
        sp, cam, sp.cam_R, sp.cam_t, sp.points, valid, fixed_m,
        bundle.MIN_SIGMA_SQ, plan=plans.kf))
    ms_schur, (Sm, E, Vinv, free) = event_ms(lambda: bundle._reduced_system(
        lin, sp, lam, bc.point_block, plans=plans))
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
          f"{ms_lin + ms_schur + ms_solve + ms_back:.3f} ms; the scatter "
          f"sums' plans, once per bundle_adjust call, {ms_plans:.3f} ms  "
          f"[{card}]")


def make_band_problem(config, seed, bundle, cam_ops, synthetic, lie):
    """A bundle problem at 128 keyframe slots, made with numpy from a seed on
    the CPU: BIG_K cameras along a 10 m sideways path looking ahead (camera
    0 fixed), BIG_N points 3.5-6 m away, each seen by the BIG_O consecutive
    cameras from the one it is anchored at (co-observation offsets at most
    BIG_O - 1 <= BIG_BAND, as on an odometry map), at pyramid levels 0-2
    with BA_NOISE_PX of noise per level-pixel; BA_OUTLIER_SHARE of the
    measurements moved by 30-60 px. Cameras 1.. and all points start
    perturbed. Returns (problem, camera, moved [N, O] bool)."""
    rng = np.random.default_rng(seed)
    tc = config.tracker
    K, N, O = BIG_K, BIG_N, BIG_O
    cam = cam_ops.make_camera(config.camera.params(), tc.width, tc.height,
                              device="cpu")
    xs = -5.0 + 10.0 * np.arange(K) / (K - 1)
    poses = [synthetic.look_at_pose((x, 0.1 * np.sin(0.3 * k), 0.0),
                                    target=(x, 0.0, 4.5), device="cpu")
             for k, x in enumerate(xs)]
    R = torch.stack([p[0] for p in poses])
    t = torch.stack([p[1] for p in poses])
    anchor = rng.integers(0, K, N)
    pts = torch.from_numpy(np.stack(
        [xs[anchor] + rng.uniform(0.0, 1.2, N), rng.uniform(-1.2, 1.2, N),
         rng.uniform(3.5, 6.0, N)], -1).astype(np.float32))
    order = torch.from_numpy(np.minimum(anchor[:, None] + np.arange(O),
                                        K - 1).astype(np.int64))
    pc = torch.einsum("noij,nj->noi", R[order], pts) + t[order]
    px = cam_ops.project(cam, pc[..., :2] / pc[..., 2:3])
    meas_valid = ((pc[..., 2] > 0.1) & cam_ops.in_image(cam, px, border=5.0)
                  & torch.from_numpy(anchor[:, None] + np.arange(O) < K))
    level = torch.from_numpy(rng.integers(0, 3, (N, O)).astype(np.float32))
    noise = torch.from_numpy(
        rng.normal(scale=BA_NOISE_PX, size=(N, O, 2)).astype(np.float32))
    uv = px + noise * (2.0 ** level)[..., None]
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


def objective_at(prob, cam, res, sigma_sq, bundle, mestimator):
    """The robust objective of a result at a given sigma^2 (Tukey scores
    plus one per ejected measurement): runs that part ways in their lambda
    schedules end at slightly different sigmas, so paths are compared at
    one."""
    kept = prob.replace(meas_valid=res.meas_valid)
    sp, valid = bundle._sanitized(kept)
    _, _, err_sq, z_bad = bundle._project_all(cam, res.cam_R, res.cam_t,
                                              res.points, sp)
    score = mestimator.objective_score(err_sq, sigma_sq)
    return float(torch.sum(torch.where(valid & ~z_bad, score, 0.0))
                 + res.outlier_meas.sum())


def ba_run(prob, cam, bundle, **kwargs):
    """One bundle_adjust on prob's device: (result, wall ms, LM iterations,
    CG solves, CG iterations, CG reads)."""
    bundle.HOST_READS.update(bundle_adjust=0, cg=0)
    bundle.CG_STATS.update(solves=0, iterations=0)
    sync(prob.points.device)
    t0 = time.perf_counter()
    res = bundle.bundle_adjust(prob, cam, **kwargs)
    sync(prob.points.device)
    return (res, 1e3 * (time.perf_counter() - t0),
            bundle.HOST_READS["bundle_adjust"], bundle.CG_STATS["solves"],
            bundle.CG_STATS["iterations"], bundle.HOST_READS["cg"])


def run_ba_path(prob, cam, assembly, solver, config, bundle):
    """One bundle_adjust run of a path at 128 keyframe slots (ba_run)."""
    bc = config.bundle
    return ba_run(prob, cam, bundle, max_iters=BIG_MAX_ITERS,
                  point_block=bc.point_block, assembly=assembly,
                  solver=solver, band_halfwidth=BIG_BAND,
                  cg_iters=bc.cg_iters, cg_tol=bc.cg_tol)


def ba_path_stages(prob, cam, assembly, solver, config, bundle, wls):
    """One LM iteration of a path at the problem's first state, stage by
    stage (CUDA events around the eager calls, median of 5; a CG stage
    includes its reads), and the scatter sums' plans that bundle_adjust
    makes once per call ("plans", not part of the iteration)."""
    bc = config.bundle
    K = prob.cam_R.shape[0]
    sp, valid = bundle._sanitized(prob)
    fixed_m = sp.cam_fixed[sp.meas_kf.long()]
    lam = bc.lambda_init
    ms = {}
    plans_ms, plans = event_ms(lambda: bundle._make_plans(
        sp.meas_kf, K, bc.point_block, assembly, solver, BIG_BAND), reps=5)
    ms["linearize"], lin = event_ms(lambda: bundle._linearize(
        sp, cam, sp.cam_R, sp.cam_t, sp.points, valid, fixed_m,
        bundle.MIN_SIGMA_SQ, plan=plans.kf), reps=5)
    if solver == "chol":
        ms["schur"], (Sm, E, Vinv, free) = event_ms(
            lambda: bundle._reduced_system(lin, sp, lam, bc.point_block,
                                           assembly, BIG_BAND, plans=plans),
            reps=5)
        ms["cholesky"], upd = event_ms(
            lambda: wls.solve_spd(Sm, E.reshape(-1), ridge=0.0), reps=5)
        upd = upd.reshape(K, 6)
    else:
        ms["assembly + cg"], (upd, Vinv, free) = event_ms(
            lambda: bundle._cg_camera_update(
                lin, sp, lam, bc.point_block, solver, BIG_BAND, bc.cg_iters,
                bc.cg_tol, plans=plans), reps=5)
    ms["back-substitution"], _ = event_ms(lambda: bundle._back_substitute(
        lin, sp, cam, sp.cam_R, sp.cam_t, sp.points, upd, Vinv, free,
        bc.update_convergence), reps=5)
    return ms, plans_ms


def phase_ba_large(device, card, config, bundle, cam_ops, lie, mestimator,
                   synthetic, wls):
    """Bundle adjustment at 128 keyframe slots through each (assembly,
    solver) path on the card and on the CPU: outcome by path, card against
    CPU, each path against the dense one, CG iterations and reads per solve,
    one LM iteration by stage."""
    prob_cpu, cam_cpu, moved = make_band_problem(config, BIG_SEED, bundle,
                                                 cam_ops, synthetic, lie)
    prob, cam = prob_cpu.to(device), cam_cpu.to(device)
    n_meas, n_moved = int(prob_cpu.meas_valid.sum()), int(moved.sum())
    offset = bundle.max_pair_offset(prob.meas_kf,
                                    prob.meas_valid & prob.point_valid[:, None])
    rms0 = float(bundle.reprojection_rms(prob, cam))
    print(f"BA at {BIG_K} cameras: {int(prob_cpu.point_valid.sum())} of "
          f"{BIG_N} points, {n_meas} measurements ({n_moved} moved), "
          f"largest co-observation offset {offset} (band {BIG_BAND}), rms "
          f"{rms0:.4f}; {BIG_MAX_ITERS} LM iterations per run")
    check(offset <= BIG_BAND, f"pair offset {offset} exceeds the band")
    runs = {}
    run_ba_path(prob, cam, "scatter", "chol", config, bundle)  # warm-up
    for assembly, solver in BIG_PAIRS:
        name = f"{assembly}+{solver}"
        card_run = run_ba_path(prob, cam, assembly, solver, config, bundle)
        cpu_run = run_ba_path(prob_cpu, cam_cpu, assembly, solver, config,
                              bundle)
        runs[name] = (card_run, cpu_run)
    dense = runs["scatter+chol"][0][0]
    sigma_ref = dense.sigma_squared
    obj_dense = objective_at(prob, cam, dense, sigma_ref, bundle, mestimator)
    rms_dense = ba_outcome(prob, cam, dense, bundle, mestimator)[0]
    for (assembly, solver) in BIG_PAIRS:
        name = f"{assembly}+{solver}"
        (res, ms, iters, solves, cg_it, cg_reads), cpu = runs[name]
        res_c, cpu_ms = cpu[0], cpu[1]
        rms1, obj1 = ba_outcome(prob, cam, res, bundle, mestimator)
        rms_c, obj_c = ba_outcome(prob_cpu, cam_cpu, res_c, bundle,
                                  mestimator)
        obj_common = objective_at(prob, cam, res, sigma_ref, bundle,
                                  mestimator)
        ejected = res.outlier_meas.cpu()
        hit = int((ejected & moved).sum())
        differ = int((ejected != res_c.outlier_meas).sum())
        stages, plans_ms = ba_path_stages(prob, cam, assembly, solver,
                                          config, bundle, wls)
        cg = (f"; CG {cg_it / solves:.1f} iterations and "
              f"{cg_reads / solves:.2f} reads per solve over {solves} "
              f"solves (CPU: {cpu[4] / max(cpu[3], 1):.1f} iterations)"
              if solves else "")
        print(f"BA at {BIG_K} cameras, {name}: rms {rms0:.4f} -> "
              f"{rms1:.4f}, objective {obj1:.3f} (at the dense run's sigma "
              f"{obj_common:.3f}, dense {obj_dense:.3f}: "
              f"{100 * (obj_common / obj_dense - 1):+.4f}%), ejected "
              f"{int(ejected.sum())} ({hit} of the moved ones), "
              f"{int(res.accepted)} steps accepted, converged "
              f"{bool(res.converged)}; {ms:.3f} ms for {iters} LM iterations "
              f"= {ms / iters:.3f} ms each{cg}  [{card}]")
        print(f"  {name} card vs CPU: rms {rms1:.4f} / {rms_c:.4f}, "
              f"objective {obj1:.3f} / {obj_c:.3f}, ejected sets differ at "
              f"{differ} measurements (CPU {cpu_ms / 1e3:.1f} s); one LM "
              f"iteration by stage: " + ", ".join(
                  f"{k} {v:.3f} ms" for k, v in stages.items())
              + f", sum {sum(stages.values()):.3f} ms; plans (once per "
              f"call) {plans_ms:.3f} ms  [{card}]")
        check(rms1 < BA_RMS_AFTER, f"{name} ended at rms {rms1}")
        check(hit >= BA_EJECTED_SHARE * n_moved,
              f"{name} ejected only {hit} of {n_moved} moved measurements")
        check(bool(torch.isfinite(res.cam_t).all()
                   and torch.isfinite(res.points).all()),
              f"{name} left a non-finite state")
        check(torch.equal(res.cam_t[0], prob.cam_t[0]),
              f"{name} moved the fixed camera")
        check(abs(rms1 - rms_c) <= BA_AGREE * rms_c
              and abs(obj1 - obj_c) <= BA_AGREE * obj_c
              and differ <= 0.01 * n_meas,
              f"{name}: card and CPU differ (rms {rms1} / {rms_c}, objective "
              f"{obj1} / {obj_c}, {differ} ejections)")
        check(abs(obj_common - obj_dense) <= BIG_DENSE_AGREE * obj_dense
              and abs(rms1 - rms_dense) <= BIG_DENSE_AGREE * rms_dense,
              f"{name} is off the dense path: objective {obj_common} / "
              f"{obj_dense}, rms {rms1} / {rms_dense}")
        if solver != "chol":
            check(solves == iters and cg_it > 0,
                  f"{name}: {solves} CG solves for {iters} LM iterations")


def segsum_cases(config, bundle, cam_ops, lie, synthetic, device):
    """(label, index, n_rows, row shape, keep) at phase 9's shapes: for
    the 32-slot problem (make_ba_problem) and the 128-slot one
    (make_band_problem), U [K, 6, 6] and the CG product [K, 6] over the
    measurement table's camera index, the first point chunk's camera-pair
    sum [K K, 6, 6], and for 128 slots that chunk's block band
    [K (2 band + 1) + 1, 6, 6], dead row included; indices and kept terms
    (the valid measurements and their pairs) as bundle_adjust's plans
    take them."""
    block = config.bundle.point_block
    cases = []
    for label, (prob, _, _) in (
            ("32 slots", make_ba_problem(config, BA_SEED, bundle, cam_ops,
                                         lie, synthetic)),
            (f"{BIG_K} slots", make_band_problem(config, BIG_SEED, bundle,
                                                 cam_ops, synthetic, lie))):
        sp, valid = bundle._sanitized(prob)
        K = sp.cam_R.shape[0]
        kf = sp.meas_kf.long().to(device)
        valid = valid.to(device)
        chunk = kf[:block]
        pairs = valid[:block, :, None] & valid[:block, None, :]
        cases += [(f"U, {label}", kf.reshape(-1), K, (6, 6), valid),
                  (f"pair chunk, {label}", bundle._pair_index(chunk, K),
                   K * K, (6, 6), pairs)]
        if K == BIG_K:
            cases.append((f"band chunk, {label}",
                          bundle._band_index(chunk, K, BIG_BAND),
                          K * (2 * BIG_BAND + 1) + 1, (6, 6), pairs))
        cases.append((f"CG product, {label}", kf.reshape(-1), K, (6,),
                      valid))
    return cases


def ptxas_resources(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} from a
    build log of nvcc -Xptxas -v."""
    found, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            words = line.replace(",", " ").split()
            spills = (int(words[words.index("spill") - 2]),
                      int(words[words.index("loads") - 3]))
        elif "Used" in line and "registers" in line and name:
            words = line.replace(",", " ").split()
            found[name] = (int(words[words.index("registers") - 1]),
                           *spills)
            name, spills = None, (0, 0)
    return found


def l2_flush(scratch):
    """A call that reads `scratch` (past the 50 MB L2) into one sum: it
    leaves the L2 full of clean lines, so no write-back of its own is
    charged to what runs after it."""
    total = scratch.new_zeros(())
    return lambda: torch.sum(scratch, 0, out=total)


def flushed_ms(fn, flush, flush_ms):
    """Device ms of one call of fn that finds the L2 flushed: CUDA-graph
    replays of (flush, then fn), less flush_ms, flush's own time."""
    def flush_then():
        flush()
        fn()
    return cuda_ms(flush_then)[1] - flush_ms


def phase_segsum(device, card, config, bundle, scatter, cam_ops, lie,
                 synthetic):
    """Phase 18: the segmented-sum kernel on the card at phase 9's shapes
    (segsum_cases), on seeded values onto a seeded out: bit-equal to the
    order-exact plain version and to the first version of the kernel
    (segmented_sum_rowblock) and to the kernel's other path, each element
    within SEGSUM_RTOL of its row's sum of |terms| of the plain version in
    index order, two launches bit-equal, rows without terms untouched;
    then timed against the first version in turns (first, new, the other
    path twice, new, first), with the L2 warm and, for the chunk cases,
    flushed (first, new, new, first), beside its bound, the plain version
    and the two library calls that compute the same sum. Returns the
    cases' figures."""
    gen = torch.Generator(device=device).manual_seed(SEGSUM_SEED)
    flush = l2_flush(torch.ones(SEGSUM_FLUSH_BYTES // 4, device=device))
    rows = []
    for label, index, n_rows, shape, keep in segsum_cases(
            config, bundle, cam_ops, lie, synthetic, device):
        n_terms, width = index.numel(), int(np.prod(shape))
        src = torch.randn(n_terms, *shape, generator=gen, device=device)
        out0 = torch.randn(n_rows, *shape, generator=gen, device=device)
        plan = scatter.make_plan(index, n_rows, keep)
        keep = keep.reshape(-1)
        kept_index, kept_src = index[keep], src[keep]
        n_kept = kept_index.numel()
        path = scatter.path_for(n_terms, n_rows)
        first = scatter.segmented_sum(out0.clone(), plan, src)
        second = scatter.segmented_sum(out0.clone(), plan, src)
        ordered = scatter.segmented_sum_ordered_reference(out0.clone(), plan,
                                                          src)
        rowblock = scatter.segmented_sum_rowblock(out0.clone(), plan, src)
        other = next(p for p in scatter.PATHS if p != path)
        other_path = out0.clone()
        scatter._launch(other_path, plan, src, path=other)
        plain = scatter.segmented_sum_reference(out0.clone(), plan, src)
        abs_sum = scatter.segmented_sum_reference(
            torch.zeros_like(out0), plan, src.abs())
        torch.cuda.synchronize()
        hit = plan.row_start[1:] > plan.row_start[:-1]
        err = (first - plain).abs()
        max_err = float(err.max())
        bits = first.view(torch.int32)
        for that, what in ((second, "a second launch"),
                            (ordered, "the order-exact plain version"),
                            (rowblock, "the first version of the kernel"),
                            (other_path, f"the kernel's {other} path")):
            check(torch.equal(bits, that.view(torch.int32)),
                  f"segmented_sum, {label}: differs from {what} at "
                  f"{int((bits != that.view(torch.int32)).sum())} values")
        check(bool((err <= SEGSUM_RTOL * abs_sum).all()),
              f"segmented_sum, {label}: {max_err} from the plain version, "
              f"beyond {SEGSUM_RTOL} of a row's sum of |terms|")
        check(torch.equal(first[~hit].view(torch.int32),
                          out0[~hit].view(torch.int32)),
              f"segmented_sum, {label}: a row without terms changed")
        n_hit = int(hit.sum())
        buf = torch.zeros_like(out0)

        def new():
            scatter.segmented_sum(buf, plan, src)

        def old():
            scatter.segmented_sum_rowblock(buf, plan, src)

        def alt_path():
            scatter._launch(buf, plan, src, path=other)

        # In turns: first version, new, the other path twice, new, first.
        old_a = cuda_ms(old)[1]
        eager, new_a = cuda_ms(new)
        other_ms = [cuda_ms(alt_path)[1] for _ in range(2)]
        new_b = cuda_ms(new)[1]
        old_b = cuda_ms(old)[1]
        ms, old_ms = (new_a + new_b) / 2, (old_a + old_b) / 2
        flushed = None
        if "chunk" in label:
            flush_ms = cuda_ms(flush)[1]
            turns = [flushed_ms(fn, flush, flush_ms)
                     for fn in (old, new, new, old)]
            flushed = dict(flush_ms=flush_ms, old_turns=[turns[0], turns[3]],
                           new_turns=[turns[1], turns[2]],
                           ms=(turns[1] + turns[2]) / 2,
                           old_ms=(turns[0] + turns[3]) / 2)
        plain_eager, plain_ms = cuda_ms(
            lambda: scatter.segmented_sum_reference(buf, plan, src))
        # The library calls that compute the same sum: over the kept terms.
        _, put_ms = cuda_ms(
            lambda: buf.index_put_((kept_index,), kept_src, accumulate=True))
        _, add_ms = cuda_ms(lambda: buf.index_add_(0, kept_index, kept_src))
        # Each kept term's values and its perm entry read once, row_start
        # read once, each row with terms read and written once; one f32 add
        # per value of a kept term.
        n_bytes = 4 * (n_kept * width + n_kept + n_rows + 1
                       + 2 * n_hit * width)
        bound, by = bound_ms(n_bytes, n_kept * width)
        row = dict(case=label, terms=n_terms, kept=n_kept, rows=n_rows,
                   rows_hit=n_hit, width=width,
                   threads=scatter.threads_for(n_terms, n_rows), path=path,
                   max_abs_err=max_err, ms=ms, ms_turns=[new_a, new_b],
                   eager_ms=eager, rowblock_ms=old_ms,
                   rowblock_ms_turns=[old_a, old_b],
                   other_path=other,
                   other_path_ms_turns=other_ms, flushed_l2=flushed,
                   plain_ms=plain_ms, plain_eager_ms=plain_eager,
                   bound_ms=bound, bound_by=by, bytes=n_bytes,
                   share_of_bound=bound / ms, index_put_ms=put_ms,
                   index_add_ms=add_ms)
        rows.append(row)
        alt_text = (f", the {other} path {other_ms[0]:.5f} / "
                    f"{other_ms[1]:.5f} ms")
        cold = (f"; L2 flushed (a {SEGSUM_FLUSH_BYTES >> 20} MB read, "
                f"{flushed['flush_ms']:.5f} ms, taken off): "
                f"{flushed['ms']:.5f} ms against the first version's "
                f"{flushed['old_ms']:.5f}" if flushed else "")
        print(f"segmented_sum, {label}: {n_kept} of {n_terms} terms kept, "
              f"{width} values each, into {n_rows} rows ({n_hit} hit), "
              f"{row['threads']} threads a row, {path} path; device kernel "
              f"{ms:.5f} ms ({new_a:.5f} / {new_b:.5f}; eager call "
              f"{eager:.5f}) against the first version's {old_ms:.5f} "
              f"({old_a:.5f} / {old_b:.5f}): {old_ms / ms:.2f}x"
              f"{alt_text}; bound {bound:.5f} ms by {by} ({n_bytes} B, "
              f"{100 * bound / ms:.1f}% of it){cold}; plain "
              f"{plain_ms:.5f} ms, index_put_(accumulate=True) {put_ms:.5f} "
              f"ms, index_add_ {add_ms:.5f} ms; max |kernel - plain| "
              f"{max_err:.3e}, bit-equal to the order-exact plain version, "
              f"the first version, the other path and a second launch  "
              f"[{card}]")
    return rows


def phase_large_map(device, card, fast, slam, fstep, bundle, synthetic,
                    cam_ops, lie, default_keyframes):
    """The large-map facade: tools/run_large_map_slam.py's configuration
    (max_keyframes 128 > dense_solver_max_cams, min_frames_between_kfs 4)
    in its mode, pipelined at depth 3, over its traverse (a 4096^2
    texture, 12 m sideways), rendered on the card. Returns the FAST
    launches of the run."""
    from visualslam_android_tpu_torch.config import (
        MapMakerConfig,
        SLAMConfig,
        TrackerConfig,
    )

    config = SLAMConfig(tracker=TrackerConfig(min_frames_between_kfs=4),
                        mapmaker=MapMakerConfig(max_keyframes=128))
    tc = config.tracker
    cam = cam_ops.make_camera(config.camera.params(), tc.width, tc.height,
                              device=device)
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    scene = synthetic.make_planar_scene(rng, depth=4.0, tex_size=4096,
                                        px_per_m=240.0, device=device)
    R0, t0_ = synthetic.look_at_pose((0.0, 0.0, 0.0), target=(0, 0, 4.0),
                                     device=device)
    images = []
    for k in list(range(LARGE_RUN)) + [LARGE_RUN - 1] * LARGE_HOLD:
        s = k / max(LARGE_FRAMES - 1, 1)
        mu = torch.tensor(
            [12.0 * s, 0.15 * np.sin(9.0 * s), 0.25 * np.sin(5.0 * s), 0.0,
             0.05 * np.sin(7.0 * s), 0.02 * np.sin(4.0 * s)],
            dtype=torch.float32, device=device)
        Rk, tk = lie.se3_mul(*lie.se3_exp(mu), R0, t0_)
        images.append(synthetic.render(scene, cam, Rk, tk,
                                       (tc.height, tc.width)))
    sync(device)
    print(f"large map: {LARGE_RUN} of the {LARGE_FRAMES} frames of the 12 m "
          f"traverse and {LARGE_HOLD} at its last pose rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    del scene

    sys_ = slam.SLAMSystem(config, seed=0, pipelined=True,
                           pipeline_depth=LARGE_DEPTH, device=device)
    chosen, dispatched = {}, {}
    choice = sys_._solver_choice

    def spy():
        c = choice()
        chosen[f"{c[0]}+{c[1]}"] = chosen.get(f"{c[0]}+{c[1]}", 0) + 1
        return c

    ba_round = fstep.ba_round

    def counted(*args, assembly, solver, cap=(), **kwargs):
        key = f"{assembly}+{solver}" + (" (bootstrap prefix)" if cap else "")
        if not cap and sys_.frame_idx > LARGE_RUN:
            key += " (hold)"
        dispatched[key] = dispatched.get(key, 0) + 1
        sync(device)
        t0 = time.perf_counter()
        out = ba_round(*args, assembly=assembly, solver=solver, cap=cap,
                       **kwargs)
        sync(device)
        ba_ms.setdefault(key, []).append(1e3 * (time.perf_counter() - t0))
        return out

    ba_ms = {}
    sys_._solver_choice = spy
    # The facade's stage timer (synchronised stages) gives the time split.
    sys_.timer.enabled = True
    for name in fast.LAUNCHES:
        fast.LAUNCHES[name] = 0
    bundle.HOST_READS.update(bundle_adjust=0, cg=0)
    bundle.CG_STATS.update(solves=0, iterations=0)
    results = []
    fstep.ba_round = counted
    try:
        sync(device)
        t_wall = time.perf_counter()
        for k, img in enumerate(images):
            if k in (0, 6):
                sys_.on_touch()
            results.append(sys_.track_frame(img))
        results += sys_.flush()
        sync(device)
        wall = time.perf_counter() - t_wall
    finally:
        fstep.ba_round = ba_round
    launches = dict(fast.LAUNCHES)
    n_calls = len(images)
    del images
    results = [r for r in results if r.valid]
    check([r.frame_id for r in results] == list(range(n_calls)),
          "large map: frame ids not delivered once each and in order")
    n_frames = len(results)
    tracked = sum(r.phase == slam.PHASE_TRACKING and not r.lost
                  for r in results)
    n_lost = sum(r.lost for r in results)
    counts = torch.stack([sys_.slam_map.points.count(),
                          sys_.slam_map.keyframes.count()]).tolist()
    n_pts, n_kf = int(counts[0]), int(counts[1])
    finite = bool(torch.isfinite(sys_.slam_map.points.pos_w).all()
                  and torch.isfinite(sys_.slam_map.keyframes.t).all())
    reads = (sum(sys_.host_reads.values()) + bundle.HOST_READS["bundle_adjust"]
             + bundle.HOST_READS["cg"])
    cg = dict(bundle.CG_STATS)
    n_reloc = sum(r.message.startswith("Relocalized") for r in results)
    n_graph, graph_words = graph_calls(sys_)
    n_front = len(results) + n_reloc + n_graph
    print(f"large map: {tracked} of {n_frames} frames tracked, "
          f"{n_kf} keyframes (the default run made {default_keyframes}), "
          f"{n_pts} points, map finite {finite}; {n_frames / wall:.3f} "
          f"frames/s over {wall:.1f} s (no claim)  [{card}]")
    first_600 = results[:LARGE_FRAMES]
    tracked_600 = sum(r.phase == slam.PHASE_TRACKING and not r.lost
                      for r in first_600)
    print(f"large map, pipelined at depth {LARGE_DEPTH}: of the first "
          f"{len(first_600)} frames {tracked_600} tracked and "
          f"{sum(r.lost for r in first_600)} lost, "
          f"{first_600[-1].n_points} points and {first_600[-1].n_keyframes} "
          f"keyframes at frame {len(first_600) - 1}; {n_lost} lost in all; "
          f"beside the JAX package's record at depth 3 (a TPU run, context, "
          f"not a bar): {LARGE_JAX_TPU}")
    print(f"large map: solver choices {chosen}; bundle-adjustment rounds by "
          f"path {dispatched}; CG {cg['iterations'] / max(cg['solves'], 1):.1f}"
          f" iterations and {bundle.HOST_READS['cg'] / max(cg['solves'], 1):.2f}"
          f" reads per solve over {cg['solves']} solves; host reads "
          f"{dict(sys_.host_reads, bundle_adjust=bundle.HOST_READS['bundle_adjust'], cg=bundle.HOST_READS['cg'])}"
          f" = {reads / max(tracked, 1):.3f} per tracked frame")
    print("large map, time by facade stage (StageTimer, synchronised):")
    for line in sys_.timer.report().splitlines():
        print(f"  {line}")
    for key, ms in sorted(ba_ms.items()):
        print(f"  bundle adjustment {key}: {len(ms)} rounds, median "
              f"{statistics.median(ms):.3f} ms, max {max(ms):.3f} ms, sum "
              f"{sum(ms):.3f} ms  [{card}]")
    print(f"large map: FAST launches {launches}: {n_front} wrapper calls "
          f"({len(results)} frames + {n_reloc} relocalized{graph_words}), "
          f"{n_kf} keyframes inserted")
    scaled = {k: v for k, v in dispatched.items() if "prefix" not in k}
    check(scaled and {k.split()[0] for k in scaled}
          <= {"band+band_pcg", "scatter+pcg"},
          f"bundle adjustments outside the band / CG paths: {dispatched}")
    check(sum(chosen.values()) == sum(scaled.values()),
          f"{chosen} choices for {scaled} rounds")
    check(finite, "the large map holds a NaN")
    check(tracked > LARGE_MIN_TRACKED * n_frames,
          f"only {tracked} of {n_frames} frames tracked")
    check(n_kf > default_keyframes,
          f"{n_kf} keyframes, not above the default run's "
          f"{default_keyframes}")
    check(launches["fast_detect_levels"] == n_front,
          f"fast_detect_levels launched {launches['fast_detect_levels']} "
          f"times for {n_front} wrapper calls")
    check(launches["fast_nonmax_levels"] == n_kf,
          f"fast_nonmax_levels launched {launches['fast_nonmax_levels']} "
          f"times for {n_kf} keyframes")
    return launches


def write_tum_sequence(root, device, synthetic, cam_ops, lie, imageio,
                       degraded=False, width=640):
    """tools/make_tum_synthetic.py's sequence (seed 33, a 2048^2 texture of
    1400 blobs at 300 px/m, width x 480, TUM_FRAMES frames, with its
    degradations when `degraded`), rendered by the port on the card and
    written as PNG files with rgb.txt and groundtruth.txt. Returns the
    camera centres."""
    from scipy.spatial.transform import Rotation

    from visualslam_android_tpu_torch.config import CameraConfig

    rng = np.random.default_rng(33)
    w, h = width, 480
    cam = cam_ops.make_camera(CameraConfig().params(), w, h, device=device)
    scene = synthetic.make_planar_scene(rng, depth=4.0, tex_size=2048,
                                        px_per_m=300.0, n_blobs=1400,
                                        device=device)
    R0, t0 = synthetic.look_at_pose((0.0, 0.0, 0.0), device=device)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    ts0 = 1305031100.0
    rgb_lines = ["# color images", "# synthetic", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory",
                "# timestamp tx ty tz qx qy qz qw"]
    centers = []
    for k in range(TUM_FRAMES):
        s = k / max(TUM_FRAMES - 1, 1)
        mu = torch.tensor(
            [0.8 * np.sin(3.14 * s), 0.12 * np.sin(5.0 * s), 0.10 * s,
             0.03 * np.sin(4.0 * s), 0.20 * np.sin(3.14 * s),
             0.05 * np.sin(2.0 * s)], dtype=torch.float32, device=device)
        R, t = lie.se3_mul(*lie.se3_exp(mu), R0, t0)
        img = synthetic.render(scene, cam, R, t, (h, w)).cpu().numpy()
        if degraded:
            img = synthetic.degrade(img, k, rng)
        ts = ts0 + k / 30.0
        name = f"rgb/{ts:.6f}.png"
        imageio.write_png(os.path.join(root, name),
                          np.clip(img, 0, 255).astype(np.uint8))
        rgb_lines.append(f"{ts:.6f} {name}")
        R, t = R.cpu().numpy(), t.cpu().numpy()
        C = -R.T @ t
        centers.append(C)
        qx, qy, qz, qw = Rotation.from_matrix(R.T).as_quat()
        gt_lines.append(f"{ts:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} "
                        f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")
    for fname, lines in (("rgb.txt", rgb_lines),
                         ("groundtruth.txt", gt_lines)):
        with open(os.path.join(root, fname), "w") as f:
            f.write("\n".join(lines) + "\n")
    return np.stack(centers)


def run_slam_variant(device, card, fast, run_slam, serialization,
                     synthetic, cam_ops, lie, imageio, degraded, width,
                     save_map):
    """run_slam --dataset tum --frames 120 --json on one variant of the
    TUM-format sequence, through its main(), on the card; with `save_map`
    the saved map is loaded back against the live one. Returns (variant,
    report, span, FAST launches, relocalizations, step warm-ups)."""
    import io
    import tempfile

    variant = f"{'degraded' if degraded else 'clean'}_{width}x480"
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        centers = write_tum_sequence(root, device, synthetic, cam_ops, lie,
                                     imageio, degraded=degraded, width=width)
        span = float(np.linalg.norm(centers.max(0) - centers.min(0)))
        print(f"run_slam {variant}: {TUM_FRAMES} PNG frames written in "
              f"{time.perf_counter() - t0:.1f} s")
        map_path = os.path.join(root, "map.npz")
        argv = ["--dataset", "tum", "--root", root, "--frames",
                str(TUM_FRAMES), "--width", str(width), "--height", "480",
                "--json", "--device", str(device)]
        if save_map:
            argv += ["--save-map", map_path]
        for name in fast.LAUNCHES:
            fast.LAUNCHES[name] = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report, sys_ = run_slam.main(argv)
        launches = dict(fast.LAUNCHES)
        line = out.getvalue().strip().splitlines()[-1]
        print(f"run_slam {' '.join(argv[:2])} ... --width {width} --json"
              f"{' --save-map ...' if save_map else ''}: {line}")
        check(json.loads(line) == report,
              f"{variant}: the report line is not the report")
        if save_map:
            loaded, cfg = serialization.load_map(map_path, device=device)
            leaves_live, leaves_loaded = {}, {}
            flatten = serialization._flatten
            flatten("", sys_.slam_map, leaves_live)
            flatten("", loaded, leaves_loaded)
            same = all(np.array_equal(leaves_live[k], leaves_loaded[k])
                       for k in leaves_live) and set(leaves_live) == set(
                           leaves_loaded)
            print(f"run_slam {variant}: saved map equals the live one: "
                  f"{same}")
            check(same and cfg == sys_.config, "the saved map does not load "
                  "back equal to the live one")
    return (variant, report, span, launches, sys_.host_reads["reloc"],
            graph_calls(sys_)[0])


def phase_run_slam(device, card, fast, run_slam, serialization, synthetic,
                   cam_ops, lie, imageio, native_runtime):
    """The command line on the four TUM-format variants (TUM_VARIANTS):
    run_slam --dataset tum --frames 120 --json through its main(), on the
    card; the first run also saves its map, which must load back equal.
    Returns the FAST launches of the four runs together."""
    try:
        native_runtime.load()
        native = "the C++ runtime builds here"
    except native_runtime.NativeRuntimeUnavailable as e:
        why = [ln for ln in str(e).splitlines() if "error" in ln]
        native = (f"the C++ runtime does not build here "
                  f"({(why or [str(e)])[0].strip()})")
    total = {}
    for i, (kind, width) in enumerate(TUM_VARIANTS):
        variant, report, span, launches, n_reloc, warm = run_slam_variant(
            device, card, fast, run_slam, serialization, synthetic, cam_ops,
            lie, imageio, kind == "degraded", width, save_map=i == 0)
        ate = report.get("ate_rmse", float("inf"))
        tpu_m, tpu_pct = TUM_JAX_TPU[variant]
        if i == 0:
            print(f"run_slam: frame reader {report.get('reader')}: {native}")
        print(f"run_slam {variant} on the card: reader "
              f"{report.get('reader')}, {report['tracked']} of {TUM_FRAMES} "
              f"tracked, {report['keyframes']} keyframes, "
              f"{report['map_points']} points, ATE {ate} m over a span of "
              f"{span:.4f} m ({100 * ate / span:.3f}%; artifacts/ATE_r5.json, "
              f"the JAX package on a TPU: {tpu_m} m, {tpu_pct}%; its "
              f"run_slam on the CPU on the tool's files: "
              f"{TUM_JAX_CPU[variant]} m: reported, not claimed), "
              f"{report['fps']} frames/s (no "
              f"claim); FAST launches {launches}  [{card}]")
        check(report.get("reader") in ("native", "numpy"),
              f"no frame reader reported: {report}")
        check(report["tracked"] > TUM_MIN_TRACKED,
              f"run_slam {variant} tracked {report['tracked']} of "
              f"{TUM_FRAMES}")
        check(report["keyframes"] >= 2,
              f"{variant}: {report['keyframes']} keyframes")
        check(ate < TUM_ATE_SHARE * span,
              f"{variant}: ATE {ate} over a span of {span}")
        check(TUM_FRAMES + warm <= launches["fast_detect_levels"]
              <= TUM_FRAMES + n_reloc + warm
              and launches["fast_nonmax_levels"] == report["keyframes"],
              f"{variant}: FAST launches {launches} for {TUM_FRAMES} frames "
              f"and {report['keyframes']} keyframes")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


def ba_run_line(name, prob, cam, run, bundle):
    """rms after, and the printed summary of one ba_run."""
    res, ms, iters, solves, cg_it, cg_reads = run
    rms = float(bundle.reprojection_rms(prob, cam, res.cam_R, res.cam_t,
                                        res.points))
    cg = (f", CG {cg_it / solves:.1f} iterations and {cg_reads / solves:.2f}"
          f" reads per solve over {solves} solves" if solves else "")
    return rms, (f"{name}: rms {rms:.4f}, {int(res.accepted)} steps accepted, "
                 f"{ms:.3f} ms for {iters} LM iterations = "
                 f"{ms / max(iters, 1):.3f} ms each, {iters} host reads of "
                 f"the LM loop{cg}")


# tests/test_scale_ba.py's cross-checks: (label, seed, keyframes, points,
# run A, run B), both runs 3 LM iterations on the same problem.
_BAND_KW = dict(max_iters=3, solver="band_pcg", band_halfwidth=16,
                point_block=1024, cg_iters=300, cg_tol=1e-7)
BA512_PAIRS = (
    ("pcg vs chol", 6, 96, 4000,
     dict(max_iters=3, solver="pcg", cg_iters=400, cg_tol=1e-9),
     dict(max_iters=3, solver="chol", assembly="scatter", point_block=1024)),
    ("band_pcg vs band+chol", 3, 96, 4000, _BAND_KW,
     dict(max_iters=3, solver="chol", assembly="band", band_halfwidth=16,
          point_block=1024)),
    ("hist vs gather sigma, band_pcg", 4, 64, 3000,
     dict(_BAND_KW, sigma_mode="hist"), dict(_BAND_KW, sigma_mode="gather")),
)


def phase_ba_512(device, card, bundle, mapmaker, fixtures, mestimator):
    """tests/test_scale_ba.py on the card: the 512-keyframe / 30,000-point
    band problem through pcg and band + chol, then its 96- and 64-keyframe
    cross-checks on the card and on the CPU (the checks of phase 14 in the
    module docstring)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    config, sm, cam, adjust = fixtures.build_band_ba_map(
        np.random.default_rng(BA512_SEED), n_kf=512, n_pts=30000,
        obs_per_pt=4, pose_perturb=0.02, point_perturb=0.03, device=device)
    prob = mapmaker.build_ba_problem(sm, adjust, config)
    del sm
    sync(device)
    t_build = time.perf_counter() - t0
    n_meas = int(prob.meas_valid.sum())
    rms0 = float(bundle.reprojection_rms(prob, cam))
    band = config.bundle.band_halfwidth
    offset = bundle.max_pair_offset(prob.meas_kf, prob.meas_valid)
    print(f"BA at 512 keyframes: {prob.cam_R.shape[0]} cameras, "
          f"{prob.points.shape[0]} points, {n_meas} measurements, largest "
          f"co-observation offset {offset} (band {band}), rms {rms0:.4f}; "
          f"map and problem built in {t_build:.3f} s")
    check(prob.cam_R.shape[0] == 512 and prob.points.shape[0] == 30000
          and n_meas > 80000, f"not the 512 x 30,000 problem ({n_meas})")
    check(prob.cam_R.shape[0] > config.bundle.dense_solver_max_cams,
          "the problem is within the dense solver's limit")
    check(rms0 > BA512_RMS_BEFORE, f"perturbation invisible: rms {rms0}")
    check(offset <= band, f"pair offset {offset} exceeds the band {band}")

    ba_run(prob, cam, bundle, max_iters=1, solver="pcg", cg_iters=16)
    pcg = ba_run(prob, cam, bundle, max_iters=4, solver="pcg", cg_iters=200,
                 cg_tol=1e-6)
    res = pcg[0]
    rms1, line = ba_run_line("pcg", prob, cam, pcg, bundle)
    print(f"BA at 512 keyframes, {line}  [{card}]")
    check(rms1 < BA512_RMS_AFTER, f"pcg: rms {rms0} -> {rms1}")
    check(int(res.accepted) >= 1, "pcg accepted no step")
    check(bool(torch.isfinite(res.cam_t).all()
               and torch.isfinite(res.points).all()),
          "pcg left a non-finite state")
    check(torch.equal(res.cam_R[0], prob.cam_R[0])
          and torch.equal(res.cam_t[0], prob.cam_t[0]),
          "pcg moved the fixed camera 0")
    chol = ba_run(prob, cam, bundle, max_iters=3, solver="chol",
                  assembly="band", band_halfwidth=band, point_block=2048)
    rms_b, line = ba_run_line("band + chol", prob, cam, chol, bundle)
    print(f"BA at 512 keyframes, {line}  [{card}]")
    check(rms_b < BA512_RMS_AFTER, f"band + chol: rms {rms_b}")
    del prob, pcg, chol, res
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"BA at 512 keyframes: torch.cuda.max_memory_allocated "
          f"{peak:.1f} MiB  [{card}]")

    for label, seed, n_kf, n_pts, kw_a, kw_b in BA512_PAIRS:
        cfg, sm, cam_c, adjust = fixtures.build_band_ba_map(
            np.random.default_rng(seed), n_kf=n_kf, n_pts=n_pts,
            obs_per_pt=4, pose_perturb=0.015, point_perturb=0.02,
            device="cpu")
        prob_c = mapmaker.build_ba_problem(sm, adjust, cfg)
        prob_g, cam_g = prob_c.to(device), cam_c.to(device)
        rms, cpu_gap = {}, []
        for tag, kw in (("A", kw_a), ("B", kw_b)):
            run_g = ba_run(prob_g, cam_g, bundle, **kw)
            run_c = ba_run(prob_c, cam_c, bundle, **kw)
            rms[tag], line = ba_run_line(f"run {tag}", prob_g, cam_g, run_g,
                                         bundle)
            sigma = run_g[0].sigma_squared
            obj_g = objective_at(prob_g, cam_g, run_g[0], sigma, bundle,
                                 mestimator)
            obj_c = objective_at(prob_c, cam_c, run_c[0], sigma.cpu(),
                                 bundle, mestimator)
            cpu_gap.append(abs(obj_g / obj_c - 1.0))
            print(f"BA at {n_kf} keyframes, {label}, {line}; card vs CPU: "
                  f"objective at the card's sigma {obj_g:.4f} / {obj_c:.4f} "
                  f"({obj_g / obj_c - 1:+.2e}), CPU {run_c[1]:.0f} ms  "
                  f"[{card}]")
        print(f"BA at {n_kf} keyframes, {label}: |rms A - rms B| = "
              f"{abs(rms['A'] - rms['B']):.5f}")
        check(abs(rms["A"] - rms["B"]) < BA512_PATHS_AGREE,
              f"{label}: rms {rms}")
        check(max(cpu_gap) < BA512_CPU_AGREE,
              f"{label}: card and CPU objectives differ by {cpu_gap}")


def slow_config():
    """tests/test_drift.py's and tests/test_real_texture.py's configuration:
    320x240, 512 point slots, 12 keyframe slots."""
    from visualslam_android_tpu_torch.config import (
        MapMakerConfig,
        SLAMConfig,
        TrackerConfig,
    )

    return SLAMConfig(
        tracker=TrackerConfig(width=320, height=240, max_map_points=512,
                              max_corners_per_level=(256, 128, 64, 32),
                              min_frames_between_kfs=6),
        mapmaker=MapMakerConfig(max_keyframes=12, max_epi_candidates=128),
    )


def swept_pose(lie, base_R, base_t, s, amps, freqs):
    """se3_exp(amps * sin(freqs * s)) composed on the base pose: the paths
    of tests/test_drift.py and tests/test_real_texture.py."""
    mu = torch.tensor([a * np.sin(f * s) for a, f in zip(amps, freqs)],
                      dtype=torch.float32, device=base_R.device)
    return lie.se3_mul(*lie.se3_exp(mu), base_R, base_t)


def run_facade(sys_, images, touches, fast, device):
    """Every image through track_frame (on_touch before the ones in
    `touches`), FAST launches zeroed before and read after. Returns
    (results, wall s, launches)."""
    for name in fast.LAUNCHES:
        fast.LAUNCHES[name] = 0
    results = []
    sync(device)
    t0 = time.perf_counter()
    for k, img in enumerate(images):
        if k in touches:
            sys_.on_touch()
        results.append(sys_.track_frame(img))
    sync(device)
    return results, time.perf_counter() - t0, dict(fast.LAUNCHES)


def facade_outcome(label, sys_, results, truth, wall, launches, slam, ate,
                   card):
    """Checks shared by phases 15 and 16: (first tracking frame, camera
    centres estimated and true from it on, ATE, span). Bootstrap found,
    never lost after it, no BAD frame, finite map, FAST launched once per
    front-end run and once per keyframe."""
    phases = [r.phase for r in results]
    check(slam.PHASE_TRACKING in phases, f"{label}: the bootstrap never "
          f"finished")
    first = phases.index(slam.PHASE_TRACKING)
    tracked = results[first:]
    est = ate.camera_centers([r.pose_R for r in tracked],
                             [r.pose_t for r in tracked])
    gtc = ate.camera_centers([R for R, _ in truth[first:]],
                             [t for _, t in truth[first:]])
    rmse, _ = ate.ate_rmse(est, gtc)
    span = float(np.linalg.norm(gtc.max(0) - gtc.min(0)))
    n_lost = sum(r.lost for r in tracked)
    n_bad = sum(r.quality == 0 for r in tracked)
    n_kf = int(sys_.slam_map.keyframes.count())
    n_reloc = sum(r.message.startswith("Relocalized") for r in results)
    print(f"{label}: bootstrap done at frame {first}, {len(tracked) - n_lost}"
          f" of {len(results)} frames tracked after it ({n_lost} lost, "
          f"{n_bad} BAD), {results[-1].n_points} points, {n_kf} keyframes, "
          f"{int(sys_.slam_map.meas.count())} measurements, ATE {rmse:.6f} "
          f"over a span of {span:.6f} ({100 * rmse / span:.3f}%); "
          f"{len(results) / wall:.3f} frames/s (no claim); FAST launches "
          f"{launches}  [{card}]")
    check(not n_lost, f"{label}: lost on {n_lost} frames")
    check(not n_bad, f"{label}: {n_bad} BAD frames")
    check(bool(torch.isfinite(sys_.slam_map.points.pos_w).all()),
          f"{label}: the map holds a NaN")
    n_graph, graph_words = graph_calls(sys_)
    check(launches["fast_detect_levels"] == len(results) + n_reloc + n_graph
          and launches["fast_nonmax_levels"] == n_kf,
          f"{label}: FAST launches {launches} for {len(results)} frames + "
          f"{n_reloc} relocalized{graph_words}, {n_kf} keyframes")
    return first, est, gtc, rmse, span


def phase_drift(device, card, fast, slam, synthetic, lie, ate):
    """tests/test_drift.py through the port's facade on the card: 200
    frames of a back-and-forth sweep with pan over the planar scene (seed
    21), touches at frames 0 and 6, with that file's bounds. Returns the
    FAST launches."""
    config = slow_config()
    rng = np.random.default_rng(21)
    scene = synthetic.make_planar_scene(rng, depth=4.0, px_per_m=140.0,
                                        device=device)
    base_R, base_t = synthetic.look_at_pose((0.0, 0.0, 0.0), device=device)
    sys_ = slam.SLAMSystem(config, seed=3, device=device)
    truth, images = [], []
    for k in range(DRIFT_FRAMES):
        R, t = swept_pose(lie, base_R, base_t, k / 100.0,
                          (0.45, 0.06, 0.04, 0.02, 0.10, 0.03),
                          (1.5708, 2.2, 1.3, 1.7, 1.5708, 0.9))
        images.append(synthetic.render(scene, sys_.cam, R, t, (240, 320)))
        truth.append((R.cpu().numpy(), t.cpu().numpy()))
    results, wall, launches = run_facade(sys_, images, (0, 6), fast, device)
    first, est, gtc, rmse, span = facade_outcome(
        "drift audit", sys_, results, truth, wall, launches, slam, ate, card)
    s, Ra, ta = ate.umeyama_alignment(est, gtc)
    err = np.linalg.norm((s * (Ra @ est.T)).T + ta - gtc, axis=-1)
    q = len(err) // 4
    early, late = float(np.median(err[:q])), float(np.median(err[-q:]))
    counts = [r.n_points for r in results[first:]]
    tail_found = float(np.median([r.n_found for r in results[-40:]]))
    n_meas = int(sys_.slam_map.meas.count())
    print(f"drift audit: median error first quarter {early:.6f}, last "
          f"quarter {late:.6f}; points at the end {counts[-1]} (most "
          f"{max(counts)}), median found over the last 40 frames "
          f"{tail_found}")
    check(first <= DRIFT_BOOT_BY, f"drift audit: tracking from frame {first}")
    check(rmse < DRIFT_ATE_SHARE * span,
          f"drift audit: ATE {rmse} over a span of {span}")
    check(late < 3.0 * max(early, 0.002),
          f"drift audit: median error {early} -> {late}")
    check(counts[-1] > 0.5 * max(counts) and results[-1].n_keyframes >= 4
          and n_meas > results[-1].n_points and tail_found > 60,
          f"drift audit: the map degenerated ({counts[-1]} of {max(counts)} "
          f"points, {results[-1].n_keyframes} keyframes, {n_meas} "
          f"measurements, {tail_found} found)")
    return launches


def phase_photo(device, card, fast, slam, synthetic, lie, ate):
    """tests/test_real_texture.py through the port's facade on the card:
    80 frames of the photograph (make_photo_scene, px_per_m 200) with
    exposure drift, read noise and defocus blur on every 7th frame (seed
    13), touches at frames 0 and 8, with that file's bounds. Returns the
    FAST launches."""
    rng = np.random.default_rng(13)
    scene = synthetic.make_photo_scene(depth=4.0, px_per_m=200.0,
                                       device=device)
    base_R, base_t = synthetic.look_at_pose((0.0, 0.0, 0.0), device=device)
    sys_ = slam.SLAMSystem(slow_config(), seed=9, device=device)
    truth, images = [], []
    for k in range(PHOTO_FRAMES):
        R, t = swept_pose(lie, base_R, base_t, k / 40.0,
                          (0.30, 0.05, 0.05, 0.02, 0.08, 0.02),
                          (1.2, 2.1, 0.9, 1.4, 1.2, 0.8))
        img = synthetic.render(scene, sys_.cam, R, t, (240, 320))
        images.append(synthetic.apply_sensor_effects(
            img, rng, exposure_gain=1.0 + 0.10 * np.sin(k / 9.0),
            exposure_bias=4.0 * np.sin(k / 5.0), noise_std=2.0,
            blur_sigma=0.8 if k % 7 == 3 else 0.0))
        truth.append((R.cpu().numpy(), t.cpu().numpy()))
    results, wall, launches = run_facade(sys_, images, (0, 8), fast, device)
    first, _, _, rmse, span = facade_outcome(
        "real photo", sys_, results, truth, wall, launches, slam, ate, card)
    check(first <= PHOTO_BOOT_BY, f"real photo: tracking from frame {first}")
    check(rmse < PHOTO_ATE_SHARE * span,
          f"real photo: ATE {rmse} over a span of {span}")
    check(results[-1].n_keyframes >= 3 and results[-1].n_points > 100,
          f"real photo: {results[-1].n_keyframes} keyframes, "
          f"{results[-1].n_points} points")
    return launches


def sync(device):
    """Wait for the device; not counted as a read of the path (the sync
    debug mode that phase 10 runs under is off around it)."""
    if torch.device(device).type == "cuda":
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def flagged_syncs(device):
    """Records every synchronising CUDA call PyTorch makes while open
    (torch.cuda.set_sync_debug_mode("warn")): the yielded list holds one
    (file, line) per call, the Python line that made it."""
    calls = []
    if torch.device(device).type != "cuda":
        yield calls
        return
    import warnings

    def record(message, category, filename, lineno, *args, **kwargs):
        if "synchroniz" in str(message):
            calls.append((filename.rsplit("/", 1)[-1], lineno))
        else:
            shown(message, category, filename, lineno, *args, **kwargs)

    shown = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield calls
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown


@contextlib.contextmanager
def recorded_facade(sys_, fstep, relocalizer, mapping_task_names):
    """While open, the facade's mapping tasks run between two device
    synchronisations and land in the yielded record by kind (ms list),
    the bundle-adjustment rounds by mode, and copies of the
    inputs of the first
    keyframe integration and of the last relocalization attempt are kept
    (for the card-against-CPU replays)."""
    dev = sys_.device
    rec = {"tasks": {}, "ba_modes": {}, "integrate": None, "reloc": None}
    step = sys_._mapmaker_step

    def timed_step():
        sync(dev)
        t0 = time.perf_counter()
        task = step()
        sync(dev)
        name = mapping_task_names[task]
        rec["tasks"].setdefault(name, []).append(
            1e3 * (time.perf_counter() - t0))
        return task

    def keep(value):
        return value.clone() if hasattr(value, "clone") else value

    integrate, ba_round = fstep.integrate_keyframe, fstep.ba_round
    attempt = relocalizer.attempt_recovery

    def integrate_kept(*args):
        if rec["integrate"] is None:
            rec["integrate"] = tuple(keep(a) for a in args)
        return integrate(*args)

    def ba_counted(*args, mode, **kwargs):
        key = mode + (" (bootstrap prefix)" if kwargs.get("cap") else "")
        rec["ba_modes"][key] = rec["ba_modes"].get(key, 0) + 1
        return ba_round(*args, mode=mode, **kwargs)

    def attempt_kept(slam_map, template, cam, max_score):
        rec["reloc"] = (slam_map.clone(), template.clone(), cam, max_score)
        return attempt(slam_map, template, cam, max_score)

    sys_._mapmaker_step = timed_step
    fstep.integrate_keyframe, fstep.ba_round = integrate_kept, ba_counted
    relocalizer.attempt_recovery = attempt_kept
    try:
        yield rec
    finally:
        sys_._mapmaker_step = step
        fstep.integrate_keyframe, fstep.ba_round = integrate, ba_round
        relocalizer.attempt_recovery = attempt


def slam_sequence(device, datasets, synthetic):
    """bench.py's full-SLAM sequence on the card, then SLAM_BLANKS grey
    frames and SLAM_AFTER frames from the pose of frame SLAM_RETURN_TO on.
    Returns (images, truth poses, camera)."""
    images, poses, _, cam, scene = datasets.make_synthetic_sequence(
        np.random.default_rng(11), n_frames=SLAM_FRAMES, size=(800, 480),
        px_per_m=240.0, device=device)
    blank = torch.full((480, 800), 127.0, device=device)
    images = images + [blank] * SLAM_BLANKS
    poses = poses + [poses[SLAM_FRAMES - 1]] * SLAM_BLANKS
    for k in range(SLAM_AFTER):
        R, t = poses[SLAM_RETURN_TO + k]
        images.append(synthetic.render(scene, cam, R, t, (480, 800)))
        poses.append((R, t))
    return images, poses, cam


def phase_full_slam(device, card, fast, slam, fstep, relocalizer,
                    native_runtime, bundle, datasets, synthetic, ate):
    """Full SLAM through the facade on the card in sync mode: the checks of
    phase 10 in the module docstring. Returns (launches, the record, the
    frames, their poses, the results)."""
    from visualslam_android_tpu_torch.config import SLAMConfig

    images, poses, cam = slam_sequence(device, datasets, synthetic)
    sys_ = slam.SLAMSystem(SLAMConfig(), seed=0, device=device)
    with recorded_facade(sys_, fstep, relocalizer,
                         native_runtime.TASK_NAMES) as rec:
        run = drive_facade(sys_, images, fast, bundle, device)
    results, reads, syncs = run["calls"], run["reads"], run["syncs"]
    launches = run["launches"]

    first, tracked = slam_bounds("full SLAM", results, poses, sys_, launches,
                                 0, slam, ate)
    n_kf = [r.n_keyframes for r in results]
    tracking = [k for k, r in enumerate(results)
                if r.phase == slam.PHASE_TRACKING and k > first]
    n_reads = {key: sum(reads[k][key] for k in tracking) for key in reads[0]}
    print(f"full SLAM: {len(results)} frames in {run['wall']:.3f} s = "
          f"{len(results) / run['wall']:.3f} frames/s, bootstrap frames and "
          f"per-task synchronisations included (no claim)  [{card}]")
    print(f"full SLAM: host reads over the {len(tracking)} frames after the "
          f"bootstrap: {n_reads} = "
          f"{sum(n_reads.values()) / max(len(tracking), 1):.3f} per frame; "
          f"stats reads {n_reads['stats']} for {len(tracking)} frames")
    if torch.device(device).type == "cuda":
        # The frame that captures the tracking step's graphs synchronises
        # in torch.cuda.graph, once per capture: reported apart.
        capturing = [k for k in tracking if run["captures"][k]]
        where, once = {}, {}
        for k in tracking:
            for call in syncs[k]:
                tally = once if k in capturing else where
                tally[call] = tally.get(call, 0) + 1
        print(f"full SLAM: synchronising calls PyTorch flagged over those "
              f"frames: {sum(where.values())} (reads counted: "
              f"{sum(n_reads.values())}); by line: "
              f"{sorted(where.items(), key=lambda kv: -kv[1])}")
        print(f"full SLAM: the step's graphs captured on frame(s) "
              f"{capturing} ({sum(run['captures'][k] for k in capturing)} "
              f"graphs): one-off synchronising calls there "
              f"{sum(once.values())}, by line {sorted(once.items())}")
        check(len(capturing) == 1, f"graphs captured on frames {capturing}")
        # Triangulation takes its null vector without eigh, whose error
        # check synchronised once per growth level.
        tri = {call: n for call, n in where.items()
               if call[0] == "triangulate.py"}
        print(f"full SLAM: synchronising calls in triangulate.py: "
              f"{sum(tri.values())}")
        check(not tri, f"triangulation synchronised: {tri}")
    counts = {name: len(ms) for name, ms in rec["tasks"].items()}
    print(f"full SLAM: mapping tasks dispatched {counts}; bundle-adjustment "
          f"rounds by mode {rec['ba_modes']}")
    for name, ms in sorted(rec["tasks"].items()):
        print(f"  task {name}: {len(ms)} runs, median "
              f"{statistics.median(ms):.3f} ms, max {max(ms):.3f} ms, sum "
              f"{sum(ms):.3f} ms  [{card}]")
    reached = set(counts)
    for name in ("add_keyframe", "refind_newly", "ba_all", "ba_recent"):
        check(name in reached, f"the scheduler never reached {name}: {counts}")
    # Five tasks per keyframe integrated, fewer for one still under way.
    under_way = [e["stage"] for e in sys_.kf_queue if "slot" in e]
    want_adds = 5 * (n_kf[-1] - 2) - sum(5 - st for st in under_way)
    check(counts["add_keyframe"] == want_adds,
          f"{counts['add_keyframe']} add_keyframe tasks for "
          f"{n_kf[-1] - 2} keyframes ({under_way} under way)")
    check(n_reads["stats"] == len(tracking) and n_reads["bootstrap"] == 0,
          f"reads on tracked frames: {n_reads}")
    check(rec["integrate"] is not None and rec["reloc"] is not None,
          "no keyframe integration or relocalization to replay")
    mode_line("sync, checked run (mapping tasks between synchronisations)",
              run, first, 0, card)
    print(f"full SLAM: step_graph_counts {sys_.step_graph_counts} over "
          f"{len(tracking)} tracked calls")
    profile_window(sys_, images[SLAM_RETURN_TO + SLAM_AFTER:][:PROFILE_FRAMES],
                   device, card)
    return launches, rec, images, poses, results


def drive_facade(sys_, images, fast, bundle, device):
    """Phase 10's sequence through the facade, touches at frames 0 and 6,
    then flush(); FAST launches set to 0 before and read after. Per call it
    records the facade's and bundle_adjust's reads, the synchronising calls
    PyTorch flags (flagged_syncs), the tracking step's graph captures and
    the mapping task; per stats read the host's wait in it
    (SLAMSystem._read_stats: the blocking read in sync mode, the wait on
    the copy's event in pipelined mode). Returns a dict: calls (what each
    track_frame returned), flushed, reads, syncs, captures (per call),
    tasks (by frame), stats_wait (s, per read), wall (s), launches."""
    run = {"calls": [], "reads": [], "syncs": [], "tasks": {},
           "stats_wait": [], "captures": []}
    read_stats, step = sys_._read_stats, sys_._mapmaker_step

    def timed_read(ctx):
        t0 = time.perf_counter()
        out = read_stats(ctx)
        run["stats_wait"].append(time.perf_counter() - t0)
        return out

    def noted_step():
        task = step()
        run["tasks"][sys_.frame_idx - 1] = task
        return task

    sys_._read_stats, sys_._mapmaker_step = timed_read, noted_step
    for name in fast.LAUNCHES:
        fast.LAUNCHES[name] = 0
    try:
        with flagged_syncs(device) as flagged:
            sync(device)
            t_wall = time.perf_counter()
            for k, img in enumerate(images):
                if k in (0, 6):
                    sys_.on_touch()
                before = dict(sys_.host_reads,
                              ba=bundle.HOST_READS["bundle_adjust"])
                n_flagged = len(flagged)
                captures = sys_.step_graph_counts["captures"]
                run["calls"].append(sys_.track_frame(img))
                run["captures"].append(
                    sys_.step_graph_counts["captures"] - captures)
                after = dict(sys_.host_reads,
                             ba=bundle.HOST_READS["bundle_adjust"])
                run["reads"].append({key: after[key] - before[key]
                                     for key in after})
                run["syncs"].append(flagged[n_flagged:])
            run["flushed"] = sys_.flush()
            sync(device)
            run["wall"] = time.perf_counter() - t_wall
    finally:
        sys_._read_stats, sys_._mapmaker_step = read_stats, step
    run["launches"] = dict(fast.LAUNCHES)
    return run


def quiet_syncs(label, run, first, depth):
    """The synchronising calls of steady-state tracked frames: the calls
    after the bootstrap (and its first 3 frames, which fill per-shape
    caches: image._level_meta, tensors.const) whose mapping task was
    "none". Each must synchronise exactly in its reads, but for the stats
    read in pipelined mode, which waits on an event and is not flagged.
    Returns (flagged calls per such frame, their count)."""
    quiet = [k for k, task in run["tasks"].items()
             if k > first + 3 and task == 0]  # native_runtime.TASK_NONE
    extra = {}
    for k in quiet:
        reads = sum(run["reads"][k].values())
        if depth:
            reads -= run["reads"][k]["stats"]
        if len(run["syncs"][k]) != reads:
            extra[k] = run["syncs"][k]
    print(f"{label}: {len(quiet)} tracked frames with no mapping work, "
          f"{len(extra)} with a synchronising call besides their reads")
    check(len(quiet) > 20 and not extra,
          f"{label}: hidden synchronising calls on the tracking path: "
          f"{extra}")
    return sum(len(run["syncs"][k]) for k in quiet) / len(quiet), len(quiet)


def mode_line(label, run, first, depth, card):
    """frames/s, the stats_pull wait per tracked frame and the synchronising
    calls per steady-state tracked frame of a drive_facade run."""
    n = len(run["calls"])
    waits = run["stats_wait"]
    if torch.cuda.is_available():
        per_quiet, n_quiet = quiet_syncs(f"full SLAM, {label}", run, first,
                                         depth)
        syncs = (f"{per_quiet:.3f} synchronising calls per steady-state "
                 f"tracked frame (over {n_quiet})")
    else:
        syncs = "synchronising calls not counted on the CPU"
    print(f"full SLAM, {label}: {n} frames in {run['wall']:.3f} s = "
          f"{n / run['wall']:.3f} frames/s; stats_pull wait "
          f"{1e3 * sum(waits) / max(len(waits), 1):.4f} ms per tracked frame "
          f"over {len(waits)}; {syncs} (no claim)  [{card}]")


def slam_bounds(label, results, poses, sys_, launches, depth, slam, ate):
    """Phase 10's bounds on a run of its sequence, `results` one per frame
    in frame order: bootstrap by SLAM_BOOT_BY, more than SLAM_MIN_TRACKED
    of the first SLAM_FRAMES tracked, keyframes added, ATE under
    SLAM_ATE_SHARE of the span, no non-finite pose; the blank frames BAD,
    tracking lost on them and relocalized on a real frame after them (in
    sync mode and at depth 1: lost on the frame max_lost_frames after the
    first blank, relocalized on the first real frame), GOOD after the
    relocalized frame; FAST launched once per front-end run and once per
    keyframe. Returns (first tracking frame, tracked frames)."""
    main = results[:SLAM_FRAMES]
    phases = [r.phase for r in main]
    check(slam.PHASE_TRACKING in phases, f"{label}: the bootstrap never "
          f"finished")
    first = phases.index(slam.PHASE_TRACKING)
    tracked = [k for k, r in enumerate(main)
               if r.phase == slam.PHASE_TRACKING and not r.lost]
    est = ate.camera_centers([r.pose_R for r in main[first:]],
                             [r.pose_t for r in main[first:]])
    truth = poses[first:SLAM_FRAMES]
    gtc = ate.camera_centers([R.cpu().numpy() for R, _ in truth],
                             [t.cpu().numpy() for _, t in truth])
    rmse, _ = ate.ate_rmse(est, gtc)
    span = float(np.linalg.norm(gtc.max(0) - gtc.min(0)))
    n_kf = results[-1].n_keyframes
    print(f"{label}: bootstrap done at frame {first}, {len(tracked)} of "
          f"{SLAM_FRAMES} frames tracked, {main[-1].n_points} points and "
          f"{main[-1].n_keyframes} keyframes at frame {SLAM_FRAMES - 1} "
          f"({n_kf} at the end), ATE {rmse:.6f} over a span of "
          f"{span:.6f} ({100 * rmse / span:.4f}%)")
    check(first <= SLAM_BOOT_BY, f"{label}: bootstrap finished at frame "
          f"{first}")
    check(len(tracked) > SLAM_MIN_TRACKED,
          f"{label}: only {len(tracked)} of {SLAM_FRAMES} frames tracked")
    check(main[-1].n_keyframes > 2,
          f"{label}: no keyframe added after the bootstrap")
    check(rmse < SLAM_ATE_SHARE * span,
          f"{label}: ATE {rmse} over a span of {span}")
    for r in results:
        check(np.isfinite(r.pose_R).all() and np.isfinite(r.pose_t).all(),
              f"{label}: frame {r.frame_id} returned a non-finite pose")
    b0 = SLAM_FRAMES
    back = b0 + SLAM_BLANKS
    print(f"{label}, relocalization: " + "; ".join(
        f"frame {k}: quality {results[k].quality}, lost {results[k].lost}, "
        f"coarse {results[k].did_coarse}, found {results[k].n_found}, "
        f"{results[k].message.split(' Found')[0]!r}"
        for k in range(b0, len(results))))
    check(all(results[k].quality == 0 for k in range(b0, back)),
          f"{label}: a blank frame did not track BAD")
    check(any(results[k].lost for k in range(b0, back)),
          f"{label}: tracking not lost on the blank frames")
    relocalized = [k for k in range(back, len(results))
                   if results[k].message.startswith("Relocalized")]
    check(relocalized, f"{label}: no relocalization after the blanks")
    k_rec = relocalized[0]
    if depth <= 1:
        trip = b0 + sys_.config.tracker.max_lost_frames
        check(results[trip].lost, f"{label}: tracking not lost at frame "
              f"{trip}")
        check(k_rec == back, f"{label}: relocalized at frame {k_rec}, not "
              f"{back}")
    rec_frame = results[k_rec]
    check(not rec_frame.lost and rec_frame.n_found > 20,
          f"{label}: relocalization at frame {k_rec}: {rec_frame.message}")
    check(all(r.quality == 2 for r in results[k_rec + 1:]),
          f"{label}: tracking after relocalization not GOOD: "
          f"{[r.quality for r in results[k_rec + 1:]]}")
    # The relocalized frame and the next one ask track_map for the coarse
    # stage; it runs only where more than coarse_min points are searched at
    # level 2 or above (tests/test_torch_slam.py holds the branch).
    after = results[k_rec + 1].did_coarse if k_rec + 1 < len(results) else None
    print(f"{label}: coarse stage on the relocalized frame ({k_rec}) and the "
          f"next: {rec_frame.did_coarse}, {after}")
    n_reloc = sum(r.message.startswith("Relocalized") for r in results)
    n_graph, graph_words = graph_calls(sys_)
    n_front = len(results) + n_reloc + n_graph
    print(f"{label}: FAST launches {launches}: {n_front} wrapper calls "
          f"({len(results)} frames + {n_reloc} relocalized frame run "
          f"twice{graph_words}), {n_kf} keyframes inserted")
    check(launches["fast_detect_levels"] == n_front,
          f"{label}: fast_detect_levels launched "
          f"{launches['fast_detect_levels']} times for {n_front} wrapper "
          f"calls")
    check(launches["fast_nonmax_levels"] == n_kf,
          f"{label}: fast_nonmax_levels launched "
          f"{launches['fast_nonmax_levels']} times for {n_kf} keyframes")
    check(launches["fast_detect"] == 0,
          f"{label}: the single-image wrapper launched")
    return first, tracked


def graph_calls(sys_):
    """(n, words): what the tracking step's graphs (models/step_graph.py)
    add to FAST's wrapper calls of one a front-end run, and the sum in
    words. Its eager warm-ups and its captures call the wrapper; a replay
    runs the recorded kernel with no call (phase 19 counts the kernel in
    the replays from the device trace). 0 on the CPU."""
    if sys_.device.type != "cuda":
        return 0, ""
    c = sys_.step_graph_counts
    return (c["eager"] + c["captures"] - c["replays"],
            f" + {c['eager']} step warm-ups + {c['captures']} captures - "
            f"{c['replays']} replays")


def same_results(label, a, b):
    """Two runs' results (one per frame, frame order) equal field for field
    and pose bit for bit; returns the first frame that differs, or None."""
    for ra, rb in zip(a, b):
        fields = ("frame_id", "phase", "quality", "n_found", "n_points",
                  "n_keyframes", "lost", "did_coarse", "added_keyframe",
                  "message")
        if (any(getattr(ra, f) != getattr(rb, f) for f in fields)
                or not np.array_equal(ra.pose_R, rb.pose_R)
                or not np.array_equal(ra.pose_t, rb.pose_t)):
            print(f"{label}: frame {ra.frame_id} differs: {ra} / {rb}")
            return ra.frame_id
    return None if len(a) == len(b) else min(len(a), len(b))


def phase_slam_modes(device, card, fast, slam, bundle, ate, images, poses,
                     checked):
    """Phase 10's sequence and touches again, each run from a fresh facade
    with the same seed and nothing wrapped but drive_facade's counters: in
    sync mode (two sync runs on the card must agree bit for bit), then
    pipelined at depth 1 (equal to the checked sync run frame for frame,
    matched by frame_id) and at each further depth of SLAM_DEPTHS (phase
    10's bounds). Every pipelined run delivers each frame id once and in
    order, with placeholders only on the `depth` calls after the
    bootstrap. Prints frames/s, the stats_pull wait and the synchronising
    calls per steady-state frame of each. Returns the FAST launches of the
    runs, summed."""
    from visualslam_android_tpu_torch.config import SLAMConfig

    total = {}
    for depth in (0,) + SLAM_DEPTHS:
        label = f"pipelined, depth {depth}" if depth else "sync"
        sys_ = slam.SLAMSystem(SLAMConfig(), seed=0, pipelined=bool(depth),
                               pipeline_depth=max(depth, 1), device=device)
        run = drive_facade(sys_, images, fast, bundle, device)
        for name, n in run["launches"].items():
            total[name] = total.get(name, 0) + n
        delivered = run["calls"] + run["flushed"]
        results = [r for r in delivered if r.valid]
        ids = [r.frame_id for r in results]
        check(ids == list(range(len(images))),
              f"{label}: frame ids delivered {ids}")
        first = [r.phase for r in results].index(slam.PHASE_TRACKING)
        waiting = [k for k, r in enumerate(run["calls"]) if not r.valid]
        check(waiting == list(range(first + 1, first + 1 + depth)),
              f"{label}: placeholders on calls {waiting}")
        mode_line(label, run, first, depth, card)
        print(f"full SLAM, {label}: step_graph_counts "
              f"{sys_.step_graph_counts}; graphs captured on calls "
              f"{[k for k, n in enumerate(run['captures']) if n]}")
        slam_bounds(f"full SLAM, {label}", results, poses, sys_,
                    run["launches"], depth, slam, ate)
        if depth <= 1:
            differs = same_results(f"full SLAM, {label}", results, checked)
            check(differs is None, f"{label}: results differ from the "
                  f"checked sync run from frame {differs}")
            print(f"full SLAM, {label}: every result equal to the checked "
                  f"sync run's, poses bit for bit")
        del sys_
    return total


def step_differences(a, b):
    """{field: largest |difference|} between two FrameStepOut, per field,
    over every tensor (0.0 where bit-equal; booleans and integers as
    counts of differing entries)."""
    from visualslam_android_tpu_torch.utils.tensors import tree_leaves

    out = {}
    for field in dataclasses.fields(a):
        worst = 0.0
        for x, y in zip(tree_leaves(getattr(a, field.name)),
                        tree_leaves(getattr(b, field.name))):
            if torch.equal(x, y):
                continue
            if x.dtype.is_floating_point:
                d = (x - y).abs()
                d = torch.where(torch.isnan(x) & torch.isnan(y), 0.0, d)
                worst = max(worst, float(d.max()))
            else:
                worst = max(worst, float((x != y).sum()))
        out[field.name] = worst
    return out


def phase_step_graphs(device, card, slam, fstep, step_graph, images):
    """Phase 19: the tracking step's CUDA graphs against the eager step.
    A facade runs STEP_GRAPH_FRAMES frames of phase 10's sequence; on its
    state and the next frame, with draws made once from STEP_GRAPH_SEED,
    each variant runs eagerly and through a new StepGraphs (its first call
    captures all six graphs, timed), and every output must be bit-equal.
    Then each variant's graph is replayed STEP_GRAPH_REPS times (CUDA
    events, median) beside STEP_EAGER_REPS eager steps (host clock to a
    synchronisation)."""
    from visualslam_android_tpu_torch.config import SLAMConfig

    t_phase = time.perf_counter()
    sys_ = slam.SLAMSystem(SLAMConfig(), seed=0, device=device)
    for k, img in enumerate(images[:STEP_GRAPH_FRAMES]):
        if k in (0, 6):
            sys_.on_touch()
        sys_.track_frame(img)
    check(sys_.phase == slam.PHASE_TRACKING and sys_.lost_frames == 0,
          "phase 19: the facade is not tracking")
    print(f"step graphs: the facade after {STEP_GRAPH_FRAMES} frames: "
          f"step_graph_counts {sys_.step_graph_counts}")
    cfg = sys_.config
    state = (sys_.slam_map.clone(), sys_.cam.clone(), sys_.R.clone(),
             sys_.t.clone(), sys_.velocity.clone(), sys_._msd.clone(),
             sys_._depth.clone(), sys_._wiggle_dev.clone(),
             sys_.sbi_last.clone(), sys_.new_points.clone(),
             sys_.failure_mask.clone(), torch.zeros(2, device=device))
    img = images[STEP_GRAPH_FRAMES]
    gen = torch.Generator(device=device).manual_seed(STEP_GRAPH_SEED)
    n = cfg.tracker.max_map_points
    uniforms = tuple(torch.rand(n, generator=gen, device=device)
                     for _ in range(2))
    del sys_
    graphs = step_graph.StepGraphs()

    def step(flags, **kwargs):
        return fstep.frame_step(img, *state, cfg, use_prior=flags[0],
                                forced_coarse=flags[1], uniforms=uniforms,
                                **kwargs)

    for flags in step_graph.VARIANTS:
        eager = step(flags)
        sync(device)
        t0 = time.perf_counter()
        out = step(flags, graphs=graphs)
        sync(device)
        wall = time.perf_counter() - t0
        diff = step_differences(eager, out)
        took = (f"first call, warm-ups and captures included: {wall:.3f} s"
                if graphs.counts["captures"] and flags == step_graph.VARIANTS[0]
                else f"call {1e3 * wall:.3f} ms")
        print(f"step graphs {flags}: {took}; differences from the eager "
              f"step by field: {diff}")
        check(not any(diff.values()),
              f"step graphs {flags}: the replay differs from the eager step:"
              f" {diff}")
        del eager, out
    print(f"step graphs: all three variants bit-equal to the eager step "
          f"(stats, pose, found masks, map); counts {graphs.counts}")
    if torch.device(device).type != "cuda":
        return  # no graph to time (a rehearsal on the CPU)
    replay_ms = {}
    for flags in step_graph.VARIANTS:
        graph = graphs._graphs[flags, 0][0]
        times = replay_ms[flags] = []
        for _ in range(STEP_GRAPH_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        eager_ms = []
        for _ in range(STEP_EAGER_REPS):
            sync(device)
            t0 = time.perf_counter()
            step(flags)
            sync(device)
            eager_ms.append(1e3 * (time.perf_counter() - t0))
        print(f"step graphs {flags}: replay device time median "
              f"{statistics.median(times):.3f} ms (min {min(times):.3f}, max "
              f"{max(times):.3f}, {STEP_GRAPH_REPS} replays); eager step "
              f"{statistics.median(eager_ms):.3f} ms host to sync (median of "
              f"{STEP_EAGER_REPS})  [{card}]")
    for flags in step_graph.VARIANTS:
        graph = graphs._graphs[flags, 0][0]
        span_ms, kernels = traced_replays(graph, STEP_TRACED_REPS, device)
        n_fast = sum("fast_levels_kernel" in name for name, _, _ in kernels)
        summed = sum(b - a for _, a, b in kernels) / 1e6
        union = union_ns([(a, b) for _, a, b in kernels]) / 1e6
        print(f"step graphs {flags}, {STEP_TRACED_REPS} replays under "
              f"torch.profiler: {span_ms / STEP_TRACED_REPS:.3f} ms a replay "
              f"(CUDA events; {statistics.median(replay_ms[flags]):.3f} "
              f"untraced), {len(kernels) / STEP_TRACED_REPS:.1f} device "
              f"activities a replay (kernels, copies, sets), their time "
              f"summed {summed / STEP_TRACED_REPS:.3f} ms and their union "
              f"{union / STEP_TRACED_REPS:.3f} ms a replay: "
              f"{100 * union / span_ms:.2f}% of the traced span busy, "
              f"{100 * union / STEP_TRACED_REPS / statistics.median(replay_ms[flags]):.2f}"
              f"% of the untraced; "
              f"fast_levels_kernel {n_fast} times  [{card}]")
        check(n_fast == STEP_TRACED_REPS,
              f"step graphs {flags}: the profiler saw fast_levels_kernel "
              f"{n_fast} times in {STEP_TRACED_REPS} replays")
    print(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")


def traced_replays(graph, reps, device):
    """`reps` replays of `graph` back to back under torch.profiler (the
    CUDA activity alone), after one replay in the profiler's warm-up step,
    whose activity it drops: (their span in ms by CUDA events around them,
    [(name, start ns, end ns)] of each device activity the profiler saw
    in them)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        graph.replay()
        sync(device)
        prof.step()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        prof.step()
    events = prof.profiler.kineto_results.events()
    return start.elapsed_time(end), [
        (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        for e in events
        if e.device_type() == torch.autograd.DeviceType.CUDA]


def union_ns(spans):
    """The length of the union of [start, end) intervals."""
    busy, end = 0, 0
    for a, b in sorted(spans):
        busy += max(0, b - max(a, end))
        end = max(end, b)
    return busy


def device_profile(run, device):
    """run() under torch.profiler with the CUDA activity alone (the CUDA
    runtime's calls and the device's kernels and copies): (its result,
    wall s, device-busy s, kernel launches). Busy time is the union of
    the device's activity intervals; launches count cudaLaunchKernel and
    cudaLaunchKernelExC calls. It reads the profiler's raw events:
    key_averages() takes tens of seconds for ~50k kernels, and with the
    CPU activity on it counts each kernel's time twice (under the op that
    launched it and under the kernel)."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        sync(device)
        window = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    busy_ns = union_ns([(e.start_ns(), e.start_ns() + e.duration_ns())
                        for e in events
                        if e.device_type() == torch.autograd.DeviceType.CUDA])
    launches = sum(e.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC")
                   for e in events)
    return out, window, busy_ns / 1e9, launches


def profile_window(sys_, images, device, card):
    """The facade goes on along the path over `images`, nothing wrapped,
    under torch.profiler: wall and device time per frame and the device's
    busy share (the frames after the checked run; their launches are not
    counted)."""
    results, window, busy_s, launches = device_profile(
        lambda: [sys_.track_frame(img) for img in images], device)
    n = len(images)
    busy = (f"{100 * busy_s / window:.2f}% busy" if busy_s > 0
            else "device time not measured (the profiler saw none)")
    print(f"full SLAM, {n} more frames under torch.profiler "
          f"({sum(r.quality == 2 for r in results)} GOOD): "
          f"{1e3 * window / n:.3f} ms per frame, device time "
          f"{1e3 * busy_s / n:.3f} ms per frame, {busy}; "
          f"{launches / n:.1f} kernel launches per frame  [{card}]")


def stream_frames(frames, k):
    """The S frames the streams see at step k: stream s at frame
    (k + STREAM_OFFSET s) mod the path's length (bench.py:163-166)."""
    return torch.stack([frames[(k + STREAM_OFFSET * s) % len(frames)]
                        for s in range(STREAMS)])


def phase_stream_kernel(frames, config, fast, image):
    """The stream-gridded fast_detect_levels on the four levels of
    STREAMS different frames: masks bit-equal to the plain version and to
    one single-frame launch per stream, scores within SCORE_ATOL of the
    plain version and bit-equal to the single-frame launches; times."""
    tc = config.tracker
    levels = [lvl.contiguous() for lvl in
              image.make_pyramid(stream_frames(frames, 0), tc.n_levels)]
    thr = tc.fast_thresholds
    max_err = 0.0
    for arc in (10, 9):
        masks, scores = fast.detect_levels_streams(levels, thr, arc)
        p_masks, p_scores = fast.detect_levels_streams_reference(levels, thr,
                                                                 arc)
        torch.cuda.synchronize()
        for lvl in range(len(levels)):
            check(torch.equal(masks[lvl], p_masks[lvl]),
                  f"stream-gridded FAST mask differs from the plain version "
                  f"at level {lvl} arc={arc}: "
                  f"{int((masks[lvl] != p_masks[lvl]).sum())} pixels")
            err = float(torch.max(torch.abs(scores[lvl] - p_scores[lvl])))
            check(err <= SCORE_ATOL,
                  f"stream-gridded FAST score differs by {err} at level {lvl}")
            max_err = max(max_err, err)
        for s in range(STREAMS):
            m1, s1 = fast.detect_levels([lv[s] for lv in levels], thr, arc)
            for lvl in range(len(levels)):
                check(torch.equal(m1[lvl], masks[lvl][s])
                      and torch.equal(s1[lvl], scores[lvl][s]),
                      f"stream {s} of the stream-gridded FAST differs from "
                      f"its single-frame launch at level {lvl} arc={arc}")
    out = {"max_abs_err": max_err,
           "n_pixels": sum(lv.numel() for lv in levels),
           "corners": int(sum(int(m.sum()) for m in masks))}
    out["eager_ms"], out["ms"] = cuda_ms(
        lambda: fast.detect_levels_streams(levels, thr))
    out["single_eager_ms"], out["single_ms"] = cuda_ms(
        lambda: [fast.detect_levels([lv[s] for lv in levels], thr)
                 for s in range(STREAMS)])
    out["plain_eager_ms"], out["plain_ms"] = cuda_ms(
        lambda: fast.detect_levels_streams_reference(levels, thr))
    return out


def stream_start(rt, sbi_ops, kf_mod, frames, R0, t0, config, device):
    """bench.py's start of the multi-stream run: every stream at (R0, t0),
    zero velocity, the SBI primed from frame 0."""
    tc = config.tracker
    sbi0 = sbi_ops.make_sbi(kf_mod.make_frame(frames[0], config).pyramid[-1],
                            tc.sbi_blur)
    st = rt.init_streams(STREAMS, R0, t0, config, device=device)
    return st.replace(
        sbi_last=sbi_ops.SBI(
            template=sbi0.template.expand(STREAMS, -1, -1).clone(),
            jacs=sbi0.jacs.expand(STREAMS, -1, -1, -1).clone()),
        has_sbi=torch.ones_like(st.has_sbi))


def count_fallbacks(fn):
    """Runs fn with functorch's fallback warning on: the number of ops that
    fell back to a per-example loop under vmap (their names, deduplicated)."""
    import warnings

    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    names = [str(w.message) for w in caught
             if "batching rule" in str(w.message)]
    return len(names), sorted(set(n.split(" for ")[-1][:60] for n in names))


def profile_steps(step, n, device):
    """n calls of step() under torch.profiler (device_profile): (wall ms
    per call, device-busy ms per call, kernel launches per call)."""
    _, window, busy_s, launches = device_profile(
        lambda: [step() for _ in range(n)], device)
    return 1e3 * window / n, 1e3 * busy_s / n, launches / n


def phase_streams(device, card, fast, rt, sbi_ops, kf_mod, tracker, image,
                  sm, cam, config, frames, poses, one_stream_fps):
    """Phase 13: multi-stream tracking (parallel/replicated_tracking) at
    S = STREAMS on phase 4's map and frames. Returns (the FAST launches of
    the streams path, the kernel's record)."""
    tc = config.tracker
    R0, t0 = poses[0]
    t_phase = time.perf_counter()

    # The kernel against its plain version and single-frame launches.
    parts = {}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    kern = phase_stream_kernel(frames, config, fast, image)
    kern["bound_ms"], kern["bound_by"] = detect_bound_ms(kern["n_pixels"])
    part("kernel")
    print(f"streams: fast_detect_levels with the stream in its grid, "
          f"{STREAMS} frames x 4 levels in one launch: device kernel "
          f"{kern['ms']:.5f} ms, {STREAMS} single-frame launches "
          f"{kern['single_ms']:.5f} ms, plain {kern['plain_ms']:.5f} ms; "
          f"eager call kernel {kern['eager_ms']:.5f} ms, single-frame "
          f"launches {kern['single_eager_ms']:.5f} ms, plain "
          f"{kern['plain_eager_ms']:.5f} ms; bound {kern['bound_ms']:.5f} ms "
          f"by {kern['bound_by']} ({kern['n_pixels']} pixels, 9 B each); "
          f"masks bit-equal to the plain version and to the single-frame "
          f"launches, max |score - plain| = {kern['max_abs_err']}; "
          f"{kern['corners']} corners  [{card}]")

    # The main path: the S = STREAMS chain, warm-up then the timed pass.
    uniforms = torch.rand(STREAMS, 2, tc.max_map_points,
                          generator=torch.Generator().manual_seed(1)
                          ).to(device)
    sframes = [stream_frames(frames, k) for k in range(len(frames))]
    state = stream_start(rt, sbi_ops, kf_mod, frames, R0, t0, config, device)
    start = state
    sync(device)
    for key in fast.LAUNCHES:
        fast.LAUNCHES[key] = 0
    record = []
    for k in range(STREAM_WARMUP):
        state, out = rt.stream_step(sframes[k], state, sm, cam, uniforms,
                                    config)
        record.append(out)
    sync(device)
    t_wall = time.perf_counter()
    for k in range(len(frames)):
        state, out = rt.stream_step(sframes[k], state, sm, cam, uniforms,
                                    config)
        record.append(out)
    sync(device)
    wall = time.perf_counter() - t_wall
    launches = dict(fast.LAUNCHES)
    part("chain")
    n_steps = STREAM_WARMUP + len(frames)
    check(launches == {"fast_detect": 0, "fast_detect_levels": n_steps,
                       "fast_nonmax_levels": 0},
          f"FAST launches over {n_steps} steps of {STREAMS} streams: "
          f"{launches}, expected one fast_detect_levels per step")
    agg_fps = STREAMS * len(frames) / wall

    found = torch.stack([o.n_found for o in record]).cpu().numpy()
    quality = torch.stack([o.quality for o in record]).cpu().numpy()
    last = record[-1]
    k_last = len(frames) - 1
    for s in range(STREAMS):
        f = (k_last + STREAM_OFFSET * s) % len(frames)
        R_true, t_true = poses[f]
        t_err = float(torch.linalg.vector_norm(last.t[s] - t_true))
        r_err = rot_angle(last.R[s], R_true)
        bad_steps = [int(k) for k in np.nonzero(
            quality[:, s] == tracker.QUALITY_BAD)[0]]
        print(f"streams: stream {s} found min {found[:, s].min()} over the "
              f"{n_steps} steps (at step {int(found[:, s].argmin())}), "
              f"last {found[-1, s]} on frame {f}, BAD at steps {bad_steps}; "
              f"last pose error {t_err:.6f} m, {r_err:.6f} rad")
        check(found[-1, s] > 50,
              f"stream {s} found {found[-1, s]} <= 50 points at the last step")
        check(quality[-1, s] != tracker.QUALITY_BAD,
              f"stream {s} tracked BAD at the last step")
        check(t_err < MAX_T_ERR and r_err < MAX_R_ERR,
              f"stream {s}: last pose error t {t_err} m, rot {r_err} rad")

    # Streams against one stream: stream s alone through stream_step at
    # S = 1 over the first steps, on the same frames and draws.
    def frames_at(i):
        return sframes[i if i < STREAM_WARMUP else i - STREAM_WARMUP]

    worst_single = 0.0
    for s in range(STREAMS):
        st1 = start._map(lambda x, s=s: x[s:s + 1])
        for i in range(STREAM_SINGLE_STEPS):
            st1, o1 = rt.stream_step(frames_at(i)[s:s + 1], st1, sm, cam,
                                     uniforms[s:s + 1], config)
            ob = record[i]
            check(int(o1.n_found[0]) == int(ob.n_found[s])
                  and int(o1.quality[0]) == int(ob.quality[s]),
                  f"stream {s} step {i}: S = 1 gives n_found "
                  f"{int(o1.n_found[0])} quality {int(o1.quality[0])}, "
                  f"S = {STREAMS} {int(ob.n_found[s])} {int(ob.quality[s])}")
            worst_single = max(
                worst_single,
                float(torch.max(torch.abs(o1.R[0] - ob.R[s]))),
                float(torch.max(torch.abs(o1.t[0] - ob.t[s]))))
    check(worst_single <= STREAM_SINGLE_ATOL,
          f"streams and S = 1 poses differ by {worst_single}")
    part("single")

    # Card against CPU: the first steps through the plain path.
    cpu = torch.device("cpu")
    t_cpu = time.perf_counter()
    st_c, sm_c, cam_c, u_c = start.to(cpu), sm.to(cpu), cam.to(cpu), \
        uniforms.cpu()
    worst_pose, worst_found = 0.0, 0.0
    for i in range(STREAM_CPU_STEPS):
        st_c, oc = rt.stream_step(frames_at(i).cpu(), st_c, sm_c, cam_c,
                                  u_c, config)
        og = record[i]
        worst_pose = max(worst_pose,
                         float(torch.max(torch.abs(og.R.cpu() - oc.R))),
                         float(torch.max(torch.abs(og.t.cpu() - oc.t))))
        nf_g, nf_c = og.n_found.cpu(), oc.n_found
        worst_found = max(worst_found, float(torch.max(
            torch.abs(nf_g - nf_c) / torch.clamp(torch.maximum(nf_g, nf_c),
                                                 min=1))))
        check(torch.equal(og.quality.cpu(), oc.quality),
              f"card and CPU quality differ at step {i}: "
              f"{og.quality.tolist()} vs {oc.quality.tolist()}")
    print(f"streams: card vs CPU over {STREAM_CPU_STEPS} steps of "
          f"{STREAMS} streams: max pose diff {worst_pose:.3e}, max relative "
          f"n_found diff {worst_found:.4f} (CPU "
          f"{time.perf_counter() - t_cpu:.1f} s); streams vs S = 1 over "
          f"{STREAM_SINGLE_STEPS} steps: max pose diff {worst_single:.3e}, "
          f"n_found and quality equal")
    check(worst_pose <= POSE_ATOL, f"card and CPU poses differ: {worst_pose}")
    check(worst_found <= 1.0 - FOUND_AGREE,
          f"card and CPU n_found differ by {worst_found} (relative)")
    part("cpu")

    # Launches, busy share and fallbacks (outside the counted run).
    prof = {}
    for S in (STREAMS, 1):
        st_p = state._map(lambda x, S=S: x[:S])
        imgs_p, u_p = sframes[0][:S], uniforms[:S]
        prof[S] = profile_steps(
            lambda: rt.stream_step(imgs_p, st_p, sm, cam, u_p, config),
            STREAM_PROFILE_STEPS, device)
    part("profile")
    n_fallback, fallback_ops = count_fallbacks(
        lambda: rt.stream_step(sframes[0], state, sm, cam, uniforms,
                               config))
    with flagged_syncs(device) as syncs:
        rt.stream_step(sframes[0], state, sm, cam, uniforms, config)
        sync(device)
    part("fallbacks_syncs")
    for S in (STREAMS, 1):
        wall_ms, dev_ms, n_launch = prof[S]
        busy = (f"{100 * dev_ms / wall_ms:.2f}% busy" if dev_ms > 0
                else "device time not measured (the profiler saw none)")
        print(f"streams: S = {S}, {STREAM_PROFILE_STEPS} steps under "
              f"torch.profiler: {wall_ms:.3f} ms per step, device "
              f"{dev_ms:.3f} ms per step, {busy}, {n_launch:.1f} "
              f"kernel launches per step  [{card}]")
    print(f"streams: aggregate {agg_fps:.3f} frames/s ({STREAMS} streams x "
          f"{len(frames)} frames in {wall:.3f} s, warm pass) against phase "
          f"6's one-stream frame_step chain {one_stream_fps:.3f} frames/s; "
          f"launches per step {prof[STREAMS][2]:.1f} at S = {STREAMS} "
          f"against {prof[1][2]:.1f} at S = 1; vmap fallbacks {n_fallback} "
          f"{fallback_ops}; synchronising calls in one step {len(syncs)} "
          f"{sorted(set(syncs))[:8]}; phase {time.perf_counter() - t_phase:.1f}"
          f" s ({', '.join(f'{k} {v:.1f}' for k, v in parts.items())})"
          f"  [{card}]")
    check(len(syncs) == 0,
          f"stream_step synchronised with the host: {sorted(set(syncs))}")
    return launches, kern


def sharded_second_keyframe(device, config, sm, cam, scene, poses, kf_mod,
                            lie, synthetic, fast):
    """Legs 4-5's map: phase 4's fixed map with keyframe 1 rendered at
    SHARDED_KF1_MU from frame 0's pose (the JAX package's multi-device
    dry run, __graft_entry__.py:165-177, at full size) and the scene-depth
    statistics the epipolar search reads (tests/test_mapmaker.py's
    two_kf_map), with the epipolar depth cap widened as there. Returns
    (config, map, the FAST launches it made)."""
    import dataclasses

    cfg = dataclasses.replace(config, mapmaker=dataclasses.replace(
        config.mapmaker, epipolar_depth_max_factor=100.0))
    tc = cfg.tracker
    R0, t0 = poses[0]
    dR, dt = lie.se3_exp(torch.tensor(SHARDED_KF1_MU, device=device))
    R1, t1 = lie.se3_mul(dR, dt, R0, t0)
    for key in fast.LAUNCHES:
        fast.LAUNCHES[key] = 0
    frame1 = kf_mod.make_frame(
        synthetic.render(scene, cam, R1, t1, (tc.height, tc.width)), cfg)
    extras1 = kf_mod.make_frame_extras(frame1, cfg)
    sm2 = sm.clone()
    kf_mod.insert_keyframe(sm2.keyframes, 1, frame1, extras1, R1, t1)
    sm2.keyframes.depth_mean[1].fill_(4.0)
    sm2.keyframes.depth_sigma[1].fill_(0.8)
    sync(device)
    return cfg, sm2, dict(fast.LAUNCHES)


def _torch_tree(tree, device):
    """A rank's numpy result (a TensorTree of arrays) as tensors."""
    import dataclasses

    def conv(x):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x).to(device)
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        if dataclasses.is_dataclass(x):
            return _torch_tree(x, device)
        return x

    return dataclasses.replace(tree, **{
        f.name: conv(getattr(tree, f.name)) for f in dataclasses.fields(tree)})


def sharded_ba_parity(label, prob, cam, res, ref, bundle, mestimator):
    """Whole sharded BA runs held at the optimum against a single-device
    run of the same problem (tests/test_sharded_ba.py's criteria): the
    objective at the reference's sigma, rms, poses against the trajectory's
    length, accepted steps. Returns the printed figures."""
    n = prob.points.shape[0]
    res = res.replace(points=res.points[:n], meas_valid=res.meas_valid[:n],
                      outlier_meas=res.outlier_meas[:n],
                      point_outliers=res.point_outliers[:n])
    sigma = ref.sigma_squared
    obj = objective_at(prob, cam, res, sigma, bundle, mestimator)
    obj_ref = objective_at(prob, cam, ref, sigma, bundle, mestimator)
    rms = ba_outcome(prob, cam, res, bundle, mestimator)[0]
    rms_ref = ba_outcome(prob, cam, ref, bundle, mestimator)[0]
    traj = float(torch.linalg.vector_norm(ref.cam_t[-1] - ref.cam_t[0]))
    pose = max(float(torch.max(torch.abs(res.cam_t - ref.cam_t))),
               float(torch.max(torch.abs(res.cam_R - ref.cam_R))))
    check(abs(obj / obj_ref - 1.0) <= SHARDED_OBJ_RTOL,
          f"{label}: objective at one sigma {obj} against {obj_ref}")
    check(abs(rms / rms_ref - 1.0) <= SHARDED_RMS_RTOL,
          f"{label}: rms {rms} against {rms_ref}")
    check(pose <= SHARDED_POSE_SHARE * traj,
          f"{label}: poses differ by {pose}, trajectory {traj}")
    check(int(res.accepted) >= 1, f"{label}: no step accepted")
    check(bool(torch.isfinite(res.cam_t).all()
               and torch.isfinite(res.points).all()),
          f"{label}: a non-finite result")
    return (f"objective at one sigma {obj:.4f} / {obj_ref:.4f} "
            f"({obj / obj_ref - 1:+.2e}), rms {rms:.5f} / {rms_ref:.5f}, "
            f"max pose diff {pose:.2e} (trajectory {traj:.3f}), "
            f"{int(res.accepted)} / {int(ref.accepted)} steps accepted")


def payload_line(step, model, scalars):
    """One LM step's collectives by site beside the payload model's items
    (sharded_ba.comm_bytes_per_lm_step; scalars: port_scalar_bytes)."""
    sites = step["sites"]
    items = [k for k in model if k not in ("scalars", "total")]
    parts = [f"{k} {sites.get(k, 0)} / {model[k]}" for k in items]
    parts.append(f"scalars {sites.get('scalars', 0)} / "
                 f"{sum(scalars.values())} (model {model['scalars']})")
    ok = (all(sites.get(k, 0) == model[k] for k in items)
          and sites.get("scalars", 0) == sum(scalars.values())
          and set(sites) <= set(items) | {"scalars"})
    return ok, "payload bytes of one LM step, seen / model: " + ", ".join(
        parts)


def phase_sharded(device, card, config, sm, cam, scene, frames, poses,
                  fast, bundle, mapmaker, kf_mod, rt, sbi_ops, fixtures,
                  cam_ops, synthetic, lie, mestimator, runs=SHARDED_RUNS,
                  rank_device=None, steps=SHARDED_STEPS,
                  ba_iters=SHARDED_BA_ITERS):
    """Phase 17: every multi-device leg at each (ranks, backend, transport)
    of `runs`, held against the single-device port function on `device`.
    Returns (the parent's FAST launches of the path, the ranks' FAST and
    segmented-sum launches summed over ranks and runs)."""
    from visualslam_android_tpu_torch.ops import scatter
    from visualslam_android_tpu_torch.parallel import mesh as mesh_mod
    from visualslam_android_tpu_torch.parallel import rank_programs
    from visualslam_android_tpu_torch.parallel import sharded_ba

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    bc = config.bundle

    # Inputs. The ranks get CPU copies; the references run here.
    p128, c128, _ = make_band_problem(config, BIG_SEED, bundle, cam_ops,
                                      synthetic, lie)
    kw128 = dict(max_iters=SHARDED_BA128_ITERS, point_block=bc.point_block,
                 assembly="scatter", solver="chol", band_halfwidth=BIG_BAND)
    cfg512, sm512, c512, adjust = fixtures.build_band_ba_map(
        np.random.default_rng(BA512_SEED), n_kf=512, n_pts=30000,
        obs_per_pt=4, pose_perturb=0.02, point_perturb=0.03, device=device)
    p512 = mapmaker.build_ba_problem(sm512, adjust, cfg512)
    del sm512
    kw512 = dict(SHARDED_BA_KW, max_iters=ba_iters)
    halo_kw = {k: v for k, v in kw512.items() if k != "solver"}
    cfg2, sm2, parent_launches = sharded_second_keyframe(
        device, config, sm, cam, scene, poses, kf_mod, lie, synthetic, fast)
    thinned = {lvl: mapmaker.thin_candidates(sm2, 1, lvl, radius=3)
               for lvl in SHARDED_EPI_LEVELS}
    uniforms = torch.rand(STREAMS, 2, config.tracker.max_map_points,
                          generator=torch.Generator().manual_seed(1))
    sframes = torch.stack([stream_frames(frames, k)
                           for k in range(SHARDED_WARMUP + steps)])
    start = stream_start(rt, sbi_ops, kf_mod, frames, poses[0][0],
                         poses[0][1], config, device)
    sm_c, cam_c = sm.to(cpu), cam.to(cpu)
    sm2_c = sm2.to(cpu)
    cases = [
        ("ba128", "bundle_adjust", dict(prob=p128, cam=c128, warmup=True,
                                        **kw128)),
        ("ba128 step", "lm_step_bytes", dict(prob=p128, cam=c128,
                                             **kw128)),
        ("ba512", "bundle_adjust", dict(prob=p512.to(cpu), cam=c512.to(cpu),
                                        warmup=True, **kw512)),
        ("ba512 step", "lm_step_bytes", dict(prob=p512.to(cpu),
                                             cam=c512.to(cpu), **kw512)),
        ("halo", "bundle_adjust", dict(prob=p512.to(cpu), cam=c512.to(cpu),
                                       mode="halo", warmup=True, **halo_kw)),
        ("halo step", "lm_step_bytes", dict(prob=p512.to(cpu),
                                            cam=c512.to(cpu), mode="halo",
                                            **halo_kw)),
        ("refind", "refind", dict(slam_map=sm2_c, kf_idx=1, cam=cam_c,
                                  point_mask=sm2_c.points.valid,
                                  config=cfg2, warmup=True)),
        ("scalable", "refind_scalable", dict(
            slam_map=sm2_c, kf_idx=1, cam=cam_c,
            point_mask=sm2_c.points.valid, config=cfg2, warmup=True)),
    ] + [(f"epipolar {lvl}", "epipolar", dict(
        slam_map=thinned[lvl].to(cpu), src_kf=1, target_kf=0, cam=cam_c,
        level=lvl, config=cfg2, warmup=True))
        for lvl in SHARDED_EPI_LEVELS] + [
        ("streams", "tracking", dict(
            frames=sframes[SHARDED_WARMUP:].cpu(), state=start.to(cpu),
            slam_map=sm_c, cam=cam_c, uniforms=uniforms, config=config,
            warmup=SHARDED_WARMUP)),
    ]
    sync(device)
    t_in = time.perf_counter() - t_phase

    # The ranks: the path. Nothing else runs meanwhile.
    results = {}
    for D, backend, transport in runs:
        t0 = time.perf_counter()
        probes = [(f"collectives {n}", "collectives",
                   dict(shapes=[(n,)] * D)) for n in SHARDED_PROBE_FLOATS]
        results[D] = mesh_mod.run_ranks(
            rank_programs.run_cases, D, backend, transport,
            device=rank_device, timeout=SHARDED_TIMEOUT,
            args=(cases + probes,), threads=SHARDED_THREADS)
        print(f"sharded: {D} rank(s) over {backend} ({transport} "
              f"transport) ran every leg in {time.perf_counter() - t0:.1f} "
              f"s, start-up included  [{card}]")
    rank_launches = {k: sum(case["launches"][k] for rs in results.values()
                            for r in rs for case in r.values()
                            if "launches" in case)
                     for k in fast.LAUNCHES}
    rank_launches.update({k: sum(
        case["scatter_launches"][k]
        for rs in results.values() for r in rs for case in r.values()
        if "scatter_launches" in case) for k in scatter.LAUNCHES})

    # The single-device references on `device`.
    p128_d, c128_d = p128.to(device), c128.to(device)
    ref128 = bundle.bundle_adjust(p128_d, c128_d, **kw128)
    ref512 = bundle.bundle_adjust(p512, c512, **kw512)
    ref_map, ref_found, ref_never = mapmaker.refind_in_keyframe(
        sm2, 1, cam, sm2.points.valid, cfg2)
    K, N = sm2.keyframes.n_slots, sm2.points.n_slots
    mask_kn = sm2.points.valid[None].expand(K, N)
    _, kn_found, _ = mapmaker.refind_in_keyframes_batched(sm2, cam, mask_kn,
                                                          cfg2)
    check(torch.equal(kn_found[1], ref_found),
          "refind_in_keyframes_batched differs from refind_in_keyframe in "
          "keyframe 1")
    epi_ref = {lvl: mapmaker.epipolar_search(thinned[lvl], 1, 0, cam, lvl,
                                             cfg2)
               for lvl in SHARDED_EPI_LEVELS}
    st, stream_ref = start, []
    for k in range(steps):
        st, o = rt.stream_step(sframes[SHARDED_WARMUP + k].to(device), st, sm,
                               cam, uniforms.to(device), config)
        stream_ref.append(o)
    n_found = int(ref_found.sum())
    check(n_found >= 32, f"the single-device re-find found {n_found} points")

    figures = {}
    for (D, backend, transport) in runs:
        rs = results[D]
        r0 = rs[0]
        tag = f"D = {D}, {backend}, {transport} transport"
        # Every rank holds the same replicated results.
        for r in rs[1:]:
            for name in ("ba128", "ba512", "halo"):
                check(np.array_equal(r[name]["result"].cam_t,
                                     r0[name]["result"].cam_t),
                      f"{tag}: ranks hold different {name} poses")
        legs = {}
        for name, prob, cam_b, ref, kw, mode in (
                ("ba128", p128_d, c128_d, ref128, kw128, "psum"),
                ("ba512", p512, c512, ref512, kw512, "psum"),
                ("halo", p512, c512, None, halo_kw, "halo")):
            run = r0[name]
            res = _torch_tree(run["result"], device)
            ref_b = ref if ref is not None else _torch_tree(
                r0["ba512"]["result"], device)
            parity = sharded_ba_parity(f"{tag}, {name}", prob, cam_b, res,
                                       ref_b, bundle, mestimator)
            step = r0[f"{name} step"]
            K_b, O_b = prob.cam_R.shape[0], prob.meas_kf.shape[1]
            model = sharded_ba.comm_bytes_per_lm_step(
                K_b, step["n_global"], O_b,
                solver="band_pcg" if mode == "halo" else kw["solver"],
                cg_iters=step["cg_issued"], inner_iters=step["inner"],
                assembly=kw.get("assembly", "band"),
                band_halfwidth=kw["band_halfwidth"],
                sigma_mode=kw.get("sigma_mode", "gather" if mode == "psum"
                                  else "hist"), reduce_mode=mode)
            ok, line = payload_line(step, model, sharded_ba.port_scalar_bytes(
                step["inner"], mode))
            check(ok, f"{tag}, {name}: {line}")
            per_iter = run["ms"] / max(run["lm_iterations"], 1)
            cg = (f", CG {run['cg_iterations'] / run['cg_solves']:.1f} "
                  f"iterations per solve" if run["cg_solves"] else "")
            legs[name] = dict(ms=run["ms"], ms_per_lm=per_iter,
                              lm=run["lm_iterations"])
            print(f"sharded {name} ({tag}): {run['ms']:.1f} ms for "
                  f"{run['lm_iterations']} LM iterations = {per_iter:.3f} ms "
                  f"each{cg}; {parity}; {line}; host copies "
                  f"{run['host_copies']}  [{card}]")

        # Leg 4: both re-finds.
        meas, found, never = r0["refind"]["result"]
        found_t = torch.as_tensor(found).to(device)
        check(torch.equal(found_t, ref_found)
              and torch.equal(torch.as_tensor(never).to(device), ref_never)
              and torch.equal(torch.as_tensor(meas.valid).to(device),
                              ref_map.meas.valid),
              f"{tag}: sharded re-find differs from refind_in_keyframe "
              f"({int(found.sum())} / {n_found} found)")
        uv_err = float(torch.max(torch.abs(
            torch.as_tensor(meas.uv).to(device) - ref_map.meas.uv)[found_t]))
        sf, spz, slv, ssp = (torch.as_tensor(x).to(device)
                             for x in r0["scalable"]["result"])
        s_meas = mapmaker.add_measurements_batch(
            sm2.meas, sf, 1, spz, slv, mapmaker.SRC_REFIND, ssp)
        check(torch.equal(sf, ref_found)
              and torch.equal(s_meas.valid, ref_map.meas.valid),
              f"{tag}: scalable re-find differs ({int(sf.sum())} / "
              f"{n_found} found)")
        uv_err = max(uv_err, float(torch.max(torch.abs(
            s_meas.uv - ref_map.meas.uv)[sf])))
        check(uv_err <= SHARDED_UV_ATOL,
              f"{tag}: re-found uv differ by {uv_err}")
        print(f"sharded re-find ({tag}): {n_found} of "
              f"{int(sm2.points.valid.sum())} points found in keyframe 1 by "
              f"both sharded forms and refind_in_keyframe (and "
              f"refind_in_keyframes_batched), max uv diff {uv_err:.2e}; "
              f"{r0['refind']['ms']:.1f} / {r0['scalable']['ms']:.1f} ms; "
              f"payload {r0['refind']['sites']} / "
              f"{r0['scalable']['sites']}  [{card}]")

        # Leg 5: the epipolar search at levels 0-2.
        counts = []
        for lvl in SHARDED_EPI_LEVELS:
            res = _torch_tree(r0[f"epipolar {lvl}"]["result"], device)
            ref = epi_ref[lvl]
            s = ref.success
            check(torch.equal(res.success, s),
                  f"{tag}: epipolar success differs at level {lvl} "
                  f"({int(res.success.sum())} / {int(s.sum())})")
            err = max(float(torch.max(torch.abs(res.pos_w - ref.pos_w)[s]))
                      if bool(s.any()) else 0.0,
                      float(torch.max(torch.abs(res.target_uv
                                                - ref.target_uv)[s]))
                      if bool(s.any()) else 0.0)
            check(err <= SHARDED_EPI_ATOL,
                  f"{tag}: epipolar level {lvl} differs by {err}")
            counts.append((lvl, int(s.sum()), int(ref.success.shape[0]),
                           err, r0[f"epipolar {lvl}"]["ms"]))
        check(sum(c[1] for c in counts) >= 32,
              f"{tag}: the epipolar legs found {counts}")
        print(f"sharded epipolar search ({tag}): " + "; ".join(
            f"level {lvl} {n} of {c} candidates succeed, max diff "
            f"{e:.2e}, {ms:.1f} ms" for lvl, n, c, e, ms in counts)
            + f"  [{card}]")

        # Leg 6: replicated tracking.
        state_r, outs = r0["streams"]["result"]
        worst = 0.0
        for k, (o, ref) in enumerate(zip(outs, stream_ref)):
            check(np.array_equal(o.n_found, ref.n_found.cpu().numpy())
                  and np.array_equal(o.quality, ref.quality.cpu().numpy()),
                  f"{tag}: step {k}: n_found {o.n_found.tolist()} / "
                  f"{ref.n_found.tolist()}, quality {o.quality.tolist()} / "
                  f"{ref.quality.tolist()}")
            worst = max(worst,
                        float(np.max(np.abs(o.R - ref.R.cpu().numpy()))),
                        float(np.max(np.abs(o.t - ref.t.cpu().numpy()))))
        check(worst <= STREAM_SINGLE_ATOL,
              f"{tag}: streams differ from stream_step by {worst}")
        for r in rs:
            check(r["streams"]["launches"] == {
                "fast_detect": 0, "fast_detect_levels": steps,
                "fast_nonmax_levels": 0},
                f"{tag}: a rank's FAST launches over {steps} steps: "
                f"{r['streams']['launches']}, expected one per step")
        ms = r0["streams"]["ms"]
        print(f"sharded streams ({tag}): {STREAMS} streams, {STREAMS // D} "
              f"a rank, {steps} steps in {ms:.1f} ms ({ms / steps:.3f} ms a "
              f"step, {STREAMS * steps * 1e3 / ms:.3f} frames/s aggregate); "
              f"max pose diff from stream_step {worst:.2e}, n_found and "
              f"quality equal; one FAST launch per rank per step; payload "
              f"{r0['streams']['sites']}, host copies "
              f"{r0['streams']['host_copies']}  [{card}]")
        for n in SHARDED_PROBE_FLOATS:
            ms = r0[f"collectives {n}"]
            print(f"sharded collectives ({tag}), {4 * n} bytes a rank, "
                  f"median ms per call (the shape check and host copies "
                  f"included): " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in ms.items())
                  + f"  [{card}]")
            legs[f"collectives {4 * n} B"] = ms
        figures[D] = legs
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s (inputs and "
          f"references {t_in:.1f} s before the ranks)")
    return parent_launches, rank_launches, figures


def replay_keyframe(args, device, fstep, slam, bundle):
    """integrate_keyframe on a copy of its inputs, the four growth levels,
    one refind_newly and one local bundle adjustment round (the facade's
    BundleAdjustRecent) on `device`. Returns what the comparison reads."""
    (sm, new_points, never, failure, frame, R, t, found, pos, level, subpix,
     slot, cam, config) = (a.to(device) if hasattr(a, "to") else a
                           for a in args)
    sm, new_points = sm.clone(), new_points.clone()
    sm, new_points, never, failure = fstep.integrate_keyframe(
        sm, new_points, never, failure, frame, R, t, found, pos, level, subpix,
        slot, cam, config)
    observed0 = (sm.meas.valid & (sm.meas.kf == slot)).any(1)
    live0 = sm.points.live()
    for lvl in slam.SLAMSystem._GROW_LEVELS:
        sm, new_points = fstep.add_map_points_step(sm, new_points, cam, slot,
                                                   lvl, config)
    grown = int((sm.points.live() & ~live0).sum())
    sm, new_points, never, failure = fstep.refind_newly(
        sm, new_points, never, failure, cam, config, n_kf=slot + 1)
    K = sm.keyframes.n_slots
    pairs = torch.zeros(sm.points.n_slots, K, dtype=torch.int32,
                        device=sm.meas.kf.device)
    pairs.scatter_add_(1, sm.meas.kf.long().clamp(0, K - 1),
                       sm.meas.valid.to(torch.int32))
    pairs = (pairs > 0) & sm.points.live()[:, None]
    out = dict(meas=int(sm.meas.count()), observed0=observed0.cpu(),
               grown=grown, pairs=pairs.cpu(), never=never.cpu())
    adjust = fstep.mapmaker.local_ba_adjust_mask(sm, slot, config)
    rms_before = map_rms(sm, cam, config, fstep.mapmaker, bundle)
    sm, failure, never, conv, ok = fstep.ba_round(
        sm, slot, never, failure, cam, config, max_iters=8,
        assembly="scatter", solver="chol", mode="local")
    out.update(ba_adjusted=int(adjust.sum()), rms_before=rms_before,
               rms_after=map_rms(sm, cam, config, fstep.mapmaker, bundle),
               ba_converged=bool(conv), ba_ok=bool(ok))
    return out


def compare_keyframe_replay(args, label, device, card, fstep, slam, bundle,
                            grows):
    """replay_keyframe on the card and on the CPU, compared by outcome. With
    `grows`, the growth levels must insert points on both."""
    t0 = time.perf_counter()
    a = replay_keyframe(args, device, fstep, slam, bundle)
    b = replay_keyframe(args, "cpu", fstep, slam, bundle)
    both_s = time.perf_counter() - t0

    def agree(x, y):
        either = x | y
        return float((x == y)[either].float().mean()) if bool(
            either.any()) else 1.0

    d_meas = abs(a["meas"] - b["meas"]) / max(b["meas"], 1)
    print(f"{label}, card vs CPU (slot {args[11]}): measurements {a['meas']} "
          f"/ {b['meas']}, points seen in the new keyframe agree on "
          f"{agree(a['observed0'], b['observed0']):.4f}, (point, keyframe) "
          f"pairs after growth and refind_newly agree on "
          f"{agree(a['pairs'], b['pairs']):.4f}, grown points {a['grown']} / "
          f"{b['grown']}, never-retry pairs {int(a['never'].sum())} / "
          f"{int(b['never'].sum())}; local BA over {a['ba_adjusted']} / "
          f"{b['ba_adjusted']} keyframes: rms {a['rms_before']:.4f} -> "
          f"{a['rms_after']:.4f} / {b['rms_before']:.4f} -> "
          f"{b['rms_after']:.4f}, converged {a['ba_converged']} / "
          f"{b['ba_converged']} ({both_s:.1f} s for both)  [{card}]")
    check(d_meas <= KF_MEAS_AGREE, f"measurement counts differ by {d_meas}")
    check(agree(a["observed0"], b["observed0"]) >= KF_PAIRS_AGREE
          and agree(a["pairs"], b["pairs"]) >= KF_PAIRS_AGREE,
          "card and CPU found different points")
    check(abs(a["grown"] - b["grown"]) <= KF_NEW_POINTS_SLACK,
          f"card and CPU grew {a['grown']} and {b['grown']} points")
    if grows:
        check(a["grown"] > 0 and b["grown"] > 0,
              f"growth inserted {a['grown']} / {b['grown']} points")
    check(a["ba_ok"] and b["ba_ok"] and a["ba_adjusted"] == b["ba_adjusted"]
          and a["ba_adjusted"] > 0, "local bundle adjustment did not run")
    check(abs(a["rms_after"] - b["rms_after"])
          <= BOOT_RMS_AGREE * b["rms_after"],
          f"card and CPU rms after local BA differ: {a['rms_after']} vs "
          f"{b['rms_after']}")


def phase_slam_cpu(rec, device, card, fstep, slam, relocalizer, bundle):
    """The first keyframe integration and the relocalization of phase 10,
    replayed from copies of their inputs on the card and on the CPU."""
    compare_keyframe_replay(rec["integrate"], "full SLAM, first keyframe "
                            "integration", device, card, fstep, slam, bundle,
                            grows=False)
    sm, template, cam, max_score = rec["reloc"]
    r_card = relocalizer.attempt_recovery(sm, template, cam, max_score)
    r_cpu = relocalizer.attempt_recovery(sm.to("cpu"), template.cpu(),
                                         cam.to("cpu"), max_score)
    d_pose = max(float((r_card.R.cpu() - r_cpu.R).abs().max()),
                 float((r_card.t.cpu() - r_cpu.t).abs().max()))
    print(f"relocalization, card vs CPU: best keyframe {int(r_card.best_kf)} "
          f"/ {int(r_cpu.best_kf)}, success {bool(r_card.success)} / "
          f"{bool(r_cpu.success)}, score {float(r_card.score):.2f} / "
          f"{float(r_cpu.score):.2f}, max pose diff {d_pose:.3e}")
    check(int(r_card.best_kf) == int(r_cpu.best_kf)
          and bool(r_card.success) == bool(r_cpu.success),
          "card and CPU relocalize to different keyframes")
    check(d_pose <= RELOC_POSE_ATOL,
          f"card and CPU relocalized poses differ by {d_pose}")


def main():
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: chip_smoke needs a GPU")
    import visualslam_android_tpu_torch  # noqa: F401  (sets TF32 off)
    from visualslam_android_tpu_torch.models import bootstrap, bundle
    from visualslam_android_tpu_torch.models import frame_step
    from visualslam_android_tpu_torch import native_runtime
    from visualslam_android_tpu_torch.models import keyframe as kf_mod
    from visualslam_android_tpu_torch.models import mapmaker
    from visualslam_android_tpu_torch.models import relocalizer, slam
    from visualslam_android_tpu_torch.models import step_graph, tracker
    from visualslam_android_tpu_torch.ops import camera as cam_ops
    from visualslam_android_tpu_torch.ops import cuda_build, fast, image, lie
    from visualslam_android_tpu_torch.ops import mestimator, scatter, wls
    from visualslam_android_tpu_torch.ops import sbi as sbi_ops
    from visualslam_android_tpu_torch.parallel import replicated_tracking
    from visualslam_android_tpu_torch import run_slam
    from visualslam_android_tpu_torch.utils import ate, datasets, fixtures
    from visualslam_android_tpu_torch.utils import imageio, serialization
    from visualslam_android_tpu_torch.utils import synthetic

    check("jax" not in sys.modules, "the port imported jax")
    t_all = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # ---- 1. device ----
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} ({torch.cuda.device_count()} visible), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build: one nvcc per source, all started together ----
    t_build = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda build: build(),
                             (fast.build_kernel, scatter.build_kernel)))
    print(f"build: {', '.join(libs)} in {time.perf_counter() - t_build:.3f} "
          f"s")
    for source in ("fast.cu", "segsum.cu"):
        resources = ptxas_resources(cuda_build.build_log(source))
        for kernel, (regs, stores, loads) in resources.items():
            print(f"  {source}: {kernel}: {regs} registers, spill stores "
                  f"{stores} B, spill loads {loads} B")
        check(resources, f"no ptxas report in {source}'s build log")
        check(not any(st or ld for _, st, ld in resources.values()),
              f"a kernel of {source} spills registers: {resources}")

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

    # ---- 18. the segmented-sum kernel vs plain, at phase 9's shapes ----
    segsum_rows = phase_segsum(device, card, fixtures.full_config(), bundle,
                               scatter, cam_ops, lie, synthetic)

    # The segmented-sum launches of each path: set to 0 just before the
    # path runs, read just after; and by width and kernel path.
    seg_by_path, seg_kinds_by_path = {}, {}

    @contextlib.contextmanager
    def seg_path(name):
        for key in scatter.LAUNCHES:
            scatter.LAUNCHES[key] = 0
        yield
        seg_by_path[name] = scatter.LAUNCHES["segmented_sum"]
        seg_kinds_by_path[name] = {k: n for k, n in scatter.LAUNCHES.items()
                                   if k != "segmented_sum"}

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
    del outs, state0

    # ---- 13. multi-stream tracking on phase 4's map and frames ----
    stream_launches, skern = phase_streams(
        device, card, fast, replicated_tracking, sbi_ops, kf_mod, tracker,
        image, sm, cam, config, frames, poses, statistics.median(fps))

    # ---- 17. the multi-device paths on phase 4's map and frames ----
    sharded_launches, sharded_rank_launches, _ = phase_sharded(
        device, card, config, sm, cam, scene, frames, poses, fast, bundle,
        mapmaker, kf_mod, replicated_tracking, sbi_ops, fixtures, cam_ops,
        synthetic, lie, mestimator)
    del frames, sm

    seg_by_path["sharded_ranks"] = sharded_rank_launches["segmented_sum"]
    seg_kinds_by_path["sharded_ranks"] = {
        k: n for k, n in sharded_rank_launches.items()
        if k.startswith("segmented_sum ")}

    # ---- 7. the stereo bootstrap, then tracking on its map ----
    with seg_path("bootstrap"):
        (b_config, b_cam, b_frames, trails, second, init, boot_launches,
         kf_args) = phase_bootstrap(device, card, fast, bootstrap,
                                    frame_step, tracker, fixtures, synthetic,
                                    cam_ops)

    # ---- 8. bootstrap: card vs CPU ----
    with seg_path("bootstrap_replay"):
        phase_bootstrap_cpu(b_config, b_cam, card, b_frames, trails, second,
                            init, bootstrap, frame_step)
        compare_keyframe_replay(kf_args, "bootstrap map, keyframe 2 from the "
                                "last tracked frame", device, card,
                                frame_step, slam, bundle, grows=True)
    del b_frames, trails, second, init, kf_args

    # ---- 9. bundle adjustment at full state size ----
    for key in fast.LAUNCHES:
        fast.LAUNCHES[key] = 0
    with seg_path("ba_full_size"):
        phase_ba_full(device, card, b_config, bundle, cam_ops, lie,
                      mestimator, synthetic, wls)
        phase_ba_large(device, card, b_config, bundle, cam_ops, lie,
                       mestimator, synthetic, wls)
    ba_launches = dict(fast.LAUNCHES)

    # ---- 10. full SLAM through the facade ----
    with seg_path("slam"):
        slam_launches, slam_rec, slam_images, slam_poses, slam_results = (
            phase_full_slam(device, card, fast, slam, frame_step, relocalizer,
                            native_runtime, bundle, datasets, synthetic, ate))
    phase_slam_cpu(slam_rec, device, card, frame_step, slam, relocalizer,
                   bundle)
    del slam_rec
    t_phase = time.perf_counter()
    with seg_path("slam_modes"):
        modes_launches = phase_slam_modes(device, card, fast, slam, bundle,
                                          ate, slam_images, slam_poses,
                                          slam_results)
    print(f"phase 10's runs in the facade's modes took "
          f"{time.perf_counter() - t_phase:.1f} s")

    # ---- 19. the tracking step's CUDA graphs against the eager step ----
    phase_step_graphs(device, card, slam, frame_step, step_graph,
                      slam_images)
    del slam_images, slam_poses, slam_results

    # ---- 11. the large-map facade ----
    with seg_path("large_map"):
        large_launches = phase_large_map(
            device, card, fast, slam, frame_step, bundle, synthetic, cam_ops,
            lie, slam_launches["fast_nonmax_levels"])

    # ---- 12. the command line on the four TUM-format sequences ----
    t_phase = time.perf_counter()
    with seg_path("run_slam"):
        cli_launches = phase_run_slam(device, card, fast, run_slam,
                                      serialization, synthetic, cam_ops, lie,
                                      imageio, native_runtime)
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")

    # ---- 14. bundle adjustment at 512 keyframes / 30,000 points ----
    for key in fast.LAUNCHES:
        fast.LAUNCHES[key] = 0
    t_phase = time.perf_counter()
    with seg_path("ba_512"):
        phase_ba_512(device, card, bundle, mapmaker, fixtures, mestimator)
    ba512_launches = dict(fast.LAUNCHES)
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")

    # ---- 15. the 200-frame drift audit ----
    t_phase = time.perf_counter()
    with seg_path("drift"):
        drift_launches = phase_drift(device, card, fast, slam, synthetic,
                                     lie, ate)
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")

    # ---- 16. the real-photo run with sensor effects ----
    t_phase = time.perf_counter()
    with seg_path("photo"):
        photo_launches = phase_photo(device, card, fast, slam, synthetic,
                                     lie, ate)
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")

    # Every path that runs bundle adjustment went through the kernel.
    print(f"segmented_sum launches by path: {seg_by_path}")
    seg_kinds = {k: sum(kinds[k] for kinds in seg_kinds_by_path.values())
                 for k in scatter.LAUNCHES if k != "segmented_sum"}
    print(f"segmented_sum launches by width and kernel path: {seg_kinds}; "
          f"by path: {seg_kinds_by_path}")
    check(sum(seg_kinds.values()) == sum(seg_by_path.values()),
          f"segmented_sum launches by kind {seg_kinds} do not add up to "
          f"{sum(seg_by_path.values())}")
    for path, n in seg_by_path.items():
        check(n > 0, f"the {path} path launched segmented_sum no time: "
                     f"{seg_by_path}")

    print(f"all phases in {time.perf_counter() - t_all:.1f} s")
    seg_main = next(r for r in segsum_rows
                    if r["case"] == f"pair chunk, {BIG_K} slots")
    one_frame_ms = sum(r[2] for r in rows)
    one_frame_plain = sum(r[3] for r in rows)
    source = "visualslam_android_tpu_torch/csrc/fast.cu"
    replaces = "visualslam_android_tpu/ops/fast_pallas.py:50"

    by_path = {"chain": chain_launches, "bootstrap": boot_launches,
               "ba_full_size": ba_launches, "slam": slam_launches,
               "slam_modes": modes_launches,
               "large_map": large_launches, "run_slam": cli_launches,
               "streams": stream_launches, "ba_512": ba512_launches,
               "drift": drift_launches, "photo": photo_launches,
               "sharded": sharded_launches,
               "sharded_ranks": sharded_rank_launches}

    def row(name, paths=tuple(by_path), counter=None, **measured):
        counts = {p: by_path[p][counter or name] for p in paths}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(counts.values()),
                "launches_by_path": counts, "library_ms": None, **measured}

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
        row("fast_detect_levels_streams", paths=("streams", "sharded_ranks"),
            counter="fast_detect_levels", max_abs_err=skern["max_abs_err"],
            ms=skern["ms"], plain_ms=skern["plain_ms"],
            bound_ms=skern["bound_ms"], bound_by=skern["bound_by"],
            single_frame_launches_ms=skern["single_ms"],
            replaces_route="visualslam_android_tpu/ops/fast_pallas.py:173 "
                           "(_detect_vmappable's custom_vmap rule)",
            note=f"fast_levels_kernel with the stream in its grid: "
                 f"{STREAMS} frames x 4 levels in one launch "
                 f"(ops/fast.detect_levels_streams, make_frames); its "
                 f"launches are counted under fast_detect_levels; "
                 f"sharded_ranks: replicated_step_fn's launches, one per "
                 f"rank per step, summed over phase 17's ranks"),
        {"name": "segmented_sum", "route": "cuda",
         "source": "visualslam_android_tpu_torch/csrc/segsum.cu",
         "replaces": "none: the card's form of the JAX package's .at[].add "
                     "at visualslam_android_tpu/models/bundle.py:177 (also "
                     ":207, :242, :390, :583, :586), no Pallas kernel",
         "launches": sum(seg_by_path.values()),
         "launches_by_path": seg_by_path,
         "launches_by_width_and_kernel_path": seg_kinds,
         "max_abs_err": max(r["max_abs_err"] for r in segsum_rows),
         "ms": seg_main["ms"], "rowblock_ms": seg_main["rowblock_ms"],
         "plain_ms": seg_main["plain_ms"],
         "bound_ms": seg_main["bound_ms"], "bound_by": seg_main["bound_by"],
         "library_ms": seg_main["index_put_ms"],
         "library_call": "index_put_((index,), src, accumulate=True)",
         "library_index_add_ms": seg_main["index_add_ms"],
         "figures_of": seg_main["case"], "cases": segsum_rows,
         "note": "bundle_adjust's scatter sums (U, eps_a, E_corr, the Schur "
                 "pairs, the band, band-to-dense, the CG product) through "
                 "ops/scatter.segmented_sum, one launch per sum; "
                 "redesigned for Hopper: where the rows are many, a group "
                 "of T / 32 warps a row staging each step's terms into "
                 "shared memory by coalesced cp.async (short path); where "
                 "they are few, groups over (row, slice of the values) "
                 "(long path); the first version's additions bit for bit; "
                 "ms: the redesign, rowblock_ms: "
                 "the first version (segmented_sum_rowblock, one block per "
                 "row) in the same run, in turns; sharded_ranks: phase "
                 "17's ranks, summed"},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
