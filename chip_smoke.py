"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port's main path, the per-frame tracking step, at the
reference's full size and checks it:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernel (csrc/fast.cu) with nvcc;
3. kernel vs plain: on an 800x480 frame's four pyramid levels, the FAST
   kernel against its plain PyTorch version (masks equal, scores within
   1e-3), and both timed with CUDA events (median of 50), eager and as
   CUDA-graph replays (device time);
4. slice: builds the 2048-slot fixed map of ``bench.py`` on the card,
   renders its 100 chained frames there and runs ``frame_step`` over them,
   chaining pose, velocity, SBI and map; every frame must find more than
   50 points with quality not BAD, stay within the pose-error bound of the
   rendered ground truth, and launch the FAST kernel exactly 4 times;
5. card vs CPU: the first 5 frames again on the CPU through the plain
   path, from the same state with the same random draws;
6. timing: a warm second pass over the 100 frames (frames/s), and the
   split between the front-end (make_frame) and the rest.

Any failed check raises and the script exits non-zero. The last two lines
of standard output are a JSON object describing the kernels and the
``{"ok": true, "device": ...}`` line. It imports no jax.
"""

from __future__ import annotations

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
    c = (torch.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(torch.arccos(torch.clamp(c, -1.0, 1.0)))


def phase_kernel(device, fast, fixtures, synthetic, image):
    """Kernel against plain version on the four level shapes."""
    config = fixtures.full_config()
    tc = config.tracker
    from visualslam_android_tpu_torch.ops import camera as cam_ops

    cam = cam_ops.make_camera(config.camera.params(), tc.width, tc.height,
                              device=device)
    scene = synthetic.make_planar_scene(np.random.default_rng(3),
                                        px_per_m=240.0, device=device)
    R0, t0 = synthetic.look_at_pose((0.0, 0.0, 0.0), device=device)
    img = synthetic.render(scene, cam, R0, t0, (tc.height, tc.width))
    levels = image.make_pyramid(img, tc.n_levels)
    max_err, rows = 0.0, []
    for lvl, (level, thresh) in enumerate(zip(levels, tc.fast_thresholds)):
        level = level.contiguous()
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


def main():
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: chip_smoke needs a GPU")
    import visualslam_android_tpu_torch  # noqa: F401  (sets TF32 off)
    from visualslam_android_tpu_torch.models import frame_step
    from visualslam_android_tpu_torch.models import keyframe as kf_mod
    from visualslam_android_tpu_torch.models import tracker
    from visualslam_android_tpu_torch.ops import fast, image
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

    # ---- 3. kernel vs plain ----
    max_err, rows = phase_kernel(device, fast, fixtures, synthetic, image)
    for shape, thresh, ms, plain_ms, eager, plain_eager, n in rows:
        print(f"fast level {shape} t={thresh}: device kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms; eager call kernel {eager:.5f} ms, "
              f"plain {plain_eager:.5f} ms; {n} corners  [{card}]")
    print(f"fast max |score - plain| = {max_err}")

    # ---- 4. the slice ----
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

    fast.KERNEL_LAUNCHES = 0
    outs = run_chain(frame_step, frames, state0, config, uniforms_dev, cam)
    torch.cuda.synchronize()
    launches = fast.KERNEL_LAUNCHES
    check(launches == 4 * N_FRAMES,
          f"FAST kernel launched {launches} times over {N_FRAMES} frames, "
          f"expected {4 * N_FRAMES}")
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

    # ---- 6. timing (warm second pass) ----
    torch.cuda.synchronize()
    t_wall = time.perf_counter()
    run_chain(frame_step, frames, state0, config, uniforms_dev, cam)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_wall
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for img in frames:
        kf_mod.make_frame(img, config)
    b.record()
    b.synchronize()
    front_ms = a.elapsed_time(b) / N_FRAMES
    frame_ms = 1000.0 * wall / N_FRAMES
    print(f"timing: {N_FRAMES / wall:.3f} frames/s ({frame_ms:.3f} ms/frame)"
          f"; make_frame {front_ms:.4f} ms/frame, rest "
          f"{frame_ms - front_ms:.3f} ms/frame  [{card}]")

    kernel_ms = sum(r[2] for r in rows)
    plain_ms = sum(r[3] for r in rows)
    print(json.dumps({"kernels": [{
        "name": "fast_detect",
        "route": "cuda",
        "source": "visualslam_android_tpu_torch/csrc/fast.cu",
        "replaces": "visualslam_android_tpu/ops/fast_pallas.py:50",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
