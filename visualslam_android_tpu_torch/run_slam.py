"""Command line: run the full SLAM system on a dataset (TUM, KITTI or the
built-in synthetic sequence), with scripted bootstrap presses in place of
the reference's touch events (jni/jni_part.cpp:49-51), and report the
similarity-aligned ATE where ground truth exists.

Port of the JAX package's ``run_slam.py``, with its flags, presets and
report keys. It runs on the CUDA card unless ``--device cpu`` is given.
The facade runs pipelined (results one frame late at the default
``--pipeline-depth 1``, the same as ``--sync``'s bit for bit) unless
``--sync`` is given.

Usage:
  python -m visualslam_android_tpu_torch.run_slam --dataset synthetic --frames 40
  python -m visualslam_android_tpu_torch.run_slam --dataset tum --root <dir>
  python -m visualslam_android_tpu_torch.run_slam --dataset kitti --root <dir>
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--dataset", choices=["synthetic", "tum", "kitti"],
                   default="synthetic")
    p.add_argument("--root", default=None, help="dataset root directory")
    p.add_argument("--sequence", default="00", help="KITTI sequence id")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--init-frame", type=int, default=0,
                   help="frame of the first bootstrap press")
    p.add_argument("--stereo-frame", type=int, default=6,
                   help="frame of the second bootstrap press")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-map", default=None)
    p.add_argument("--json", action="store_true",
                   help="print one JSON line instead of a report")
    p.add_argument("--profile", action="store_true",
                   help="print a per-stage wall-clock timing table")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace into this dir")
    p.add_argument("--preset", choices=["default", "small"],
                   default="default",
                   help="'small' shrinks map and corner capacities for quick "
                        "runs (lower quality ceiling)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain versions on the host)")
    p.add_argument("--sync", action="store_true",
                   help="synchronous per-frame results (one blocking stats "
                        "read per frame) instead of the default pipelined "
                        "mode, where results lag and steady-state tracking "
                        "never blocks on the read")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="pipelined mode: frames in flight before waiting "
                        "for the oldest one's stats. 1 = results one frame "
                        "late, bit for bit those of --sync; d >= 2: the "
                        "host's decisions trail by d frames")
    return p.parse_args(argv)


def make_config(preset: str, size):
    """run_slam's two presets at frame size (width, height)."""
    from visualslam_android_tpu_torch.config import (
        MapMakerConfig,
        SLAMConfig,
        TrackerConfig,
    )

    if preset == "small":
        return SLAMConfig(
            tracker=TrackerConfig(
                width=size[0], height=size[1], max_map_points=256,
                max_corners_per_level=(256, 128, 64, 32), max_trails=128,
                min_frames_between_kfs=6,
            ),
            mapmaker=MapMakerConfig(max_keyframes=8, max_epi_candidates=64),
        )
    return SLAMConfig(
        tracker=TrackerConfig(
            width=size[0], height=size[1], max_map_points=1024,
            max_corners_per_level=(512, 256, 128, 64),
            min_frames_between_kfs=6,
        ),
        mapmaker=MapMakerConfig(max_keyframes=16, max_epi_candidates=128),
    )


def load_frames(args, device):
    """(frame iterator, frame count, ground-truth centres or None, size,
    reader info)."""
    from visualslam_android_tpu_torch.utils import datasets

    info = {}
    if args.dataset == "synthetic":
        size = (args.width or 320, args.height or 240)
        images, _, gt_centers, _, _ = datasets.make_synthetic_sequence(
            np.random.default_rng(args.seed), n_frames=args.frames,
            size=size, device=device)
        return iter(images), args.frames, gt_centers, size, info
    if not args.root:
        raise SystemExit("--root required for tum/kitti")
    if args.dataset == "tum":
        seq = datasets.load_tum(
            args.root, size=(args.width or 640, args.height or 480),
            max_frames=args.frames)
    else:
        seq = datasets.load_kitti(
            args.root, args.sequence,
            size=(args.width or 620, args.height or 188),
            max_frames=args.frames)
    return (datasets.iter_images(seq, info=info), len(seq), seq.gt_positions,
            seq.size, info)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from visualslam_android_tpu_torch.models import slam
    from visualslam_android_tpu_torch.utils import ate, profiling
    from visualslam_android_tpu_torch.utils import serialization
    from visualslam_android_tpu_torch.utils.tensors import default_device

    device = default_device(torch.device(args.device))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    images, n_frames, gt_centers, size, info = load_frames(args, device)
    config = make_config(args.preset, size)
    sys_ = slam.SLAMSystem(config, seed=args.seed, pipelined=not args.sync,
                           pipeline_depth=args.pipeline_depth, device=device)
    sys_.timer.enabled = args.profile

    est, used_gt = [], []

    def consume(res):
        if not res.valid:
            return  # pipelined warm-up placeholder
        if not args.json:
            print(f"[{res.frame_id:4d}] {res.message}"
                  + ("  (lost)" if res.lost else ""))
        if res.phase == slam.PHASE_TRACKING and not res.lost:
            est.append((res.pose_R, res.pose_t))
            if gt_centers is not None:
                used_gt.append(gt_centers[res.frame_id])

    t0 = time.perf_counter()
    with profiling.profiler_trace(args.trace_dir):
        for k, img in enumerate(images):
            if k in (args.init_frame, args.stereo_frame):
                sys_.on_touch()
            consume(sys_.track_frame(img))
        for res in sys_.flush():
            consume(res)
    wall = time.perf_counter() - t0
    if args.profile:
        print(sys_.timer.report())

    counts = torch.stack([sys_.slam_map.points.count(),
                          sys_.slam_map.keyframes.count()]).tolist()
    report = {
        "frames": n_frames,
        "tracked": len(est),
        "fps": round(n_frames / wall, 2),
        "map_points": int(counts[0]),
        "keyframes": int(counts[1]),
    }
    if gt_centers is not None and len(est) > 5:
        centers = ate.camera_centers([e[0] for e in est], [e[1] for e in est])
        rmse, _ = ate.ate_rmse(centers, np.asarray(used_gt))
        report["ate_rmse"] = round(rmse, 5)
    if args.save_map:
        serialization.save_map(args.save_map, sys_.slam_map, config)
        report["map_saved"] = args.save_map
    if "reader" in info:
        report["reader"] = info["reader"]
    print(json.dumps(report))
    return report, sys_


if __name__ == "__main__":
    main()
