"""Dataset loaders, TUM-RGBD (mono) and KITTI odometry (mono), and the
synthetic sequence generator used where no dataset is on disk.

Port of the JAX package's ``utils/datasets.py``. Frames come out as f32
grey images in [0, 255] at the configured size. They are read by the
repository's C++ runtime (``native_runtime.FramePipeline``: worker threads
decode and resize ahead of the consumer) where it builds, else by
``utils/imageio`` with numpy, which gives the same bytes; the JAX package
falls back to PIL instead, which the card's machine does not have. The
synthetic scene's texture is drawn with numpy from the caller's generator
in the JAX package's order, so one seed gives the same frames in both.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from visualslam_android_tpu_torch.config import CameraConfig
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.utils import imageio, synthetic
from visualslam_android_tpu_torch.utils.tensors import default_device


@dataclasses.dataclass
class Sequence:
    name: str
    frames: List[str]                     # image paths
    timestamps: np.ndarray                # [T]
    gt_positions: Optional[np.ndarray]    # [T, 3] or None
    gt_quaternions: Optional[np.ndarray]  # [T, 4] (x, y, z, w) or None
    size: Tuple[int, int]                 # (width, height)

    def __len__(self):
        return len(self.frames)


def _table(path):
    """The rows of a whitespace-separated text file, '#' lines skipped."""
    with open(path) as f:
        return [line.split() for line in f
                if line.strip() and not line.lstrip().startswith("#")]


def load_tum(root: str, size=(640, 480), max_frames=None) -> Sequence:
    """TUM-RGBD mono: rgb.txt, and groundtruth.txt where present,
    associated to each frame by nearest timestamp (the TUM protocol)."""
    entries = [(float(row[0]), os.path.join(root, row[1]))
               for row in _table(os.path.join(root, "rgb.txt"))]
    if max_frames:
        entries = entries[:max_frames]
    ts = np.asarray([e[0] for e in entries])
    gt_pos = gt_quat = None
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_file):
        raw = np.asarray([[float(v) for v in row]
                          for row in _table(gt_file)])
        # The first ground truth at or after each frame, or its left
        # neighbour where that is as close or closer.
        hi = np.clip(np.searchsorted(raw[:, 0], ts), 0, len(raw) - 1)
        lo = np.clip(hi - 1, 0, len(raw) - 1)
        idx = np.where(np.abs(raw[lo, 0] - ts) <= np.abs(raw[hi, 0] - ts),
                       lo, hi)
        gt_pos, gt_quat = raw[idx, 1:4], raw[idx, 4:8]
    return Sequence(name=os.path.basename(root.rstrip("/")),
                    frames=[e[1] for e in entries], timestamps=ts,
                    gt_positions=gt_pos, gt_quaternions=gt_quat, size=size)


def load_kitti(root: str, sequence="00", size=(620, 188),
               max_frames=None) -> Sequence:
    """KITTI odometry mono (image_0), poses from poses/<sequence>.txt."""
    img_dir = os.path.join(root, "sequences", sequence, "image_0")
    frames = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                    if f.endswith(".png"))
    if max_frames:
        frames = frames[:max_frames]
    gt_pos = None
    pose_file = os.path.join(root, "poses", f"{sequence}.txt")
    if os.path.exists(pose_file):
        gt_pos = np.loadtxt(pose_file).reshape(-1, 3, 4)[:len(frames), :, 3]
    return Sequence(name=f"kitti-{sequence}", frames=frames,
                    timestamps=np.arange(len(frames), dtype=np.float64) * 0.1,
                    gt_positions=gt_pos, gt_quaternions=None, size=size)


def iter_images(seq: Sequence, use_native: bool = True,
                info: Optional[dict] = None) -> Iterator[np.ndarray]:
    """f32 grey frames [height, width] at seq.size: through the C++
    runtime's FramePipeline where use_native and the library builds, else
    through utils/imageio (the same bytes). `info`, where given, gets
    "reader": "native" or "numpy" for the reader that ran, and
    "native_error" where the native one was asked for and failed."""
    from visualslam_android_tpu_torch import native_runtime

    info = {} if info is None else info
    w, h = seq.size
    if use_native:
        try:
            with native_runtime.FramePipeline(seq.frames, w, h) as pipe:
                info["reader"] = "native"
                for _, img in pipe:
                    yield img.astype(np.float32)
            return
        except native_runtime.NativeRuntimeUnavailable as e:
            info["native_error"] = str(e)
    info["reader"] = "numpy"
    for path in seq.frames:
        yield imageio.decode_image(path, w, h).astype(np.float32)


def make_synthetic_sequence(rng, n_frames=60, size=(320, 240), depth=4.0,
                            motion_scale=1.0, px_per_m=140.0, device=None):
    """Rendered planar sequence with ground truth, on `device` (the CUDA
    card when None). size is (width, height); px_per_m sets the texture
    density (raise it for 800x480 frames so gradients stay strong).
    Returns (images: [H, W] f32 tensors, poses: camera-from-world (R, t)
    tensors, centers: [n_frames, 3] numpy camera centers, camera, scene)."""
    device = default_device(device)
    cam = cam_ops.make_camera(CameraConfig().params(), size[0], size[1],
                              device=device)
    scene = synthetic.make_planar_scene(rng, depth=depth, px_per_m=px_per_m,
                                        device=device)
    R0, t0 = synthetic.look_at_pose((0.0, 0.0, 0.0), target=(0, 0, depth),
                                    device=device)
    images, poses = [], []
    for k in range(n_frames):
        s = k / max(n_frames - 1, 1)
        mu = torch.tensor(
            [motion_scale * 0.6 * s, motion_scale * 0.1 * np.sin(2.5 * s),
             motion_scale * 0.08 * s, 0.0, motion_scale * 0.14 * s,
             motion_scale * 0.04 * np.sin(3 * s)],
            dtype=torch.float32, device=device,
        )
        dR, dt = lie.se3_exp(mu)
        Rk, tk = lie.se3_mul(dR, dt, R0, t0)
        images.append(synthetic.render(scene, cam, Rk, tk,
                                       (size[1], size[0])))
        poses.append((Rk, tk))
    centers = np.stack([(-R.T @ t).cpu().numpy() for R, t in poses])
    return images, poses, centers, cam, scene
