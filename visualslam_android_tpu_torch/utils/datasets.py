"""The synthetic sequence generator: a rendered planar scene seen along a
smooth camera path, with its ground truth.

Port of ``make_synthetic_sequence`` from the JAX package's
``utils/datasets.py``. The scene's texture is drawn with numpy from the
caller's generator in the JAX package's order, so one seed gives the same
frames in both. The TUM-RGBD and KITTI loaders are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from visualslam_android_tpu_torch.config import CameraConfig
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.utils import synthetic
from visualslam_android_tpu_torch.utils.tensors import default_device


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
