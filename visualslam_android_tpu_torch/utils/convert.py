"""State carry-over from the JAX package: numpy trees -> the port's
dataclasses of tensors.

Each function takes one of the JAX package's NamedTuples after
``jax.tree.map(np.asarray, x)`` (so numpy arrays, or tuples of them, in
the fields) and returns the port's dataclass with the same field names on
the given device (the CUDA card when `device` is None). With it both
packages compute on the same map, camera, SBI, frame and bundle problem.
This module itself imports neither jax nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from visualslam_android_tpu_torch.models.bootstrap import TrailState
from visualslam_android_tpu_torch.models.bundle import BAProblem, BAResult
from visualslam_android_tpu_torch.models.homography import HomographyResult
from visualslam_android_tpu_torch.models.mapmaker import EpipolarResult
from visualslam_android_tpu_torch.models.map_store import (
    FrameData,
    FrameExtras,
    KeyFrameStore,
    MeasStore,
    PointStore,
    SLAMMap,
)
from visualslam_android_tpu_torch.ops.camera import Camera
from visualslam_android_tpu_torch.parallel.replicated_tracking import (
    StreamState,
)
from visualslam_android_tpu_torch.ops.sbi import SBI
from visualslam_android_tpu_torch.utils.tensors import default_device


def _tensor(x, device):
    if isinstance(x, tuple):
        return tuple(_tensor(v, device) for v in x)
    return torch.as_tensor(np.array(x), device=default_device(device))


def _convert(cls, tree, device):
    return cls(**{f.name: _tensor(getattr(tree, f.name), device)
                  for f in dataclasses.fields(cls)})


def map_from_numpy(tree, device=None) -> SLAMMap:
    return SLAMMap(
        points=_convert(PointStore, tree.points, device),
        keyframes=_convert(KeyFrameStore, tree.keyframes, device),
        meas=_convert(MeasStore, tree.meas, device),
        good=_tensor(tree.good, device),
    )


def camera_from_numpy(tree, device=None) -> Camera:
    return _convert(Camera, tree, device)


def sbi_from_numpy(tree, device=None) -> SBI:
    return _convert(SBI, tree, device)


def stream_state_from_numpy(tree, device=None) -> StreamState:
    """The JAX package's replicated_tracking.StreamState, SBI included."""
    fields = {f.name: _tensor(getattr(tree, f.name), device)
              for f in dataclasses.fields(StreamState)
              if f.name != "sbi_last"}
    return StreamState(sbi_last=sbi_from_numpy(tree.sbi_last, device),
                       **fields)


def frame_from_numpy(tree, device=None) -> FrameData:
    return _convert(FrameData, tree, device)


def extras_from_numpy(tree, device=None) -> FrameExtras:
    return _convert(FrameExtras, tree, device)


def homography_from_numpy(tree, device=None) -> HomographyResult:
    return _convert(HomographyResult, tree, device)


def ba_problem_from_numpy(tree, device=None) -> BAProblem:
    return _convert(BAProblem, tree, device)


def ba_result_from_numpy(tree, device=None) -> BAResult:
    return _convert(BAResult, tree, device)


def epipolar_result_from_numpy(tree, device=None) -> EpipolarResult:
    return _convert(EpipolarResult, tree, device)


def trails_from_numpy(frame, extras, patches, init_pos, cur_pos, valid,
                      device=None) -> TrailState:
    """The bootstrap trail state, which the JAX package keeps as attributes
    of its SLAMSystem (_trail_first, _trail_patches, _trail_init_pos,
    _trail_cur_pos, _trail_valid)."""
    return TrailState(
        frame=frame_from_numpy(frame, device),
        extras=extras_from_numpy(extras, device),
        patches=_tensor(patches, device), init_pos=_tensor(init_pos, device),
        cur_pos=_tensor(cur_pos, device), valid=_tensor(valid, device),
    )
