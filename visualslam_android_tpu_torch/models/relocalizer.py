"""Relocalization after tracking is lost.

Port of the JAX package's ``models/relocalizer.py`` (the reference's
jni/Relocaliser.{h,cc}): score the current frame's SmallBlurryImage against
every keyframe's (ScoreKFs, Relocaliser.cc:46-58, one batched reduction),
ESM-align it to the best one (6 iterations), lift the SE(2) to a camera
rotation and compose it with that keyframe's pose (AttemptRecovery
:17-42); accept when the alignment score is below max_score (9e6 by
default, :37). The best keyframe stays a 0-d tensor on the device: nothing
here reads back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.models.map_store import SLAMMap
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.ops import sbi as sbi_ops
from visualslam_android_tpu_torch.utils.tensors import TensorTree


@dataclasses.dataclass(frozen=True)
class RelocResult(TensorTree):
    success: torch.Tensor  # [] bool: score < max_score and a valid keyframe
    R: torch.Tensor        # [3, 3] recovered camera-from-world
    t: torch.Tensor        # [3]
    best_kf: torch.Tensor  # [] int32
    score: torch.Tensor    # [] ESM final score


def attempt_recovery(slam_map: SLAMMap, cur_sbi_template,
                     cam: cam_ops.Camera, max_score=9e6) -> RelocResult:
    kfs = slam_map.keyframes
    scores = sbi_ops.score_against_all(cur_sbi_template, kfs.sbi_template,
                                       kfs.valid)
    best = torch.argmin(scores).reshape(1)

    def pick(x):
        return x.index_select(0, best)[0]

    target = sbi_ops.SBI(template=pick(kfs.sbi_template),
                         jacs=pick(kfs.sbi_jacs))
    se2, esm_score = sbi_ops.esm_align(cur_sbi_template, target, 6)
    Rr, tr = sbi_ops.se3_from_se2(se2, cam, tuple(cur_sbi_template.shape))
    R, t = lie.se3_mul(Rr, tr, pick(kfs.R), pick(kfs.t))
    return RelocResult(
        success=torch.any(kfs.valid) & (esm_score < max_score),
        R=R, t=t, best_kf=best[0].to(torch.int32), score=esm_score,
    )
