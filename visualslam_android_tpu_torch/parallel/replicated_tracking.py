"""Multi-stream tracking: S independent camera streams tracked against one
shared, read-only map, in one batched program on one device or with the
streams sharded over the ranks of a mesh.

Port of the JAX package's ``parallel/replicated_tracking.py``
(``StreamState``, ``StreamOutputs``, ``init_streams``, ``stream_step``,
``make_mesh``, ``replicated_step_fn``; SURVEY.md §2, row "replicated
tracking"). Each stream runs the full TrackFrame hot path
(jni/Tracker.cc:76-146): front-end, SBI + ESM rotation prior, motion
model, TrackMap and the motion-model update. Every operation is issued
once for all S streams:

- the front-end is ``keyframe.make_frames``: one pyramid over [S, H, W]
  and ONE FAST launch with the stream in the kernel's grid;
- the rest is ``torch.func.vmap`` of the single-stream step over the
  stream axis, so each op runs once on the batch (the JAX package's
  ``jax.vmap`` of ``_one_stream_step``).

The map and camera are shared and not modified. Randomness: the JAX
package splits each stream's key inside ``track_map`` into the coarse
and fine selection draws; here the caller passes those draws, as
``uniforms`` [S, 2, N], in the keys' place. ``stream_step`` makes no
device-to-host read: the caller reads the ``StreamOutputs`` once per
frame.

``replicated_step_fn`` shards the stream axis over a mesh
(parallel/mesh.py): each rank runs ``stream_step`` on its S/D streams
against the replicated map (one stream-gridded FAST launch per rank per
step), and every rank gets the whole state and outputs back by all_gather.
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models import keyframe as kf_mod
from visualslam_android_tpu_torch.models import tracker
from visualslam_android_tpu_torch.models.map_store import FrameData, SLAMMap
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import sbi as sbi_ops
from visualslam_android_tpu_torch.parallel import mesh as mesh_mod
from visualslam_android_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from visualslam_android_tpu_torch.utils.tensors import (
    TensorTree,
    default_device,
)

_dc = dataclasses.dataclass(frozen=True)

@_dc
class StreamState(TensorTree):
    """Per-stream tracker state (leading axis = stream)."""

    R: torch.Tensor                 # [S, 3, 3]
    t: torch.Tensor                 # [S, 3]
    velocity: torch.Tensor          # [S, 6]
    vel_msd_mag: torch.Tensor       # [S]
    scene_depth_mean: torch.Tensor  # [S]
    sbi_last: sbi_ops.SBI           # [S, h, w] template / [S, h, w, 2] jacs
    has_sbi: torch.Tensor           # [S] bool (first frame has no prior SBI)


@_dc
class StreamOutputs(TensorTree):
    R: torch.Tensor             # [S, 3, 3]
    t: torch.Tensor             # [S, 3]
    n_found: torch.Tensor       # [S] int32
    quality: torch.Tensor       # [S] int32 (2 good / 1 dodgy / 0 bad)
    did_coarse: torch.Tensor    # [S] bool


def init_streams(n_streams: int, R0, t0, config: SLAMConfig,
                 depth_mean=4.0, device=None) -> StreamState:
    """All streams start at pose (R0, t0) with zero velocity and no SBI
    prior, on `device` (the CUDA card when None); replace per-stream
    values afterwards if streams differ."""
    tc = config.tracker
    h, w = tc.height // 16, tc.width // 16
    S = n_streams
    f32 = torch.float32
    device = default_device(device)
    R0 = torch.as_tensor(R0, dtype=f32, device=device)
    t0 = torch.as_tensor(t0, dtype=f32, device=device)
    return StreamState(
        R=R0.expand(S, 3, 3).clone(),
        t=t0.expand(S, 3).clone(),
        velocity=torch.zeros(S, 6, dtype=f32, device=device),
        vel_msd_mag=torch.zeros(S, dtype=f32, device=device),
        scene_depth_mean=torch.full((S,), depth_mean, dtype=f32,
                                    device=device),
        sbi_last=sbi_ops.SBI(
            template=torch.zeros(S, h, w, dtype=f32, device=device),
            jacs=torch.zeros(S, h, w, 2, dtype=f32, device=device),
        ),
        has_sbi=torch.zeros(S, dtype=torch.bool, device=device),
    )


def _one_stream_step(frame: FrameData, state: StreamState,
                     slam_map: SLAMMap, cam: cam_ops.Camera, uniforms,
                     config: SLAMConfig):
    """The TrackFrame hot path (Tracker.cc:76-146) for ONE stream after
    its front-end: SBI + ESM rotation prior, motion model, TrackMap,
    motion-model update. Unbatched; stream_step vmaps it. uniforms [2, N]
    are track_map's two selection draws. Returns (new state without
    has_sbi, outputs), as tuples of tensors."""
    tc = config.tracker
    sbi_cur = sbi_ops.make_sbi(frame.pyramid[-1], tc.sbi_blur)
    sbi_rot = tracker.calc_sbi_rotation(
        sbi_cur.template, state.sbi_last, cam, tc.sbi_esm_iters
    )
    R1, t1 = tracker.apply_motion_model(
        state.R, state.t, state.velocity, sbi_rot, state.has_sbi
    )
    out = tracker.track_map(
        frame, slam_map, cam, R1, t1, state.vel_msd_mag, config,
        uniforms=(uniforms[0], uniforms[1]),
    )
    depth = torch.where(out.depth_stats_valid, out.scene_depth_mean,
                        state.scene_depth_mean)
    velocity, _, msd = tracker.update_motion_model(
        out.R, out.t, state.R, state.t, state.velocity, depth,
        tc.motion_decay,
    )
    quality = tracker.assess_tracking_quality(
        out.attempted_per_level, out.found_per_level,
        tc.quality_good, tc.quality_lost,
    )
    new_state = (out.R, out.t, velocity, msd, depth, sbi_cur.template,
                 sbi_cur.jacs)
    outputs = (out.R, out.t, torch.sum(out.found).to(torch.int32),
               quality.to(torch.int32), out.did_coarse)
    return new_state, outputs


def stream_step(imgs, state: StreamState, slam_map: SLAMMap,
                cam: cam_ops.Camera, uniforms, config: SLAMConfig):
    """One tracking frame for all S streams. imgs [S, H, W]; uniforms
    [S, 2, N] in [0, 1), track_map's coarse and fine selection draws for
    each stream (the JAX package takes a key per stream here). Returns
    (StreamState, StreamOutputs)."""
    frames = kf_mod.make_frames(imgs, config)

    def one(pyramid, corner_mask, corner_score, R, t, velocity, msd, depth,
            template, jacs, has_sbi, draws):
        frame = FrameData(pyramid=pyramid, corner_mask=corner_mask,
                          corner_score=corner_score)
        st = StreamState(R=R, t=t, velocity=velocity, vel_msd_mag=msd,
                         scene_depth_mean=depth,
                         sbi_last=sbi_ops.SBI(template=template, jacs=jacs),
                         has_sbi=has_sbi)
        return _one_stream_step(frame, st, slam_map, cam, draws, config)

    (R, t, velocity, msd, depth, template, jacs), outs = torch.func.vmap(
        one)(frames.pyramid, frames.corner_mask, frames.corner_score,
             state.R, state.t, state.velocity, state.vel_msd_mag,
             state.scene_depth_mean, state.sbi_last.template,
             state.sbi_last.jacs, state.has_sbi, uniforms)
    new_state = StreamState(
        R=R, t=t, velocity=velocity, vel_msd_mag=msd, scene_depth_mean=depth,
        sbi_last=sbi_ops.SBI(template=template, jacs=jacs),
        has_sbi=torch.ones_like(state.has_sbi),
    )
    return new_state, StreamOutputs(*outs)


def replicated_step_fn(mesh, config: SLAMConfig):
    """stream_step with the stream axis sharded over `mesh` and the map and
    camera replicated. Returns step(imgs, state, slam_map, cam, uniforms)
    taking the global [S, ...] batch (S a multiple of the mesh size, as in
    the JAX package): each rank steps its S/D streams, and the new state and
    outputs of all S streams come back on every rank."""

    def step(imgs, state: StreamState, slam_map: SLAMMap,
             cam: cam_ops.Camera, uniforms):
        rows = mesh_mod.shard_rows(mesh, imgs.shape[0])
        new_state, outputs = stream_step(
            imgs[rows], state._map(lambda x: x[rows]), slam_map, cam,
            uniforms[rows], config)
        return (mesh_mod.gather_tree(mesh, new_state, site="streams"),
                mesh_mod.gather_tree(mesh, outputs, site="streams"))

    return step
