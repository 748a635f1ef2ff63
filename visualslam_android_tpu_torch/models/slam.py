"""The SLAM system facade: the per-frame entry point, the bootstrap state
machine, the mapping-stage scheduler and relocalization.

Port of the JAX package's ``models/slam.py`` (the reference's engine facade
SystemPTAM, jni/jni_part.cpp:16-75; the tracker's frame loop and
initialisation flow, jni/Tracker.cc:76-346; the MapMaker priority loop,
jni/MapMaker.cc:80-123, which runs here as one scheduled unit of mapping
work after each tracked frame).

Each tracked frame runs ``frame_step`` (front-end, SBI prior, motion
model, TrackMap, quality and bad-point handling), then one mapping task
chosen by the scheduler from host state only (the keyframe queue, the
bundle adjustments' convergence, mirrors of the device's queue flags from
the last stats read), then its packed stats vector is read once and every
host decision is made on it. A bundle adjustment's convergence and map
health stay on the device and ride the next frame's stats vector. Besides
that read, the per-frame path reads the device in bundle_adjust (once per
LM iteration) and once on a frame that tries to relocalize;
``SLAMSystem.host_reads`` counts the facade's own reads.

Two modes, as in the JAX package:

- sync (``pipelined=False``, the default): ``track_frame`` reads the
  frame's stats before it returns, and returns that frame's result;
- pipelined (``pipelined=True, pipeline_depth=d``): the stats go to the
  host as a stream-ordered copy into pinned memory, started when the frame
  is dispatched and marked by a CUDA event (a plain copy on the CPU), and
  are read ``d`` frames later, so the host enqueues the next frames while
  a frame's stats are in flight. ``track_frame`` returns the oldest result
  ready; ``FrameResult.frame_id`` says which frame it belongs to, the
  first calls after the bootstrap return placeholders
  (``valid=False``), and ``flush()`` returns the frames still in flight.
  At depth 1 the results are those of sync mode bit for bit, one frame
  late. At depth d >= 2 the host's decisions (lost counting, keyframe
  adds, bundle-adjustment convergence, tier-3 resets) trail by d frames,
  so the outcome differs from sync mode. In-flight frames are resolved
  before relocalization and before a reset is serviced.

No result carries a non-finite pose: a frame that tracked against a
non-finite map returns, and restores on the device, the newest finite
pose the host has read (at depth >= 2 the frame dispatched before it may
itself be non-finite, so the pose a frame started from is no fallback).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from visualslam_android_tpu_torch import native_runtime
from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models import bootstrap
from visualslam_android_tpu_torch.models import bundle as bundle_mod
from visualslam_android_tpu_torch.models import frame_step as fstep
from visualslam_android_tpu_torch.models import map_store, relocalizer
from visualslam_android_tpu_torch.models import step_graph
from visualslam_android_tpu_torch.models import tracker as tracker_mod
from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.utils import profiling
from visualslam_android_tpu_torch.utils.tensors import default_device

# Bootstrap phases (TrackForInitialMap states, Tracker.cc:218-261).
PHASE_NOT_STARTED = 0
PHASE_TRAILS = 1
PHASE_TRACKING = 2


@dataclasses.dataclass
class FrameResult:
    """Per-frame output of :meth:`SLAMSystem.track_frame`.

    ``valid`` is False only for the pipelined warm-up placeholder (the
    first tracked frames' results are still in flight; they arrive at the
    next calls or through ``flush()``). A placeholder carries
    ``frame_id=-1`` and the identity pose: consumers skip it when they
    count tracked frames or collect a trajectory."""

    pose_R: np.ndarray
    pose_t: np.ndarray
    quality: int
    n_found: int
    n_points: int
    n_keyframes: int
    phase: int
    lost: bool
    did_coarse: bool
    added_keyframe: bool
    message: str
    frame_id: int = -1  # which track_frame call this result belongs to
    valid: bool = True  # False: warm-up placeholder, not a real frame


class SLAMSystem:
    """Create once, call `track_frame(gray_f32_image)` per frame and
    `on_touch()` for the two bootstrap presses (SystemPTAM semantics,
    jni/jni_part.cpp:49-71). Runs on `device`, the CUDA card when None; on
    a machine without one it raises unless device="cpu" is passed. One
    torch.Generator seeded from `seed` on that device makes every random
    draw (MLESAC, the plane RANSAC, track_map's point selections).

    pipelined=False (default): track_frame returns this frame's result.
    pipelined=True: track_frame returns the result of the frame
    pipeline_depth calls back (a placeholder while there is none) and
    makes no blocking read on a steady-state frame; call flush() after the
    last frame for the rest."""

    def __init__(self, config: Optional[SLAMConfig] = None, seed: int = 0,
                 pipelined: bool = False, pipeline_depth: int = 1,
                 device=None):
        """pipeline_depth (pipelined mode only): how many frames may be in
        flight before track_frame waits for the oldest one's stats. Depth 1
        gives sync mode's results bit for bit, one frame late; at depth d
        the host's decisions trail by d frames (the reference's
        tracker/mapmaker thread pair tolerates the same kind of lag through
        its racing flags, MapMaker.h:114-118; d bounds it here)."""
        self.config = config or SLAMConfig()
        self.device = default_device(device)
        self.pipelined = pipelined
        self.pipeline_depth = max(1, int(pipeline_depth))
        tc = self.config.tracker
        self.cam = cam_ops.make_camera(self.config.camera.params(), tc.width,
                                       tc.height, device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._pending_zero = torch.zeros(2, device=self.device)
        # Device-to-host reads made by the facade itself, by kind: "stats"
        # (one per tracked frame), "reloc" (one per relocalization
        # attempt), "pending" (a deferred bundle-adjustment result resolved
        # without a frame to carry it), "bootstrap" (trail counts and the
        # new map's pose on bootstrap frames), "solver" (the band check of
        # _solver_choice). bundle.HOST_READS counts the bundle adjustment's
        # own.
        self.host_reads = {"stats": 0, "reloc": 0, "pending": 0,
                           "bootstrap": 0, "solver": 0}
        # The tracking step's cache (models/step_graph.py): captured CUDA
        # graphs replayed from static buffers on the card, reused buffers
        # on the CPU. Its counts: "captures", "replays", "eager" (steps run
        # outside a graph: all on the CPU, the warm-ups on the card). It
        # outlives reset(): the shapes stay those of the configuration.
        self._step_graphs = step_graph.StepGraphs()
        self.step_graph_counts = self._step_graphs.counts
        # Wall-clock stage timer, off by default (run_slam --profile).
        self.timer = profiling.StageTimer(enabled=False)
        # Results not yet handed to the caller (pipelined mode can make two
        # in one call around lost, bootstrap and reset edges). Survives
        # reset() so that no result is dropped.
        self._result_backlog: List[FrameResult] = []
        # Pipelined mode: a ring of pipeline_depth + 1 host buffers for the
        # stats copies (pinned on the card, so the copy is asynchronous),
        # each with the CUDA event that marks its copy done.
        self._stats_ring = []
        if pipelined:
            cuda = self.device.type == "cuda"
            self._stats_ring = [
                (torch.empty(fstep.STATS_LEN, pin_memory=cuda),
                 torch.cuda.Event() if cuda else None)
                for _ in range(self.pipeline_depth + 1)]
        self._ring_next = 0
        self.reset()

    def _read(self, x, kind):
        """A blocking read of x into a numpy array, counted by kind (the
        pipelined stats copy is counted in _read_stats). A copy: on the CPU
        x may be a step output, which the next step overwrites."""
        self.host_reads[kind] += 1
        return x.cpu().numpy().copy()

    # ---- control -----------------------------------------------------

    def reset(self):
        """Tracker::Reset + MapMaker::Reset (Tracker.cc:45-70,
        MapMaker.cc:60-74)."""
        cfg, dev = self.config, self.device
        self.slam_map = map_store.empty_map(cfg, device=dev)
        self.phase = PHASE_NOT_STARTED
        self.R = torch.eye(3, device=dev)
        self.t = torch.zeros(3, device=dev)
        self.velocity = torch.zeros(6, device=dev)
        self._msd = torch.zeros((), device=dev)       # scene-depth-scaled |v|
        self._depth = torch.ones((), device=dev)      # scene depth mean
        self._wiggle_dev = torch.ones((), device=dev)  # wiggle_depth_norm
        self.vel_mag = 0.0                   # host mirrors
        self.scene_depth_mean = 1.0
        self.wiggle_depth_norm = 1.0
        self._pose_host = (np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))
        self.sbi_last = None
        self.lost_frames = 0
        self.just_recovered = False
        self.frame_idx = 0
        self.last_kf_frame = -100
        self.pressed = False
        self._trails: Optional[bootstrap.TrailState] = None
        self._trail_count = 0
        self._prev_frame = None
        # Mapping-stage state (device) and host mirrors of its queue flags,
        # refreshed at each stats read (one frame stale in sync mode,
        # pipeline_depth frames in pipelined mode).
        N = cfg.tracker.max_map_points
        K = cfg.mapmaker.max_keyframes
        self.never_retry = torch.zeros(N, K, dtype=torch.bool, device=dev)
        self.failure_mask = torch.zeros(N, K, dtype=torch.bool, device=dev)
        self.new_points = torch.zeros(N, dtype=torch.bool, device=dev)
        self._any_failure_host = False
        self._any_new_host = False
        self.kf_queue: List[dict] = []
        self.recent_converged = True
        self.full_converged = True
        self.reset_requested = False
        self._mm_rng = np.random.default_rng(1234)
        # Deferred bundle-adjustment result (kind, converged, map_ok), the
        # two flags on the device: they ride the next frame_step's
        # `pending` input and are resolved at that frame's stats read.
        self._pending_ba = None
        # Pipelined mode's in-flight frames, oldest first (at most
        # pipeline_depth; empty between calls in sync mode).
        self._ctxs: List[dict] = []
        # Keyframes are never deleted and slots fill in order, so the host
        # knows the count without reading the device.
        self._kf_count_host = 0
        self._newest_kf_host = -1
        self._n_points_host = 0
        # (keyframe count, (assembly, solver)) of the last band check.
        self._band_choice = None

    def on_touch(self):
        """Touch = PTAM spacebar (jni_part.cpp:49-51)."""
        self.pressed = True

    # ---- per-frame ---------------------------------------------------

    def _drain_ctxs(self):
        """Resolve every in-flight frame, oldest first, into the result
        backlog: before any path that needs the host's decision state
        current (servicing a reset, relocalization, flush)."""
        while self._ctxs:
            self._result_backlog.append(self._process_ctx())

    def track_frame(self, img) -> FrameResult:
        """TrackFrame (Tracker.cc:76-146) on a grey [H, W] image (numpy or
        tensor, values in [0, 255]); returns this frame's result in sync
        mode, the oldest ready one in pipelined mode."""
        # Pipelined mode: resolve in-flight frames down to depth - 1; their
        # decisions (keyframe add, quality and lost count, BA convergence)
        # feed this frame's scheduling.
        while len(self._ctxs) >= self.pipeline_depth:
            self._result_backlog.append(self._process_ctx())
        # Tier-3 recovery (MapMaker.cc:906-915): a bundle adjustment that
        # left a non-finite map requested a full reset. Frames still in
        # flight tracked against that map; they resolve first.
        if self.reset_requested:
            self._drain_ctxs()
            self.reset()
        img = torch.as_tensor(img).to(self.device, torch.float32)
        fid = self.frame_idx
        self.frame_idx += 1
        if self.phase == PHASE_TRACKING:
            res = self._tracking_frame(img, fid)
        else:
            res = self._bootstrap_frame(img, fid)
        if res is not None:
            self._result_backlog.append(res)
        if self._result_backlog:
            return self._result_backlog.pop(0)
        # Warm-up edge: the first tracked frames' results are in flight.
        return FrameResult(
            pose_R=np.eye(3, dtype=np.float32),
            pose_t=np.zeros(3, np.float32),
            quality=tracker_mod.QUALITY_GOOD, n_found=0,
            n_points=self._n_points_host, n_keyframes=self._kf_count_host,
            phase=self.phase, lost=False, did_coarse=False,
            added_keyframe=False,
            message="(pipelined warm-up: result pending)",
            frame_id=-1, valid=False,
        )

    def flush(self) -> List[FrameResult]:
        """Every result not yet delivered (pipelined mode: the frames in
        flight and the backlog; sync mode: none)."""
        if self._ctxs:
            self._drain_ctxs()
            if self.reset_requested:
                self.reset()
        out, self._result_backlog = self._result_backlog, []
        return out

    # ---- bootstrap frames ---------------------------------------------

    def _bootstrap_frame(self, img, fid) -> FrameResult:
        with self.timer.stage("frontend"):
            frame, sbi_cur = fstep.bootstrap_frontend(img, self.config)
            self.timer.sync(frame, sbi_cur)
        with self.timer.stage("bootstrap"):
            self._bootstrap(frame)
        self.sbi_last = sbi_cur
        self._prev_frame = frame
        if self.reset_requested:
            self.reset()
        n_found = self._trail_count
        message = {
            PHASE_NOT_STARTED: "Touch to start map initialization",
            PHASE_TRAILS: f"Trail tracking: {n_found} trails; "
                          "touch again to build map",
            PHASE_TRACKING: "Map built",
        }[self.phase]
        return FrameResult(
            pose_R=self._pose_host[0].copy(),
            pose_t=self._pose_host[1].copy(),
            quality=tracker_mod.QUALITY_GOOD, n_found=n_found,
            n_points=self._n_points_host, n_keyframes=self._kf_count_host,
            phase=self.phase, lost=False, did_coarse=False,
            added_keyframe=False, message=message, frame_id=fid,
        )

    # ---- normal tracking ----------------------------------------------

    def _tracking_frame(self, img, fid) -> Optional[FrameResult]:
        """The tracking step and one mapping task; after max_lost_frames
        BAD frames, relocalization first (Tracker.cc:133-175). Returns the
        result in sync mode, None when the frame is left in flight."""
        cfg = self.config
        lost = self.lost_frames >= cfg.tracker.max_lost_frames

        use_prior, forced_coarse, recovered = True, False, False
        if lost:
            # Relocalization reads and writes the host's decision state:
            # resolve the frames in flight first, so that its inputs are
            # current and the results stay in order.
            self._drain_ctxs()
            with self.timer.stage("reloc"):
                frame, sbi_cur = fstep.bootstrap_frontend(img, cfg)
                res = relocalizer.attempt_recovery(
                    self.slam_map, sbi_cur.template, self.cam,
                    cfg.mapmaker.reloc_max_score,
                )
                got = self._read(torch.cat([
                    res.success.to(torch.float32)[None], res.R.reshape(-1),
                    res.t]), "reloc")
            if not got[0] > 0.5:
                # No frame_step carries a deferred bundle-adjustment result
                # on this path: resolve it now, before the mapping task can
                # dispatch another over it (a non-finite map then requests
                # the reset).
                self._resolve_pending_sync()
                self.sbi_last = sbi_cur
                self._prev_frame = frame
                with self.timer.stage("mapmaker"):
                    self._mapmaker_step()
                    self.timer.sync(self.slam_map)
                return self._lost_result(fid)
            # Tracker.cc:163-174: adopt the recovered pose, zero the motion
            # model, force the coarse stage.
            self.R, self.t = res.R, res.t
            self._pose_host = (got[1:10].reshape(3, 3), got[10:13])
            self.velocity = torch.zeros(6, device=self.device)
            use_prior, forced_coarse, recovered = False, True, True
        elif self.just_recovered:
            forced_coarse = True  # one more forced-coarse frame
        self.just_recovered = False

        pend = self._pending_ba
        if pend is not None:
            pending_vec = torch.stack([pend[1].to(torch.float32),
                                       pend[2].to(torch.float32)])
            pending_kind = pend[0]
            self._pending_ba = None
        else:
            pending_vec, pending_kind = self._pending_zero, None

        with self.timer.stage("frame_step"):
            out = fstep.frame_step(
                img, self.slam_map, self.cam, self.R, self.t, self.velocity,
                self._msd, self._depth, self._wiggle_dev, self.sbi_last,
                self.new_points, self.failure_mask, pending_vec, cfg,
                use_prior=use_prior, forced_coarse=forced_coarse,
                generator=self.generator, graphs=self._step_graphs,
            )
            self.timer.sync(out.stats)
        # The step's state comes back in the buffers its next step reads;
        # its other outputs last until the next step, so what outlives that
        # is copied (_keep). _prev_frame always names the newest frame, so
        # it needs no copy.
        ctx = dict(
            stats=out.stats, img=img, frame=out.frame, found=out.found,
            found_pos=out.found_pos, search_level=out.search_level,
            did_subpix=out.did_subpix, R=out.R, t=out.t,
            pending_kind=pending_kind, recovered=recovered, fid=fid,
        )
        if self.pipelined and self.pipeline_depth > 1:
            self._keep(ctx)  # resolved after later steps
        self.slam_map = out.slam_map
        self.R, self.t, self.velocity = out.R, out.t, out.velocity
        self._msd, self._depth = out.msd, out.depth
        self.sbi_last = out.sbi
        self.new_points = out.new_points
        self._prev_frame = out.frame
        if recovered:
            self.just_recovered = True  # force coarse next frame too

        with self.timer.stage("mapmaker"):
            self._mapmaker_step()
            self.timer.sync(self.slam_map)
        self._ctxs.append(ctx)
        if not self.pipelined:
            return self._process_ctx()
        # Start the stats copy now, behind the work already enqueued; the
        # host reads it pipeline_depth frames later.
        buf, done = self._stats_ring[self._ring_next]
        self._ring_next = (self._ring_next + 1) % len(self._stats_ring)
        buf.copy_(out.stats, non_blocking=done is not None)
        if done is not None:
            done.record(torch.cuda.current_stream(self.device))
        ctx["stats_copy"] = (buf, done)
        return None

    @staticmethod
    def _keep(ctx):
        """Replace the step outputs in `ctx` that the keyframe queue takes
        by copies of their own (the next step overwrites the step's). Level
        0 of the frame's pyramid is the image the step was handed, bit for
        bit, so that image stands for it."""
        if ctx.get("kept"):
            return
        frame = ctx["frame"]
        ctx["frame"] = map_store.FrameData(
            pyramid=(ctx["img"],) + tuple(p.clone()
                                          for p in frame.pyramid[1:]),
            corner_mask=tuple(m.clone() for m in frame.corner_mask),
            corner_score=tuple(s.clone() for s in frame.corner_score))
        for key in ("found", "found_pos", "search_level", "did_subpix", "R",
                    "t"):
            ctx[key] = ctx[key].clone()
        ctx["kept"] = True

    def _resolve_pending_sync(self):
        """Resolve a deferred bundle-adjustment result with a read of its
        own (the lost frame, and a new dispatch over an unresolved one), so
        that neither a convergence update nor a reset request is lost."""
        if self._pending_ba is None:
            return
        kind, conv, okd = self._pending_ba
        self._pending_ba = None
        got = self._read(torch.stack([conv.to(torch.float32),
                                      okd.to(torch.float32)]), "pending")
        self._resolve_pending(kind, bool(got[0] > 0.5), bool(got[1] > 0.5))

    def _resolve_pending(self, kind: str, conv: bool, ok: bool):
        """A non-finite map requests a reset (the reference's negative
        Bundle::Compute return, MapMaker.cc:906-915); convergence drives the
        scheduler's bundle-adjustment rungs."""
        if not ok:
            self.reset_requested = True
        elif kind == "recent":
            self.recent_converged = conv
            if not conv:
                self.full_converged = False
        else:  # "full"
            self.full_converged = conv
            if conv:
                self.recent_converged = True

    def _read_stats(self, ctx):
        """The frame's packed stats on the host: a blocking read in sync
        mode; in pipelined mode a wait on the event of the copy started at
        dispatch, then the pinned buffer (copied out: it is reused)."""
        copy = ctx.get("stats_copy")
        if copy is None:
            return self._read(ctx["stats"], "stats")
        buf, done = copy
        if done is not None:
            done.synchronize()
        self.host_reads["stats"] += 1
        return buf.numpy().copy()

    def _process_ctx(self) -> FrameResult:
        """Read the oldest in-flight frame's packed stats (its one read) and
        make every host decision on it."""
        ctx = self._ctxs.pop(0)
        cfg = self.config
        tc = cfg.tracker
        S = fstep
        with self.timer.stage("stats_pull"):
            stats = self._read_stats(ctx)
        finite = bool(np.isfinite(stats).all())

        if finite:
            quality = int(stats[S.STAT_QUALITY])
            pose_R = stats[S.STAT_POSE_R:S.STAT_POSE_R + 9].reshape(3, 3)
            pose_t = stats[S.STAT_POSE_T:S.STAT_POSE_T + 3].copy()
            self._pose_host = (pose_R.copy(), pose_t.copy())
            self.vel_mag = float(stats[S.STAT_VEL_MAG])
            self.scene_depth_mean = float(stats[S.STAT_DEPTH])
            self._n_points_host = int(stats[S.STAT_N_POINTS])
            self._any_failure_host = bool(stats[S.STAT_ANY_FAILURE] > 0.5)
            self._any_new_host = bool(stats[S.STAT_ANY_NEW] > 0.5)
            n_found = int(stats[S.STAT_N_FOUND])
            n_points = int(stats[S.STAT_N_POINTS])
            n_keyframes = int(stats[S.STAT_N_KEYFRAMES])
            did_coarse = bool(stats[S.STAT_DID_COARSE] > 0.5)
            found_l = [int(x) for x in
                       stats[S.STAT_FOUND_L0:S.STAT_FOUND_L0 + S.N_LEVELS]]
        else:
            # This frame tracked against a non-finite map (a corrupting
            # bundle adjustment, detected at this same read): demote it to
            # BAD and go back to the newest finite pose read. In sync mode
            # and at depth 1 that is the pose the frame started from, bit
            # for bit; deeper, the frame dispatched before this one may be
            # non-finite too, so the device's pose before this frame is no
            # fallback (the JAX package restores it and can return NaN).
            quality = tracker_mod.QUALITY_BAD
            pose_R, pose_t = (p.copy() for p in self._pose_host)
            self.R = torch.tensor(pose_R, device=self.device)
            self.t = torch.tensor(pose_t, device=self.device)
            self.velocity = torch.zeros(6, device=self.device)
            self._msd = torch.zeros((), device=self.device)
            self._depth = torch.ones((), device=self.device)
            self.vel_mag = 0.0
            self.scene_depth_mean = 1.0
            n_found, did_coarse = 0, False
            n_points = self._n_points_host
            n_keyframes = self._kf_count_host
            found_l = [0] * S.N_LEVELS

        if ctx["pending_kind"] is not None:
            self._resolve_pending(
                ctx["pending_kind"],
                finite and stats[S.STAT_PENDING_CONV] > 0.5,
                finite and stats[S.STAT_PENDING_OK] > 0.5,
            )

        # Distance-to-map sanity demotion (Tracker.cc:867-872).
        if (quality == tracker_mod.QUALITY_DODGY and finite
                and stats[S.STAT_DIST_EXCESSIVE] > 0.5):
            quality = tracker_mod.QUALITY_BAD
        if quality == tracker_mod.QUALITY_BAD:
            self.lost_frames += 1
        else:
            self.lost_frames = 0

        # Keyframe-add heuristic (Tracker.cc:127-132): the queue entry is
        # consumed by later frames' mapping tasks.
        added = False
        if (quality == tracker_mod.QUALITY_GOOD
                and ctx["fid"] - self.last_kf_frame > tc.min_frames_between_kfs
                and len(self.kf_queue) < tc.max_kf_queue
                and finite and stats[S.STAT_NEED_KF] > 0.5):
            self._keep(ctx)
            self.kf_queue.append(dict(
                frame=ctx["frame"], R=ctx["R"], t=ctx["t"],
                found=ctx["found"], found_pos=ctx["found_pos"],
                level=ctx["search_level"], subpix=ctx["did_subpix"],
            ))
            self.last_kf_frame = ctx["fid"]
            added = True

        message = (
            f"Tracking Map, quality {['BAD', 'DODGY', 'GOOD'][quality]}. "
            f"Found: {found_l} Map: {n_points}P, {n_keyframes}KF"
            + (" Adding key-frame." if added else "")
        )
        if ctx["recovered"]:
            message = "Relocalized. " + message
        return FrameResult(
            pose_R=pose_R, pose_t=pose_t, quality=quality, n_found=n_found,
            n_points=n_points, n_keyframes=n_keyframes, phase=self.phase,
            lost=self.lost_frames >= tc.max_lost_frames,
            did_coarse=did_coarse, added_keyframe=added, message=message,
            frame_id=ctx["fid"],
        )

    def _lost_result(self, fid) -> FrameResult:
        return FrameResult(
            pose_R=self._pose_host[0].copy(),
            pose_t=self._pose_host[1].copy(),
            quality=tracker_mod.QUALITY_BAD, n_found=0,
            n_points=self._n_points_host, n_keyframes=self._kf_count_host,
            phase=self.phase, lost=True, did_coarse=False,
            added_keyframe=False,
            message="Lost; attempting relocalization", frame_id=fid,
        )

    # ---- bootstrap (TrackForInitialMap) ------------------------------

    def _bootstrap(self, frame):
        cfg = self.config
        if self.phase == PHASE_NOT_STARTED:
            if self.pressed:
                self.pressed = False
                # TrailTracking_Start (Tracker.cc:264-291).
                self._trails = bootstrap.trail_start(frame, cfg)
                self._trail_count = int(self._read(self._trails.valid.sum(),
                                              "bootstrap"))
                self.phase = PHASE_TRAILS
            return
        # PHASE_TRAILS: TrailTracking_Advance (Tracker.cc:294-346).
        self._trails, count = bootstrap.trail_advance(
            self._trails, frame, self._prev_frame, cfg)
        self._trail_count = int(self._read(count, "bootstrap"))
        if self._trail_count < cfg.tracker.min_trails_to_continue:
            # Reset init (Tracker.cc:245-248).
            self.phase = PHASE_NOT_STARTED
            self._trails = None
            return
        if self.pressed:
            self.pressed = False
            ok = self._init_from_stereo(frame)
            self.phase = PHASE_TRACKING if ok else PHASE_NOT_STARTED

    def _init_from_stereo(self, frame_second) -> bool:
        """InitFromStereo (MapMaker.cc:204-376), synchronous as in the
        reference: bootstrap.init_from_stereo, then the facade's state."""
        cfg = self.config
        init = bootstrap.init_from_stereo(self._trails, frame_second,
                                          self.cam, cfg,
                                          generator=self.generator,
                                          timer=self.timer)
        if not init.ok:
            # A bundle adjustment that left a non-finite map asks for the
            # full reset, as a deferred one does (MapMaker.cc:906-915).
            if init.reason == bootstrap.NON_FINITE:
                self.reset_requested = True
            return False
        self.slam_map = init.slam_map
        self._kf_count_host = 2
        self._newest_kf_host = 1
        self.never_retry = init.never_retry
        self.failure_mask = init.failure_mask
        self.new_points = init.new_points
        self._depth = init.depth
        self._wiggle_dev = init.wiggle_depth_norm
        self.R, self.t = init.R, init.t
        self.velocity = init.velocity
        self._msd = init.msd
        # The last round's convergence, as the synchronous rounds resolve
        # it (a converged global round also marks the local one converged).
        self.full_converged = init.ba_converged
        self.recent_converged = True
        # frame_idx has already moved past this frame; keyframe gating
        # compares 0-based frame ids (FrameResult.frame_id).
        self.last_kf_frame = self.frame_idx - 1
        got = self._read(torch.cat([init.R.reshape(-1), init.t,
                                    init.depth[None]]), "bootstrap")
        self._pose_host = (got[:9].reshape(3, 3), got[9:12])
        self.scene_depth_mean = float(got[12])
        self.wiggle_depth_norm = cfg.mapmaker.wiggle_scale / max(
            self.scene_depth_mean, 1e-6)
        self._n_points_host = init.n_points
        self._any_new_host = True  # epipolar growth queued new points
        return True

    # ---- mapping stage (MapMaker::run priorities) --------------------

    def _mapmaker_step(self) -> int:
        """One prioritized unit of mapping work (MapMaker.cc:80-123),
        chosen from host state only. HandleBadPoints runs inside every
        frame_step (as in every pass of the reference's run() loop,
        MapMaker.cc:116). Returns the task id."""
        task = self._select_task()
        if task == native_runtime.TASK_ADD_KEYFRAME:
            self._add_keyframe_from_queue()
        elif task == native_runtime.TASK_BA_RECENT:
            self._dispatch_ba("local", max_iters=8)
        elif task == native_runtime.TASK_REFIND_NEWLY:
            (self.slam_map, self.new_points, self.never_retry,
             self.failure_mask) = fstep.refind_newly(
                self.slam_map, self.new_points, self.never_retry,
                self.failure_mask, self.cam, self.config,
                n_kf=self._kf_count_host,
            )
            self._any_new_host = False
        elif task == native_runtime.TASK_BA_ALL:
            self._dispatch_ba("global", max_iters=6)
        elif task == native_runtime.TASK_REFIND_FAILURES:
            (self.slam_map, self.never_retry,
             self.failure_mask) = fstep.refind_failures(
                self.slam_map, self.never_retry, self.failure_mask,
                self.cam, self.config, n_kf=self._kf_count_host,
            )
            self._any_failure_host = False
        return task

    def _select_task(self) -> int:
        return native_runtime.scheduler_next_py(
            len(self.kf_queue), self.recent_converged, self.full_converged,
            self._any_failure_host, self._any_new_host,
            self._mm_rng.integers(20) == 0,
        )

    # Epipolar growth order after a keyframe insertion (MapMaker.cc:499-502).
    _GROW_LEVELS = (3, 0, 1, 2)

    def _add_keyframe_from_queue(self):
        """AddKeyFrameFromTopOfQueue (MapMaker.cc:481-506) over five
        mapping tasks: make-rest + measurement registration + scene depth +
        re-find in the new keyframe, then one AddSomeMapPoints per level
        (3, 0, 1, 2). The scheduler keeps choosing TASK_ADD_KEYFRAME while
        the entry is queued (the reference's queue-first priority)."""
        entry = self.kf_queue[0]
        stage = entry.get("stage", 0)
        if stage == 0:
            slot = self._kf_count_host
            if slot >= self.config.mapmaker.max_keyframes:
                self.kf_queue.pop(0)
                return  # capacity full: dropped
            (self.slam_map, self.new_points, self.never_retry,
             self.failure_mask) = fstep.integrate_keyframe(
                self.slam_map, self.new_points, self.never_retry,
                self.failure_mask, entry["frame"], entry["R"], entry["t"],
                entry["found"], entry["found_pos"], entry["level"],
                entry["subpix"], slot, self.cam, self.config,
            )
            # Only the slot is needed by the four growth tasks.
            entry.clear()
            entry.update(stage=1, slot=slot)
            self._kf_count_host = slot + 1
            self._newest_kf_host = slot
            self.recent_converged = False
            self.full_converged = False
        else:
            self._add_some_map_points(entry["slot"],
                                      self._GROW_LEVELS[stage - 1])
            if stage == len(self._GROW_LEVELS):
                self.kf_queue.pop(0)
            else:
                entry["stage"] = stage + 1

    def _add_some_map_points(self, src_kf: int, level: int):
        """AddSomeMapPoints (MapMaker.cc:427-437); the target keyframe is
        chosen on the device."""
        self.slam_map, self.new_points = fstep.add_map_points_step(
            self.slam_map, self.new_points, self.cam, src_kf, level,
            self.config,
        )
        self._any_new_host = True

    def _solver_choice(self):
        """(assembly, solver) of bundle adjustment: the scatter Schur
        assembly and a dense Cholesky solve while the keyframe slots stay
        within dense_solver_max_cams; above, the block band and band CG when
        every co-observing pair fits band_halfwidth (odometry maps), else
        the matrix-free CG. The band check reads the device once; its
        answer is kept until the keyframe count changes."""
        bc = self.config.bundle
        if self.config.mapmaker.max_keyframes <= bc.dense_solver_max_cams:
            return "scatter", "chol"
        if (self._band_choice is None
                or self._band_choice[0] != self._kf_count_host):
            offset = int(self._read(bundle_mod.pair_offset_tensor(
                self.slam_map.meas.kf, self.slam_map.meas.valid), "solver"))
            choice = (("band", "band_pcg") if offset <= bc.band_halfwidth
                      else ("scatter", "pcg"))
            self._band_choice = (self._kf_count_host, choice)
        return self._band_choice[1]

    def _dispatch_ba(self, mode: str, max_iters: int):
        """BundleAdjustRecent ("local") or BundleAdjustAll ("global")
        (MapMaker.cc:801-851). Its convergence and map-health flags stay on
        the device and ride the next frame_step's `pending` input."""
        cfg = self.config
        if (mode == "local"
                and self._kf_count_host < cfg.mapmaker.local_ba_min_kfs):
            self.recent_converged = True
            return
        assembly, solver = self._solver_choice()
        (self.slam_map, self.failure_mask, self.never_retry, conv,
         okd) = fstep.ba_round(
            self.slam_map, self._newest_kf_host, self.never_retry,
            self.failure_mask, self.cam, cfg, max_iters=max_iters,
            assembly=assembly, solver=solver, mode=mode,
        )
        # Never overwrite an unresolved deferred result: it may carry a
        # reset request.
        self._resolve_pending_sync()
        self._pending_ba = ("recent" if mode == "local" else "full", conv,
                            okd)
