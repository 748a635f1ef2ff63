"""Configuration for the PyTorch port of the SLAM engine.

A field-for-field copy of the JAX package's frozen dataclasses
(``visualslam_android_tpu/config.py``), kept as a separate module because
importing anything under ``visualslam_android_tpu`` runs that package's
``__init__``, which imports jax. Each value carries the reference's
file:line provenance (paths relative to the reference's source tree).

The *capacity* fields (``max_*``) size the fixed-shape tensors of the map
stores: the reference uses dynamically sized std::vectors; the port keeps
padded tensors with validity masks, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """ATAN/FOV (Devernay-Faugeras) camera model parameters.

    Reference: hardcoded calibration in jni/ATANCamera.cc:20-24, normalized
    by image size (jni/ATANCamera.cc:37-129).
    """

    fx: float = 0.841906   # focal / width
    fy: float = 1.10893    # focal / height
    cx: float = 0.505171   # principal point / width
    cy: float = 0.470265   # principal point / height
    w: float = -0.0133843  # FOV distortion parameter omega

    def params(self) -> Tuple[float, float, float, float, float]:
        return (self.fx, self.fy, self.cx, self.cy, self.w)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Per-frame tracking constants (jni/Tracker.cc)."""

    # Frame geometry: jni/jni_part.cpp:41 builds the tracker at 800x480.
    width: int = 800
    height: int = 480
    n_levels: int = 4  # 4-level pyramid, jni/KeyFrame.h / KeyFrame.cc:20-23

    # FAST thresholds per pyramid level: jni/KeyFrame.cc:32-39 (10/15/15/10).
    fast_thresholds: Tuple[int, ...] = (10, 15, 15, 10)

    # Patch search: jni/Tracker.cc:405-416 (coarse), :518-519 (fine).
    max_patches_per_frame: int = 1000   # gvnMaxPatchesPerFrame, Tracker.cc:518
    coarse_min: int = 20                # gvnCoarseMin, Tracker.cc:405
    coarse_max: int = 60                # gvnCoarseMax, Tracker.cc:406
    coarse_range: int = 30              # gvnCoarseRange, Tracker.cc:407
    coarse_sub_pix_its: int = 8         # gvnCoarseSubPixIts, Tracker.cc:408
    disable_coarse: bool = False        # gvnCoarseDisabled, Tracker.cc:409
    coarse_min_velocity: float = 0.006  # gvdCoarseMinVel, Tracker.cc:410
    fine_range_top: int = 10            # fine stage range, Tracker.cc:504
    fine_range_rest: int = 5            # Tracker.cc:531 (via "rest" search)
    pose_update_iters: int = 10         # Tracker.cc:543
    pose_prior: float = 100.0           # WLS prior, Tracker.cc:697
    # Extension (no reference equivalent): the reference only refines
    # top-level points to subpixel in the fine stage (Tracker.cc:507) —
    # a CPU-budget compromise that leaves most measurements quantized to
    # integer corners. Batched subpixel for every point is cheap on an
    # accelerator and improves pose accuracy ~5x; set False for reference
    # parity.
    subpix_all_levels: bool = True

    # Motion model: decaying velocity, jni/Tracker.cc:802-820.
    motion_decay: float = 0.9

    # Tracking-quality thresholds: jni/Tracker.cc:832-878.
    quality_good: float = 0.3           # gvdQualityGood
    quality_lost: float = 0.13          # gvdQualityLost
    max_lost_frames: int = 3            # reloc after 3 bad frames, Tracker.cc:104

    # Keyframe-add heuristic: jni/Tracker.cc:127-132.
    min_frames_between_kfs: int = 20
    max_kf_queue: int = 3

    # Init-phase trail tracking: jni/Tracker.cc:226-227,245-248,277-289.
    max_trails: int = 1000
    trail_search_range: int = 10        # MiniPatch::mnRange default, MiniPatch.cc:87
    trail_max_ssd: int = 100000         # tracker override, Tracker.cc:226-227
    min_trails_to_continue: int = 10    # reset if fewer, Tracker.cc:245-248

    # SBI (SmallBlurryImage): blur 0.75 in tracker (Tracker.cc:87-97),
    # ESM iterations 6 (Tracker.cc:885-893 / SmallBlurryImage usage).
    sbi_blur: float = 0.75
    sbi_esm_iters: int = 6

    # --- Capacities (fixed shapes; no reference equivalent) ---
    max_corners_per_level: Tuple[int, ...] = (4096, 2048, 1024, 512)
    max_map_points: int = 4096

    @property
    def pyramid_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(
            (self.height >> l, self.width >> l) for l in range(self.n_levels)
        )


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Patch matching constants (jni/PatchFinder.*, jni/MiniPatch.*)."""

    half_patch_size: int = 5       # PatchFinder 11x11 default, PatchFinder.h:48
    mini_half_patch: int = 4       # MiniPatch 9x9, MiniPatch.cc:86
    max_ssd_per_pixel: int = 500   # PatchFinder.cc:19-20 (maxSSD = 500*N^2)
    subpix_converged: float = 0.03  # PatchFinder.cc:272-285
    subpix_max_iters: int = 10     # MapMaker.cc:303,642 (refind uses 8, :1022)
    # Search-level selection: det in [0.25, 3) per level, PatchFinder.cc:56-63.
    warp_det_lo: float = 0.25
    warp_det_hi: float = 3.0
    # NOTE deliberately absent knobs (present in the reference, no analog
    # here): the template warp-change cache + refresh limit 0.07
    # (PatchFinder.cc:92-106) — this build always regenerates warped
    # templates, which is one batched gather (ops/match.py "warped
    # template" docs); and MiniPatch's default
    # maxSSD 9999 (MiniPatch.cc:88) — the only MiniPatch consumer (trail
    # tracking) overrides it to 100000 (Tracker.cc:226-227), exposed as
    # TrackerConfig.trail_max_ssd.


@dataclasses.dataclass(frozen=True)
class BundleConfig:
    """Bundle adjustment constants (jni/Bundle.cc)."""

    max_iters: int = 20            # gvnMaxIterations, Bundle.cc:65
    update_convergence: float = 1e-6  # gvdUpdateConvergenceLimit, Bundle.cc:66
    min_tukey_sigma: float = 0.4   # Bundle.cc:224
    lambda_init: float = 1e-4      # mdLambda initial (Bundle ctor)
    lambda_factor_init: float = 2.0  # mdLambdaFactor (Bundle ctor)
    lambda_good: float = 0.3       # accepted step: lambda *= 0.3 (Bundle.cc:609-617)
    # (No separate outlier threshold: a measurement is ejected exactly when
    # its Tukey weight hits zero or z <= 0, matching Bundle.cc:516-531.)
    # Capacities.
    max_obs_per_point: int = 16
    point_block: int = 1024        # points per Schur-assembly chunk
    # Scale strategy: above this many camera slots, switch from one-hot
    # Schur assembly + dense Cholesky to scatter assembly + matrix-free
    # block-Jacobi PCG (KITTI-scale global BA; SURVEY.md §7).
    dense_solver_max_cams: int = 64
    cg_iters: int = 250
    cg_tol: float = 1e-6
    # Block-band Schur assembly (assembly="band"): used when every
    # co-observing camera pair is within this index offset — odometry
    # maps — cutting the sharded-BA collective payload by ~K/(2P+1).
    band_halfwidth: int = 16


@dataclasses.dataclass(frozen=True)
class MapMakerConfig:
    """Map construction constants (jni/MapMaker.cc, jni/HomographyInit.cc)."""

    wiggle_scale: float = 0.1      # mgvdWiggleScale, MapMaker.cc:57
    # MLESAC homography: 300 trials of 4-pt DLT, HomographyInit.cc:216-262.
    mlesac_trials: int = 300
    max_pixel_error: float = 5.0   # dMaxPixelError, MapMaker.cc:234
    homography_refine_iters: int = 5   # HomographyInit.cc:133-214
    # Candidate thinning: 10px exclusion, MapMaker.cc:393-422.
    thin_candidates_radius: int = 10
    # Shi-Tomasi candidate threshold and border: KeyFrame.cc:57,65.
    shi_tomasi_threshold: float = 70.0
    candidate_border: int = 10
    # Epipolar depth-range clamping: mean +/- sigma in
    # [wiggle, 40*wiggle], MapMaker.cc:552-568.
    epipolar_depth_max_factor: float = 40.0
    # Outlier handling: MapMaker.cc:140-164.
    max_outliers: int = 20
    # Plane-alignment RANSAC: 100 trials, inlier 0.05, MapMaker.cc:1104-1231.
    plane_ransac_trials: int = 100
    plane_inlier_threshold: float = 0.05
    # Keyframe distance heuristic: 10x wiggle, MapMaker.cc:1098-1101.
    kf_distance_factor: float = 10.0
    # NeedNewKeyFrame: closest-KF distance (normalized by scene depth)
    # must exceed this multiple of the wiggle depth norm — the port's
    # "dDistance > 0.2*mdWiggleScaleDepthNormalized" (MapMaker.cc:763-773).
    max_kf_dist_mult: float = 0.2
    # Local BA: newest KF + 4 nearest (skip if map < 8 KFs), MapMaker.cc:801-851.
    local_ba_neighbors: int = 4
    local_ba_min_kfs: int = 8
    # Relocalizer accept threshold (Relocaliser.cc:37).
    reloc_max_score: float = 9e6
    # Capacities.
    max_keyframes: int = 64
    max_epi_candidates: int = 256
    # Budget of (point, keyframe) pairs one re-find dispatch processes;
    # leftovers stay queued for the next mapping slot. Sized so one task
    # costs about one tracking frame's patch search (the reference's
    # analog is its mapmaker thread naturally timeslicing against the
    # tracker core, MapMaker.cc:80-123).
    refind_pair_budget: int = 4096


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    patch: PatchConfig = dataclasses.field(default_factory=PatchConfig)
    bundle: BundleConfig = dataclasses.field(default_factory=BundleConfig)
    mapmaker: MapMakerConfig = dataclasses.field(default_factory=MapMakerConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SLAMConfig":
        d = json.loads(s)
        return cls(
            camera=CameraConfig(**d.get("camera", {})),
            tracker=_with_tuples(TrackerConfig, d.get("tracker", {})),
            patch=PatchConfig(**d.get("patch", {})),
            bundle=BundleConfig(**d.get("bundle", {})),
            mapmaker=MapMakerConfig(**d.get("mapmaker", {})),
        )

    def replace(self, **sections) -> "SLAMConfig":
        return dataclasses.replace(self, **sections)


def _with_tuples(cls, d):
    d = dict(d)
    for f in dataclasses.fields(cls):
        if f.name in d and isinstance(d[f.name], list):
            d[f.name] = tuple(d[f.name])
    return cls(**d)
