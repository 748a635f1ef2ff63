"""The port's multi-device paths against the JAX package's, on the CPU.

The port's ranks are gloo processes on the CPU (parallel/mesh.run_ranks
with device="cpu", backend="gloo", transport="host"); the JAX package's
shard_map runs on the first D of the 8 virtual CPU devices that
tests/conftest.py makes. Each world size (D = 2 and D = 4) starts its
ranks once, in a background thread while the JAX references compute,
and runs every case inside them (parallel/rank_programs.run_cases).

Inputs, the same numpy arrays to both packages:

- bundle adjustment: tests/test_bundle.py's _make_problem (4 cameras, 120
  points, seed 42; the default, pcg and band_pcg + hist paths) and
  _make_trajectory_problem (128 cameras, 10 points each, seed 42; the
  halo path against the psum band_pcg one);
- mapping: tests/test_mapmaker.py's two_kf_map recipe (the fixed map of
  seed 31 at 320x240 and keyframe 1 rendered at a translated pose, the
  epipolar depth cap widened to 100), built by the port: the JAX
  fixture's eager build takes ~30 s on the CPU;
- tracking: tests/test_torch_streams.py's streams (the 128x96 fixed map
  of seed 5, each stream on its own path), S = 4, 3 frames, built by the
  port, with the JAX keys' draws passed as uniforms.

Tolerances are the JAX package's own tests': the default (scatter +
chol) and pcg paths by the rms criterion and poses within 5e-3,
band_pcg + hist poses 1e-4 and points 1e-3, the halo path against the
port's psum band_pcg run by accepted steps, against it and the JAX
package's halo and psum band_pcg runs by rms within 5%, and against the
port's psum and the JAX halo runs by poses within 5e-3 of the
trajectory's length; re-find and the epipolar search found /
success sets and measurement masks equal, uv 1e-4, pos_w and target_uv
1e-3; tracking n_found and quality equal, R and t 1e-4; the histogram
sigma rtol 1e-6; the halo reduction against the plain sum 1e-5. The pure
functions (padding, camera-block packing, the payload model, the band's
lower half) are exact. The payload audit counts one LM step's collectives
at D = 2 against comm_bytes_per_lm_step item by item; pcg's CG loop
issues its iterations in chunks of bundle.CG_CHUNK, so the model gets the
iterations issued (a multiple of the chunk, at most cg_iters), and the
port's scalar sums are port_scalar_bytes' named ones.
"""

import dataclasses
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.models import bundle as jb
from visualslam_android_tpu.models import map_store as jms
from visualslam_android_tpu.models import mapmaker as jmm
from visualslam_android_tpu.ops import camera as jcam_ops
from visualslam_android_tpu.ops import mestimator as jme
from visualslam_android_tpu.parallel import replicated_tracking as jrt
from visualslam_android_tpu.parallel import sharded_ba as jsba
from visualslam_android_tpu.parallel import sharded_mapping as jsm
from visualslam_android_tpu.utils import fixtures as jfix
from visualslam_android_tpu_torch.models import bundle as tb
from visualslam_android_tpu_torch.models import keyframe as tkf
from visualslam_android_tpu_torch.models import mapmaker as tmm
from visualslam_android_tpu_torch.ops import lie as tlie
from visualslam_android_tpu_torch.ops import mestimator as tme
from visualslam_android_tpu_torch.parallel import mesh as tmesh
from visualslam_android_tpu_torch.parallel import rank_programs
from visualslam_android_tpu_torch.parallel import replicated_tracking as trt
from visualslam_android_tpu_torch.parallel import sharded_ba as tsba
from visualslam_android_tpu_torch.parallel import sharded_mapping as tsm
from visualslam_android_tpu_torch.utils import convert
from visualslam_android_tpu_torch.utils import fixtures as tfix
from visualslam_android_tpu_torch.utils import synthetic as tsyn
from visualslam_android_tpu_torch.utils.tensors import TensorTree
from tests.test_bundle import _make_problem, _make_trajectory_problem

torch.set_num_threads(2)

WORLDS = (2, 4)
TIMEOUT = 60          # seconds, each set of ranks
POSE_ATOL = 5e-3
HIST_KW = dict(max_iters=8, solver="band_pcg", band_halfwidth=4,
               sigma_mode="hist", cg_iters=120, cg_tol=1e-7)
DEFAULT_KW = dict(max_iters=12)
PCG_KW = dict(max_iters=12, point_block=32, assembly="scatter",
              solver="pcg", cg_iters=200)
HALO_KW = dict(max_iters=3, point_block=256, cg_iters=150, cg_tol=1e-6,
               band_halfwidth=16)
HALO_ROWS, HALO_STRIP, HALO_F = 16, 5, 7
N_STREAMS, N_FRAMES = 4, 3
# One LM step through each path of the payload audit, at D = 2: (name,
# problem, bundle_adjust keywords; mode "halo" packs the problem first).
AUDIT = (
    ("scatter+chol, gather sigma", "small",
     dict(assembly="scatter", solver="chol")),
    ("band+chol, gather sigma", "small",
     dict(assembly="band", solver="chol", band_halfwidth=4)),
    ("band_pcg, hist sigma", "small",
     dict(solver="band_pcg", band_halfwidth=4, sigma_mode="hist")),
    ("pcg, gather sigma", "small",
     dict(assembly="scatter", solver="pcg", cg_iters=40, cg_tol=1e-12)),
    ("halo, hist sigma", "traj",
     dict(mode="halo", band_halfwidth=16, sigma_mode="hist", cg_iters=32)),
)


def _ns(named_tuple):
    """A JAX NamedTuple's fields as numpy in a plain namespace (what the
    port's convert functions read; the ranks must not unpickle JAX
    classes)."""
    return SimpleNamespace(**{k: np.asarray(v)
                              for k, v in named_tuple._asdict().items()})


def _jax_tree(cls, store):
    # jnp.array copies, so the JAX map owns its buffers.
    def field(x):
        if isinstance(x, tuple):
            return tuple(jnp.array(v.numpy()) for v in x)
        return jnp.array(x.numpy())

    return cls(**{f: field(getattr(store, f)) for f in cls._fields})


def _jax_map(tm):
    return jms.SLAMMap(
        points=_jax_tree(jms.PointStore, tm.points),
        keyframes=_jax_tree(jms.KeyFrameStore, tm.keyframes),
        meas=_jax_tree(jms.MeasStore, tm.meas),
        good=jnp.array(tm.good.numpy()),
    )


def _two_kf_maps():
    """tests/test_mapmaker.py's two_kf_map, built by the port on the CPU:
    (port config, JAX config, port map, JAX map, port camera, JAX
    camera)."""
    tcfg = tfix.small_config()
    tcfg = dataclasses.replace(tcfg, mapmaker=dataclasses.replace(
        tcfg.mapmaker, epipolar_depth_max_factor=100.0))
    jcfg = jfix.small_config()
    jcfg = jcfg.replace(mapmaker=dataclasses.replace(
        jcfg.mapmaker, epipolar_depth_max_factor=100.0))
    sm, cam, scene, (R0, t0), _ = tfix.build_fixed_map(
        tcfg, np.random.default_rng(31), device="cpu")
    dR, dt = tlie.se3_exp(torch.tensor([0.35, 0.02, 0.0, 0.0, 0.08, 0.0]))
    R1, t1 = tlie.se3_mul(dR, dt, R0, t0)
    tc = tcfg.tracker
    frame1 = tkf.make_frame(
        tsyn.render(scene, cam, R1, t1, (tc.height, tc.width)), tcfg)
    kfs = tkf.insert_keyframe(sm.keyframes, 1, frame1,
                              tkf.make_frame_extras(frame1, tcfg), R1, t1)
    kfs.depth_mean[1] = 4.0
    kfs.depth_sigma[1] = 0.8
    return tcfg, jcfg, sm, _jax_map(sm), cam, _jax_tree(jcam_ops.Camera, cam)


def _stream_inputs():
    """S = N_STREAMS streams on the 128x96 fixed map of seed 5, each on its
    own camera path (tests/test_torch_streams.py's recipe), the JAX keys'
    track_map draws, and the initial state."""
    tcfg = tfix.small_config(128, 96)
    sm, cam, scene, (R0, t0), _ = tfix.build_fixed_map(
        tcfg, np.random.default_rng(5), device="cpu")
    shape = (tcfg.tracker.height, tcfg.tracker.width)
    imgs = torch.zeros(N_FRAMES, N_STREAMS, *shape)
    for s in range(N_STREAMS):
        for f in range(N_FRAMES):
            mu = torch.tensor(
                [0.02 * s - 0.07, 0.01 * f, 0.015 * s * f / 4,
                 0.01 * np.sin(s), 0.02 * np.cos(f + s), 0.0],
                dtype=torch.float32) * 0.5
            dR, dt = tlie.se3_exp(mu)
            Rk, tk = tlie.se3_mul(dR, dt, R0, t0)
            imgs[f, s] = tsyn.render(scene, cam, Rk, tk, shape)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(N_STREAMS))
    n = tcfg.tracker.max_map_points

    def draws(key):
        _, k1, k2 = jax.random.split(key, 3)
        return np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float32))
                         for k in (k1, k2)])

    uniforms = torch.as_tensor(np.stack([draws(k) for k in keys]))
    state = trt.init_streams(N_STREAMS, R0, t0, tcfg, device="cpu")
    return dict(tcfg=tcfg, jcfg=jfix.small_config(128, 96), map=sm, cam=cam,
                imgs=imgs, keys=keys, uniforms=uniforms, state=state,
                R0=R0, t0=t0)


def _own_copy(value):
    """A tensor or TensorTree cloned, anything else as it is."""
    if isinstance(value, (torch.Tensor, TensorTree)):
        return value.clone()
    return value


class _Ranks(threading.Thread):
    """run_ranks of run_cases in a background thread. The ranks get their
    own copies of the cases' tensors: spawning moves a tensor's storage
    into shared memory and frees the old buffer, under any numpy view
    that a test in the main thread holds of it at that moment."""

    def __init__(self, world, cases):
        super().__init__(daemon=True)
        self.world = world
        self.cases = [(name, prog, {k: _own_copy(v) for k, v in kw.items()})
                      for name, prog, kw in cases]
        self.out, self.err = None, None
        self.start()

    def run(self):
        try:
            self.out = tmesh.run_ranks(
                rank_programs.run_cases, self.world, "gloo", "host",
                device="cpu", timeout=TIMEOUT, args=(self.cases,), threads=1)
        except BaseException as e:  # re-raised in the test thread
            self.err = e

    def results(self):
        self.join()
        if self.err is not None:
            raise self.err
        return self.out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    jprob, jcam = _make_problem(rng, n_cams=4, n_pts=120, perturb=0.02)[:2]
    jtraj, jtcam = _make_trajectory_problem(np.random.default_rng(42),
                                            n_cams=128, pts_per_cam=10)
    small = convert.ba_problem_from_numpy(_ns(jprob), device="cpu")
    scam = convert.camera_from_numpy(_ns(jcam), device="cpu")
    traj = convert.ba_problem_from_numpy(_ns(jtraj), device="cpu")
    tcam = convert.camera_from_numpy(_ns(jtcam), device="cpu")
    tcfg, jcfg, tmap, jmap, mcam, jmcam = _two_kf_maps()
    thinned = tmm.thin_candidates(tmap, 1, 1, radius=10)
    streams = _stream_inputs()
    hist_rng = np.random.default_rng(7)
    err = torch.as_tensor(hist_rng.lognormal(0.0, 2.0, 4096).astype(
        np.float32))
    mask = torch.as_tensor(hist_rng.uniform(size=4096) < 0.8)

    def cases(D):
        contrib = np.zeros((D, D * HALO_ROWS, HALO_F), np.float32)
        crng = np.random.default_rng(D)
        for d in range(D):
            lo = d * HALO_ROWS
            hi = min(D * HALO_ROWS, (d + 1) * HALO_ROWS + HALO_STRIP)
            contrib[d, lo:hi] = crng.normal(size=(hi - lo, HALO_F))
        out = [
            ("default", "bundle_adjust",
             dict(prob=small, cam=scam, point_block=32, **DEFAULT_KW)),
            ("band_pcg_hist", "bundle_adjust",
             dict(prob=small, cam=scam, point_block=32, **HIST_KW)),
            ("pcg", "bundle_adjust", dict(prob=small, cam=scam, **PCG_KW)),
            ("psum_band", "bundle_adjust",
             dict(prob=traj, cam=tcam, solver="band_pcg", sigma_mode="hist",
                  **HALO_KW)),
            ("halo", "bundle_adjust",
             dict(prob=traj, cam=tcam, mode="halo", **HALO_KW)),
            ("halo_reduce", "halo_reduce",
             dict(contrib=contrib, rows=HALO_ROWS, halo=HALO_STRIP)),
            ("hist_tukey", "hist_sigma", dict(err_sq=err, mask=mask)),
            ("hist_ls", "hist_sigma",
             dict(err_sq=err, mask=mask, estimator=tme.LEAST_SQUARES)),
            ("refind", "refind",
             dict(slam_map=tmap, kf_idx=1, cam=mcam,
                  point_mask=tmap.points.valid, config=tcfg)),
            ("scalable", "refind_scalable",
             dict(slam_map=tmap, kf_idx=1, cam=mcam,
                  point_mask=tmap.points.valid, config=tcfg)),
            ("epipolar", "epipolar",
             dict(slam_map=thinned, src_kf=1, target_kf=0, cam=mcam, level=1,
                  config=tcfg)),
        ]
        if D == 2:
            out += [(f"audit {name}", "lm_step_bytes",
                     dict(prob=small if p == "small" else traj,
                          cam=scam if p == "small" else tcam, **kw))
                    for name, p, kw in AUDIT]
            out.append(("tracking", "tracking", dict(
                frames=streams["imgs"], state=streams["state"],
                slam_map=streams["map"], cam=streams["cam"],
                uniforms=streams["uniforms"], config=streams["tcfg"])))
        return out

    ranks = {D: _Ranks(D, cases(D)) for D in WORLDS}
    return dict(jprob=jprob, jcam=jcam, jtraj=jtraj, jtcam=jtcam,
                small=small, scam=scam, traj=traj, tcam=tcam, tcfg=tcfg,
                jcfg=jcfg, tmap=tmap, jmap=jmap, mcam=mcam, jmcam=jmcam,
                thinned=thinned, streams=streams, err=err, mask=mask,
                ranks=ranks)


def _results(inputs, D):
    return inputs["ranks"][D].results()


def _case(inputs, D, name, rank=0):
    return _results(inputs, D)[rank][name]


def _jmesh(D):
    return jsba.make_mesh(jax.devices()[:D])


def _rms(prob, cam, res, n=None):
    n = prob.points.shape[0] if n is None else n
    return float(tb.reprojection_rms(
        prob, cam, *(torch.as_tensor(np.asarray(x))
                     for x in (res.cam_R, res.cam_t, res.points[:n]))))


# ---------------------------------------------------------------------------
# Pure functions (exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multiple", [2, 4, 8])
def test_pad_problem_matches_jax(inputs, multiple):
    got = tsba.pad_problem(inputs["small"], multiple)
    ref = jsba.pad_problem(inputs["jprob"], multiple)
    assert got.points.shape[0] % multiple == 0
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("n_dev", WORLDS)
def test_pack_problem_camblock_matches_jax(inputs, n_dev):
    packed, orig = tsba.pack_problem_camblock(inputs["traj"], n_dev, 16)
    jpacked, jorig = jsba.pack_problem_camblock(inputs["jtraj"], n_dev, 16)
    np.testing.assert_array_equal(orig, jorig)
    for f in jpacked._fields:
        np.testing.assert_array_equal(getattr(packed, f).numpy(),
                                      np.asarray(getattr(jpacked, f)), f)
    n = inputs["traj"].points.shape[0]
    fake = tb.BAResult(
        cam_R=packed.cam_R, cam_t=packed.cam_t, points=packed.points,
        meas_valid=packed.meas_valid, outlier_meas=packed.meas_valid,
        point_outliers=torch.arange(packed.points.shape[0],
                                    dtype=torch.int32),
        accepted=torch.tensor(0), converged=torch.tensor(False),
        sigma_squared=torch.tensor(1.0))
    back = tsba.unpack_point_outputs(fake, orig, n)
    np.testing.assert_array_equal(back.points.numpy(),
                                  inputs["traj"].points.numpy())
    np.testing.assert_array_equal(back.meas_valid.numpy(),
                                  inputs["traj"].meas_valid.numpy())
    with pytest.raises(ValueError):
        tsba.pack_problem_camblock(inputs["traj"], n_dev, 2)


def test_comm_bytes_model_matches_jax():
    grid = [dict(K=K, N_global=N, O=O, solver=solver, cg_iters=it,
                 inner_iters=inner, assembly=assembly, band_halfwidth=band,
                 sigma_mode=sigma, reduce_mode=reduce)
            for K, N, O in ((6, 136, 8), (512, 30000, 4))
            for solver, assembly in (("chol", "scatter"), ("chol", "band"),
                                     ("pcg", "scatter"),
                                     ("band_pcg", "band"))
            for it in (16, 250) for inner in (1, 3) for band in (4, 16)
            for sigma in ("gather", "hist") for reduce in ("psum", "halo")]
    assert len(grid) == 256
    for kw in grid:
        assert tsba.comm_bytes_per_lm_step(**kw) == \
            jsba.comm_bytes_per_lm_step(**kw), kw


def test_band_lower_from_upper_matches_jax():
    rng = np.random.default_rng(3)
    K, band = 32, 4
    S = np.zeros((K, 2 * band + 1, 6, 6), np.float32)
    for i in range(K):
        for d in range(band, 2 * band + 1):
            if i + d - band < K:
                S[i, d] = rng.normal(size=(6, 6))
    for i in range(K):
        for d in range(band):
            j = i + d - band
            if j >= 0:
                S[i, d] = S[j, (i - j) + band].T
    half = S[:, band:]
    got = tb._band_lower_from_upper(torch.as_tensor(half), band).numpy()
    np.testing.assert_array_equal(got, S)
    np.testing.assert_array_equal(
        got, np.asarray(jb._band_lower_from_upper(jnp.asarray(half), band)))


# ---------------------------------------------------------------------------
# Collectives: the halo reduction and the histogram sigma
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", WORLDS)
def test_halo_reduce_gather_equals_sum(inputs, D):
    """The ppermute-strip + all_gather reduction equals the plain sum of
    the ranks' contributions (JAX test_halo_reduce_gather_equals_sum), on
    every rank."""
    contrib = _results(inputs, D)
    crng = np.random.default_rng(D)
    ref = np.zeros((D, D * HALO_ROWS, HALO_F), np.float32)
    for d in range(D):
        lo = d * HALO_ROWS
        hi = min(D * HALO_ROWS, (d + 1) * HALO_ROWS + HALO_STRIP)
        ref[d, lo:hi] = crng.normal(size=(hi - lo, HALO_F))
    for rank in range(D):
        np.testing.assert_allclose(contrib[rank]["halo_reduce"],
                                   ref.sum(0), rtol=0, atol=1e-5)


@pytest.mark.parametrize("D", WORLDS)
def test_hist_sigma_over_mesh_equals_unsharded(inputs, D):
    err, mask = inputs["err"], inputs["mask"]
    for name, est in (("hist_tukey", tme.TUKEY),
                      ("hist_ls", tme.LEAST_SQUARES)):
        one = tme.find_sigma_squared_hist(err, mask, est).numpy()
        jone = np.asarray(jme.find_sigma_squared_hist(
            jnp.asarray(err.numpy()), jnp.asarray(mask.numpy()),
            jme.LEAST_SQUARES if est == tme.LEAST_SQUARES else jme.TUKEY))
        for rank in range(D):
            got = _case(inputs, D, name, rank)
            np.testing.assert_allclose(got, one, rtol=1e-6)
            np.testing.assert_allclose(got, jone, rtol=1e-6)


# ---------------------------------------------------------------------------
# Sharded bundle adjustment
# ---------------------------------------------------------------------------


def _replicated(inputs, D, name):
    """rank 0's result of a case, after checking every rank holds the same
    BAResult."""
    res = [r[name]["result"] for r in _results(inputs, D)]
    for other in res[1:]:
        for f in dataclasses.fields(res[0]):
            np.testing.assert_array_equal(getattr(other, f.name),
                                          getattr(res[0], f.name), f.name)
    return res[0]


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_bundle_adjust_default_matches(inputs, D):
    prob, cam = inputs["small"], inputs["scam"]
    res = _replicated(inputs, D, "default")
    one = tb.bundle_adjust(prob, cam, point_block=64, **DEFAULT_KW)
    jres = jsba.sharded_bundle_adjust(inputs["jprob"], inputs["jcam"],
                                      _jmesh(D), point_block=32, **DEFAULT_KW)
    rms = _rms(prob, cam, res)
    for ref in (one, jres):
        rms_ref = _rms(prob, cam, ref)
        assert rms < max(1.5 * rms_ref, 0.6), (rms, rms_ref)
        np.testing.assert_allclose(res.cam_t[:4], np.asarray(ref.cam_t[:4]),
                                   rtol=0, atol=POSE_ATOL)
        np.testing.assert_allclose(res.cam_R[:4], np.asarray(ref.cam_R[:4]),
                                   rtol=0, atol=POSE_ATOL)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_bundle_adjust_pcg_matches(inputs, D):
    """scatter + pcg: one [K, 6] psum per CG product, the ranks iterating in
    lockstep; whole runs held at the optimum (12 LM iterations)."""
    prob, cam = inputs["small"], inputs["scam"]
    res = _replicated(inputs, D, "pcg")
    one = tb.bundle_adjust(prob, cam, **PCG_KW)
    jres = jsba.sharded_bundle_adjust(inputs["jprob"], inputs["jcam"],
                                      _jmesh(D), **PCG_KW)
    rms = _rms(prob, cam, res)
    for ref in (one, jres):
        rms_ref = _rms(prob, cam, ref)
        assert rms < max(1.2 * rms_ref, 0.6), (rms, rms_ref)
        np.testing.assert_allclose(res.cam_t[:4], np.asarray(ref.cam_t[:4]),
                                   rtol=0, atol=POSE_ATOL)
        np.testing.assert_allclose(res.cam_R[:4], np.asarray(ref.cam_R[:4]),
                                   rtol=0, atol=POSE_ATOL)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_bundle_adjust_band_pcg_hist_matches(inputs, D):
    prob, cam = inputs["small"], inputs["scam"]
    res = _replicated(inputs, D, "band_pcg_hist")
    one = tb.bundle_adjust(prob, cam, point_block=64, **HIST_KW)
    jres = jsba.sharded_bundle_adjust(inputs["jprob"], inputs["jcam"],
                                      _jmesh(D), point_block=32, **HIST_KW)
    assert int(res.accepted) >= 1
    n = prob.points.shape[0]
    for ref in (one, jres):
        np.testing.assert_allclose(res.cam_t, np.asarray(ref.cam_t), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(res.cam_R, np.asarray(ref.cam_R), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(res.points[:n],
                                   np.asarray(ref.points)[:n], rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_bundle_adjust_halo_matches_psum(inputs, D):
    """reduce_mode "halo" (camera-block packing, the strip ppermute and the
    half band all-gathered) reaches the optimum of the port's psum
    band_pcg run and of the JAX package's halo and psum band_pcg runs at
    the same D: the same sums in another order, so optimum-level parity.
    rms against all three; poses against the two that run the same
    accept tests as this one (the port's psum run and the JAX halo run).
    At D = 2 the JAX psum run accepts a third step that its own halo run
    does not (a strict comparison of two f32 sums parts), and its
    trajectory's far end then lies 0.66 from the JAX halo run's, so its
    poses are no reference after 3 LM iterations (ROADMAP queue 3,
    differences already explained)."""
    prob, cam = inputs["traj"], inputs["tcam"]
    res = _replicated(inputs, D, "halo")
    psum = _replicated(inputs, D, "psum_band")
    assert int(res.accepted) == int(psum.accepted)
    mesh = _jmesh(D)
    jhalo = jsba.sharded_bundle_adjust_halo(inputs["jtraj"], inputs["jtcam"],
                                            mesh, **HALO_KW)
    jpsum = jsba.sharded_bundle_adjust(inputs["jtraj"], inputs["jtcam"], mesh,
                                       solver="band_pcg", sigma_mode="hist",
                                       **HALO_KW)
    n = prob.points.shape[0]
    rms_halo = _rms(prob, cam, res)
    for ref in (psum, jhalo, jpsum):
        rms_ref = _rms(prob, cam, ref, n)
        assert rms_halo < 1.05 * rms_ref + 1e-4, (rms_halo, rms_ref)
    for ref in (psum, jhalo):
        ref_t = np.asarray(ref.cam_t)
        traj_len = float(np.linalg.norm(ref_t[-1] - ref_t[0]))
        assert np.abs(res.cam_t - ref_t).max() < POSE_ATOL * max(traj_len,
                                                                1.0)
    sites = _case(inputs, D, "halo")["sites"]
    assert sites["halo_strip"] > 0 and "psum" not in sites


@pytest.mark.parametrize("name,problem,kwargs", AUDIT,
                         ids=[a[0] for a in AUDIT])
def test_lm_step_payload_matches_model(inputs, name, problem, kwargs):
    """One LM step's collectives at D = 2 (mesh.COMM_SITES) equal
    comm_bytes_per_lm_step item by item; the scalars are the port's named
    sums (port_scalar_bytes)."""
    got = _case(inputs, 2, f"audit {name}")
    prob = inputs["small"] if problem == "small" else inputs["traj"]
    kw = dict(kwargs)
    mode = kw.pop("mode", "psum")
    K, O = prob.cam_R.shape[0], prob.meas_kf.shape[1]
    solver = "band_pcg" if mode == "halo" else kw.get("solver", "chol")
    assert got["inner"] == 1
    model = tsba.comm_bytes_per_lm_step(
        K, got["n_global"], O, solver=solver,
        cg_iters=got["cg_issued"], inner_iters=1,
        assembly=kw.get("assembly", "band" if mode == "halo" else "scatter"),
        band_halfwidth=kw.get("band_halfwidth", 16),
        sigma_mode=kw.get("sigma_mode", "gather"), reduce_mode=mode)
    scalars = tsba.port_scalar_bytes(1, mode)
    sites = got["sites"]
    items = [k for k in model if k not in ("scalars", "total")]
    assert sorted(sites) == sorted(items + ["scalars"]), sites
    for item in items:
        assert sites[item] == model[item], (item, sites[item], model[item])
    assert sites["scalars"] == sum(scalars.values()), (sites, scalars)
    if solver == "pcg":
        cg = kw["cg_iters"]
        assert 0 < got["cg_issued"] <= cg
        assert got["cg_issued"] % tb.CG_CHUNK == 0 or got["cg_issued"] == cg


def test_halo_refuses_unpacked_points(inputs):
    """reduce_mode "halo" on points that are not packed by camera block
    raises on every rank (the JAX package drops their rows, ROADMAP queue 3
    c), through run_ranks."""
    prob, cam = inputs["traj"], inputs["tcam"]
    K = prob.cam_R.shape[0]
    with pytest.raises(Exception, match="pack_problem_camblock"):
        tmesh.run_ranks(
            rank_programs.run_cases, 2, "gloo", "host", device="cpu",
            timeout=TIMEOUT, threads=1, args=([(
                "unpacked", "bundle_adjust",
                dict(prob=prob, cam=cam, assembly="band", solver="band_pcg",
                     reduce_mode="halo", shard_rows=K // 2, max_iters=1))],))


# ---------------------------------------------------------------------------
# Sharded mapping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_refind_matches_jax(inputs, D):
    jmap, jcfg = inputs["jmap"], inputs["jcfg"]
    meas, found, never = _case(inputs, D, "refind")["result"]
    jsm_map, jfound, jnever = jsm.sharded_refind_in_keyframe(
        jmap, 1, inputs["jmcam"], jmap.points.valid, jcfg, _jmesh(D))
    tm1, tf1, tn1 = tmm.refind_in_keyframe(
        inputs["tmap"], 1, inputs["mcam"], inputs["tmap"].points.valid,
        inputs["tcfg"])
    assert int(found.sum()) > 20
    for ref_found, ref_never, ref_meas in (
            (np.asarray(jfound), np.asarray(jnever), jsm_map.meas),
            (tf1.numpy(), tn1.numpy(), tm1.meas)):
        np.testing.assert_array_equal(found, ref_found)
        np.testing.assert_array_equal(never, ref_never)
        np.testing.assert_array_equal(meas.valid, np.asarray(ref_meas.valid))
        f = found
        np.testing.assert_allclose(meas.uv[f], np.asarray(ref_meas.uv)[f],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_refind_scalable_matches_jax(inputs, D):
    jmap, jcfg = inputs["jmap"], inputs["jcfg"]
    found, pos_zero, level, subpix = _case(inputs, D, "scalable")["result"]
    jout = jsm.sharded_refind_scalable(jmap, 1, inputs["jmcam"],
                                       jmap.points.valid, jcfg, _jmesh(D))
    np.testing.assert_array_equal(found, np.asarray(jout[0]))
    meas = tmm.add_measurements_batch(
        inputs["tmap"].meas, torch.as_tensor(found), 1,
        torch.as_tensor(pos_zero), torch.as_tensor(level), tmm.SRC_REFIND,
        torch.as_tensor(subpix))
    jmeas = jmm.add_measurements_batch(jmap.meas, *jout[:1], 1, *jout[1:3],
                                       jmm.SRC_REFIND, jout[3])
    tm1, tf1, _ = tmm.refind_in_keyframe(
        inputs["tmap"], 1, inputs["mcam"], inputs["tmap"].points.valid,
        inputs["tcfg"])
    np.testing.assert_array_equal(found, tf1.numpy())
    for ref in (jmeas, tm1.meas):
        np.testing.assert_array_equal(meas.valid.numpy(),
                                      np.asarray(ref.valid))
        np.testing.assert_allclose(meas.uv.numpy()[found],
                                   np.asarray(ref.uv)[found], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_epipolar_matches_jax(inputs, D):
    res = _case(inputs, D, "epipolar")["result"]
    jthin = jmm.thin_candidates(inputs["jmap"], 1, 1, radius=10)
    jres = jsm.sharded_epipolar_search(jthin, 1, 0, inputs["jmcam"], 1,
                                       inputs["jcfg"], _jmesh(D))
    one = tmm.epipolar_search(inputs["thinned"], 1, 0, inputs["mcam"], 1,
                              inputs["tcfg"])
    s = res.success
    assert int(s.sum()) > 5
    for ref in (jres, one):
        np.testing.assert_array_equal(s, np.asarray(ref.success))
        np.testing.assert_allclose(res.pos_w[s], np.asarray(ref.pos_w)[s],
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(res.target_uv[s],
                                   np.asarray(ref.target_uv)[s], rtol=0,
                                   atol=1e-3)


def test_refind_search_matches_jax(inputs):
    """The one-keyframe search (_refind_search: templates at the keyframe's
    pose, then _refind_search_core on its frame, which refind_in_keyframe
    and the sharded re-finds run) against the JAX package's, and against
    refind_pairs (the facade's pair-list search) over the same points."""
    tmap, jmap = inputs["tmap"], inputs["jmap"]
    active = tmap.points.live() & ~tmm.map_store.point_observed_in(
        tmap.meas, 1)
    found, pos_zero, level, subpix = tmm._refind_search(
        tmap, 1, inputs["mcam"], active, inputs["tcfg"])
    jsearch = jax.jit(jmm._refind_search, static_argnames=("config",))
    jout = jsearch(jmap, 1, inputs["jmcam"], jnp.asarray(active.numpy()),
                   config=inputs["jcfg"])
    f = np.asarray(jout[0])
    assert f.sum() > 20
    np.testing.assert_array_equal(found.numpy(), f)
    np.testing.assert_array_equal(level.numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(subpix.numpy(), np.asarray(jout[3]))
    np.testing.assert_allclose(pos_zero.numpy()[f], np.asarray(jout[1])[f],
                               rtol=0, atol=1e-4)
    N = tmap.points.n_slots
    pairs = tmm.refind_pairs(tmap, torch.arange(N),
                             torch.full((N,), 1, dtype=torch.long), active,
                             inputs["mcam"], inputs["tcfg"])
    for got, want in zip((found, pos_zero, level, subpix), pairs):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("D", WORLDS)
def test_shard_keyframe_pyramids(inputs, D):
    """Each rank's map holds its K' = ceil(K / D) pyramid slots (zero past
    the last keyframe) and the other stores whole; the scalable re-find
    refuses a map whose pyramids are not the rank's shard, before any
    collective."""
    tmap = inputs["tmap"]
    kfs = tmap.keyframes
    K = kfs.n_slots
    k_loc = -(-K // D)
    for rank in range(D):
        mesh = tmesh.Mesh(rank=rank, size=D, device=torch.device("cpu"),
                          transport="host")
        shard = tsm.shard_keyframe_pyramids(tmap, mesh)
        for full, cut in zip(kfs.pyramid + kfs.corner_mask,
                             shard.keyframes.pyramid
                             + shard.keyframes.corner_mask):
            want = torch.zeros((k_loc,) + tuple(full.shape[1:]),
                               dtype=full.dtype)
            part = full[rank * k_loc:(rank + 1) * k_loc]
            want[:part.shape[0]] = part
            np.testing.assert_array_equal(cut.numpy(), want.numpy())
        np.testing.assert_array_equal(shard.keyframes.R.numpy(),
                                      kfs.R.numpy())
        np.testing.assert_array_equal(shard.points.pos_w.numpy(),
                                      tmap.points.pos_w.numpy())
        with pytest.raises(ValueError, match="shard_keyframe_pyramids"):
            tsm.sharded_refind_scalable(tmap, 1, inputs["mcam"],
                                        tmap.points.valid, inputs["tcfg"],
                                        mesh)


def test_refind_in_keyframes_batched_matches_jax(inputs):
    """The K-lane oracle: every keyframe's search, measurements inserted
    keyframe by keyframe; against the JAX package's and against
    refind_in_keyframe keyframe by keyframe."""
    tmap, jmap = inputs["tmap"], inputs["jmap"]
    K, N = tmap.keyframes.n_slots, tmap.points.n_slots
    mask = np.ones((K, N), bool)
    mask[:, 3::7] = False
    tm, tf, tn = tmm.refind_in_keyframes_batched(
        tmap, inputs["mcam"], torch.as_tensor(mask), inputs["tcfg"])
    jm, jf, jn = jmm.refind_in_keyframes_batched(
        jmap, inputs["jmcam"], jnp.asarray(mask), inputs["jcfg"])
    assert int(tf.sum()) > 20
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tm.meas.valid.numpy(),
                                  np.asarray(jm.meas.valid))
    v = tm.meas.valid.numpy()
    np.testing.assert_allclose(tm.meas.uv.numpy()[v],
                               np.asarray(jm.meas.uv)[v], rtol=0, atol=1e-4)
    loop = tmap
    for k in range(K):
        loop, f, _ = tmm.refind_in_keyframe(
            loop, k, inputs["mcam"],
            torch.as_tensor(mask[k]) & loop.keyframes.valid[k],
            inputs["tcfg"])
        np.testing.assert_array_equal(f.numpy(), tf[k].numpy())
    np.testing.assert_array_equal(loop.meas.valid.numpy(), v)


# ---------------------------------------------------------------------------
# Replicated tracking
# ---------------------------------------------------------------------------


def test_replicated_step_matches_jax(inputs):
    """replicated_step_fn at D = 2, S = 4 against the JAX package's on a
    2-device mesh, the same frames, map and draws; every rank holds every
    stream's outputs, and each rank made one FAST launch per step (none
    here: on the CPU the wrappers run their plain versions and count
    nothing)."""
    st = inputs["streams"]
    got = _results(inputs, 2)
    state_t, outs_t = got[0]["tracking"]["result"]
    step = jrt.replicated_step_fn(jrt.make_mesh(jax.devices()[:2]),
                                  st["jcfg"])
    jstate = jrt.init_streams(N_STREAMS, st["R0"].numpy(), st["t0"].numpy(),
                              st["jcfg"])
    jmap = _jax_map(st["map"])
    jcam = _jax_tree(jcam_ops.Camera, st["cam"])
    for f in range(N_FRAMES):
        jstate, jo = step(jnp.asarray(st["imgs"][f].numpy()), jstate, jmap,
                          jcam, st["keys"])
        to = outs_t[f]
        np.testing.assert_array_equal(to.n_found, np.asarray(jo.n_found))
        np.testing.assert_array_equal(to.quality, np.asarray(jo.quality))
        np.testing.assert_allclose(to.R, np.asarray(jo.R), rtol=0, atol=1e-4)
        np.testing.assert_allclose(to.t, np.asarray(jo.t), rtol=0, atol=1e-4)
        other = got[1]["tracking"]["result"][1][f]
        np.testing.assert_array_equal(other.R, to.R)
        np.testing.assert_array_equal(other.n_found, to.n_found)
    assert int(np.asarray(jo.n_found).min()) > 10
    np.testing.assert_allclose(state_t.velocity, np.asarray(jstate.velocity),
                               rtol=0, atol=1e-4)


def test_replicated_step_equals_stream_step(inputs):
    """Each stream of the sharded step equals the single-device
    stream_step of all S streams on the same frames and draws."""
    st = inputs["streams"]
    _, outs_t = _case(inputs, 2, "tracking")["result"]
    state = st["state"]
    for f in range(N_FRAMES):
        state, out = trt.stream_step(st["imgs"][f], state, st["map"],
                                     st["cam"], st["uniforms"], st["tcfg"])
        np.testing.assert_array_equal(outs_t[f].n_found, out.n_found.numpy())
        np.testing.assert_allclose(outs_t[f].R, out.R.numpy(), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(outs_t[f].t, out.t.numpy(), rtol=0,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# The launcher and the mesh
# ---------------------------------------------------------------------------


def test_rank_failures_fail():
    """A rank's exception is raised by run_ranks, ranks still running at
    the timeout are stopped and run_ranks raises TimeoutError, ranks that
    enter a collective with different shapes all raise, and a backend and
    transport that do not go together, or a bool psum, raise before any
    collective."""
    with pytest.raises(Exception, match="halo reduce needs"):
        tmesh.run_ranks(
            rank_programs.run_cases, 2, "gloo", "host", device="cpu",
            timeout=TIMEOUT, threads=1, args=([(
                "bad", "halo_reduce",
                dict(contrib=np.zeros((2, 30, 3), np.float32), rows=16,
                     halo=5))],))
    with pytest.raises(Exception, match="different"):
        tmesh.run_ranks(
            rank_programs.run_cases, 2, "gloo", "host", device="cpu",
            timeout=TIMEOUT, threads=1, args=([(
                "mismatch", "collectives",
                dict(shapes=[(8,), (9,)], reps=1))],))
    with pytest.raises(TimeoutError):
        tmesh.run_ranks(rank_programs.run_cases, 2, "gloo", "host",
                        device="cpu", timeout=0.5, args=([],))
    with pytest.raises(ValueError, match="transport"):
        tmesh.run_ranks(rank_programs.run_cases, 2, "gloo", "device",
                        device="cpu")
    mesh = tmesh.Mesh(rank=0, size=1, device=torch.device("cpu"),
                      transport="host")
    with pytest.raises(ValueError, match="bool"):
        tmesh.psum(mesh, torch.zeros(3, dtype=torch.bool))


def test_ranks_spawn_without_jax(inputs):
    """Every set of ranks finished (run_ranks raises if a rank imported jax
    or the JAX package) and replicated what it should."""
    for D in WORLDS:
        res = _results(inputs, D)
        assert len(res) == D
        for r in res[1:]:
            np.testing.assert_array_equal(r["hist_tukey"],
                                          res[0]["hist_tukey"])
