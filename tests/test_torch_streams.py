"""Multi-stream tracking: the port's parallel/replicated_tracking against
the JAX package's on the same map, camera, frames and random draws.

S = 3 streams, each on its own camera path near the map pose, for 3
chained frames (built as tests/test_replicated_tracking.py builds its
streams), at the small configuration (128x96). The JAX stream_step runs
under jax.jit; the port's starts from stream_state_from_numpy of the same
init_streams state. track_map splits each stream's key in three
(tracker.py:236-237,266 of the JAX package) and draws the coarse and fine
priorities from the last two: the same uniforms go to the port.

Tolerances, per stream and frame: n_found, quality and did_coarse equal; R
and t within atol 1e-4 (f32 Gauss-Newton over ~90 points in another
summation order); velocity within atol 1e-4 for the same reason; the SBI
template within 1e-5 of its largest magnitude (it is a blur of grey levels
of magnitude up to ~100; the JAX package's own jitted and eager make_sbi
differ by about 1e-5 of the magnitude on such frames); scene depth within
rtol 1e-5.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu.parallel import replicated_tracking as jrt
from visualslam_android_tpu.utils import fixtures as jfix
from visualslam_android_tpu.utils import synthetic as jsyn
from visualslam_android_tpu_torch.ops import fast as tfast
from visualslam_android_tpu_torch.parallel import replicated_tracking as trt
from visualslam_android_tpu_torch.utils import convert
from visualslam_android_tpu_torch.utils import fixtures as tfix

torch.set_num_threads(2)

N_STREAMS = 3
N_FRAMES = 3
POSE_ATOL = 1e-4
SBI_REL = 1e-5
SINGLE_ATOL = 1e-6   # the same arithmetic batched or alone on the CPU
MAX_OP_RATIO = 1.2   # dispatched ops of one step, S = 3 against S = 1


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _uniforms(key, n):
    """track_map's two draws for one stream's key."""
    _, k1, k2 = jax.random.split(key, 3)
    return np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float32))
                     for k in (k1, k2)])


@pytest.fixture(scope="module")
def streams():
    rng = np.random.default_rng(5)
    jcfg = jfix.small_config(128, 96)
    tcfg = tfix.small_config(128, 96)
    slam_map, cam, scene, (R0, t0), _ = jfix.build_fixed_map(jcfg, rng)
    shape = (jcfg.tracker.height, jcfg.tracker.width)
    imgs = np.zeros((N_FRAMES, N_STREAMS, *shape), np.float32)
    for s in range(N_STREAMS):
        for f in range(N_FRAMES):
            mu = jnp.asarray(
                [0.02 * s - 0.07, 0.01 * f, 0.015 * s * f / 4,
                 0.01 * np.sin(s), 0.02 * np.cos(f + s), 0.0],
                jnp.float32,
            ) * 0.5
            dR, dt = jlie.se3_exp(mu)
            Rk, tk = jlie.se3_mul(dR, dt, R0, t0)
            imgs[f, s] = np.asarray(jsyn.render(scene, cam, Rk, tk, shape))
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(N_STREAMS))
    n = jcfg.tracker.max_map_points
    uniforms = torch.as_tensor(np.stack([_uniforms(k, n) for k in keys]))

    step = jax.jit(jrt.stream_step, static_argnums=(5,))
    jstate = jrt.init_streams(N_STREAMS, R0, t0, jcfg)
    tstate0 = convert.stream_state_from_numpy(_np_tree(jstate), device="cpu")
    t_map = convert.map_from_numpy(_np_tree(slam_map), device="cpu")
    t_cam = convert.camera_from_numpy(_np_tree(cam), device="cpu")
    jouts, touts, tstate = [], [], tstate0
    for f in range(N_FRAMES):
        jstate, jo = step(jnp.asarray(imgs[f]), jstate, slam_map, cam, keys,
                          jcfg)
        tstate, to = trt.stream_step(torch.as_tensor(imgs[f]), tstate, t_map,
                                     t_cam, uniforms, tcfg)
        jouts.append((_np_tree(jstate), _np_tree(jo)))
        touts.append((tstate, to))
    return dict(jouts=jouts, touts=touts, imgs=imgs, uniforms=uniforms,
                tstate0=tstate0, t_map=t_map, t_cam=t_cam, tcfg=tcfg,
                jstate0=_np_tree(jrt.init_streams(N_STREAMS, R0, t0, jcfg)),
                R0=np.array(R0), t0=np.array(t0))


@pytest.mark.parametrize("f", range(N_FRAMES))
def test_stream_step_matches_jax(streams, f):
    (jstate, jo), (tstate, to) = streams["jouts"][f], streams["touts"][f]
    np.testing.assert_array_equal(to.n_found.numpy(), jo.n_found)
    np.testing.assert_array_equal(to.quality.numpy(), jo.quality)
    np.testing.assert_array_equal(to.did_coarse.numpy(), jo.did_coarse)
    assert to.n_found.dtype == torch.int32 and to.quality.dtype == torch.int32
    np.testing.assert_allclose(to.R.numpy(), jo.R, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(to.t.numpy(), jo.t, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(tstate.velocity.numpy(), jstate.velocity,
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(tstate.scene_depth_mean.numpy(),
                               jstate.scene_depth_mean, rtol=1e-5)
    tmpl = jstate.sbi_last.template
    np.testing.assert_allclose(tstate.sbi_last.template.numpy(), tmpl,
                               rtol=0, atol=SBI_REL * np.abs(tmpl).max())
    np.testing.assert_array_equal(tstate.has_sbi.numpy(), jstate.has_sbi)
    # The streams really tracked.
    assert int(jo.n_found.min()) > 10 and int(jo.quality.min()) >= 1


def test_streams_equal_single_streams(streams):
    """Each stream of the S = 3 step equals stream_step at S = 1 on its
    own frames and draws, over all frames."""
    u, cfg = streams["uniforms"], streams["tcfg"]
    for s in range(N_STREAMS):
        st = streams["tstate0"]._map(lambda x, s=s: x[s:s + 1])
        for f in range(N_FRAMES):
            st, out = trt.stream_step(
                torch.as_tensor(streams["imgs"][f, s:s + 1]), st,
                streams["t_map"], streams["t_cam"], u[s:s + 1], cfg)
            batched = streams["touts"][f][1]
            for name in ("n_found", "quality", "did_coarse"):
                assert torch.equal(getattr(out, name)[0],
                                   getattr(batched, name)[s]), (s, f, name)
            for name in ("R", "t"):
                np.testing.assert_allclose(
                    getattr(out, name)[0].numpy(),
                    getattr(batched, name)[s].numpy(), rtol=0,
                    atol=SINGLE_ATOL)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_stream_step_is_batched(streams):
    """One step at S = 3 issues at most MAX_OP_RATIO times the ops of
    S = 1 (a per-stream loop would issue 3x), and no op falls back to
    functorch's per-example loop."""
    u, cfg = streams["uniforms"], streams["tcfg"]
    imgs = torch.as_tensor(streams["imgs"][0])
    counts = {}
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        for S in (1, N_STREAMS):
            state = streams["tstate0"]._map(lambda x, S=S: x[:S])
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with _CountOps() as mode:
                    trt.stream_step(imgs[:S], state, streams["t_map"],
                                    streams["t_cam"], u[:S], cfg)
            fallbacks = [str(w.message) for w in caught
                         if "batching rule" in str(w.message)]
            assert fallbacks == [], fallbacks
            counts[S] = mode.n
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert counts[1] > 1000
    assert counts[N_STREAMS] <= MAX_OP_RATIO * counts[1], counts


def test_detect_levels_streams_plain_matches_detect_levels():
    """The stream-batched FAST on the CPU (its plain version) gives each
    frame what detect_levels gives it alone, bit for bit."""
    rng = np.random.default_rng(8)
    thresholds = (10, 15, 15, 10)
    frames = rng.uniform(0, 255, size=(3, 48, 64)).astype(np.float32)
    levels = [torch.as_tensor(frames)]
    for _ in range(3):
        x = levels[-1]
        levels.append(x.reshape(3, x.shape[1] // 2, 2, x.shape[2] // 2, 2)
                      .mean(dim=(2, 4)).contiguous())
    masks, scores = tfast.detect_levels_streams(levels, thresholds)
    for s in range(3):
        m1, s1 = tfast.detect_levels([lv[s].contiguous() for lv in levels],
                                     thresholds)
        for lvl in range(4):
            assert masks[lvl].shape == levels[lvl].shape
            assert torch.equal(masks[lvl][s], m1[lvl])
            assert torch.equal(scores[lvl][s], s1[lvl])
    assert int(masks[0].sum()) > 0


@pytest.mark.parametrize("bad", ["ndim", "streams", "dtype", "strided",
                                 "thresholds"])
def test_detect_levels_streams_rejects(bad):
    lv = [torch.zeros(2, 16, 16), torch.zeros(2, 8, 8)]
    th = [10, 15]
    if bad == "ndim":
        lv[1] = lv[1][0]
    elif bad == "streams":
        lv[1] = torch.zeros(3, 8, 8)
    elif bad == "dtype":
        lv[0] = lv[0].double()
    elif bad == "strided":
        lv[0] = torch.zeros(2, 16, 32)[:, :, ::2]
    else:
        th = [10]
    with pytest.raises(ValueError):
        tfast.detect_levels_streams(lv, th)


def test_init_streams_matches_jax(streams):
    """init_streams builds the JAX package's initial state; with no device
    named it builds on the CUDA card, and raises where there is none."""
    cfg = streams["tcfg"]
    state = trt.init_streams(N_STREAMS, torch.as_tensor(streams["R0"]),
                             streams["t0"], cfg, device="cpu")
    ref = streams["jstate0"]
    for name in ("R", "t", "velocity", "vel_msd_mag", "scene_depth_mean",
                 "has_sbi"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      getattr(ref, name), name)
    np.testing.assert_array_equal(state.sbi_last.template.numpy(),
                                  ref.sbi_last.template)
    np.testing.assert_array_equal(state.sbi_last.jacs.numpy(),
                                  ref.sbi_last.jacs)
    conv = streams["tstate0"]
    assert conv.sbi_last.jacs.shape == state.sbi_last.jacs.shape
    assert conv.has_sbi.dtype == torch.bool
    if torch.cuda.is_available():
        assert trt.init_streams(1, streams["R0"], streams["t0"],
                                cfg).R.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device"):
            trt.init_streams(1, streams["R0"], streams["t0"], cfg)
