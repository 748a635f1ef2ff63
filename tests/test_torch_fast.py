"""Parity of the port's FAST detector with the JAX package.

On the CPU the port's ``detect`` and ``detect_levels`` run the plain
PyTorch version ``detect_reference``, and ``nonmax_levels`` runs
``nonmax_levels_reference`` (the CUDA kernels run only on a GPU;
chip_smoke.py holds them against the plain versions there). detect_reference is held here
against the JAX package's dense ``_detect_jnp`` and against its Pallas
kernel in interpret mode, as tests/test_fast.py runs that kernel on the
CPU. Masks must be equal exactly. Scores are sums of 16 f32 terms of
magnitude up to 255: atol 1e-3 against _detect_jnp everywhere, and against
the Pallas kernel on the interior only, whose wraparound border differs by
design (ops/fast.py:65-67).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.ops import fast as jfast
from visualslam_android_tpu.ops import fast_pallas
from visualslam_android_tpu_torch.ops import cuda_build
from visualslam_android_tpu_torch.ops import fast as tfast

torch.set_num_threads(2)

SCORE_ATOL = 1e-3


def _image(seed, h=96, w=128):
    """Random blocks (clear corners) over noise, values in [0, 255]."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    for _ in range(12):
        y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
        img[y:y + rng.integers(5, 12), x:x + rng.integers(5, 12)] = rng.uniform(0, 255)
    return img


CASES = [(t, arc) for t in (10, 15) for arc in (9, 10)]


@pytest.mark.parametrize("threshold,arc", CASES)
def test_reference_matches_dense_jax(threshold, arc):
    img = _image(threshold * 100 + arc)
    jm, js = jfast._detect_jnp(jnp.asarray(img), threshold, arc)
    tm, ts = tfast.detect_reference(torch.from_numpy(img), threshold, arc)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.numpy().sum() > 0
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("threshold,arc", CASES)
def test_reference_matches_pallas_interpret(threshold, arc):
    img = _image(threshold * 100 + arc + 1, h=64, w=96)
    pm, ps = fast_pallas.detect(jnp.asarray(img), threshold, arc,
                                interpret=True)
    tm, ts = tfast.detect_reference(torch.from_numpy(img), threshold, arc)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(pm))
    np.testing.assert_allclose(ts.numpy()[3:-3, 3:-3],
                               np.asarray(ps)[3:-3, 3:-3], rtol=0,
                               atol=SCORE_ATOL)


def test_detect_on_cpu_is_the_reference():
    img = torch.from_numpy(_image(5))
    before = dict(tfast.LAUNCHES)
    m, s = tfast.detect(img, 10)
    rm, rs = tfast.detect_reference(img, 10)
    assert torch.equal(m, rm) and torch.equal(s, rs)
    assert tfast.LAUNCHES == before  # no kernel on the CPU


@pytest.mark.parametrize("bad", ["dtype", "ndim", "strided", "arc"])
def test_detect_rejects_bad_input(bad):
    img = torch.from_numpy(_image(6))
    kwargs = {}
    if bad == "dtype":
        img = img.double()
    elif bad == "ndim":
        img = img[None]
    elif bad == "strided":
        img = img[:, ::2]
    else:
        kwargs["arc_length"] = 8
    with pytest.raises(ValueError):
        tfast.detect(img, 10, **kwargs)


def test_kernel_source_and_build_flags():
    """The CUDA source exists and builds for Hopper's sm_90a; the library
    name follows the source, so an edited kernel is rebuilt."""
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    path = cuda_build.library_path("fast.cu")
    assert path.startswith(cuda_build.BUILD_DIR) and path.endswith(".so")
    assert path == cuda_build.library_path("fast.cu")


@pytest.mark.parametrize("threshold", [10, 15])
def test_nonmax_matches_jax(threshold):
    img = _image(7 + threshold)
    jm, js = jfast._detect_jnp(jnp.asarray(img), threshold, 10)
    tm, ts = torch.from_numpy(np.array(jm)), torch.from_numpy(np.array(js))
    np.testing.assert_array_equal(
        tfast.nonmax_3x3(tm, ts).numpy(), np.asarray(jfast.nonmax_3x3(jm, js))
    )


@pytest.mark.parametrize("k,border", [(32, 0), (64, 10), (4096, 10)])
def test_top_k_matches_jax(k, border):
    img = _image(8)
    jm, js = jfast._detect_jnp(jnp.asarray(img), 10, 10)
    # Integer scores make ties: both must keep the lower raster index.
    js = jnp.floor(js / 50.0)
    jxy, jv = jfast.top_k_corners(jm, js, k, border=border)
    txy, tv = tfast.top_k_corners(torch.from_numpy(np.array(jm)),
                                  torch.from_numpy(np.array(js)), k,
                                  border=border)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(txy.numpy()[tv.numpy()],
                                  np.asarray(jxy)[np.asarray(jv)])


# Level shapes for the multi-level wrappers: a regular pyramid, odd sizes,
# and widths that are no multiple of 4 (the kernels' scalar tail).
LEVEL_SHAPES = {
    "pyramid": [(96, 128), (48, 64), (24, 32), (14, 20)],
    "odd": [(37, 53), (19, 27)],
    "width_not_4": [(40, 70), (20, 35), (14, 17)],
    "one_level": [(33, 46)],
}


def _levels(name):
    return [_image(40 + i, h, w) for i, (h, w) in
            enumerate(LEVEL_SHAPES[name])]


@pytest.mark.parametrize("name", list(LEVEL_SHAPES))
@pytest.mark.parametrize("arc", [9, 10])
def test_detect_levels_matches_jax(name, arc):
    """detect_levels against the JAX package's detect per level (its dense
    `_detect_jnp`, which `detect` runs on the CPU): masks equal, scores
    within 1e-3."""
    levels = _levels(name)
    thresholds = [10, 15, 15, 10][:len(levels)]
    before = dict(tfast.LAUNCHES)
    masks, scores = tfast.detect_levels(
        [torch.from_numpy(l) for l in levels], thresholds, arc)
    assert tfast.LAUNCHES == before
    assert len(masks) == len(scores) == len(levels)
    for lvl, t, m, s in zip(levels, thresholds, masks, scores):
        jm, js = jfast.detect(jnp.asarray(lvl), t, arc)
        assert m.dtype == torch.bool and m.shape == lvl.shape
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0,
                                   atol=SCORE_ATOL)


@pytest.mark.parametrize("name", list(LEVEL_SHAPES))
def test_nonmax_levels_matches_jax(name):
    """The fused rescore + nonmax (plain path) against the JAX package's
    two steps: detect at the level's threshold, detect again at barrier
    10 for the score, nonmax_3x3. Masks equal: both sum the same 16 f32
    terms per pixel in ring order, and a tie is kept by both."""
    levels = _levels(name)
    thresholds = [10, 15, 15, 10][:len(levels)]
    want, cmasks = [], []
    for lvl, t in zip(levels, thresholds):
        jm, _ = jfast.detect(jnp.asarray(lvl), t)
        _, js10 = jfast.detect(jnp.asarray(lvl), 10)
        cmasks.append(torch.from_numpy(np.array(jm)))
        want.append(np.asarray(jfast.nonmax_3x3(jm, js10)))
    got = tfast.nonmax_levels([torch.from_numpy(l) for l in levels], cmasks)
    n_kept = 0
    for g, w, cm in zip(got, want, cmasks):
        np.testing.assert_array_equal(g.numpy(), w)
        assert not (g & ~cm).any()  # a subset of the corners
        n_kept += int(g.sum())
    assert n_kept > 0


@pytest.mark.parametrize("bad", ["count", "dtype", "mask_dtype", "mask_shape",
                                 "strided", "empty"])
def test_level_wrappers_reject_bad_input(bad):
    img = torch.from_numpy(_image(6))
    mask = torch.zeros(img.shape, dtype=torch.bool)
    with pytest.raises(ValueError):
        if bad == "count":
            tfast.detect_levels([img, img], [10])
        elif bad == "dtype":
            tfast.detect_levels([img.double()], [10])
        elif bad == "empty":
            tfast.detect_levels([], [])
        elif bad == "mask_dtype":
            tfast.nonmax_levels([img], [mask.float()])
        elif bad == "mask_shape":
            tfast.nonmax_levels([img], [mask[:, :-1]])
        else:
            tfast.nonmax_levels([img[:, ::2]], [mask[:, ::2]])


def test_make_frame_extras_matches_jax():
    """make_frame_extras of the port (one fused nonmax call in place of
    detect + nonmax_3x3 per level) against the JAX package's on a rendered
    320x240 frame: nonmax masks equal on every level, the same candidate
    positions and validity, Shi-Tomasi scores within 1e-2 relative (box
    sums of squared gradients by a convolution here, a reduce_window
    there), SBI within 1e-4 grey."""
    from visualslam_android_tpu.models import keyframe as jkf
    from visualslam_android_tpu.utils import fixtures as jfix
    from visualslam_android_tpu.utils import synthetic as jsyn
    from visualslam_android_tpu.ops import camera as jcam
    from visualslam_android_tpu_torch.models import keyframe as tkf
    from visualslam_android_tpu_torch.utils import fixtures as tfix

    jcfg, tcfg = jfix.small_config(), tfix.small_config()
    tc = jcfg.tracker
    cam = jcam.make_camera(jcfg.camera.params(), tc.width, tc.height)
    scene = jsyn.make_planar_scene(np.random.default_rng(17))
    R, t = jsyn.look_at_pose((0.1, -0.05, 0.0))
    img = np.asarray(jsyn.render(scene, cam, R, t, (tc.height, tc.width)))
    je = jkf.make_frame_extras(jkf.make_frame(jnp.asarray(img), jcfg), jcfg)
    te = tkf.make_frame_extras(
        tkf.make_frame(torch.from_numpy(img.copy()), tcfg), tcfg)
    for lvl in range(tc.n_levels):
        np.testing.assert_array_equal(te.nonmax_mask[lvl].numpy(),
                                      np.asarray(je.nonmax_mask[lvl]))
        jv = np.asarray(je.cand_valid[lvl])
        tv = te.cand_valid[lvl].numpy()
        assert jv.sum() == tv.sum()
        jxy = {tuple(p) for p in np.asarray(je.cand_xy[lvl])[jv]}
        txy = {tuple(p) for p in te.cand_xy[lvl].numpy()[tv]}
        assert jxy == txy, lvl
        np.testing.assert_allclose(
            np.sort(te.cand_score[lvl].numpy()[tv]),
            np.sort(np.asarray(je.cand_score[lvl])[jv]), rtol=1e-2)
    assert int(te.cand_valid[0].sum()) > 100
    np.testing.assert_allclose(te.sbi_template.numpy(),
                               np.asarray(je.sbi_template), rtol=0, atol=1e-4)
