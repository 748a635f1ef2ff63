"""Parity of the port's FAST detector with the JAX package.

On the CPU the port's ``detect`` runs its plain PyTorch version
``detect_reference`` (the CUDA kernel runs only on a GPU; chip_smoke.py
holds it against detect_reference there). detect_reference is held here
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
    before = tfast.KERNEL_LAUNCHES
    m, s = tfast.detect(img, 10)
    rm, rs = tfast.detect_reference(img, 10)
    assert torch.equal(m, rm) and torch.equal(s, rs)
    assert tfast.KERNEL_LAUNCHES == before  # no kernel on the CPU


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
