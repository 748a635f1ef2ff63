"""Parity of the port's patch matching with the JAX package: warp and
search level, warped templates, coarse ZMSSD search and subpixel
refinement, on a small fixed map seen from a moved camera.

The inputs (map, frame pyramid, corner masks, predictions) are made once
from a seed and fed to both packages as numpy. Tolerances: template data
atol 1e-4 (bilinear blends of values up to 255 in another order), `bad`
equal; coarse `found` equal on at least 99% of lanes (ZMSSD sums of ~1e6
can reorder near-ties of the argmin), the matched position equal wherever
both found; subpixel positions within 1e-3 px wherever both converged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu.models import tracker as jtracker
from visualslam_android_tpu.ops import camera as jcam
from visualslam_android_tpu.ops import match as jmatch
from visualslam_android_tpu_torch.models import keyframe as tkf
from visualslam_android_tpu_torch.ops import lie as tlie
from visualslam_android_tpu_torch.ops import match as tmatch
from visualslam_android_tpu_torch.utils import fixtures as tfix
from visualslam_android_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def case():
    config = tfix.small_config()
    tc = config.tracker
    sm, cam, scene, (R0, t0), _ = tfix.build_fixed_map(
        config, np.random.default_rng(11), device="cpu"
    )
    mu = torch.tensor([0.03, -0.02, 0.04, 0.01, -0.015, 0.02])
    dR, dt = tlie.se3_exp(mu)
    R, t = tlie.se3_mul(dR, dt, R0, t0)
    img = tsyn.render(scene, cam, R, t, (tc.height, tc.width))
    frame = tkf.make_frame(img, config)

    jc = jcam.Camera(*(jnp.asarray(getattr(cam, f)) for f in jcam.Camera._fields))
    pts, kfs = sm.points, sm.keyframes
    Rn, tn = R.numpy(), t.numpy()
    pc, px, derivs, ok = jtracker.project_points(
        jc, jnp.asarray(pts.pos_w.numpy()), Rn, tn,
        jnp.asarray([tc.width, tc.height], jnp.float32),
    )
    motion_r = pts.pixel_right_w.numpy() @ Rn.T
    motion_d = pts.pixel_down_w.numpy() @ Rn.T
    warp_inv, level, good = jmatch.calc_search_level_and_warp(
        pc, motion_r, motion_d, derivs
    )
    idx = np.nonzero(pts.valid.numpy() & np.asarray(ok) & np.asarray(good))[0]
    assert len(idx) > 100
    return dict(
        frame_pyr=[p.numpy() for p in frame.pyramid],
        frame_mask=[m.numpy() for m in frame.corner_mask],
        kf_pyr=[p.numpy() for p in kfs.pyramid],
        source_kf=pts.source_kf.numpy()[idx],
        source_level=pts.source_level.numpy()[idx],
        center=pts.center.numpy()[idx],
        pc=np.asarray(pc), derivs=np.asarray(derivs),
        motion_r=motion_r, motion_d=motion_d,
        warp_inv=np.asarray(warp_inv)[idx], level=np.asarray(level)[idx],
        pred=np.asarray(px)[idx],
    )


def test_search_level_and_warp(case):
    j = jmatch.calc_search_level_and_warp(
        case["pc"], case["motion_r"], case["motion_d"], case["derivs"]
    )
    t = tmatch.calc_search_level_and_warp(
        _t(case["pc"]), _t(case["motion_r"]), _t(case["motion_d"]),
        _t(case["derivs"]),
    )
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))


def _templates(case):
    args = (case["source_kf"], case["source_level"], case["center"],
            case["warp_inv"], case["level"])
    j = jmatch.make_templates_warped_multilevel(
        tuple(jnp.asarray(p) for p in case["kf_pyr"]),
        *(jnp.asarray(a) for a in args), 5,
    )
    t = tmatch.make_templates_warped_multilevel(
        tuple(_t(p) for p in case["kf_pyr"]), *(_t(a) for a in args), 5,
    )
    return j, t


@pytest.mark.parametrize("field", ["data", "bad", "sums", "h_inv"])
def test_templates(case, field):
    j, t = _templates(case)
    if field == "data":
        np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data),
                                   rtol=0, atol=1e-4)
    elif field == "bad":
        np.testing.assert_array_equal(t.bad.numpy(), np.asarray(j.bad))
        assert (~t.bad.numpy()).sum() > 50
    elif field == "sums":
        np.testing.assert_allclose(t.t_sum.numpy(), np.asarray(j.t_sum),
                                   rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(t.t_sumsq.numpy(), np.asarray(j.t_sumsq),
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(t.h_inv.numpy(), np.asarray(j.h_inv),
                                   rtol=1e-3, atol=1e-7)


def _coarse(case, max_range):
    j_tmpl, _ = _templates(case)
    t_tmpl = tmatch.Templates(*(_t(f) for f in j_tmpl))
    n = len(case["pred"])
    rng = np.random.default_rng(max_range)
    radius = rng.uniform(max_range / 2, max_range, n).astype(np.float32)
    # Perturb predictions so the search has work to do.
    pred = (case["pred"] + rng.normal(0, 2.0, (n, 2))).astype(np.float32)
    active = rng.uniform(size=n) < 0.9
    args = (pred, case["level"], radius, active)
    j = jmatch.find_patch_coarse_multilevel(
        tuple(jnp.asarray(p) for p in case["frame_pyr"]),
        tuple(jnp.asarray(m) for m in case["frame_mask"]), j_tmpl,
        *(jnp.asarray(a) for a in args), max_range=max_range,
    )
    t = tmatch.find_patch_coarse_multilevel(
        tuple(_t(p) for p in case["frame_pyr"]),
        tuple(_t(m) for m in case["frame_mask"]), t_tmpl,
        *(_t(a) for a in args), max_range=max_range,
    )
    return j, t, j_tmpl, t_tmpl, active


@pytest.mark.parametrize("max_range", [10, 30])
def test_coarse_search(case, max_range):
    j, t, *_ = _coarse(case, max_range)
    jf, tf = np.asarray(j.found), t.found.numpy()
    assert jf.sum() > 50
    assert (jf == tf).mean() >= 0.99
    both = jf & tf
    np.testing.assert_array_equal(t.pos_level.numpy()[both],
                                  np.asarray(j.pos_level)[both])


@pytest.mark.parametrize("max_range", [10, 30])
def test_subpix(case, max_range):
    j, _, j_tmpl, t_tmpl, _ = _coarse(case, max_range)
    pos, sel = np.asarray(j.pos_level), np.asarray(j.found)
    js = jmatch.iterate_subpix_multilevel(
        tuple(jnp.asarray(p) for p in case["frame_pyr"]), j_tmpl,
        jnp.asarray(pos), jnp.asarray(case["level"]), jnp.asarray(sel),
        max_iters=8,
    )
    ts = tmatch.iterate_subpix_multilevel(
        tuple(_t(p) for p in case["frame_pyr"]), t_tmpl, _t(pos),
        _t(case["level"]), _t(sel), max_iters=8,
    )
    jc, tc = np.asarray(js.converged), ts.converged.numpy()
    assert jc.sum() > 50
    assert (jc == tc).mean() >= 0.99
    both = jc & tc
    np.testing.assert_allclose(ts.pos_zero.numpy()[both],
                               np.asarray(js.pos_zero)[both], rtol=0,
                               atol=1e-3)
