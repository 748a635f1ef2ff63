"""The plain reference on known cases: alignment, the trajectory and map
numbers, the reprojection, the FAST segment test, the roofline arithmetic,
the device-busy union and the judge."""

import math

import numpy as np
import pytest
import torch

from benchmark import devtrace
from benchmark.reference import ate, check, fast, geometry, roofline


def random_rotation(rng):
    R, _ = geometry.se3_exp(np.concatenate([[0, 0, 0], rng.normal(size=3)]))
    return R


def test_umeyama_recovers_a_similarity():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(20, 3))
    R = random_rotation(rng)
    dst = 2.5 * src @ R.T + [1.0, -2.0, 0.5]
    s, R2, t = ate.umeyama(src, dst)
    assert math.isclose(s, 2.5, rel_tol=1e-9)
    assert np.allclose(R2, R) and np.allclose(t, [1.0, -2.0, 0.5])


def test_orientation_alignment_recovers_a_similarity():
    """Map poses made from world poses by a known similarity: the
    alignment takes it back, also along a straight path."""
    rng = np.random.default_rng(2)
    Q = random_rotation(rng)
    s, c = 0.2, np.array([0.3, -0.1, 4.0])
    truth_R = np.stack([random_rotation(rng) @ np.eye(3) for _ in range(6)])
    truth_c = np.stack([[0.1 * k, 0.0, 0.0] for k in range(6)])
    # Map frame: x_w = s Q x_m + c  =>  R_m = R_w Q, C_m = Q^T (C_w - c) / s
    est_R = truth_R @ Q
    est_c = (truth_c - c) @ Q / s
    s2, Q2, c2 = ate.align_by_orientation(est_R, est_c, truth_R, truth_c)
    assert math.isclose(s2, s, rel_tol=1e-9)
    assert np.allclose(Q2, Q) and np.allclose(c2, c)


def test_trajectory_and_map_numbers_are_zero_when_exact():
    rng = np.random.default_rng(3)
    truth_R = np.stack([random_rotation(rng) for _ in range(5)])
    truth_c = rng.normal(size=(5, 3))
    truth_t = -np.einsum("nij,nj->ni", truth_R, truth_c)
    ate_pct, sim = check.trajectory_numbers(truth_R, truth_t, truth_R,
                                            truth_t)
    assert ate_pct < 1e-9
    pts = np.concatenate([rng.normal(size=(30, 2)), np.full((30, 1), 4.0)],
                         1)
    assert check.map_plane_pct(pts, sim, 4.0) < 1e-9
    pts[:, 2] = 4.4
    assert math.isclose(check.map_plane_pct(pts, sim, 4.0), 10.0,
                        rel_tol=1e-9)


def test_trajectory_with_too_few_frames_fails():
    R = np.stack([np.eye(3)] * 2)
    assert check.trajectory_numbers(R, np.zeros((2, 3)), R,
                                    np.zeros((2, 3)))[0] == math.inf


def test_camera_round_trip_and_the_port():
    from visualslam_android_tpu_torch.config import CameraConfig
    from visualslam_android_tpu_torch.ops import camera as cam_ops

    params = CameraConfig().params()
    cam = geometry.Camera.from_params(params, 800, 480)
    px = torch.tensor([[0.0, 0.0], [400.0, 240.0], [799.0, 479.0],
                       [123.4, 321.0]], dtype=torch.float64)
    assert torch.allclose(cam.project(cam.unproject(px)), px, atol=1e-9)
    port = cam_ops.make_camera(params, 800, 480, device="cpu")
    m = cam.unproject(px).float()
    assert torch.allclose(cam_ops.project(port, m), cam.project(m), atol=1e-3)
    assert torch.allclose(cam_ops.unproject(port, px.float()),
                          cam.unproject(px).float(), atol=1e-6)


def test_reprojection_is_zero_for_exact_measurements():
    rng = np.random.default_rng(4)
    cam = geometry.Camera.from_params((0.84, 1.1, 0.5, 0.47, -0.013), 800,
                                      480)
    kf_R = np.stack([np.eye(3), random_rotation(rng)])
    kf_t = np.array([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0]])
    pts = np.concatenate([rng.uniform(-1, 1, (10, 2)),
                          rng.uniform(3, 5, (10, 1))], 1)
    meas_point = np.repeat(np.arange(10), 2)
    meas_kf = np.tile([0, 1], 10)
    xc = np.einsum("nij,nj->ni", kf_R[meas_kf], pts[meas_point]) + \
        kf_t[meas_kf]
    uv = cam.project(torch.from_numpy(xc[:, :2] / xc[:, 2:])).numpy()
    level = np.zeros(20, np.int64)
    assert check.reprojection_px(cam, kf_R, kf_t, pts, meas_point, meas_kf,
                                 uv, level) < 1e-9
    uv[:, 0] += 4.0
    level[:] = 2
    assert math.isclose(check.reprojection_px(
        cam, kf_R, kf_t, pts, meas_point, meas_kf, uv, level), 1.0,
        rel_tol=1e-9)


def test_segment_test_against_the_port():
    from visualslam_android_tpu_torch.ops import fast as port_fast
    from visualslam_android_tpu_torch.ops import image

    g = torch.Generator().manual_seed(5)
    img = torch.rand(60, 80, generator=g) * 255
    ours = fast.corners(img, (10, 15, 15, 10))
    levels = image.make_pyramid(img, 4)
    for (mask, score), lvl, th in zip(ours, levels, (10, 15, 15, 10)):
        pm, ps = port_fast.detect_reference(lvl, th)
        assert torch.equal(mask, pm) and torch.equal(score, ps)


def test_segment_test_finds_a_bright_spot():
    img = torch.full((20, 20), 100.0)
    img[10, 10] = 200.0
    mask, score = fast.segment_test(img, 10)
    assert bool(mask[10, 10]) and int(mask.sum()) == 1
    assert math.isclose(float(score[10, 10]), 16 * 90.0)


def test_fast_numbers_count_mismatches():
    g = torch.Generator().manual_seed(6)
    img = torch.rand(40, 48, generator=g) * 255
    ref = fast.corners(img, (10, 15))
    masks = [m.clone() for m, _ in ref]
    scores = [s.clone() for _, s in ref]
    assert check.fast_numbers([(img, masks, scores)], (10, 15)) == (0, 0.0)
    masks[0][5, 5] = ~masks[0][5, 5]
    scores[1] = scores[1] + 0.25
    mismatch, err = check.fast_numbers([(img, masks, scores)], (10, 15))
    assert mismatch == 1 and math.isclose(err, 0.25, rel_tol=1e-6)


def test_bf16_segment_test_differs():
    """The control: the segment test in bfloat16 flags other corners on a
    rendered-looking image."""
    g = torch.Generator().manual_seed(7)
    img = torch.rand(64, 64, generator=g) * 255
    f32 = fast.corners(img, (10,))[0][0]
    bf16 = fast.corners(img, (10,), torch.bfloat16)[0][0]
    assert int((f32 != bf16).sum()) > 0


def test_roofline_arithmetic():
    px = roofline.pyramid_pixels(480, 800, 4)
    assert px == 384000 + 96000 + 24000 + 6000
    assert math.isclose(roofline.fast_levels_least_s(480, 800, 4),
                        9 * px / 3.35e12)
    assert roofline.segsum_bytes(100, 10, 50, 6) == \
        100 * 28 + 51 * 4 + 2 * 10 * 24
    assert math.isclose(roofline.segsum_least_s(100, 10, 50, 6),
                        roofline.segsum_bytes(100, 10, 50, 6) / 3.35e12)


def test_busy_union():
    busy, merged = devtrace.busy_union([(0, 10), (5, 12), (20, 25),
                                        (21, 22)])
    assert busy == 17 and merged == [[0, 12], [20, 25]]


class FakeEvent:
    def __init__(self, name, start, dur, device):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


def test_summarise_canned_events():
    """Busy time, launches, kernels by name and idle gaps put down to the
    host span open when each began (the profiler's clock 1,000 ns ahead of
    the host's)."""
    CUDA, CPU = "cuda", "cpu"
    off = 1000
    events = [
        FakeEvent("cudaDeviceSynchronize", 100 + off, 5, CPU),
        FakeEvent("cudaLaunchKernel", 110 + off, 2, CPU),
        FakeEvent("cudaLaunchKernel", 150 + off, 2, CPU),
        FakeEvent("fast_levels_kernel(DetectParams, int)", 200 + off, 50,
                  CUDA),
        FakeEvent("segsum_staged<36>", 300 + off, 100, CUDA),
    ]
    spans = devtrace.HostSpans(["frame_step", "track_frame"])
    spans.spans["track_frame"].append((150, 500))
    spans.spans["frame_step"].append((260, 290))
    s = devtrace.summarise(events, CUDA, (150, 500), 100, spans, frames=2)
    assert s.busy_s == 150e-9 and s.launches == 2 and s.frames == 2
    assert s.window_s == 350e-9
    assert s.kernel_times("fast_levels_kernel") == [50e-9]
    # Gaps: [150, 200) in track_frame; [250, 300) begins in track_frame
    # (frame_step opens at 260); [400, 500) in track_frame.
    assert s.idle_by_label == {"track_frame": pytest.approx(200e-9)}
    b = s.breakdown()
    assert b["device_ops"][0] == ["segsum_staged<36>", 100e-9]
    assert b["idle_gaps"] == [["track_frame", pytest.approx(200e-9)]]


def test_judge():
    ok, checks = check.judge({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 1.5})
    assert not ok and checks["a"] == {"value": 1.0, "limit": 1.0}
    ok, _ = check.judge({"a": 1.0}, {"a": 1.0})
    assert ok
    ok, checks = check.judge({"a": math.inf, "b": None}, {"a": 9, "b": 9})
    assert not ok and checks["a"]["value"] is None
    ok, _ = check.judge({}, {"a": 9})
    assert not ok



def test_nonmax_is_the_ports_plain_nonmax():
    """The frozen nonmax (corners at the level's threshold, barrier-10
    scores, 3x3 maxima) flags what the port's plain version flags."""
    from visualslam_android_tpu_torch.ops import fast as port_fast

    g = torch.Generator().manual_seed(8)
    img = torch.rand(48, 64, generator=g) * 255
    levels = fast.pyramid(img, 2)
    masks = [fast.segment_test(lvl, th)[0] for lvl, th in zip(levels,
                                                              (12, 15))]
    theirs = port_fast.nonmax_levels_reference(levels, masks, 10)
    ours = fast.nonmax(img, (12, 15))
    for (kept, margin), b in zip(ours, theirs):
        assert torch.equal(kept, b)
        assert bool((margin[kept] >= 0).all())
    assert int(ours[0][0].sum()) < int(masks[0].sum())


def test_nonmax_numbers_count_mismatches_and_refuse():
    g = torch.Generator().manual_seed(9)
    img = torch.rand(40, 48, generator=g) * 255
    ref = fast.nonmax(img, (10, 15))
    masks = [kept.clone() for kept, _ in ref]
    assert check.nonmax_numbers([(img, masks)], (10, 15)) == (0.0, 0.0)
    masks[1][4, 4] = ~masks[1][4, 4]
    mismatch, gap = check.nonmax_numbers([(img, masks)], (10, 15))
    assert mismatch == 1.0
    assert gap == abs(float(ref[1][1][4, 4]))
    assert check.nonmax_numbers([], (10, 15))[0] == math.inf
    assert check.nonmax_numbers([(None, masks)], (10, 15))[0] == math.inf
