"""The traffic generator: schedules, paths and frames, at a tiny size on
the CPU, and the renderer and paths against the port's own."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness, traffic
from benchmark.reference import geometry, scene

DATA = os.path.join(os.path.dirname(__file__), "data")


def tiny(width=64, height=48):
    config = harness.load_json(os.path.join(DATA, "tiny_320x240_desk.json"))
    config = json.loads(json.dumps(config))
    config["slam_config"]["tracker"].update(width=width, height=height)
    config["scene"].update(texture_px=[128, 160], n_blobs=20)
    workload = harness.load_json(os.path.join(DATA,
                                              "tiny_desk_occluded.json"))
    workload = dict(workload, calls=60)
    return config, workload


@pytest.mark.parametrize("playback,expect", [
    ("pingpong", [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2]),
    ("once", [0, 1, 2, 3]),
])
def test_schedule_playback(playback, expect):
    w = {"path": {"frames": 4, "playback": playback}, "calls": 11}
    idx, covered = traffic.schedule(w)
    assert idx.tolist() == expect
    assert not covered.any()


def test_schedule_covered_pause_waits():
    w = {"path": {"frames": 100, "playback": "once"}, "calls": 12,
         "pause": {"moving": 3, "paused": 2, "covered": True, "value": 127.0}}
    idx, covered = traffic.schedule(w)
    assert covered.tolist() == [False] * 3 + [True] * 2 + [False] * 3 + \
        [True] * 2 + [False] * 2
    assert idx.tolist() == [0, 1, 2, 2, 2, 3, 4, 5, 5, 5, 6, 7]


def test_frames_from_the_seed():
    config, workload = tiny()
    a = traffic.make_traffic(config, workload, 2 ** 31 + 7, "cpu")
    b = traffic.make_traffic(config, workload, 2 ** 31 + 7, "cpu")
    c = traffic.make_traffic(config, workload, 5, "cpu")
    assert len(a) == workload["calls"]
    assert a.frame(0).shape == (48, 64) and a.frame(0).dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a.frames, b.frames))
    assert not torch.equal(a.frame(3), c.frame(3))
    # The same path, pauses and truth whatever the seed.
    assert np.array_equal(a.order, c.order)
    assert np.array_equal(a.truth_t, c.truth_t)
    blank = int(np.nonzero(a.blank)[0][0])
    assert torch.all(a.frame(blank) == workload["pause"]["value"])
    # The path waits while the lens is covered.
    assert np.array_equal(a.truth_t[blank], a.truth_t[blank - 1])


def test_texture_statistics():
    config, _ = tiny()
    tex = scene.make_texture(config["scene"], 3, "cpu")
    assert tex.shape == (128, 160)
    assert float(tex.min()) >= 0.0 and float(tex.max()) <= 255.0


def test_blur_keeps_a_constant_image():
    img = torch.full((9, 11), 42.0)
    assert torch.allclose(scene.blur(img, 1.0), img)


def test_renderer_against_the_port():
    """The benchmark's renderer and the port's utils/synthetic.render give
    the same frame of the same plane from the same pose."""
    from visualslam_android_tpu_torch.ops import camera as cam_ops
    from visualslam_android_tpu_torch.utils import synthetic

    config, workload = tiny(96, 64)
    sc = dict(config["scene"], texture_px=[256, 256])
    tex = scene.make_texture(sc, 9, "cpu")
    params = [config["slam_config"]["camera"][k]
              for k in ("fx", "fy", "cx", "cy", "w")]
    R, t = scene.path_poses(workload["path"], 7)
    ours = scene.render(tex, sc, geometry.Camera.from_params(params, 96, 64),
                        torch.from_numpy(R).float(),
                        torch.from_numpy(t).float(), 64, 96)
    plane = synthetic.PlanarScene(texture=tex, depth=sc["depth_m"],
                                  px_per_m=sc["px_per_m"])
    cam = cam_ops.make_camera(params, 96, 64, device="cpu")
    for k in range(7):
        theirs = synthetic.render(plane, cam, torch.from_numpy(R[k]).float(),
                                  torch.from_numpy(t[k]).float(), (64, 96))
        assert torch.allclose(ours[k], theirs, atol=2e-2), k


def test_desk_path_is_bench_py_sweep():
    """desk_orbit's path is the port's make_synthetic_sequence sweep
    (bench.py's full-SLAM sequence) pose for pose."""
    from visualslam_android_tpu_torch.utils import datasets

    w = harness.load_json(os.path.join(harness.BENCH_DIR, "workloads",
                                       "desk_orbit.json"))
    R, t = scene.path_poses(w["path"], 120)
    _, poses, _, _, _ = datasets.make_synthetic_sequence(
        np.random.default_rng(0), n_frames=120, size=(40, 24), device="cpu")
    for k in range(0, 120, 7):
        assert np.allclose(R[k], poses[k][0].numpy(), atol=1e-5)
        assert np.allclose(t[k], poses[k][1].numpy(), atol=1e-5)


def test_schedule_hold_keeps_the_camera_still():
    w = {"path": {"frames": 100, "playback": "once"}, "calls": 8,
         "pause": {"moving": 3, "paused": 2, "covered": False,
                   "value": 127.0}}
    idx, covered = traffic.schedule(w)
    assert not covered.any()
    assert idx.tolist() == [0, 1, 2, 2, 2, 3, 4, 5]
