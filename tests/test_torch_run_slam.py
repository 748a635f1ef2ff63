"""The port's command line and what it stands on, against the JAX package on
the CPU: the TUM and KITTI loaders, the frame readers (numpy and the C++
runtime's binding), map save / load across the two packages, the stage
timer, and the CLI itself against a direct SLAMSystem run.

Tolerances: loaders, readers and maps are compared exactly (the same
files, the same bytes); PIL, where present, within 1 grey level (it rounds
its luma where libpng truncates); the CLI's report equals the direct run's
in every key but fps (the same frames, seed and configuration through the
same code).
"""

import json
import os
import shutil
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_android_tpu import native_runtime as jnative
from visualslam_android_tpu.config import SLAMConfig as JConfig
from visualslam_android_tpu.models import map_store as jmap
from visualslam_android_tpu.utils import datasets as jdata
from visualslam_android_tpu.utils import serialization as jser
from visualslam_android_tpu_torch import native_runtime as tnative
from visualslam_android_tpu_torch import run_slam
from visualslam_android_tpu_torch.models import slam as tslam
from visualslam_android_tpu_torch.utils import ate, datasets, imageio
from visualslam_android_tpu_torch.utils import profiling, serialization

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
TUM = os.path.join(DATA, "tum_tiny")
KITTI = os.path.join(DATA, "kitti_tiny")
CLI_FRAMES = 20


def test_tum_loader_matches_jax():
    for size, max_frames in (((64, 48), None), ((32, 24), 5)):
        j = jdata.load_tum(TUM, size=size, max_frames=max_frames)
        t = datasets.load_tum(TUM, size=size, max_frames=max_frames)
        assert t.name == j.name and t.size == j.size
        assert t.frames == j.frames and len(t) == len(j) > 0
        np.testing.assert_array_equal(t.timestamps, j.timestamps)
        np.testing.assert_array_equal(t.gt_positions, j.gt_positions)
        np.testing.assert_array_equal(t.gt_quaternions, j.gt_quaternions)


def test_kitti_loader_matches_jax():
    for max_frames in (None, 3):
        j = jdata.load_kitti(KITTI, "00", size=(64, 48),
                             max_frames=max_frames)
        t = datasets.load_kitti(KITTI, "00", size=(64, 48),
                                max_frames=max_frames)
        assert t.name == j.name and t.frames == j.frames and len(t) > 0
        np.testing.assert_array_equal(t.timestamps, j.timestamps)
        np.testing.assert_array_equal(t.gt_positions, j.gt_positions)
        assert t.gt_quaternions is None


def _write_raw_png(path, arr, ctype, depth, chunks):
    """A PNG with unfiltered rows at any bit depth and extra chunks."""
    h = arr.shape[0]
    if depth == 16:
        rows = arr.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth < 8:
        bits = (arr[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    else:
        rows = arr.astype(np.uint8).reshape(h, -1)
    raw = np.hstack([np.zeros((h, 1), np.uint8), rows]).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", arr.shape[1], h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + b"".join(chunk(k, b) for k, b in chunks)
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """The tiny datasets' grey PNGs, and RGB (with and without a gamma
    chunk), palette, 16-bit, 2-bit and PGM / PPM files written here from a
    seed."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(9)
    files = sorted(datasets.load_tum(TUM).frames)[:3] + sorted(
        datasets.load_kitti(KITTI).frames)[:3]
    ramp = (np.add.outer(np.arange(47) * 3, np.arange(61) * 2) % 256)
    rgb = rng.integers(0, 256, (47, 61, 3)).astype(np.uint8)
    rgb[::2, ::3] = ramp[::2, ::3, None]  # some grey pixels among colour
    own = str(d / "own_rgb.png")
    imageio.write_png(own, rgb)
    files.append(own)
    ppm = str(d / "rgb.ppm")
    with open(ppm, "wb") as f:
        f.write(b"P6\n# comment\n61 47\n255\n" + rgb.tobytes())
    pgm = str(d / "deep.pgm")
    with open(pgm, "wb") as f:
        f.write(b"P5 61 47 1000\n"
                + (ramp * 3).astype(">u2").tobytes())
    files += [ppm, pgm]
    for name, chunks, arr, ctype, depth in (
            # An sRGB / gAMA chunk takes libpng's RGB-to-grey through its
            # gamma tables.
            ("raw_gamma_rgb.png", [(b"gAMA", struct.pack(">I", 45455))],
             rgb, 2, 8),
            ("raw_srgb_rgb.png", [(b"sRGB", b"\x00")], rgb, 2, 8),
            ("raw_rgb16.png", [], rng.integers(0, 65536, rgb.shape), 2, 16),
            ("raw_grey16.png", [], rng.integers(0, 65536, ramp.shape), 0, 16),
            ("raw_grey2.png", [], ramp % 4, 0, 2)):
        path = str(d / name)
        _write_raw_png(path, arr, ctype, depth, chunks)
        files.append(path)
    try:
        from PIL import Image
    except ImportError:
        return files, None
    for mode, arr in (("RGB", rgb), ("RGBA", np.dstack([rgb, ramp]))):
        path = str(d / f"pil_{mode}.png")
        Image.fromarray(arr.astype(np.uint8), mode).save(path, optimize=True)
        files.append(path)
    path = str(d / "pil_palette.png")
    Image.fromarray(rgb).quantize(50).save(path)
    files.append(path)
    return files, Image


def test_numpy_reader_and_native_binding_match_jax_native(image_files):
    """decode_image through utils/imageio and through the port's binding of
    the C++ runtime, byte for byte the JAX package's binding of the same
    runtime, at each file's own size and resized up and down; PIL's luma
    within 1 grey level where PIL is present."""
    files, Image = image_files
    for path in files:
        w, h = jnative.image_size(path)
        assert tnative.image_size(path) == (w, h)
        for size in ((w, h), (w * 2 - 3, h + 7), (w // 2 + 1, h // 3)):
            want = jnative.decode_image(path, *size)
            np.testing.assert_array_equal(imageio.decode_image(path, *size),
                                          want, err_msg=f"{path} {size}")
            np.testing.assert_array_equal(tnative.decode_image(path, *size),
                                          want, err_msg=f"{path} {size}")
        # PIL reads no gamma chunk and scales 16 bits its own way: compare
        # the plain 8-bit files only.
        if (Image is not None and path.endswith(".png")
                and "raw_" not in path):
            pil = np.asarray(Image.open(path).convert("L"), np.int32)
            assert np.abs(pil - imageio.read_gray(path)).max() <= 1, path


def test_iter_images_readers_agree():
    """iter_images gives the same f32 frames through either reader, and
    says which one ran."""
    seq = datasets.load_tum(TUM, size=(40, 30))
    info_n, info_p = {}, {}
    native = list(datasets.iter_images(seq, use_native=True, info=info_n))
    plain = list(datasets.iter_images(seq, use_native=False, info=info_p))
    assert info_n["reader"] == "native" and info_p["reader"] == "numpy"
    assert len(native) == len(plain) == len(seq)
    for a, b in zip(native, plain):
        assert a.dtype == np.float32 and a.shape == (30, 40)
        np.testing.assert_array_equal(a, b)
    jax_frames = list(jdata.iter_images(jdata.load_tum(TUM, size=(40, 30))))
    np.testing.assert_array_equal(np.stack(native), np.stack(jax_frames))


def test_blob_checkpoint_crosses_packages(tmp_path):
    sections = {"a": np.arange(10, dtype=np.float32),
                "b": np.ones((3, 4), np.int32)}
    path = str(tmp_path / "x.blob")
    tnative.blob_write(path, sections)
    got = jnative.blob_read(path)
    assert set(got) == set(sections)
    for k, v in sections.items():
        np.testing.assert_array_equal(got[k].view(v.dtype).reshape(v.shape),
                                      v)
    jnative.blob_write(path, sections)
    back = tnative.blob_read(path)
    np.testing.assert_array_equal(back["a"].view(np.float32), sections["a"])


def test_native_scheduler_matches_python():
    """The C++ runtime's scheduler decision equals scheduler_next_py (the
    facade's) and the JAX package's binding on every combination of
    flags."""
    import itertools

    for q, *flags in itertools.product((0, 1, 3), *[(False, True)] * 5):
        want = tnative.scheduler_next_py(q, *flags)
        assert tnative.scheduler_next(q, *flags) == want
        assert jnative.scheduler_next(q, *flags) == want


def _leaves(prefix, obj, out):
    """{key: numpy array} of a map of either package, under save_map's key
    names."""
    if hasattr(obj, "_fields"):
        for name, val in zip(obj._fields, obj):
            _leaves(f"{prefix}{name}.", val, out)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            _leaves(f"{prefix}{name}.", getattr(obj, name), out)
    elif isinstance(obj, tuple):
        for i, val in enumerate(obj):
            _leaves(f"{prefix}{i}.", val, out)
    else:
        out[prefix.rstrip(".")] = np.asarray(obj)
    return out


def _random_jax_map(config, seed):
    """The JAX package's empty map with every array filled from a seed."""
    rng = np.random.default_rng(seed)
    flat = _leaves("", jmap.empty_map(config), {})

    def fill(a):
        if a.dtype == bool:
            return rng.uniform(size=a.shape) < 0.5
        if a.dtype.kind == "i":
            return rng.integers(-5, 300, a.shape).astype(a.dtype)
        return rng.normal(size=a.shape).astype(a.dtype)

    def rebuild(prefix, template):
        if hasattr(template, "_fields"):
            return type(template)(*[rebuild(f"{prefix}{n}.", v) for n, v in
                                    zip(template._fields, template)])
        if isinstance(template, tuple):
            return tuple(rebuild(f"{prefix}{i}.", v)
                         for i, v in enumerate(template))
        return jnp.asarray(fill(flat[prefix.rstrip(".")]))

    return rebuild("", jmap.empty_map(config))


def test_map_save_load_crosses_packages(tmp_path):
    """A map saved by the JAX package loads in the port with every array
    equal (dtype and shape too) and the same configuration; the port's save
    of it loads back in the JAX package equal; the text exports are the
    same files."""
    jcfg = JConfig.from_json(run_slam.make_config("small",
                                                  (320, 240)).to_json())
    jm = _random_jax_map(jcfg, 3)
    path_j = str(tmp_path / "jax.npz")
    jser.save_map(path_j, jm, jcfg)
    tm, tcfg = serialization.load_map(path_j, device="cpu")
    assert tcfg.to_json() == jcfg.to_json()
    want = _leaves("", jm, {})
    got = _leaves("", tm, {})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    path_t = str(tmp_path / "port.npz")
    serialization.save_map(path_t, tm, tcfg)
    jm2, jcfg2 = jser.load_map(path_t)
    assert jcfg2 == jcfg
    back = _leaves("", jm2, {})
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert sorted(np.load(path_t).files) == sorted(np.load(path_j).files)

    serialization.export_map_text(str(tmp_path / "t"), tm)
    jser.export_map_text(str(tmp_path / "j"), jm)
    for root, _, names in os.walk(tmp_path / "j"):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), tmp_path / "j")
            with open(os.path.join(root, name)) as a, \
                    open(tmp_path / "t" / rel) as b:
                assert a.read() == b.read(), rel
    with pytest.raises(ValueError):
        bad = dict(np.load(path_t))
        bad["map.points.pos_w"] = bad["map.points.pos_w"][:3]
        np.savez(str(tmp_path / "bad.npz"), **bad)
        serialization.load_map(str(tmp_path / "bad.npz"), device="cpu")


def test_stage_timer_and_trace(tmp_path):
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("a"):
            timer.sync(torch.ones(3), {"x": (torch.zeros(2),)})
    with timer.stage("b"):
        pass
    s = timer.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["a"]["total_s"] >= 0 and s["a"]["max_ms"] >= s["a"]["p50_ms"]
    report = timer.report()
    assert report.splitlines()[0].split()[:2] == ["stage", "count"]
    assert len(report.splitlines()) == 3
    timer.reset()
    assert timer.summary() == {}
    off = profiling.StageTimer(enabled=False)
    with off.stage("a"):
        off.sync(torch.ones(1))
    assert off.summary() == {}
    with profiling.profiler_trace(str(tmp_path / "trace")):
        torch.ones(64).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with profiling.profiler_trace(None):
        pass


def _direct_run(seed, n_frames):
    """What the CLI does, written out: the small preset on the synthetic
    sequence, touches at frames 0 and 6."""
    size = (320, 240)
    images, _, gt, _, _ = datasets.make_synthetic_sequence(
        np.random.default_rng(seed), n_frames=n_frames, size=size,
        device="cpu")
    config = run_slam.make_config("small", size)
    sys_ = tslam.SLAMSystem(config, seed=seed, device="cpu")
    est, used = [], []
    for k, img in enumerate(images):
        if k in (0, 6):
            sys_.on_touch()
        r = sys_.track_frame(img)
        if r.phase == tslam.PHASE_TRACKING and not r.lost:
            est.append((r.pose_R, r.pose_t))
            used.append(gt[r.frame_id])
    rmse, _ = ate.ate_rmse(ate.camera_centers(*zip(*est)), np.asarray(used))
    return {"frames": n_frames, "tracked": len(est),
            "map_points": int(sys_.slam_map.points.count()),
            "keyframes": int(sys_.slam_map.keyframes.count()),
            "ate_rmse": round(rmse, 5)}, sys_


def test_cli_matches_a_direct_run(tmp_path, capsys):
    """run_slam --preset small --device cpu --json on the synthetic
    sequence prints one JSON line whose every key but fps equals a direct
    SLAMSystem run on the same frames; --save-map writes a map that loads
    back equal to the live one; --profile times the facade's stages."""
    path = str(tmp_path / "map.npz")
    report, sys_ = run_slam.main([
        "--dataset", "synthetic", "--frames", str(CLI_FRAMES), "--preset",
        "small", "--device", "cpu", "--json", "--save-map", path,
        "--profile"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == report
    assert any(line.startswith("frame_step") for line in lines)
    assert set(report) == {"frames", "tracked", "fps", "map_points",
                           "keyframes", "ate_rmse", "map_saved"}
    direct, _ = _direct_run(0, CLI_FRAMES)
    assert {k: v for k, v in report.items()
            if k not in ("fps", "map_saved")} == direct
    assert report["tracked"] > CLI_FRAMES // 2 and report["keyframes"] >= 2
    loaded, cfg = serialization.load_map(path, device="cpu")
    assert cfg == sys_.config
    live = _leaves("", sys_.slam_map, {})
    for k, v in _leaves("", loaded, {}).items():
        np.testing.assert_array_equal(v, live[k], err_msg=k)
    stages = sys_.timer.summary()
    assert {"frontend", "bootstrap", "frame_step", "mapmaker",
            "stats_pull", "init_homography", "init_ba5"} <= set(stages)


def test_cli_reads_a_tum_directory(tmp_path):
    """--dataset tum on a copy of tests/data/tum_tiny: the report names the
    reader; --pipeline-depth above 1 is accepted, and its run delivers
    every frame (the trailing ones through flush)."""
    root = tmp_path / "tum"
    shutil.copytree(TUM, root)
    args = ["--dataset", "tum", "--root", str(root), "--width", "64",
            "--height", "48", "--preset", "small", "--device", "cpu",
            "--json"]
    report, _ = run_slam.main(args)
    assert report["frames"] == len(datasets.load_tum(str(root)))
    assert report["reader"] == ("native" if tnative.available() else "numpy")
    deep, sys_ = run_slam.main(args + ["--pipeline-depth", "3"])
    assert sys_.pipelined and sys_.pipeline_depth == 3
    assert deep["frames"] == report["frames"]
    assert deep["reader"] == report["reader"]
    assert not sys_._ctxs and not sys_._result_backlog


def test_cli_default_report_equals_sync(capsys):
    """The default mode (pipelined at depth 1) reports what --sync reports:
    tracked frames, keyframes and ATE (the per-frame lines too, one frame
    later in the loop but the same lines)."""
    args = ["--dataset", "synthetic", "--frames", str(CLI_FRAMES),
            "--preset", "small", "--device", "cpu"]
    piped, sys_piped = run_slam.main(args)
    lines_piped = capsys.readouterr().out.strip().splitlines()
    synced, sys_sync = run_slam.main(args + ["--sync"])
    lines_sync = capsys.readouterr().out.strip().splitlines()
    assert sys_piped.pipelined and not sys_sync.pipelined
    keys = ("frames", "tracked", "map_points", "keyframes", "ate_rmse")
    assert {k: piped[k] for k in keys} == {k: synced[k] for k in keys}
    assert lines_piped[:-1] == lines_sync[:-1]


def test_native_build_failure_falls_back_to_numpy(tmp_path, monkeypatch):
    """Where the C++ runtime does not build (here: a compiler that fails, as
    a machine without libpng's headers does), load() raises
    NativeRuntimeUnavailable carrying the compiler's output, and
    iter_images reads the same frames with numpy and says so."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_error", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho 'fatal error: png.h: No such file'"
                      " >&2\nexit 1\n")
    script.chmod(0o755)
    monkeypatch.setenv("CXX", str(script))
    with pytest.raises(tnative.NativeRuntimeUnavailable, match="png.h"):
        tnative.load()
    assert not tnative.available()
    seq = datasets.load_tum(TUM, size=(40, 30))
    info = {}
    frames = list(datasets.iter_images(seq, info=info))
    assert info["reader"] == "numpy" and "png.h" in info["native_error"]
    np.testing.assert_array_equal(
        np.stack(frames),
        np.stack(list(jdata.iter_images(jdata.load_tum(TUM, size=(40, 30))))))
