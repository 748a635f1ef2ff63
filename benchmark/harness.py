"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` does the work on any device (the tests drive it on the CPU);
``main`` is the command line, which insists on the CUDA card. A run:

1. set-up: builds the port's CUDA libraries (the first run of a checkout
   compiles them into the package's ``_build/``), renders the cell's
   frames on the card from the seed, creates ``SLAMSystem`` in the
   configuration's mode, touches and bootstraps, and runs the set-up
   frames;
2. window: hands the path's frames to ``SLAMSystem.track_frame`` one after
   another (closed loop: the next frame goes in when the call returns)
   for ``--seconds``, then ``flush()`` and a synchronisation. With
   ``--trace 1`` the window runs in two segments: torch.profiler alone,
   then the facade's own stage timer alone;
3. check: the program's outputs (poses, map, corners) against the truth
   the benchmark made (``reference/check.py``), once the window has
   closed, the peak memory has been read and the program is freed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import devtrace, traffic
from benchmark.reference import check, geometry

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "visualslam_android_tpu")
PROFILE_MAX_S = 20.0   # the traced run's profiled segment lasts at most this
CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("CUDA_CACHE_PATH", "nv"))
SPAN_ORDER = ("ba_round", "reloc", "frontend", "frame_step", "stats_pull",
              "mapmaker", "track_frame")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def pin_caches(root=ROOT):
    """Every cache the run's libraries may write at a fixed directory
    under ``.bench_cache/`` in the checkout; called before the process
    reaches the card."""
    for var, sub in CACHES:
        os.environ[var] = os.path.join(root, ".bench_cache", sub)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must never
    load, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_spec(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(spec, name, root=ROOT, workload_dir=None):
    """(cell entry, configuration file, workload file) of a cell named in
    BENCHMARK.json: the configuration's file as the entry names it, the
    traffic in workloads/<traffic>.json (or in workload_dir)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    workload = load_json(os.path.join(
        workload_dir or os.path.join(BENCH_DIR, "workloads"),
        cell["traffic"] + ".json"))
    if workload["config"] != cell["config"]:
        raise ValueError(f"workload {cell['traffic']} is for "
                         f"{workload['config']}, the cell for "
                         f"{cell['config']}")
    return cell, config, workload


def metric_reader(name):
    """The read(data) function of metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(spec, cell_name, kind):
    """The entries of BENCHMARK.json's `kind` list that this cell reports."""
    return [m for m in spec[kind]
            if cell_name in m.get("workloads", [cell_name])]


def slam_config(config: dict):
    """The port's SLAMConfig from the configuration file; every field of
    SLAMConfig must be given."""
    from visualslam_android_tpu_torch.config import SLAMConfig

    cfg = SLAMConfig.from_json(json.dumps(config["slam_config"]))
    given = json.loads(json.dumps(dataclasses.asdict(cfg)))
    if given != config["slam_config"]:
        raise ValueError("the configuration file does not give every field "
                         "of SLAMConfig as it is run")
    return cfg


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def is_tracked(result, slam_mod) -> bool:
    """A frame whose pose the user can use: tracking, not lost, quality not
    BAD."""
    return (result.phase == slam_mod.PHASE_TRACKING and not result.lost
            and result.quality != slam_mod.tracker_mod.QUALITY_BAD)


def failed_frames(feed, first, slam_mod) -> int:
    """The window's frames whose answer is wrong for what was handed in: a
    frame with no result, a visible frame not tracked, or a covered frame
    whose result claims a usable pose. A covered frame reported lost is the
    answer the system owes there, not a failure."""
    failed = 0
    for f in range(first, feed.n):
        if f not in feed.results:
            failed += 1
            continue
        tracked = is_tracked(feed.results[f], slam_mod)
        failed += tracked if feed.traffic.blank[f] else not tracked
    return failed


class Feed:
    """Hands the traffic's frames to the facade in order and keeps every
    result it returns, by frame id (the call's index)."""

    def __init__(self, sys_, traffic_: traffic.Traffic):
        self.sys = sys_
        self.traffic = traffic_
        self.n = 0
        self.results = {}
        self.calls_s = []
        self.returned = 0   # results (not placeholders) that calls returned

    def keep(self, results):
        for r in results:
            if r.valid:
                self.results[r.frame_id] = r

    def call(self):
        if self.n in self.traffic.touches:
            self.sys.on_touch()
        img = self.traffic.frame(self.n)
        a = time.perf_counter()
        r = self.sys.track_frame(img)
        self.calls_s.append(time.perf_counter() - a)
        self.n += 1
        self.returned += r.valid
        self.keep([r])
        return r

    def run_until(self, deadline):
        """Calls until the deadline, or until the path's last frame (a
        window cut short so is said on standard error)."""
        n0 = self.n
        while time.perf_counter() < deadline:
            if self.n == len(self.traffic):
                log(f"the path ended after {self.n} calls, before the window")
                break
            self.call()
        return self.n - n0


def profiled_segment(feed, seconds, device, slam_mod, fstep, relocalizer,
                     scatter):
    """Drive the facade for `seconds` under torch.profiler (the CUDA
    activity alone) with the benchmark's host spans and a record of every
    segmented-sum launch; returns (a function that reads the trace into a
    DeviceSummary, the segmented-sum launches)."""
    from torch.profiler import ProfilerActivity, profile

    sys_ = feed.sys
    spans = devtrace.HostSpans(SPAN_ORDER)
    launches = []
    seg_sum = scatter.segmented_sum

    def counted_sum(out, plan, src):
        before = scatter.LAUNCHES["segmented_sum"]
        res = seg_sum(out, plan, src)
        if scatter.LAUNCHES["segmented_sum"] > before:
            launches.append((plan.row_start, int(out[0].numel())))
        return res

    saved = dict(frame_step=fstep.frame_step, ba_round=fstep.ba_round,
                 bootstrap_frontend=fstep.bootstrap_frontend,
                 attempt=relocalizer.attempt_recovery)
    fstep.frame_step = spans.wrap("frame_step", fstep.frame_step)
    fstep.ba_round = spans.wrap("ba_round", fstep.ba_round)
    fstep.bootstrap_frontend = spans.wrap("frontend",
                                          fstep.bootstrap_frontend)
    relocalizer.attempt_recovery = spans.wrap("reloc",
                                              relocalizer.attempt_recovery)
    sys_._mapmaker_step = spans.wrap("mapmaker", sys_._mapmaker_step)
    sys_._read_stats = spans.wrap("stats_pull", sys_._read_stats)
    scatter.segmented_sum = counted_sum
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    track = sys_.track_frame
    sys_.track_frame = spans.wrap("track_frame", track)
    try:
        with profile(activities=activities) as prof:
            calib = time.perf_counter_ns()
            sync(device)
            t0 = time.perf_counter_ns()
            frames = feed.run_until(time.perf_counter() + seconds)
            sync(device)
            t1 = time.perf_counter_ns()
    finally:
        fstep.frame_step = saved["frame_step"]
        fstep.ba_round = saved["ba_round"]
        fstep.bootstrap_frontend = saved["bootstrap_frontend"]
        relocalizer.attempt_recovery = saved["attempt"]
        scatter.segmented_sum = seg_sum
        for name in ("_mapmaker_step", "_read_stats", "track_frame"):
            del sys_.__dict__[name]
    device_type = (torch.autograd.DeviceType.CUDA if cuda
                   else torch.autograd.DeviceType.CPU)

    def summary():
        """Read the trace; after the window, so it takes none of it."""
        return devtrace.summarise(prof.profiler.kineto_results.events(),
                                  device_type, (t0, t1),
                                  calib if cuda else None, spans, frames)

    return summary, launches


def segsum_work(launches):
    """(n_kept, n_hit_rows, n_rows, width) of each recorded segmented-sum
    launch, read from its plan's row bounds once the segment is over."""
    if not launches:
        return []
    uniq = {}
    for row_start, _ in launches:
        uniq.setdefault(id(row_start), row_start)
    keys = list(uniq)
    stats = torch.stack([torch.stack([
        uniq[k][-1].long(), (uniq[k][1:] > uniq[k][:-1]).sum()])
        for k in keys]).cpu().numpy()
    by_id = {k: (int(a), int(b)) for k, (a, b) in zip(keys, stats)}
    return [(*by_id[id(rs)], rs.shape[0] - 1, width)
            for rs, width in launches]


def staged_segment(feed, seconds, device, fstep, bundle, profiling):
    """Drive the facade for `seconds` with its own stage timer on and a
    benchmark span around each bundle-adjustment round, ended by a
    synchronisation; returns (stage samples, [(seconds, LM iterations)])."""
    sys_ = feed.sys
    ba_round = fstep.ba_round
    ba = []

    def timed_round(*args, **kwargs):
        sync(device)
        before = bundle.HOST_READS["bundle_adjust"]
        t0 = time.perf_counter()
        out = ba_round(*args, **kwargs)
        sync(device)
        ba.append((time.perf_counter() - t0,
                   bundle.HOST_READS["bundle_adjust"] - before))
        return out

    sys_.timer = profiling.StageTimer(enabled=True)
    fstep.ba_round = timed_round
    try:
        feed.run_until(time.perf_counter() + seconds)
    finally:
        fstep.ba_round = ba_round
        sys_.timer.enabled = False
    return dict(sys_.timer.samples), ba


@contextlib.contextmanager
def recorded_extras(kf_mod, kept):
    """While open, keep (level-0 image, nonmax masks) of every keyframe
    the program makes: the output of ``fast_nonmax_levels``, which
    ``keyframe.make_frame_extras`` launches once per keyframe."""
    make = kf_mod.make_frame_extras

    def recorded(frame, config):
        extras = make(frame, config)
        kept.append((frame.pyramid[0], extras.nonmax_mask))
        return extras

    kf_mod.make_frame_extras = recorded
    try:
        yield kept
    finally:
        kf_mod.make_frame_extras = make


def handed_in(traffic_, img):
    """The benchmark's own frame that the program's level-0 image `img`
    is, or None."""
    for frame in traffic_.frames:
        if frame.data_ptr() == img.data_ptr() and frame.shape == img.shape:
            return frame
    for frame in traffic_.frames:
        if torch.equal(frame, img):
            return frame
    return None


def program_outputs(sys_, feed, first, slam_mod, extras):
    """What the check judges, copied to the host (the frames' FAST output
    stays on the device): the window's results, the map, the corner
    masks of the window's keyframes and of the last frame, and the nonmax
    masks of the keyframes the window made (`extras`, from
    recorded_extras; None for a frame that is not one of the benchmark's
    own)."""
    t = feed.traffic
    window = range(first, feed.n)
    m = sys_.slam_map
    pts, kfs, meas = m.points, m.keyframes, m.meas
    live = pts.valid & ~pts.bad
    kf_ok = kfs.valid[meas.kf.long().clamp(0, kfs.valid.shape[0] - 1)]
    mvalid = meas.valid & live[:, None] & kf_ok & (meas.kf >= 0)
    point_idx, obs_idx = torch.nonzero(mvalid, as_tuple=True)
    out = dict(
        points_w=pts.pos_w[live].double().cpu().numpy(),
        points_w_all=pts.pos_w.double().cpu().numpy(),
        kf_R=kfs.R.double().cpu().numpy(),
        kf_t=kfs.t.double().cpu().numpy(),
        meas_point=point_idx.cpu().numpy(),
        meas_kf=meas.kf[point_idx, obs_idx].long().cpu().numpy(),
        meas_uv=meas.uv[point_idx, obs_idx].double().cpu().numpy(),
        meas_level=meas.level[point_idx, obs_idx].cpu().numpy(),
        n_keyframes=int(kfs.valid.sum()),
    )
    # Keyframe slots fill in order from the queue, which takes the frames
    # whose result says added_keyframe, in frame order; slots 0 and 1 are
    # the bootstrap's.
    added = sorted(fid for fid, r in feed.results.items()
                   if r.added_keyframe)
    kf_fids = (sorted(t.touches)[:2] + added)[:out["n_keyframes"]]
    out["kf_fids"] = kf_fids
    out["kf_image_mismatch"] = sum(
        not torch.equal(kfs.pyramid[0][slot], t.frame(fid))
        for slot, fid in enumerate(kf_fids))
    fast_frames = []
    for slot, fid in enumerate(kf_fids):
        if fid >= first:
            fast_frames.append((t.frame(fid),
                                [lvl[slot] for lvl in kfs.corner_mask],
                                None))
    last = sys_._prev_frame
    if last is not None and feed.n > first:
        fast_frames.append((t.frame(feed.n - 1), list(last.corner_mask),
                            list(last.corner_score)))
    out["fast_frames"] = fast_frames
    out["nonmax_frames"] = [(handed_in(t, img), list(masks))
                            for img, masks in extras]
    tracked = [f for f in window if f in feed.results
               and is_tracked(feed.results[f], slam_mod) and not t.blank[f]]
    out["tracked"] = tracked
    out["est_R"] = np.asarray([feed.results[f].pose_R for f in tracked],
                              np.float64).reshape(-1, 3, 3)
    out["est_t"] = np.asarray([feed.results[f].pose_t for f in tracked],
                              np.float64).reshape(-1, 3)
    return out


def judge_outputs(out, feed, first, config, workload):
    """The numbers of the check, and (correct, checks)."""
    t = feed.traffic
    tc = config["slam_config"]["tracker"]
    cam = geometry.Camera.from_params(
        [config["slam_config"]["camera"][k] for k in
         ("fx", "fy", "cx", "cy", "w")], tc["width"], tc["height"])
    tracked = out["tracked"]
    ate_pct, sim = check.trajectory_numbers(
        out["est_R"], out["est_t"], t.truth_R[tracked], t.truth_t[tracked])
    frames = out["fast_frames"]
    mismatch, score_err = check.fast_numbers(
        [(img, masks, scores or [None] * len(masks))
         for img, masks, scores in frames], tc["fast_thresholds"])
    nonmax_mismatch, nonmax_tie_gap = check.nonmax_numbers(
        out["nonmax_frames"], tc["fast_thresholds"])
    visible = [f for f in range(first, feed.n) if not t.blank[f]]
    numbers = dict(
        ate_pct=ate_pct,
        kf_image_mismatch=float(out["kf_image_mismatch"]),
        map_plane_pct=check.map_plane_pct(out["points_w"], sim,
                                          config["scene"]["depth_m"]),
        reproj_px=check.reprojection_px(
            cam, out["kf_R"], out["kf_t"], out["points_w_all"],
            out["meas_point"], out["meas_kf"], out["meas_uv"],
            out["meas_level"]),
        fast_mismatch=float(mismatch) if frames else math.inf,
        fast_score_err=score_err,
        nonmax_mismatch=nonmax_mismatch,
        nonmax_tie_gap=nonmax_tie_gap,
        tracked_pct=100.0 * len(tracked) / max(len(visible), 1),
        covered_frames=float(feed.n - first - len(visible)),
        map_points=float(len(out["points_w"])),
        measurements=float(len(out["meas_point"])),
        fast_frames=float(len(frames)),
        nonmax_frames=float(len(out["nonmax_frames"])),
    )
    correct, checks = check.judge(numbers, workload["limits"])
    return numbers, correct, checks


def card_power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


@dataclasses.dataclass
class Run:
    """One driven run of a cell: what the result line and the check are
    made from."""
    spec: dict
    cell_name: str
    config: dict
    workload: dict
    cfg: object
    feed: Feed
    first: int              # the window's first call
    out: dict               # program_outputs
    attempted: int
    failed: int
    returned: int
    setup_s: float
    window_s: float
    calls_s: list
    device: dict            # the line's "device", before the trace's keys
    trace: dict = None      # the per-layer readers' data (--trace 1)
    summary: object = None  # devtrace.DeviceSummary (--trace 1)


def drive(cell_name: str, seed: int, seconds: float, trace: int, device,
          t_start: float, spec=None, root=ROOT, workload_dir=None) -> Run:
    """Set-up, the window and the program's outputs of one run of a cell
    on `device`; the program is freed before this returns."""
    from visualslam_android_tpu_torch.models import bundle, relocalizer
    from visualslam_android_tpu_torch.models import frame_step as fstep
    from visualslam_android_tpu_torch.models import keyframe as kf_mod
    from visualslam_android_tpu_torch.models import slam as slam_mod
    from visualslam_android_tpu_torch.ops import fast, scatter
    from visualslam_android_tpu_torch.utils import profiling

    spec = spec if spec is not None else load_spec(root)
    _, config, workload = find_cell(spec, cell_name, root, workload_dir)
    cfg = slam_config(config)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} asked for, and this machine has no "
                               f"CUDA card: the measured path never falls "
                               f"back to the CPU")
        torch.cuda.set_device(device)
        fast.build_kernel()
        scatter.build_kernel()

    # ---- set-up -----------------------------------------------------------
    t_render = time.perf_counter()
    t = traffic.make_traffic(config, workload, seed, device)
    sync(device)
    t_render = time.perf_counter() - t_render
    facade = config["facade"]
    sys_ = slam_mod.SLAMSystem(cfg, seed=seed % (2 ** 63), device=device,
                               pipelined=facade["pipelined"],
                               pipeline_depth=facade["pipeline_depth"])
    feed = Feed(sys_, t)
    for _ in range(t.setup_frames):
        feed.call()
    if sys_.phase != slam_mod.PHASE_TRACKING:
        raise RuntimeError(f"the bootstrap did not finish in the "
                           f"{t.setup_frames} set-up frames")
    first = feed.n
    returned_before = feed.returned
    gc.collect()
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    log(f"set-up {setup_s:.3f} s: {len(t.frames)} frames rendered in "
        f"{t_render:.3f} s, {t.setup_frames} set-up frames; "
        f"{cfg.mapmaker.max_keyframes} keyframe slots, "
        f"{sys_._kf_count_host} keyframes")

    # ---- window -----------------------------------------------------------
    read_trace, seg_launches, stages, ba_spans = None, [], {}, []
    with recorded_extras(kf_mod, []) as extras:
        if trace:
            prof_s = min(seconds / 2.0, PROFILE_MAX_S)
            read_trace, seg_launches = profiled_segment(
                feed, prof_s, device, slam_mod, fstep, relocalizer, scatter)
            stages, ba_spans = staged_segment(feed, seconds - prof_s, device,
                                              fstep, bundle, profiling)
        else:
            feed.run_until(t0 + seconds)
        calls_s = list(feed.calls_s[first:])
        tail = sys_.flush()
        sync(device)
        window_s = time.perf_counter() - t0
    feed.keep(tail)
    # Results returned in the window: those of its calls and of flush().
    returned = feed.returned - returned_before + len(tail)
    attempted = feed.n - first
    failed = failed_frames(feed, first, slam_mod)
    covered = int(t.blank[first:feed.n].sum())

    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window {window_s:.3f} s: {attempted} frames handed in, {returned} "
        f"results returned, {covered} covered, {failed} failed; "
        f"{sys_._kf_count_host} keyframes")

    # ---- the program's outputs, then the program freed -----------------------
    out = program_outputs(sys_, feed, first, slam_mod, extras)
    del sys_, feed.sys, extras
    gc.collect()
    summary = read_trace() if trace else None
    del read_trace
    if cuda:
        torch.cuda.empty_cache()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if cuda:
        card = card_power_limit()
        if card:
            dev["card"] = card
    data = None
    if trace:
        data = dict(stages=stages, ba=ba_spans, device=summary,
                    segsum=segsum_work(seg_launches),
                    frame=(cfg.tracker.height, cfg.tracker.width,
                           cfg.tracker.n_levels))
    return Run(spec=spec, cell_name=cell_name, config=config,
               workload=workload, cfg=cfg, feed=feed, first=first, out=out,
               attempted=attempted, failed=failed, returned=returned,
               setup_s=setup_s, window_s=window_s, calls_s=calls_s,
               device=dev, trace=data, summary=summary)


def result_line(run: Run) -> dict:
    """The result line's object of a driven run: the check, then the
    metrics of the run's kind (the per-layer ones with --trace 1)."""
    numbers, correct, checks = judge_outputs(run.out, run.feed, run.first,
                                             run.config, run.workload)
    line = {"correct": bool(correct), "attempted": run.attempted,
            "failed": run.failed}
    dev = dict(run.device)
    if run.trace is not None:
        metrics = {}
        for m in cell_metrics(run.spec, run.cell_name, "per_layer"):
            value = metric_reader(m["name"])(run.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["metrics"] = metrics
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
        line["device"] = dev
        line["breakdown"] = run.summary.breakdown()
    else:
        values = dict(
            frames_per_s=run.returned / run.window_s,
            frame_ms_p95=float(np.percentile(run.calls_s, 95)) * 1e3
            if run.calls_s else None,
            setup_s=run.setup_s)
        line["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell_metrics(run.spec, run.cell_name, "end_to_end")
            if values.get(m["name"]) is not None}
        line["device"] = dev
    line["numbers"] = {k: v for k, v in numbers.items() if k not in checks}
    line["checks"] = checks
    return line


def run_cell(cell_name: str, seed: int, seconds: float, trace: int, device,
             t_start: float, spec=None, root=ROOT,
             workload_dir=None) -> dict:
    """One run of a cell on `device`; returns the result line's object."""
    return result_line(drive(cell_name, seed, seconds, trace, device,
                             t_start, spec, root, workload_dir))


def main(argv, t_start: float) -> int:
    """The command line: one run of one cell on the CUDA card, the result
    as the last line of standard output, the compared numbers beside their
    limits as the last lines of standard error. Exits 2 without a card
    (or with fewer than the cell asks for), 3 if a forbidden package was
    loaded, 1 on any other failure; no result line then."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        spec = load_spec()
        cell = find_cell(spec, args.workload)[0]
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            log(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
                f"machine has {torch.cuda.device_count()}")
            return 2
        line = run_cell(args.workload, args.seed, args.seconds, args.trace,
                        "cuda:0", t_start, spec)
    except Exception:  # noqa: BLE001 - report and fail the run
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"forbidden packages loaded: {bad}")
        return 3
    for name, value in line["numbers"].items():
        log(f"number {name}: {value}")
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']} limit {c['limit']}")
    log(f"correct: {line['correct']}")
    print(json.dumps(line), flush=True)
    return 0
