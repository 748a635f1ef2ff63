"""Readings for the limits of ``correct``: a cell's check numbers over
many seeds, for the program as it runs, for its controls and for faults
planted in it, in one process (set-up is paid per seed, imports and the
CUDA start once).

    python benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds 11,12,13 [--tf32 | --fault <name>] [--out <file>]

Prints JSON lines per seed (the seed, the control, correct, the numbers
and the end-to-end metrics): without an option the program's own and,
judged from the same outputs, those of the controls in CONTROLS; with
--tf32 the program's with TF32 products; with --fault the program's with
that fault of FAULTS planted. The benchmark's own runs never run a
control or a fault; see PERF.md for the readings and the limits set from
them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import fast as ref_fast  # noqa: E402

CONTROLS = ("state_bf16", "fast_bf16")


def controlled(out, control, thresholds):
    """The program's outputs as a control gives them: "state_bf16", the
    poses, the map's points and its keyframe poses held in bfloat16 (the
    precision below the float32 of the configuration); "fast_bf16", the
    FAST segment test and the keyframes' nonmax run in bfloat16 in the
    program's place."""
    out = dict(out)
    if control == "state_bf16":
        for key in ("est_R", "est_t", "points_w", "points_w_all", "kf_R",
                    "kf_t"):
            out[key] = torch.from_numpy(out[key]).to(
                torch.bfloat16).double().numpy()
    elif control == "fast_bf16":
        out["fast_frames"] = [
            (img, *map(list, zip(*ref_fast.corners(img, thresholds,
                                                   torch.bfloat16))))
            for img, _, _ in out["fast_frames"]]
        out["nonmax_frames"] = [
            (img, None if img is None else
             [kept for kept, _ in ref_fast.nonmax(img, thresholds,
                                                  dtype=torch.bfloat16)])
            for img, _ in out["nonmax_frames"]]
    else:
        raise ValueError(f"unknown control {control!r}")
    return out


@contextlib.contextmanager
def tf32():
    """The program's matrix products and convolutions in TF32 while open:
    the precision below the float32 its configuration states (the port
    turns TF32 off when it is imported)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _pose_in_stats(out, R, t):
    from visualslam_android_tpu_torch.models import frame_step as fstep

    stats = out.stats.clone()
    stats[fstep.STAT_POSE_R:fstep.STAT_POSE_R + 9] = R.reshape(-1)
    stats[fstep.STAT_POSE_T:fstep.STAT_POSE_T + 3] = t
    return stats


def state_unchanged(patch):
    """The tracking step hands back the pose it started from."""
    from visualslam_android_tpu_torch.models import frame_step as fstep

    step = fstep.frame_step

    def frozen(img, slam_map, cam, R, t, *args, **kwargs):
        out = step(img, slam_map, cam, R, t, *args, **kwargs)
        return out.replace(R=R, t=t, stats=_pose_in_stats(out, R, t))

    patch(fstep, "frame_step", frozen)


def half_left_out(patch):
    """FAST flags corners in the top half of each level only."""
    from visualslam_android_tpu_torch.ops import fast

    detect = fast.detect_levels

    def half(levels, thresholds, arc_length=10):
        masks, scores = detect(levels, thresholds, arc_length)
        cut = []
        for m in masks:
            m = m.clone()
            m[m.shape[0] // 2:] = False
            cut.append(m)
        return tuple(cut), scores

    patch(fast, "detect_levels", half)


def answer_altered(patch):
    """Every third tracked frame reports its pose moved sideways."""
    from visualslam_android_tpu_torch.models import frame_step as fstep

    step = fstep.frame_step
    calls = [0]

    def altered(*args, **kwargs):
        out = step(*args, **kwargs)
        calls[0] += 1
        if calls[0] % 3:
            return out
        t = out.t + torch.tensor([1.0, 0.0, 0.0], device=out.t.device)
        return out.replace(stats=_pose_in_stats(out, out.R, t))

    patch(fstep, "frame_step", altered)


def ba_unchanged(patch):
    """Bundle adjustment hands back the map it was given, converged."""
    from visualslam_android_tpu_torch.models import frame_step as fstep

    def skipped(slam_map, newest_kf, never_retry, failure_mask, *args,
                **kwargs):
        yes = torch.ones((), dtype=torch.bool,
                         device=slam_map.points.pos_w.device)
        return slam_map, failure_mask, never_retry, yes, yes

    patch(fstep, "ba_round", skipped)


def nonmax_skipped(patch):
    """The keyframe's nonmax keeps every corner (no suppression)."""
    from visualslam_android_tpu_torch.ops import fast

    def every(levels, corner_masks, barrier=10):
        return tuple(m.clone() for m in corner_masks)

    patch(fast, "nonmax_levels", every)


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out,
                                  answer_altered, ba_unchanged,
                                  nonmax_skipped)}


@contextlib.contextmanager
def planted(name):
    """The fault FAULTS[name] planted in the port while open."""
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    FAULTS[name](patch)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--tf32", action="store_true",
                        help="run the program with TF32 products")
    parser.add_argument("--fault", choices=sorted(FAULTS),
                        help="run the program with this fault planted")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    harness.pin_caches()
    label = "tf32" if args.tf32 else args.fault or "none"
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            ctx = (tf32() if args.tf32 else planted(args.fault)
                   if args.fault else contextlib.nullcontext())
            with ctx:
                run = harness.drive(args.workload, seed, args.seconds, 0,
                                    "cuda:0", time.perf_counter())
            line = harness.result_line(run)
            recs = [{"control": label, "correct": line["correct"],
                     "numbers": dict(line["numbers"], **{
                         k: c["value"] for k, c in line["checks"].items()})}]
            if label == "none":
                for name in CONTROLS:
                    numbers, correct, _ = harness.judge_outputs(
                        controlled(run.out, name,
                                   run.cfg.tracker.fast_thresholds),
                        run.feed, run.first, run.config, run.workload)
                    recs.append({"control": name, "correct": correct,
                                 "numbers": numbers})
            for rec in recs:
                rec = dict(workload=args.workload, seed=seed,
                           attempted=line["attempted"],
                           failed=line["failed"],
                           metrics={k: v["value"] for k, v in
                                    line["metrics"].items()}, **rec)
                print(json.dumps(rec), flush=True)
                if out:
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
