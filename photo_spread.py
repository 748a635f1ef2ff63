"""Run-to-run spread of chip_smoke.py's real-photo run (phase 16) on the
CUDA card, with the keyframe re-find checked against the pair-list search.

    python3 photo_spread.py [--runs 6]

Runs phase 16 (80 frames of the photograph through SLAMSystem, the same
inputs every run) `--runs` times in one process and prints each run's ATE
as a share of the span, its keyframes and measurements, and whether it
met phase 16's bounds. Every call of mapmaker.refind_in_keyframe (the
re-find of keyframe integration, through _refind_search) also runs
mapmaker.refind_pairs on the same points and keyframe, and the script
prints how many found flags, levels and subpixel flags differ and the
largest uv difference over the points both found. Needs one card.
"""

import argparse
import builtins
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("photo_spread needs a CUDA card")
    import visualslam_android_tpu_torch  # noqa: F401  (sets TF32 off)
    from visualslam_android_tpu_torch.models import map_store, mapmaker, slam
    from visualslam_android_tpu_torch.ops import fast, lie
    from visualslam_android_tpu_torch.utils import ate, synthetic

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = cs.card_line()
    print(card, flush=True)
    fast.build_kernel()

    failures = []
    cs.check = lambda ok, msg: None if ok else failures.append(msg)
    refind = mapmaker.refind_in_keyframe
    diffs = []

    def refind_checked(slam_map, kf_idx, cam, point_mask, config):
        pts, n = slam_map.points, slam_map.points.n_slots
        active = (point_mask & pts.live()
                  & ~map_store.point_observed_in(slam_map.meas, kf_idx))
        a = mapmaker._refind_search(slam_map, kf_idx, cam, active, config)
        b = mapmaker.refind_pairs(
            slam_map, torch.arange(n, device=device),
            torch.full((n,), int(kf_idx), dtype=torch.long, device=device),
            active, cam, config)
        both = a[0] & b[0]
        uv = (float((a[1] - b[1])[both].abs().max()) if bool(both.any())
              else 0.0)
        diffs.append((int((a[0] != b[0]).sum()), int((a[2] != b[2]).sum()),
                      int((a[3] != b[3]).sum()), uv))
        return refind(slam_map, kf_idx, cam, point_mask, config)

    mapmaker.refind_in_keyframe = refind_checked
    shares = []
    for run in range(args.runs):
        failures.clear()
        diffs.clear()
        lines = []
        quiet = builtins.print
        builtins.print = lambda *a, **k: lines.append(" ".join(map(str, a)))
        t0 = time.perf_counter()
        try:
            cs.phase_photo(device, card, fast, slam, synthetic, lie, ate)
        finally:
            builtins.print = quiet
        outcome = next(x for x in lines
                       if x.startswith("real photo: bootstrap"))
        share = float(outcome.split("(")[2].split("%")[0])
        shares.append(share)
        print(f"run {run}: {outcome.split(';')[0]} "
              f"({time.perf_counter() - t0:.1f} s); "
              f"{'bounds met' if not failures else failures}; re-find calls "
              f"{len(diffs)}, found / level / subpixel flags differing "
              f"{sum(d[0] for d in diffs)} / {sum(d[1] for d in diffs)} / "
              f"{sum(d[2] for d in diffs)}, largest uv difference "
              f"{max((d[3] for d in diffs), default=0.0):.3g}  [{card}]",
              flush=True)
    print(f"ATE share of span over {args.runs} runs: min {min(shares)}%, "
          f"max {max(shares)}%, above the {100 * cs.PHOTO_ATE_SHARE}% bound "
          f"{sum(s >= 100 * cs.PHOTO_ATE_SHARE for s in shares)}  [{card}]")


if __name__ == "__main__":
    main()
