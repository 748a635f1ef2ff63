"""Helpers of the per-layer readers that read StageTimer samples."""

import numpy as np


def stage_mean_ms(data, stage):
    xs = data["stages"].get(stage)
    return 1e3 * float(np.mean(xs)) if xs else None


def stage_percentile_ms(data, stage, q):
    xs = data["stages"].get(stage)
    return 1e3 * float(np.percentile(xs, q)) if xs else None
