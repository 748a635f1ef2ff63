"""Robust M-estimators: Tukey, Cauchy, Huber, LeastSquares.

Port of the JAX package's ``ops/mestimator.py`` (the reference's
jni/MEstimator.h:13-155): MAD-based sigma (x4.6851 for Tukey and Cauchy,
x1.345 for Huber), weights, square-root weights and objective scores.
Inputs are *squared* errors, as in the reference. The median is taken over
a fixed-shape tensor plus a validity mask with one sort, or read from a
log2 histogram of the squared errors (``find_sigma_squared_hist``, the form
that point shards on several ranks add up: one psum of the histogram).
"""

from __future__ import annotations

import torch

from visualslam_android_tpu_torch.parallel import mesh as mesh_mod

TUKEY = "tukey"
CAUCHY = "cauchy"
HUBER = "huber"
LEAST_SQUARES = "least_squares"

_SIGMA_MULT = {TUKEY: 4.6851, CAUCHY: 4.6851, HUBER: 1.345}


def masked_median_of_squares(err_sq, mask):
    """Median of the valid entries with the reference's index convention:
    sorted element [n/2] (MEstimator.h:73-74). ``torch.median`` takes
    [(n-1)/2], hence the explicit sort and index. Invalid entries sort to
    +inf; returns 0 if nothing is valid."""
    n = torch.sum(mask, dim=-1)
    vals, _ = torch.sort(torch.where(mask, err_sq, torch.inf), dim=-1)
    idx = torch.clamp(n // 2, 0, err_sq.shape[-1] - 1)
    med = torch.gather(vals, -1, idx[..., None])[..., 0]
    return torch.where(n > 0, med, 0.0), n


def find_sigma_squared(err_sq, mask=None, estimator=TUKEY):
    """MAD-based sigma^2 (MEstimator.h:67-77 and per-estimator variants):
    sigma = mult * 1.4826 * (1 + 5/(2n - 6)) * sqrt(median(err^2)); for
    least squares the mean of the valid squared errors."""
    if mask is None:
        mask = torch.ones_like(err_sq, dtype=torch.bool)
    if estimator == LEAST_SQUARES:
        n = torch.sum(mask, dim=-1)
        s = torch.sum(torch.where(mask, err_sq, 0.0), dim=-1)
        return torch.where(n > 0, s / torch.clamp(n, min=1), 0.0)
    med, n = masked_median_of_squares(err_sq, mask)
    nf = torch.clamp(n.to(err_sq.dtype), min=4.0)  # guard 2n-6 > 0
    sigma = 1.4826 * (1.0 + 5.0 / (2.0 * nf - 6.0)) * torch.sqrt(med)
    sigma = _SIGMA_MULT[estimator] * sigma
    return sigma * sigma


def find_sigma_squared_hist(err_sq, mask=None, estimator=TUKEY,
                            axis_name=None, bins=512,
                            log2_lo=-30.0, log2_hi=24.0):
    """MAD sigma^2 from a log2-spaced histogram of the squared errors in
    place of the exact masked median (JAX ``mestimator.py:56-119``).

    The median is sorted element floor(n/2) (MEstimator.h:73-74),
    interpolated uniformly in log2 inside its bin: (log2_hi - log2_lo) /
    bins octaves of resolution, sigma within a few percent. Counts
    accumulate in f32 whatever the input dtype; adding 1.0 is exact below
    2^24, so the counts do not depend on the order of the additions. The
    whole computation stays on the input's device, with no host read.

    axis_name: a ``parallel.mesh.Mesh`` whose ranks each hold a shard of
    the errors. The [bins] histogram (for least squares the (n, s) sums)
    then goes through one psum, so every rank reads the median of all the
    shards; the counts are f32 sums of 1.0, so it equals the unsharded
    one."""
    if axis_name is not None and not isinstance(axis_name, mesh_mod.Mesh):
        raise TypeError(f"axis_name must be a parallel.mesh.Mesh, not "
                        f"{axis_name!r}")
    if mask is None:
        mask = torch.ones_like(err_sq, dtype=torch.bool)
    e = err_sq.reshape(-1)
    m = mask.reshape(-1).to(torch.float32)
    dtype = e.dtype

    if estimator == LEAST_SQUARES:
        n = torch.sum(m)
        s = torch.sum(torch.where(m > 0, e, 0.0).to(torch.float32))
        if axis_name is not None:
            n, s = _psum(axis_name, torch.stack([n, s]))
        return torch.where(n > 0, s / torch.clamp(n, min=1.0),
                           0.0).to(dtype)

    scale = bins / (log2_hi - log2_lo)
    l2 = torch.log2(torch.clamp(e, min=2.0 ** log2_lo))
    idx = torch.clamp(torch.floor((l2 - log2_lo) * scale).long(), 0,
                      bins - 1)
    hist = torch.zeros(bins, dtype=torch.float32,
                       device=e.device).index_add_(0, idx, m)
    if axis_name is not None:
        hist = _psum(axis_name, hist)

    n = torch.sum(hist)
    target = torch.floor(n / 2.0)
    cum = torch.cumsum(hist, 0)
    # First bin whose cumulative count passes the rank (cum is sorted).
    b = torch.clamp(torch.sum(cum <= target), max=bins - 1).reshape(1)
    hist_b = torch.gather(hist, 0, b)[0]
    cum_before = torch.gather(cum, 0, b)[0] - hist_b
    frac = torch.clamp((target + 0.5 - cum_before)
                       / torch.clamp(hist_b, min=1.0), 0.0, 1.0)
    med_log2 = log2_lo + (b[0].to(torch.float32) + frac) / scale
    med = torch.where(n > 0, torch.exp2(med_log2), 0.0)

    nf = torch.clamp(n, min=4.0)
    sigma = 1.4826 * (1.0 + 5.0 / (2.0 * nf - 6.0)) * torch.sqrt(med)
    sigma = _SIGMA_MULT[estimator] * sigma
    return (sigma * sigma).to(dtype)


def _psum(mesh, x):
    """psum over the mesh, counted under the comm model's sigma item."""
    return mesh_mod.psum(mesh, x, site="sigma_gather")


def square_root_weight(err_sq, sigma_sq, estimator=TUKEY):
    if estimator == TUKEY:
        # MEstimator.h:48-55
        return torch.where(err_sq > sigma_sq, 0.0, 1.0 - err_sq / sigma_sq)
    if estimator in (CAUCHY, HUBER):
        return torch.sqrt(weight(err_sq, sigma_sq, estimator))
    return torch.ones_like(err_sq)


def weight(err_sq, sigma_sq, estimator=TUKEY):
    if estimator == TUKEY:
        w = square_root_weight(err_sq, sigma_sq, TUKEY)
        return w * w
    if estimator == CAUCHY:
        # MEstimator.h:85-88
        return 1.0 / (1.0 + err_sq / sigma_sq)
    if estimator == HUBER:
        # MEstimator.h:119-125
        safe = torch.clamp(err_sq, min=1e-30)
        return torch.where(err_sq < sigma_sq, 1.0, torch.sqrt(sigma_sq / safe))
    return torch.ones_like(err_sq)


def objective_score(err_sq, sigma_sq, estimator=TUKEY):
    if estimator == TUKEY:
        # MEstimator.h:57-64 (no sigma^2/6 factor, as in the reference)
        d = 1.0 - err_sq / sigma_sq
        return torch.where(err_sq > sigma_sq, 1.0, 1.0 - d * d * d)
    if estimator == CAUCHY:
        return torch.log1p(err_sq / sigma_sq)
    if estimator == HUBER:
        sigma = torch.sqrt(sigma_sq)
        err = torch.sqrt(torch.clamp(err_sq, min=0.0))
        return torch.where(err_sq < sigma_sq, 0.5 * err_sq,
                           sigma * (err - 0.5 * sigma))
    return err_sq
