"""Robust M-estimators: Tukey, Cauchy, Huber, LeastSquares.

Port of the JAX package's ``ops/mestimator.py`` (the reference's
jni/MEstimator.h:13-155): MAD-based sigma (x4.6851 for Tukey and Cauchy,
x1.345 for Huber), weights, square-root weights and objective scores.
Inputs are *squared* errors, as in the reference. The median is taken over
a fixed-shape tensor plus a validity mask with one sort. The histogram form
of the sigma (``find_sigma_squared_hist``, for point shards across devices)
is not ported.
"""

from __future__ import annotations

import torch

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
