"""Tukey M-estimator: MAD-based sigma and weights.

Port of the parts of the JAX package's ``ops/mestimator.py`` the tracker
uses (the reference's jni/MEstimator.h:13-77). Inputs are *squared*
errors, as in the reference. The median is taken over a fixed-shape
tensor plus a validity mask with one sort.
"""

from __future__ import annotations

import torch

TUKEY = "tukey"

_SIGMA_MULT = {TUKEY: 4.6851}


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


def find_sigma_squared(err_sq, mask, estimator=TUKEY):
    """MAD-based sigma^2 (MEstimator.h:67-77):
    sigma = mult * 1.4826 * (1 + 5/(2n - 6)) * sqrt(median(err^2))."""
    med, n = masked_median_of_squares(err_sq, mask)
    nf = torch.clamp(n.to(err_sq.dtype), min=4.0)  # guard 2n-6 > 0
    sigma = 1.4826 * (1.0 + 5.0 / (2.0 * nf - 6.0)) * torch.sqrt(med)
    sigma = _SIGMA_MULT[estimator] * sigma
    return sigma * sigma


def weight(err_sq, sigma_sq, estimator=TUKEY):
    """Tukey weight (MEstimator.h:48-55, squared)."""
    if estimator != TUKEY:
        raise ValueError(f"only {TUKEY!r} is ported, got {estimator!r}")
    w = torch.where(err_sq > sigma_sq, 0.0, 1.0 - err_sq / sigma_sq)
    return w * w
