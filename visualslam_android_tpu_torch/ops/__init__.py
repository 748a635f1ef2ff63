"""Compute ops of the PyTorch port: Lie groups, camera model, robust
estimator, image ops, FAST (CUDA kernel), SBI alignment, patch matching."""
