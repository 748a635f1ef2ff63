"""Peaks of the card and the least time of a kernel's work.

The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32
outside the tensor cores. A share of the roofline is the least time the
card could take for the work (the larger of bytes over the memory rate
and operations over the float32 rate) over the device time measured. The
card's power limit is reported beside every share, since a card set below
700 W runs slower under load.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

# FAST-10 (fast_levels_kernel): per pixel of every pyramid level, an f32
# read and a bool and an f32 write; 131 f32 operations (16 ring terms of
# 2 compares, 2 subtractions, 2 max and 2 adds; hi, lo and the final max).
FAST_BYTES_PER_PIXEL = 9
FAST_OPS_PER_PIXEL = 131


def least_s(n_bytes: float, n_ops: float = 0.0) -> float:
    return max(n_bytes / H100_BYTES_PER_S, n_ops / H100_F32_OPS_PER_S)


def pyramid_pixels(height: int, width: int, n_levels: int) -> int:
    return sum((height >> lvl) * (width >> lvl) for lvl in range(n_levels))


def fast_levels_least_s(height: int, width: int, n_levels: int) -> float:
    """Least time of one FAST launch over the frame's pyramid."""
    px = pyramid_pixels(height, width, n_levels)
    return least_s(FAST_BYTES_PER_PIXEL * px, FAST_OPS_PER_PIXEL * px)


def segsum_bytes(n_kept: int, n_hit_rows: int, n_rows: int,
                 width: int) -> int:
    """Least bytes of one segmented sum out[r] += sum of src over row r's
    kept terms, F = width f32 values a row: the kept terms' values and
    their index in the plan's order (4 B) read once; the row bounds
    (n_rows + 1 int32) read once; each row that takes terms read and
    written once. Rows without terms need no traffic."""
    return (n_kept * (width * 4 + 4) + (n_rows + 1) * 4
            + 2 * n_hit_rows * width * 4)


def segsum_least_s(n_kept: int, n_hit_rows: int, n_rows: int,
                   width: int) -> float:
    """One addition a kept value: far under the memory time."""
    return least_s(segsum_bytes(n_kept, n_hit_rows, n_rows, width),
                   n_kept * width)
