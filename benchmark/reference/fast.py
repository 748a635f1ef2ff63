"""FAST-10 corners of a frame, written out plainly: the image pyramid
(2x2 block means, jni/KeyFrame.cc:18-23) and the segment test on the
16-pixel ring with the reference's strict thresholds and old-style score
(jni/KeyFrame.cc:32-39, cvfast.cpp), as in the port's plain version
``ops/fast.detect_reference``; and a keyframe's nonmax corners (the
corners re-scored at barrier 10 and thinned to the 3x3 maxima,
jni/KeyFrame.cc:53-62)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

RING_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
BORDER = 3
NONMAX_BARRIER = 10   # the keyframe's rescoring threshold, KeyFrame.cc:62


def half_sample(img):
    """2x2 block mean."""
    H, W = img.shape[-2:]
    x = img[..., : H - H % 2, : W - W % 2]
    x = x.reshape(*x.shape[:-2], H // 2, 2, W // 2, 2)
    return x.mean(dim=(-3, -1))


def pyramid(img, n_levels: int):
    levels = [img]
    for _ in range(n_levels - 1):
        levels.append(half_sample(levels[-1]))
    return levels


def segment_test(img, threshold, arc_length: int = 10):
    """(corner mask, score) of a [H, W] image: a pixel is a corner when
    arc_length consecutive ring pixels are all brighter than it by more
    than threshold, or all darker; pixels within 3 of the edge never are.
    The score is the larger of the summed excesses above and below."""
    H, W = img.shape
    padded = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    ring = torch.stack([padded[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
                        for dx, dy in RING_OFFSETS])
    hi = img + threshold
    lo = img - threshold
    bright = ring > hi[None]
    dark = ring < lo[None]

    def has_arc(flags):
        acc = flags
        for k in range(1, arc_length):
            acc = acc & torch.roll(flags, -k, dims=0)
        return torch.any(acc, dim=0)

    corner = has_arc(bright) | has_arc(dark)
    corner[:BORDER, :] = False
    corner[-BORDER:, :] = False
    corner[:, :BORDER] = False
    corner[:, -BORDER:] = False
    sp = torch.sum(torch.clamp(ring - hi[None], min=0.0), dim=0)
    sn = torch.sum(torch.clamp(lo[None] - ring, min=0.0), dim=0)
    return corner, torch.maximum(sp, sn)


def corners(img, thresholds, dtype=torch.float32):
    """Per level of the frame's pyramid: (mask, score). dtype: the
    precision the test runs in (bfloat16 for the control)."""
    levels = pyramid(img.to(dtype), len(thresholds))
    return [segment_test(lvl, float(th)) for lvl, th in zip(levels, thresholds)]


def nonmax_3x3(mask, score):
    """(kept, margin): the corners of `mask` that no corner among their 8
    neighbours beats by a strictly greater score (cvfast.cpp:9243-9335),
    and each pixel's score (-1 off the corners) less the largest of its
    neighbours'."""
    H, W = mask.shape
    s = torch.where(mask, score, torch.full_like(score, -1.0))
    padded = F.pad(s[None, None], (1, 1, 1, 1), value=-2.0)[0, 0]
    neigh = torch.stack([padded[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if dy or dx]).amax(0)
    return mask & (s >= neigh), s - neigh


def nonmax(img, thresholds, barrier=NONMAX_BARRIER, dtype=torch.float32):
    """Per level of the frame's pyramid, nonmax_3x3 of the corners at the
    level's threshold under the segment-test score at `barrier`."""
    levels = pyramid(img.to(dtype), len(thresholds))
    return [nonmax_3x3(segment_test(lvl, float(th))[0],
                       segment_test(lvl, float(barrier))[1])
            for lvl, th in zip(levels, thresholds)]
