"""FAST corner detection: segment test + score and the keyframe's fused
rescore + non-max suppression (CUDA kernels on the GPU), and top-k
candidate selection.

Port of the JAX package's ``ops/fast.py`` and its Pallas kernel
``ops/fast_pallas.py``: FAST-10 as the reference uses it
(``cvCornerFast_10``, jni/vision/cvfast.cpp, called at jni/KeyFrame.cc:32-39),
FAST-9 with ``arc_length=9``, the old-style score (cvfast.cpp:9337-9369)
and 3x3 non-max suppression (cvfast.cpp:9243-9335).

Three wrappers launch the two hand-written kernels of ``csrc/fast.cu`` for
tensors on a CUDA device:

- ``detect_levels``: all pyramid levels of a frame in one launch
  (``make_frame``); plain version ``detect_reference`` per level;
- ``detect_levels_streams``: the same for S frames at once, levels
  [S, H_l, W_l], one launch with the frame in the kernel's grid
  (``make_frames``, the multi-stream front-end; the JAX package's
  ``custom_vmap`` rule of ``_detect_vmappable``); plain version
  ``detect_levels_streams_reference``;
- ``detect``: one image, the same kernel with one level descriptor;
- ``nonmax_levels``: the barrier-10 rescore fused with the 3x3 non-max
  suppression on all levels in one launch (``make_frame_extras``); plain
  version ``nonmax_levels_reference``.

For tensors on the CPU each wrapper runs its plain PyTorch version (the
counterpart of the JAX package's ``_detect_jnp`` and ``nonmax_3x3``).
There is no other path: on the GPU a kernel launches or the wrapper
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from visualslam_android_tpu_torch.ops import cuda_build

# Bresenham circle of radius 3, clockwise; (dx, dy) order as in
# compute_fast_score_old's pointer_dir (cvfast.cpp:9374-9391).
RING_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)

# Kernel launches in this process, by wrapper: each wrapper adds one where
# it has launched its kernel, and nowhere else.
LAUNCHES = {"fast_detect": 0, "fast_detect_levels": 0,
            "fast_nonmax_levels": 0}

# Levels one launch takes (kMaxLevels in csrc/fast.cu); longer pyramids go
# in several launches.
MAX_LEVELS = 4

_SOURCE = "fast.cu"


class _DetectArg(ctypes.Structure):
    """FastDetectArg of csrc/fast.cu."""

    _fields_ = [("img", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("score", ctypes.c_void_p), ("H", ctypes.c_int),
                ("W", ctypes.c_int), ("threshold", ctypes.c_float),
                ("stride", ctypes.c_longlong)]


class _NonmaxArg(ctypes.Structure):
    """FastNonmaxArg of csrc/fast.cu."""

    _fields_ = [("img", ctypes.c_void_p), ("corner", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("H", ctypes.c_int),
                ("W", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(_SOURCE)
    lib.fast_detect_levels.argtypes = [
        ctypes.POINTER(_DetectArg), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.fast_detect_levels.restype = ctypes.c_int
    lib.fast_nonmax_levels.argtypes = [
        ctypes.POINTER(_NonmaxArg), ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.fast_nonmax_levels.restype = ctypes.c_int
    return lib


def build_kernel() -> str:
    """Compile the kernels now (they are otherwise built at first launch);
    returns the library path."""
    return cuda_build.build(_SOURCE)


def _check_image(img, what, ndim=2):
    if img.dtype != torch.float32 or img.dim() != ndim or img.numel() == 0:
        raise ValueError(f"{what} takes non-empty {ndim}-D float32 images, "
                         f"got {img.dtype} {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError(f"{what} takes contiguous images")


def _check_arc(arc_length):
    if not 9 <= arc_length <= 16:
        raise ValueError(f"arc_length must be in 9..16, got {arc_length}")


def _device_of(tensors, what):
    """'cpu' or 'cuda'; every tensor must lie on the same device."""
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, got {device}")
    if any(t.device != device for t in tensors):
        raise ValueError(f"{what} takes tensors of one device")
    return device


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _level_views(buf, levels):
    """Views of the flat buffer `buf`, one per level, in the levels'
    shapes."""
    parts = torch.split(buf, [lvl.numel() for lvl in levels])
    return tuple(part.view(lvl.shape) for part, lvl in zip(parts, levels))


def _launch_levels(name, arg_type, rows, scalars, device, count=None):
    """Launch the library's `name` on the current stream over `rows` (the
    fields of one `arg_type` per level), MAX_LEVELS levels per launch,
    with the arguments `scalars` after the level count, and count each
    launch under `count` (default: `name`)."""
    fn = getattr(_library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for i in range(0, len(rows), MAX_LEVELS):
            chunk = rows[i:i + MAX_LEVELS]
            args = (arg_type * len(chunk))(*[arg_type(*r) for r in chunk])
            _raise_on(fn(args, len(chunk), *scalars, stream), name)
            LAUNCHES[count or name] += 1


def detect(img, threshold, arc_length: int = 10):
    """FAST segment test: (corner_mask [H, W] bool, score [H, W] f32).

    A pixel is a corner iff `arc_length` contiguous ring pixels are all
    brighter than center + threshold or all darker than center - threshold
    (strict); the 3-px border is excluded. The score is the old-style score
    at the same threshold. CUDA tensors go through the kernel, CPU tensors
    through detect_reference.
    """
    _check_image(img, "detect")
    _check_arc(arc_length)
    device = _device_of([img], "detect")
    if device.type == "cpu":
        return detect_reference(img, threshold, arc_length)

    masks, scores = _detect_levels_cuda([img], [threshold], arc_length,
                                        device, count="fast_detect")
    return masks[0], scores[0]


def detect_levels(levels, thresholds, arc_length: int = 10):
    """`detect` on every level of a pyramid with its own threshold:
    (masks, scores), tuples over levels. On a CUDA device all levels (up
    to MAX_LEVELS) go in ONE launch; the masks are views into one buffer,
    and so are the scores."""
    levels = list(levels)
    thresholds = list(thresholds)
    if not levels or len(levels) != len(thresholds):
        raise ValueError("detect_levels takes one threshold per level")
    for lvl in levels:
        _check_image(lvl, "detect_levels")
    _check_arc(arc_length)
    device = _device_of(levels, "detect_levels")
    if device.type == "cpu":
        out = [detect_reference(lvl, t, arc_length)
               for lvl, t in zip(levels, thresholds)]
        return tuple(m for m, _ in out), tuple(s for _, s in out)

    return _detect_levels_cuda(levels, thresholds, arc_length, device,
                               count="fast_detect_levels")


def detect_levels_streams(levels, thresholds, arc_length: int = 10):
    """`detect_levels` on S frames at once (one per camera stream): levels
    [S, H_l, W_l], one threshold per level; (masks, scores), tuples over
    levels of [S, H_l, W_l]. On a CUDA device all frames and levels (up to
    MAX_LEVELS) go in ONE launch, the frame in the kernel's grid; each
    frame's result is the one `detect_levels` gives for it alone."""
    levels = list(levels)
    thresholds = list(thresholds)
    if not levels or len(levels) != len(thresholds):
        raise ValueError("detect_levels_streams takes one threshold per "
                         "level")
    for lvl in levels:
        _check_image(lvl, "detect_levels_streams", ndim=3)
        if lvl.shape[0] != levels[0].shape[0]:
            raise ValueError("detect_levels_streams takes levels of one "
                             "stream count")
    _check_arc(arc_length)
    device = _device_of(levels, "detect_levels_streams")
    if device.type == "cpu":
        return detect_levels_streams_reference(levels, thresholds,
                                               arc_length)
    return _detect_levels_cuda(levels, thresholds, arc_length, device,
                               count="fast_detect_levels")


def detect_levels_streams_reference(levels, thresholds,
                                    arc_length: int = 10):
    """Plain PyTorch detect_levels_streams: detect_reference per frame and
    per level."""
    out = [[detect_reference(frame, t, arc_length) for frame in lvl]
           for lvl, t in zip(levels, thresholds)]
    return (tuple(torch.stack([m for m, _ in lv]) for lv in out),
            tuple(torch.stack([s for _, s in lv]) for lv in out))


def _detect_levels_cuda(levels, thresholds, arc_length, device, count):
    """The detect kernel on CUDA levels ([H, W], or [S, H, W] for S
    frames in one launch), its launches counted under `count`: (masks,
    scores), views into one buffer each."""
    n_frames = levels[0].shape[0] if levels[0].dim() == 3 else 1
    n_pixels = sum(lvl.numel() for lvl in levels)
    masks = _level_views(
        torch.empty(n_pixels, dtype=torch.bool, device=device), levels)
    scores = _level_views(
        torch.empty(n_pixels, dtype=torch.float32, device=device), levels)
    _launch_levels(
        "fast_detect_levels", _DetectArg,
        [(lvl.data_ptr(), m.data_ptr(), s.data_ptr(), *lvl.shape[-2:],
          float(t), lvl.shape[-2] * lvl.shape[-1])
         for lvl, m, s, t in zip(levels, masks, scores, thresholds)],
        (n_frames, int(arc_length)), device, count=count,
    )
    return masks, scores


def nonmax_levels(levels, corner_masks, barrier=10):
    """The keyframe's corner thinning on every level: the old-style score
    at `barrier` (KeyFrame.cc:62) and 3x3 non-max suppression among the
    corners of `corner_masks`, i.e. ``nonmax_3x3(cmask, detect(lvl,
    barrier)[1])`` per level, as a tuple of bool masks. On a CUDA device
    one fused launch covers all levels (up to MAX_LEVELS) and writes only
    the masks; on the CPU it is nonmax_levels_reference."""
    levels = list(levels)
    corner_masks = list(corner_masks)
    if not levels or len(levels) != len(corner_masks):
        raise ValueError("nonmax_levels takes one corner mask per level")
    for lvl, cm in zip(levels, corner_masks):
        _check_image(lvl, "nonmax_levels")
        if (cm.dtype != torch.bool or cm.shape != lvl.shape
                or not cm.is_contiguous()):
            raise ValueError(
                "nonmax_levels takes a contiguous bool corner mask of each "
                f"level's shape, got {cm.dtype} {tuple(cm.shape)} for "
                f"{tuple(lvl.shape)}"
            )
    device = _device_of(levels + corner_masks, "nonmax_levels")
    if device.type == "cpu":
        return nonmax_levels_reference(levels, corner_masks, barrier)

    outs = _level_views(
        torch.empty(sum(lvl.numel() for lvl in levels), dtype=torch.bool,
                    device=device), levels)
    _launch_levels(
        "fast_nonmax_levels", _NonmaxArg,
        [(lvl.data_ptr(), cm.data_ptr(), o.data_ptr(), *lvl.shape)
         for lvl, cm, o in zip(levels, corner_masks, outs)],
        (float(barrier),), device,
    )
    return outs


def nonmax_levels_reference(levels, corner_masks, barrier=10):
    """Plain PyTorch nonmax_levels: a full detect_reference at `barrier`
    for the score map, then nonmax_3x3, per level."""
    return tuple(
        nonmax_3x3(cm, detect_reference(lvl, barrier)[1])
        for lvl, cm in zip(levels, corner_masks)
    )


def _ring_stack(img):
    """[16, H, W] ring-shifted copies, edge-padded."""
    H, W = img.shape
    padded = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    return torch.stack(
        [padded[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
         for dx, dy in RING_OFFSETS]
    )


def detect_reference(img, threshold, arc_length: int = 10):
    """Plain PyTorch FAST (the JAX package's ``_detect_jnp``): 16 shifted
    views, strict threshold tests, a circular AND over arc_length
    consecutive flags, and the old-style score."""
    ring = _ring_stack(img)
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
    corner[:3, :] = False
    corner[-3:, :] = False
    corner[:, :3] = False
    corner[:, -3:] = False
    sp = torch.sum(torch.clamp(ring - hi[None], min=0.0), dim=0)
    sn = torch.sum(torch.clamp(lo[None] - ring, min=0.0), dim=0)
    return corner, torch.maximum(sp, sn)


def nonmax_3x3(corner_mask, score):
    """Non-max suppression over the 8-neighborhood among corners
    (cvfast.cpp:9243-9335): suppressed iff a neighboring corner's score is
    strictly greater."""
    s = torch.where(corner_mask, score, -1.0)
    neigh_max = F.max_pool2d(s[None, None], 3, stride=1, padding=1)[0, 0]
    return corner_mask & (s >= neigh_max)


def corner_count(mask):
    return torch.sum(mask, dtype=torch.int32)


def top_k_corners(mask, score, k: int, border: int = 0):
    """Up to k corners by score: (xy [k, 2] int32, valid [k]). Ties go to
    the lower raster index, as ``lax.top_k`` breaks them. Corners closer
    than `border` to the edge are excluded (KeyFrame.cc:65)."""
    H, W = mask.shape
    s = torch.where(mask, score, -torch.inf)
    if border > 0:
        inb = torch.zeros_like(mask)
        inb[border:H - border, border:W - border] = True
        s = torch.where(inb, s, -torch.inf)
    vals, idx = torch.sort(s.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    xy = torch.stack([idx % W, idx // W], dim=-1).to(torch.int32)
    return xy, vals > -torch.inf
