"""FAST corner detection: segment test + score (CUDA kernel on the GPU),
non-max suppression and top-k candidate selection.

Port of the JAX package's ``ops/fast.py`` and its Pallas kernel
``ops/fast_pallas.py``: FAST-10 as the reference uses it
(``cvCornerFast_10``, jni/vision/cvfast.cpp, called at jni/KeyFrame.cc:32-39),
FAST-9 with ``arc_length=9``, the old-style score (cvfast.cpp:9337-9369)
and 3x3 non-max suppression (cvfast.cpp:9243-9335).

``detect`` launches the hand-written kernel ``csrc/fast.cu`` for a tensor
on a CUDA device, and runs ``detect_reference`` (plain PyTorch, the
counterpart of the JAX package's ``_detect_jnp``) for a tensor on the CPU.
There is no other path: on the GPU the kernel launches or ``detect``
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

# Launches of the CUDA kernel in this process (incremented by `detect` on
# every successful launch, and nowhere else).
KERNEL_LAUNCHES = 0

_SOURCE = "fast.cu"


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(_SOURCE)
    fn = lib.fast_detect
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # img, mask, score
        ctypes.c_int, ctypes.c_int,                          # H, W
        ctypes.c_float, ctypes.c_int,                        # threshold, arc
        ctypes.c_void_p,                                     # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def build_kernel() -> str:
    """Compile the kernel now (it is otherwise built at first launch);
    returns the library path."""
    return cuda_build.build(_SOURCE)


def detect(img, threshold, arc_length: int = 10):
    """FAST segment test: (corner_mask [H, W] bool, score [H, W] f32).

    A pixel is a corner iff `arc_length` contiguous ring pixels are all
    brighter than center + threshold or all darker than center - threshold
    (strict); the 3-px border is excluded. The score is the old-style score
    at the same threshold. CUDA tensors go through the kernel, CPU tensors
    through detect_reference.
    """
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError(
            f"detect takes a 2-D float32 image, got {img.dtype} {tuple(img.shape)}"
        )
    if not img.is_contiguous():
        raise ValueError("detect takes a contiguous image")
    if not 9 <= arc_length <= 16:
        raise ValueError(f"arc_length must be in 9..16, got {arc_length}")
    if img.device.type == "cpu":
        return detect_reference(img, threshold, arc_length)
    if img.device.type != "cuda":
        raise ValueError(f"detect runs on cpu or cuda, got {img.device}")

    global KERNEL_LAUNCHES
    H, W = img.shape
    mask = torch.empty((H, W), dtype=torch.bool, device=img.device)
    score = torch.empty((H, W), dtype=torch.float32, device=img.device)
    fn = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), mask.data_ptr(), score.data_ptr(), H, W,
                 float(threshold), int(arc_length), stream)
    if err != 0:
        raise RuntimeError(f"fast_detect launch failed: cudaError_t {err}")
    KERNEL_LAUNCHES += 1
    return mask, score


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
