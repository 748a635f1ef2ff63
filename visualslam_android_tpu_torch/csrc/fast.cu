// FAST segment-test corner detection for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fast_strip_kernel` of the JAX package
// (visualslam_android_tpu/ops/fast_pallas.py, reached through
// `_detect_single` and `ops/fast.py:detect`). Semantics are those of the
// JAX package's dense reference `_detect_jnp` (ops/fast.py), mirrored in
// PyTorch by `detect_reference` (visualslam_android_tpu_torch/ops/fast.py):
//
//   * a pixel is a corner iff `arc_length` circularly contiguous pixels of
//     the 16-pixel Bresenham ring (RING_OFFSETS, clockwise from (0, 3)) are
//     all strictly brighter than center + threshold, or all strictly darker
//     than center - threshold; the 3-px image border is never a corner;
//   * score = max(sum max(v - hi, 0), sum max(lo - v, 0)) over the ring
//     (the reference's old-style score, cvfast.cpp:9337-9369), computed for
//     every pixel. Ring reads clamp to the image, as the reference's edge
//     padding does, so border scores match `detect_reference` too.
//
// What bounds it on the H100: each pixel moves about 8 bytes (one f32
// read, one bool and one f32 write) and costs about 50 compares and adds,
// so the kernel is memory-bound and tiny: a frame's four levels at 800x480
// are about 0.5 M pixels, a few MB of traffic.
//
// What the design does about it: one thread per output pixel in 32x8
// blocks; each block stages its tile plus a 3-px halo in shared memory, so
// every pixel is read from device memory once (plus the halo) and the 16
// ring reads hit shared memory. The 16 comparisons pack into two 16-bit
// masks; the arc test ANDs `arc_length` shifted copies of the doubled word
// (m | m << 16), and a non-zero low half means some start position has a
// full arc. The TPU kernel's 128-row strips, 8-row halo, lane padding and
// vmap rule are layout choices of that machine and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRing = 3;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kTileX = kBlockX + 2 * kRing;
constexpr int kTileY = kBlockY + 2 * kRing;

__device__ __forceinline__ bool has_arc(unsigned m, int arc_length) {
  const unsigned d = m | (m << 16);
  unsigned acc = d;
  for (int k = 1; k < arc_length; ++k) acc &= d >> k;
  return (acc & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
fast_kernel(const float* __restrict__ img, uint8_t* __restrict__ mask,
            float* __restrict__ score, int H, int W, float threshold,
            int arc_length) {
  __shared__ float tile[kTileY][kTileX];

  const int x0 = blockIdx.x * kBlockX - kRing;
  const int y0 = blockIdx.y * kBlockY - kRing;
  for (int i = threadIdx.y * kBlockX + threadIdx.x; i < kTileY * kTileX;
       i += kBlockX * kBlockY) {
    const int ty = i / kTileX;
    const int tx = i - ty * kTileX;
    const int gy = min(max(y0 + ty, 0), H - 1);
    const int gx = min(max(x0 + tx, 0), W - 1);
    tile[ty][tx] = img[(size_t)gy * W + gx];
  }
  __syncthreads();

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= W || y >= H) return;

  // Ring offsets (dx, dy), the order of RING_OFFSETS in ops/fast.py.
  const int dxs[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int dys[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

  const int cx = threadIdx.x + kRing;
  const int cy = threadIdx.y + kRing;
  const float c = tile[cy][cx];
  const float hi = c + threshold;
  const float lo = c - threshold;
  unsigned bright = 0u, dark = 0u;
  float sp = 0.0f, sn = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float v = tile[cy + dys[k]][cx + dxs[k]];
    bright |= static_cast<unsigned>(v > hi) << k;
    dark |= static_cast<unsigned>(v < lo) << k;
    sp += fmaxf(v - hi, 0.0f);
    sn += fmaxf(lo - v, 0.0f);
  }
  const bool inside =
      x >= kRing && y >= kRing && x < W - kRing && y < H - kRing;
  const bool corner =
      inside && (has_arc(bright, arc_length) || has_arc(dark, arc_length));
  const size_t o = (size_t)y * W + x;
  mask[o] = corner ? 1 : 0;
  score[o] = fmaxf(sp, sn);
}

}  // namespace

// Launches the detector on `stream`. img: f32 [H, W] contiguous on the
// device; mask: bool (one byte) [H, W]; score: f32 [H, W]. Returns the
// cudaError_t of the launch (0 on success); never synchronizes.
extern "C" int fast_detect(const float* img, uint8_t* mask, float* score,
                           int H, int W, float threshold, int arc_length,
                           cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  fast_kernel<<<grid, block, 0, stream>>>(img, mask, score, H, W, threshold,
                                          arc_length);
  return static_cast<int>(cudaGetLastError());
}
