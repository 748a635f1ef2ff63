// FAST segment-test corner detection for NVIDIA Hopper (sm_90a): the
// per-frame detector over all pyramid levels in one launch, and the
// keyframe form that fuses the barrier-10 rescore with the 3x3 non-max
// suppression.
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
// What bounds it on the H100: by the rule of bytes and operations, bytes.
// Each pixel moves 9 bytes (one f32 read, one bool and one f32 write) and
// costs about 130 f32 compares, subtractions and adds; a frame's four
// levels at 800x480 are 510,000 pixels, 4.59 MB, 1.37 us at 3.35 TB/s
// against about 1 us of f32 work at 67 TFLOP/s. In practice neither: a
// pixel takes about 150 executed instructions, which is ~3 us on the card's
// 528 warp schedulers, and a launch costs ~2-3 us before the first block
// runs. So the design spends nothing on bandwidth tricks (every read hits
// L2) and everything on executing fewer instructions, in parallel, behind
// one launch.
//
// What the design does about it:
//
//   * fast_levels_kernel, one launch for up to 4 levels of up to 65535
//     frames. The level descriptors travel by value in the kernel's
//     parameters; the grid's x axis is one flat list of 32x32-pixel tiles
//     and a block finds its level from the prefix table of tile counts; the
//     grid's y axis is the frame (the stream, when S camera streams are
//     tracked together): frame s of a level starts s * stride elements
//     after frame 0, in the image, the mask and the score alike. At 800x480
//     that is 515 blocks of 256 threads per frame: one frame's blocks are
//     all resident at once on 132 SMs (<= 64 registers, 4 blocks an SM),
//     four frames' (2060 blocks) make four such waves in one launch, which
//     is what first gives the kernel more work than its launch latency (the
//     JAX package runs a batch through the Pallas kernel's vmap rule, a
//     sequential lax.map of one-frame calls).
//     Narrow tiles waste few lanes on the ragged right edge (800, 400, 200
//     and 100 columns: 1.5% of the lanes idle; 13% with 128-wide tiles).
//   * Each thread owns 4 consecutive x pixels of one row: one float4 score
//     store and one uchar4 mask store, and float4 global loads for every
//     4-pixel group of the tile that lies inside the image (clamped scalar
//     loads for the groups that cross an image edge, or when the width is
//     no multiple of 4); a thread starts all its loads before its first
//     shared store. The 3-px halo makes a 38x38 tile for 32x32 outputs,
//     1.41 reads per pixel, all from L2.
//   * The thread's 4 pixels advance together through the 16 ring positions
//     (ring position outermost): four independent dependency chains, and
//     neighbouring pixels share most ring reads. A first version that ran
//     the pixels one after the other, two rows per thread, was slower than
//     one thread per pixel: the chain per thread, not the bytes, set the
//     time.
//   * Shared memory holds the tile with its columns split into four planes
//     by column mod 4: column c of a row lives at plane (c & 3), slot
//     (c >> 2). A warp spans 4 tile rows of 8 threads; thread t of a row
//     reads column 4t + k for a compile-time k, i.e. 8 consecutive words of
//     one plane, and the row stride (40 words) is 8 modulo the 32 banks, so
//     the warp's 4 rows fall on 4 disjoint groups of 8 banks: no bank
//     conflict on any of the +-3 column reads (row-major, the same reads
//     would be 4 words apart, a 4-way conflict).
//   * A ring flag is the sign bit of a difference the score needs anyway
//     (ring_term below): one funnel shift per flag, no compare. The arc
//     test runs only when at least `arc_length` flags are set, in four
//     doubling steps on the doubled word m | m << 16.
//   * fast_nonmax_kernel, the keyframe form, also one launch for all
//     levels, on the same tiles. Corners are a few percent of the pixels
//     and come in clusters, so a block first lists the corners of its tile
//     and of the 1-px ring around it, then scores the list with its threads
//     side by side (one barrier-10 ring score each, read straight from
//     global memory, L2-resident) into a shared score tile, and last each
//     thread compares its 4 pixels with their 8 neighbours there. It writes
//     the non-max mask only: no score map and no pooling pass go to
//     memory. Both kernels sum the 16 ring terms in the same order with the
//     same operations (no multiply, so no FMA can form), so the fused
//     result equals nonmax(corner mask, score of fast_levels_kernel at
//     barrier 10) bit for bit.
//
// The TPU kernel's 128-row strips, 8-row halo, lane padding and vmap rule
// are layout choices of that machine and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kRing = 3;
constexpr int kTileW = 32;                   // output pixels per tile row
constexpr int kThreads = 256;
constexpr int kThreadsX = kTileW / 4;        // threads per tile row
constexpr int kTileH = kThreads / kThreadsX; // output rows per tile
constexpr int kTileRows = kTileH + 2 * kRing;
constexpr int kGroups = kTileW / 4 + 2;      // four-pixel groups per row
// Slots per column-mod-4 plane of a shared row: at least `slots`, and such
// that the row stride 4 * plane is congruent to kThreadsX modulo the 32
// banks, so the rows a warp spans start kThreadsX banks apart.
constexpr int plane_size(int slots) {
  int p = slots;
  while ((4 * p) % 32 != kThreadsX % 32) ++p;
  return p;
}
constexpr int kPlane = plane_size(kGroups);
constexpr int kRowStride = 4 * kPlane;
// The non-max kernel's score tile: the outputs plus a 1-px ring, in the
// same four-plane layout.
constexpr int kScoreCols = kTileW + 2;
constexpr int kScoreRows = kTileH + 2;
constexpr int kScorePlane = plane_size((kScoreCols + 3) / 4);
constexpr int kScoreStride = 4 * kScorePlane;

// Ring offsets (dx, dy), the order of RING_OFFSETS in ops/fast.py.
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                            0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDy[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                            -3, -3, -2, -1, 0, 1, 2, 3};

struct DetectLevel {
  const float* img;
  uint8_t* mask;
  float* score;
  int H, W;
  float threshold;
  int tiles_x;
  int first_block;  // prefix sum of tile counts
  int vec;          // 1: W % 4 == 0 and the pointers aligned for vectors
  long long stride; // elements from one frame of the level to the next
};

struct DetectParams {
  DetectLevel lv[kMaxLevels];
  int n;
};

struct NonmaxLevel {
  const float* img;
  const uint8_t* corner;
  uint8_t* out;
  int H, W;
  int tiles_x;
  int first_block;  // prefix sum of tile counts
  int vec;          // 1: W % 4 == 0 and the output pointer 4-byte aligned
};

struct NonmaxParams {
  NonmaxLevel lv[kMaxLevels];
  int n;
};

// `m` holds the 16 ring flags in its low half (in ring order or reversed:
// contiguity is the same either way). Doubling steps on the doubled word
// d = m | m << 16: a bit of x8 is set where a run of 8 set flags starts,
// and a run of arc_length (9..16) is two such runs arc_length - 8 apart.
__device__ __forceinline__ bool has_arc(unsigned m, int arc_length) {
  if (__popc(m) < arc_length) return false;
  const unsigned d = m | (m << 16);
  const unsigned x2 = d & (d >> 1);
  const unsigned x4 = x2 & (x2 >> 2);
  const unsigned x8 = x4 & (x4 >> 4);
  return (x8 & (x8 >> (arc_length - 8)) & 0xFFFFu) != 0u;
}

// One ring pixel `v` against the bounds hi = c + t, lo = c - t: shifts the
// two flags (v > hi, v < lo) into `bright` and `dark` and adds the score
// terms. hi - v is negative exactly when v > hi, and -(hi - v) is v - hi
// bit for bit, so the sign bit gives the flag (one funnel shift) and the
// same subtraction gives the score term; likewise v - lo for the dark side.
__device__ __forceinline__ void ring_term(float v, float hi, float lo,
                                          unsigned& bright, unsigned& dark,
                                          float& sp, float& sn) {
  const float bp = hi - v;
  const float bd = v - lo;
  bright = __funnelshift_l(__float_as_uint(bp), bright, 1);
  dark = __funnelshift_l(__float_as_uint(bd), dark, 1);
  sp += fmaxf(-bp, 0.0f);
  sn += fmaxf(-bd, 0.0f);
}

// Word index of column c in a shared row whose planes hold `plane` slots.
__device__ __forceinline__ int plane_slot(int c, int plane) {
  return (c & 3) * plane + (c >> 2);
}

__global__ void __launch_bounds__(kThreads, 4)
fast_levels_kernel(const DetectParams p, const int arc_length) {
  __shared__ float tile[kTileRows * kRowStride];

  // The block's level: the last one whose first block is not after it.
  int li = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < p.n && static_cast<int>(blockIdx.x) >= p.lv[i].first_block) li = i;
  }
  DetectLevel L = p.lv[li];
  // The block's frame: its level's image, mask and score start `stride`
  // elements further on per frame.
  const long long frame = static_cast<long long>(blockIdx.y) * L.stride;
  L.img += frame;
  L.mask += frame;
  L.score += frame;
  const int t = static_cast<int>(blockIdx.x) - L.first_block;
  const int x0 = (t % L.tiles_x) * kTileW;
  const int y0 = (t / L.tiles_x) * kTileH;
  const int H = L.H, W = L.W;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  // Stage the tile: group g of shared row r holds image columns
  // x0 - 4 + 4g .. x0 - 1 + 4g of image row y0 - 3 + r, i.e. tile columns
  // 4g - 1 .. 4g + 2 (tile column c is image column x0 - 3 + c).
  // All of a thread's loads start before its first store, so their
  // latencies overlap.
  constexpr int kStageIters = (kTileRows * kGroups + kThreads - 1) / kThreads;
  float v[kStageIters][4];
#pragma unroll
  for (int it = 0; it < kStageIters; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kGroups;
    const int g = i - r * kGroups;
    const int gy = min(max(y0 - kRing + r, 0), H - 1);
    const int gx = x0 - 4 + 4 * g;
    const float* row = L.img + static_cast<size_t>(gy) * W;
    if (i >= kTileRows * kGroups) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[it][e] = 0.0f;
    } else if (L.vec && gx >= 0 && gx + 3 < W) {
      const float4 q = *reinterpret_cast<const float4*>(row + gx);
      v[it][0] = q.x; v[it][1] = q.y; v[it][2] = q.z; v[it][3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[it][e] = row[min(max(gx + e, 0), W - 1)];
    }
  }
#pragma unroll
  for (int it = 0; it < kStageIters; ++it) {
    const int i = tid + it * kThreads;
    if (i >= kTileRows * kGroups) break;
    const int r = i / kGroups;
    const int g = i - r * kGroups;
    float* srow = tile + r * kRowStride;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * g + e - 1;
      if (c >= 0 && c < kTileW + 2 * kRing) {
        srow[plane_slot(c, kPlane)] = v[it][e];
      }
    }
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int x = x0 + 4 * tx;
  const int y = y0 + threadIdx.y;
  if (y >= H || x >= W) return;

  // The ring again as compile-time values: the loops below unroll, so
  // every shared-memory offset is a constant.
  const int dxs[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int dys[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  // Shared row of ring offset dy is threadIdx.y + 3 + dy; tile column of
  // pixel j at ring offset dx is 4 tx + j + 3 + dx.
  const float* base = tile + (threadIdx.y + kRing) * kRowStride + tx;
  float hi[4], lo[4], sp[4], sn[4];
  unsigned bright[4], dark[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float c = base[plane_slot(j + 3, kPlane)];
    hi[j] = c + L.threshold;
    lo[j] = c - L.threshold;
    sp[j] = sn[j] = 0.0f;
    bright[j] = dark[j] = 0u;
  }
  // Ring position outermost, the thread's four pixels innermost: four
  // independent chains for the scheduler, and neighbouring pixels share
  // most of their ring reads.
#pragma unroll
  for (int k = 0; k < 16; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v =
          base[dys[k] * kRowStride + plane_slot(j + 3 + dxs[k], kPlane)];
      ring_term(v, hi[j], lo[j], bright[j], dark[j], sp[j], sn[j]);
    }
  }
  float sc[4];
  uint8_t mk[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int px = x + j;
    const bool inside =
        px >= kRing && y >= kRing && px < W - kRing && y < H - kRing;
    const bool corner = inside && (has_arc(bright[j], arc_length) ||
                                   has_arc(dark[j], arc_length));
    mk[j] = corner ? 1 : 0;
    sc[j] = fmaxf(sp[j], sn[j]);
  }
  const size_t o = static_cast<size_t>(y) * W + x;
  if (L.vec) {  // W % 4 == 0, so x + 3 < W
    *reinterpret_cast<float4*>(L.score + o) =
        make_float4(sc[0], sc[1], sc[2], sc[3]);
    *reinterpret_cast<uchar4*>(L.mask + o) =
        make_uchar4(mk[0], mk[1], mk[2], mk[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (x + j < W) {
        L.score[o + j] = sc[j];
        L.mask[o + j] = mk[j];
      }
    }
  }
}

// Old-style score of pixel (x, y) at barrier `t`, ring reads clamped to the
// image; the same operations in the same order as fast_levels_kernel.
__device__ float ring_score(const float* __restrict__ img, int H, int W,
                            int x, int y, float t) {
  const float c = img[static_cast<size_t>(y) * W + x];
  const float hi = c + t;
  const float lo = c - t;
  float sp = 0.0f, sn = 0.0f;
  unsigned bright = 0u, dark = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int gy = min(max(y + kDy[k], 0), H - 1);
    const int gx = min(max(x + kDx[k], 0), W - 1);
    ring_term(img[static_cast<size_t>(gy) * W + gx], hi, lo, bright, dark,
              sp, sn);
  }
  return fmaxf(sp, sn);
}

__global__ void __launch_bounds__(kThreads)
fast_nonmax_kernel(const NonmaxParams p, const float barrier) {
  // Barrier score of every corner of the tile and of its 1-px ring; -1
  // where there is no corner (a score is never negative).
  __shared__ float score[kScoreRows * kScoreStride];
  __shared__ uint16_t corner_slot[kScoreRows * kScoreCols];
  __shared__ int n_corners;

  // The block's level: the last one whose first block is not after it.
  int li = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < p.n && static_cast<int>(blockIdx.x) >= p.lv[i].first_block) li = i;
  }
  const NonmaxLevel L = p.lv[li];
  const int t = static_cast<int>(blockIdx.x) - L.first_block;
  const int x0 = (t % L.tiles_x) * kTileW;
  const int y0 = (t / L.tiles_x) * kTileH;
  const int H = L.H, W = L.W;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  // Neighbouring corners fall to neighbouring threads here, so a cluster
  // of corners is scored in parallel, each corner once per tile.
  // Corners come in clusters and are a few percent of the pixels, so the
  // tile's corner slots are first gathered into a list (a thread loads the
  // mask bytes of all its slots before it looks at any, so the latencies
  // overlap), and then the list is scored with the threads side by side:
  // about one ring score per thread in place of one divergent pass per
  // slot a thread owns.
  constexpr int kSlots = kScoreRows * kScoreCols;
  constexpr int kScoreIters = (kSlots + kThreads - 1) / kThreads;
  bool is_corner[kScoreIters];
#pragma unroll
  for (int it = 0; it < kScoreIters; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kScoreCols;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + (i - r * kScoreCols);
    is_corner[it] = i < kSlots && gy >= 0 && gy < H && gx >= 0 && gx < W &&
                    L.corner[static_cast<size_t>(gy) * W + gx] != 0;
  }
  if (tid == 0) n_corners = 0;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kScoreIters; ++it) {
    const int i = tid + it * kThreads;
    if (i >= kSlots) break;
    if (is_corner[it]) {
      corner_slot[atomicAdd(&n_corners, 1)] = static_cast<uint16_t>(i);
    } else {
      const int r = i / kScoreCols;
      score[r * kScoreStride + plane_slot(i - r * kScoreCols, kScorePlane)] =
          -1.0f;
    }
  }
  __syncthreads();
  for (int n = tid; n < n_corners; n += kThreads) {
    const int i = corner_slot[n];
    const int r = i / kScoreCols;
    const int c = i - r * kScoreCols;
    score[r * kScoreStride + plane_slot(c, kScorePlane)] =
        ring_score(L.img, H, W, x0 - 1 + c, y0 - 1 + r, barrier);
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int x = x0 + 4 * tx;
  const int y = y0 + threadIdx.y;
  if (y >= H || x >= W) return;
  // Score-tile column of pixel j at offset dx is 4 tx + j + 1 + dx, its row
  // at offset dy is threadIdx.y + 1 + dy.
  const float* base = score + (threadIdx.y + 1) * kScoreStride + tx;
  uint8_t keep[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float s = base[plane_slot(j + 1, kScorePlane)];
    float best = -1.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dx == 0 && dy == 0) continue;
        best = fmaxf(best, base[dy * kScoreStride +
                                plane_slot(j + 1 + dx, kScorePlane)]);
      }
    }
    keep[j] = (s >= 0.0f && s >= best) ? 1 : 0;
  }
  const size_t o = static_cast<size_t>(y) * W + x;
  if (L.vec) {
    *reinterpret_cast<uchar4*>(L.out + o) =
        make_uchar4(keep[0], keep[1], keep[2], keep[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (x + j < W) L.out[o + j] = keep[j];
    }
  }
}

inline bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// One level as the Python wrapper passes it (ctypes.Structure of the same
// layout in ops/fast.py).
struct FastDetectArg {
  const float* img;   // f32 [S, H, W] (frames `stride` elements apart)
  uint8_t* mask;      // bool (one byte), the same layout
  float* score;       // f32, the same layout
  int H, W;
  float threshold;
  long long stride;   // elements between frames, >= H * W; H * W when the
                      // S frames of the level are one contiguous tensor
};

struct FastNonmaxArg {
  const float* img;       // f32 [H, W]
  const uint8_t* corner;  // bool [H, W], the detector's corner mask
  uint8_t* out;           // bool [H, W], the non-max mask
  int H, W;
};

// Detects corners on `n` (1..4) levels of `n_frames` (1..65535) frames in
// one launch on `stream`. Returns the cudaError_t of the launch (0 on
// success); never synchronizes.
extern "C" int fast_detect_levels(const FastDetectArg* args, int n,
                                  int n_frames, int arc_length,
                                  cudaStream_t stream) {
  if (n < 1 || n > kMaxLevels || n_frames < 1 || n_frames > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DetectParams p;
  p.n = n;
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    const FastDetectArg& a = args[i];
    if (a.H < 1 || a.W < 1 ||
        (n_frames > 1 && a.stride < static_cast<long long>(a.H) * a.W)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    DetectLevel& L = p.lv[i];
    L.img = a.img;
    L.mask = a.mask;
    L.score = a.score;
    L.H = a.H;
    L.W = a.W;
    L.threshold = a.threshold;
    L.tiles_x = (a.W + kTileW - 1) / kTileW;
    L.first_block = blocks;
    L.stride = n_frames > 1 ? a.stride : 0;
    // Every frame's pointers keep the alignment when the stride is a
    // multiple of 4 elements.
    L.vec = (a.W % 4 == 0 && L.stride % 4 == 0 && aligned(a.img, 16) &&
             aligned(a.score, 16) && aligned(a.mask, 4)) ? 1 : 0;
    blocks += L.tiles_x * ((a.H + kTileH - 1) / kTileH);
  }
  for (int i = n; i < kMaxLevels; ++i) p.lv[i] = p.lv[0];
  const dim3 block(kThreadsX, kTileH);
  const dim3 grid(blocks, n_frames);
  fast_levels_kernel<<<grid, block, 0, stream>>>(p, arc_length);
  return static_cast<int>(cudaGetLastError());
}

// Barrier-`barrier` rescore fused with the 3x3 non-max suppression on `n`
// (1..4) levels in one launch: out = corner and no 8-neighbour corner with
// a strictly greater score.
extern "C" int fast_nonmax_levels(const FastNonmaxArg* args, int n,
                                  float barrier, cudaStream_t stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  NonmaxParams p;
  p.n = n;
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    const FastNonmaxArg& a = args[i];
    if (a.H < 1 || a.W < 1) return static_cast<int>(cudaErrorInvalidValue);
    NonmaxLevel& L = p.lv[i];
    L.img = a.img;
    L.corner = a.corner;
    L.out = a.out;
    L.H = a.H;
    L.W = a.W;
    L.tiles_x = (a.W + kTileW - 1) / kTileW;
    L.first_block = blocks;
    L.vec = (a.W % 4 == 0 && aligned(a.out, 4)) ? 1 : 0;
    blocks += L.tiles_x * ((a.H + kTileH - 1) / kTileH);
  }
  for (int i = n; i < kMaxLevels; ++i) p.lv[i] = p.lv[0];
  const dim3 block(kThreadsX, kTileH);
  fast_nonmax_kernel<<<blocks, block, 0, stream>>>(p, barrier);
  return static_cast<int>(cudaGetLastError());
}
