// Fixed-order segmented sum for NVIDIA Hopper (sm_90a): bundle
// adjustment's scatter sums (U, eps_a, E_corr, the Schur camera-pair
// blocks, the block band, band-to-dense, the CG product).
//
// It replaces no TPU kernel. It is the card's form of the JAX package's
// `.at[].add` in visualslam_android_tpu/models/bundle.py (lines 177, 207,
// 242, 390, 583, 586), which XLA runs as a scatter-add whose sums repeat
// from run to run. On the card, `index_add_` adds with float atomics in no
// fixed order, so two runs on the same inputs part in the last bits and the
// SLAM runs built on them part too; `index_put_(accumulate=True)` repeats
// itself but sorts the indices on every call and walks each row's terms
// one after another in one warp.
//
// What it computes, in place (index_add_'s semantics):
//
//   out[r, f] += sum over j in [row_start[r], row_start[r + 1]) of
//                src[perm[j], f]          (r < n_rows, f < F, F = 6 or 36)
//
// where perm is the stable argsort of the row index of each term and
// row_start the offsets of each row's terms in that order: the plan,
// built once per bundle_adjust call by ops/scatter.make_plan (the indices
// do not change between LM iterations).
//
// The order. T = ops/scatter.threads_for(terms, rows), a power of two in
// [32, 256] that depends on the shapes alone. For each row r and value f:
//   1. chain t < T sums the row's terms k = t, t + T, t + 2T, ... (k
//      counted from row_start[r]) one after another, from 0.0f;
//   2. the T chain sums go through a tree: at level s = T/2, ..., 1, slot
//      u < s takes slot u + s (slot[u] = slot[u] + slot[u + s]);
//   3. slot 0 is added to out[r, f].
// A row with no terms is not touched. Every addition is one IEEE f32 add
// (no multiply to contract; the build has no fast-math), so any kernel that
// makes these additions gives these bits, whatever thread makes them and
// whatever order the threads and blocks run in; no float atomics are used.
// ops/scatter.segmented_sum_ordered_reference makes the same additions with
// elementwise PyTorch adds.
//
// What bounds it on the H100: bytes. A call reads each kept term's F
// floats and its perm entry once, row_start once, and reads and writes each
// row with terms: (M F + M + n_rows + 1) * 4 + 2 * rows_hit * F * 4 bytes,
// against M F float adds (at 67 TFLOP/s, far below the bytes' time). At
// 3.35 TB/s: one chunk of the 128-slot Schur pairs (1024 points x 16^2
// pairs x 144 B, the valid ones) is 37 MB, ~11 us (it fits the 50 MB L2,
// so CUDA-graph replays of one chunk read it from there); U over 2048 x 16
// terms is 4.7 MB, ~1.4 us; the CG product over the same terms (F = 6)
// 0.9 MB, ~0.3 us, below a launch's latency. What stands between a kernel
// and that bound differs by case:
//
// * Many short rows (the pair and band chunks: 16,384 or 4,225 rows of
//   0-155 terms, T = 32; the 32-slot pair chunk, 1,024 rows of ~256, T =
//   64). A term is 144 scattered bytes (perm gathers it), and a warp whose
//   lanes each load 16 bytes of their own term touches 32 lines an
//   instruction: the L1 serves one line a wavefront, so these gathers, not
//   the memory, set the pace. And a row costs a few dependent trips to
//   memory (row bounds, perm, the terms, out), so a warp's rows are
//   latency-bound unless it keeps the next step's terms in flight.
//   The short path (segsum_staged): a group of T / 32 warps takes a row,
//   thread t chain t over whole terms, eight warps a 256-thread block, no
//   block-wide barrier. A warp copies the 32 terms of its chains' next
//   step into shared memory with cp.async in coalesced pieces of 16 bytes
//   (8 at F = 6): at F = 36 piece q of the step is piece q % 9 of term
//   q / 9, so an instruction touches ~4 terms side by side, ~8 lines, not
//   32. The copies run one step ahead of the adds in a two-stage ring,
//   and lane t reads term t back (stride 36 floats: no bank conflict).
//   The tree's levels s >= 32 go across the group's warps through their
//   rings, s = 16 ... 1 by __shfl_down_sync, which is "slot u takes
//   u + s". The grid holds as many groups as are resident (at F = 36
//   three blocks an SM: the rings take 72 KB a block); group g of G takes
//   rows g, g + G, ..., so the groups at work at one time hold
//   neighbouring rows, and an empty row costs a group two int reads.
//
// * Few long rows (U and the CG product: 32-128 rows of ~250-1000 terms,
//   T = 64-256). One row a block would leave most of the 132 SMs idle.
//   The long path (segsum_sliced): each value f has an order of its own,
//   so a group of T threads takes one (row, slice of V values) task: V = 4
//   (16 bytes, 9 slices a row) at F = 36, V = 2 at F = 6, so 32 rows give
//   288 groups, each chain with eight gathers in flight. The tree as in
//   the short path. The slices of one row are neighbouring groups, so a
//   term's sectors come from L2 once.
//
// The path is chosen per launch from the shapes (ops/scatter.path_for:
// short where the rows give at least 1,024 warps), so one problem always
// takes one path; both make the same additions, and a source not aligned
// for the short path's pieces takes the long one.
//
// What Hopper's newer units do here. TMA copies tiles of a strided tensor
// and has no indexed gather on sm_90 (perm scatters the terms over src), so
// the gathers stay cp.async (short path) and 16-byte ld.global.nc loads
// (long path). wgmma has no product to run. Both paths keep their registers
// under 128 a thread with no spill (ptxas -v, in the build log).
//
// segmented_sum_rowblock is the first version of this kernel (one block
// of T threads per row, the tree in shared memory with a barrier a
// level), kept as a yardstick: it makes the same additions, so it is a
// bit-equality oracle on the card and the "before" time; no wrapper on
// any path launches it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBlockThreads = 256;  // threads a block of both paths
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kDevices = 64;        // devices the launch caches cover

// ---- the first version (the yardstick) ----

// One term's F floats added into acc, as the widest aligned loads: nine
// float4 for F = 36, three float2 for F = 6 (scalar loads when the source
// is not aligned so).
__device__ __forceinline__ void add_term(float (&acc)[36],
                                         const float* __restrict__ row,
                                         bool vec) {
  if (vec) {
    const float4* v = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float4 x = __ldg(v + i);
      acc[4 * i] += x.x;
      acc[4 * i + 1] += x.y;
      acc[4 * i + 2] += x.z;
      acc[4 * i + 3] += x.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < 36; ++f) acc[f] += __ldg(row + f);
  }
}

__device__ __forceinline__ void add_term(float (&acc)[6],
                                         const float* __restrict__ row,
                                         bool vec) {
  if (vec) {
    const float2* v = reinterpret_cast<const float2*>(row);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float2 x = __ldg(v + i);
      acc[2 * i] += x.x;
      acc[2 * i + 1] += x.y;
    }
  } else {
#pragma unroll
    for (int f = 0; f < 6; ++f) acc[f] += __ldg(row + f);
  }
}

// One block per output row; blockDim.x = T, a power of two <= kMaxThreads;
// dynamic shared memory F * T floats, slot (f, t) at f * T + t.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
segsum_rowblock(float* __restrict__ out, const float* __restrict__ src,
                const int* __restrict__ perm,
                const int* __restrict__ row_start, int vec) {
  extern __shared__ float part[];
  const int r = blockIdx.x;
  const int j0 = row_start[r];
  const int j1 = row_start[r + 1];
  if (j0 >= j1) return;  // the whole block leaves: no barrier is skipped
  const int T = blockDim.x;
  const int t = threadIdx.x;

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (int j = j0 + t; j < j1; j += T) {
    add_term(acc, src + static_cast<long long>(perm[j]) * F, vec != 0);
  }
#pragma unroll
  for (int f = 0; f < F; ++f) part[f * T + t] = acc[f];
  __syncthreads();

  // The tree: at level s, slot (f, u) for u < s takes slot (f, u + s).
  // The s * F additions of a level are spread over the T threads.
  for (int s = T >> 1; s > 0; s >>= 1) {
    for (int i = t; i < s * F; i += T) {
      const int f = i / s;
      const int u = i - f * s;
      part[f * T + u] += part[f * T + u + s];
    }
    __syncthreads();
  }
  float* o = out + static_cast<long long>(r) * F;
  for (int f = t; f < F; f += T) o[f] += part[f * T];
}

// ---- shared by both paths ----

// A barrier of the `threads` threads of one group (named barrier id 1 ...
// 8; 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Levels s = 16 ... 1 of the tree in one warp (lane u takes lane u + s; a
// lane at or past s keeps a value no later level reads), then lane 0 adds
// slot 0 into o.
template <int V>
__device__ __forceinline__ void warp_tree_out(float (&acc)[V], int lane,
                                              float* o) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[v] += __shfl_down_sync(kFullMask, acc[v], s);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] += acc[v];
  }
}

// ---- the short path ----

// cp.async: a copy from global into shared memory that no register holds;
// kBytes = 16 (cached in L2 only) or 8. The commit closes the thread's
// group of copies; the wait returns once all but its newest N groups have
// landed.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Floats a piece of a term (16 bytes at F = 36, 8 at F = 6) and pieces a
// term.
template <int F>
__host__ __device__ constexpr int piece_floats() {
  return F % 4 == 0 ? 4 : 2;
}

// One step of a warp: the terms b, b + 1, ..., b + 31 below j1 copied to
// dst [32][F] (term b + k at dst + k F) in the warp's coalesced pieces:
// piece q = i 32 + lane of instruction i is piece q % P of term q / P.
// The lane's perm entry reaches the lanes that copy its term by a
// shuffle. Commits one group of copies (empty past j1).
template <int F>
__device__ __forceinline__ void stage_step(float* dst,
                                           const float* __restrict__ src,
                                           const int* __restrict__ perm,
                                           int b, int j1, int lane) {
  constexpr int VW = piece_floats<F>();
  constexpr int P = F / VW;
  const int n = j1 - b;  // the same in every lane
  if (n > 0) {
    const int mine = lane < n ? perm[b + lane] : 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int q = i * 32 + lane;
      const int k = q / P;
      const int from = __shfl_sync(kFullMask, mine, k);
      if (k < n) {
        cp_async<VW * 4>(dst + q * VW,
                         src + static_cast<long long>(from) * F +
                             (q - k * P) * VW);
      }
    }
  }
  cp_async_commit();
}

// Steps a warp's ring holds: the next step's copies are in flight while
// a step is added.
constexpr int kStages = 2;

// The floats of a warp's ring: kStages steps of [32][F], and at least the
// [32][F + 1] tile of the tree's cross-warp levels, in 16-byte units.
template <int F>
__host__ __device__ constexpr int ring_floats() {
  constexpr int steps = kStages * 32 * F;
  constexpr int tile = 32 * (F + 1);
  return ((steps > tile ? steps : tile) + 3) / 4 * 4;
}

// Rows by warps through shared memory: group g (W warps, T = 32 W threads)
// of the grid's G takes rows g, g + G, ..., thread t chain t over whole
// terms; its warp stages the 32 terms of the next step in its ring,
// kStages - 1 steps ahead of the adds.
template <int F, int W>
__global__ void __launch_bounds__(kBlockThreads)
segsum_staged(float* __restrict__ out, const float* __restrict__ src,
              const int* __restrict__ perm,
              const int* __restrict__ row_start, int n_rows) {
  constexpr int T = 32 * W;
  constexpr int R = kBlockThreads / T;
  constexpr int kStep = 32 * F;
  constexpr int kRing = ring_floats<F>();
  extern __shared__ __align__(16) float stage[];  // [warps][kRing]
  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  const int lane = threadIdx.x & 31;
  const int w = t >> 5;
  float* ring = stage + (threadIdx.x >> 5) * kRing;
  float* group_rings = stage + g * W * kRing;
  for (int r = blockIdx.x * R + g; r < n_rows; r += gridDim.x * R) {
    const int j0 = row_start[r];
    const int j1 = row_start[r + 1];
    if (j0 >= j1) continue;  // the whole group skips the row

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
    const int first = j0 + 32 * w;  // the step's term of chain 32 w
    int ahead = first;
#pragma unroll
    for (int d = 0; d + 1 < kStages; ++d) {
      stage_step<F>(ring + d * kStep, src, perm, ahead, j1, lane);
      ahead += T;
    }
    int slot = 0;
    for (int b = first; b < j1; b += T) {
      stage_step<F>(ring + ((slot + kStages - 1) % kStages) * kStep, src,
                    perm, ahead, j1, lane);
      ahead += T;
      cp_async_wait<kStages - 1>();
      __syncwarp();
      if (b + lane < j1) {
        const float* x = ring + slot * kStep + lane * F;
        if constexpr (F % 4 == 0) {
#pragma unroll
          for (int k = 0; k < F / 4; ++k) {
            const float4 q = reinterpret_cast<const float4*>(x)[k];
            acc[4 * k] += q.x;
            acc[4 * k + 1] += q.y;
            acc[4 * k + 2] += q.z;
            acc[4 * k + 3] += q.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < F / 2; ++k) {
            const float2 q = reinterpret_cast<const float2*>(x)[k];
            acc[2 * k] += q.x;
            acc[2 * k + 1] += q.y;
          }
        }
      }
      __syncwarp();  // the slot is read before a later step refills it
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }
    cp_async_wait<0>();  // the steps past j1 copied nothing: none pending

    if constexpr (W > 1) {
      // Levels s >= 32 through the group's rings: thread t's sums at
      // [t % 32][F + 1] of warp t / 32's ring.
#pragma unroll
      for (int s = T / 2; s >= 32; s >>= 1) {
        if (t >= s && t < 2 * s) {
          float* o = group_rings + w * kRing + lane * (F + 1);
#pragma unroll
          for (int f = 0; f < F; ++f) o[f] = acc[f];
        }
        group_sync(g + 1, T);
        if (t < s) {
          const int u = t + s;
          const float* o =
              group_rings + (u >> 5) * kRing + (u & 31) * (F + 1);
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] += o[f];
        }
        group_sync(g + 1, T);
      }
    }
    if (t < 32) {
      warp_tree_out<F>(acc, lane, out + static_cast<long long>(r) * F);
    }
  }
}

// ---- the long path ----

// V values of one term into x as the widest aligned loads: float4s where V
// is a multiple of 4 and vec == 2 (src and every slice 16-byte aligned),
// float2s where V is even and vec >= 1 (8-byte aligned), else scalars.
template <int V>
__device__ __forceinline__ void load_values(float (&x)[V],
                                            const float* __restrict__ p,
                                            int vec) {
  if (V % 4 == 0 && vec == 2) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 w = __ldg(q + i);
      x[4 * i] = w.x;
      x[4 * i + 1] = w.y;
      x[4 * i + 2] = w.z;
      x[4 * i + 3] = w.w;
    }
  } else if (V % 2 == 0 && vec >= 1) {
    const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 w = __ldg(q + i);
      x[2 * i] = w.x;
      x[2 * i + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = __ldg(p + v);
  }
}

// Rows by slices of the values: group g (W warps, T = 32 W threads) of the
// grid's G takes tasks g, g + G, ... (task = row F / V + slice c: values
// [c V, c V + V) of the row), thread t chain t over its slice of the
// terms, the gathers of a chain's next U terms issued before their adds.
template <int F, int V, int U, int W>
__global__ void __launch_bounds__(kBlockThreads)
segsum_sliced(float* __restrict__ out, const float* __restrict__ src,
              const int* __restrict__ perm,
              const int* __restrict__ row_start, int n_rows, int vec) {
  constexpr int T = 32 * W;
  constexpr int R = kBlockThreads / T;
  constexpr int S = F / V;
  static_assert(F % V == 0, "slices tile the row");
  // The upper half's sums for the levels s >= 32; the stride V + 1 is
  // odd, so 32 lanes that write one value each touch 32 banks.
  __shared__ float part[W > 1 ? R : 1][W > 1 ? T / 2 : 1][V + 1];
  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  const int lane = t & 31;
  const int n_tasks = n_rows * S;
  for (int task = blockIdx.x * R + g; task < n_tasks;
       task += gridDim.x * R) {
    const int r = task / S;
    const int c = task - r * S;
    const int j0 = row_start[r];
    const int j1 = row_start[r + 1];
    if (j0 >= j1) continue;  // the whole group skips the row
    const float* s0 = src + c * V;

    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int j = j0 + t; j < j1; j += T * U) {
      // The gathers of the next U terms first, then their adds in order.
      float x[U][V];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (j + T * k < j1) {
          load_values<V>(x[k],
                         s0 + static_cast<long long>(perm[j + T * k]) * F,
                         vec);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) x[k][v] = 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (j + T * k < j1) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += x[k][v];
        }
      }
    }

    if constexpr (W > 1) {
      // Levels s >= 32: slot u < s takes slot u + s across the warps.
#pragma unroll
      for (int s = T / 2; s >= 32; s >>= 1) {
        if (t >= s && t < 2 * s) {
#pragma unroll
          for (int v = 0; v < V; ++v) part[g][t - s][v] = acc[v];
        }
        group_sync(g + 1, T);
        if (t < s) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += part[g][t][v];
        }
        group_sync(g + 1, T);
      }
    }
    if (t < 32) {
      warp_tree_out<V>(acc, lane,
                       out + static_cast<long long>(r) * F + c * V);
    }
  }
}

// ---- launches ----

bool aligned(const void* p, unsigned long bytes) {
  return reinterpret_cast<unsigned long>(p) % bytes == 0;
}

bool valid_threads(int threads) {
  return threads >= 32 && threads <= kMaxThreads &&
         (threads & (threads - 1)) == 0;
}

// Blocks of `kernel` that the current device holds at once, cached per
// kernel and device (a benign race: every thread writes one value); the
// first call also lets the kernel take `shared` bytes of dynamic shared
// memory.
template <typename Kernel>
int resident_blocks(Kernel kernel, int* cache, int shared) {
  int device = 0;
  cudaGetDevice(&device);
  int hold = device < kDevices ? cache[device] : 0;
  if (hold == 0) {
    if (shared > 0) {
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           shared);
    }
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kBlockThreads, shared);
    hold = sms * (per_sm > 0 ? per_sm : 1);
    if (device < kDevices) cache[device] = hold;
  }
  return hold;
}

int grid_for(long long tasks, int groups_a_block, int hold) {
  const long long needed = (tasks + groups_a_block - 1) / groups_a_block;
  return needed < hold ? static_cast<int>(needed) : hold;
}

template <int F, int W>
void launch_staged(float* o, const float* s, const int* p, const int* rs,
                   int n_rows, cudaStream_t stream) {
  constexpr int kShared =
      (kBlockThreads / 32) * ring_floats<F>() * sizeof(float);
  static int cache[kDevices] = {};
  auto kernel = segsum_staged<F, W>;
  const int blocks = grid_for(n_rows, kBlockThreads / (32 * W),
                              resident_blocks(kernel, cache, kShared));
  kernel<<<blocks, kBlockThreads, kShared, stream>>>(o, s, p, rs, n_rows);
}

template <int F, int W>
void launch_sliced(float* o, const float* s, const int* p, const int* rs,
                   int n_rows, int vec, cudaStream_t stream) {
  constexpr int kV = F % 4 == 0 ? 4 : 2;
  static int cache[kDevices] = {};
  auto kernel = segsum_sliced<F, kV, 8, W>;
  const int blocks =
      grid_for(static_cast<long long>(n_rows) * (F / kV),
               kBlockThreads / (32 * W), resident_blocks(kernel, cache, 0));
  kernel<<<blocks, kBlockThreads, 0, stream>>>(o, s, p, rs, n_rows, vec);
}

template <int F, int W>
void launch_path(float* o, const float* s, const int* p, const int* rs,
                 int n_rows, int path, int vec, cudaStream_t stream) {
  if (path == 1) {
    launch_staged<F, W>(o, s, p, rs, n_rows, stream);
  } else {
    launch_sliced<F, W>(o, s, p, rs, n_rows, vec, stream);
  }
}

template <int F>
void launch(float* o, const float* s, const int* p, const int* rs,
            int n_rows, int threads, int path, int vec,
            cudaStream_t stream) {
  if (threads == 32) {
    launch_path<F, 1>(o, s, p, rs, n_rows, path, vec, stream);
  } else if (threads == 64) {
    launch_path<F, 2>(o, s, p, rs, n_rows, path, vec, stream);
  } else if (threads == 128) {
    launch_path<F, 4>(o, s, p, rs, n_rows, path, vec, stream);
  } else {
    launch_path<F, 8>(o, s, p, rs, n_rows, path, vec, stream);
  }
}

}  // namespace

// out [n_rows, F] f32, src [n_terms, F] f32, perm [n_terms] int32,
// row_start [n_rows + 1] int32, all on the device of the current
// context; threads = T, a power of two in [32, 256]; path 1: the short
// path (src 16-byte aligned at F = 36, 8 at F = 6), 2: the long path.
// Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int segmented_sum(void* out, const void* src, const void* perm,
                             const void* row_start, int n_rows, int F,
                             int threads, int path, cudaStream_t stream) {
  const int vec = aligned(src, 16) ? 2 : (aligned(src, 8) ? 1 : 0);
  const bool staged_ok = F == 36 ? vec == 2 : vec >= 1;
  if (n_rows < 1 || n_rows > (1 << 26) || !valid_threads(threads) ||
      (path != 1 && path != 2) || (path == 1 && !staged_ok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* o = static_cast<float*>(out);
  const float* s = static_cast<const float*>(src);
  const int* p = static_cast<const int*>(perm);
  const int* rs = static_cast<const int*>(row_start);
  if (F == 36) {
    launch<36>(o, s, p, rs, n_rows, threads, path, vec, stream);
  } else if (F == 6) {
    launch<6>(o, s, p, rs, n_rows, threads, path, vec, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first version, with its arguments: one block of `threads` per row.
// Launched only to compare with (chip_smoke.py phase 18).
extern "C" int segmented_sum_rowblock(void* out, const void* src,
                                      const void* perm, const void* row_start,
                                      int n_rows, int F, int threads,
                                      cudaStream_t stream) {
  if (n_rows < 1 || !valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = static_cast<size_t>(F) * threads * sizeof(float);
  float* o = static_cast<float*>(out);
  const float* s = static_cast<const float*>(src);
  const int* p = static_cast<const int*>(perm);
  const int* rs = static_cast<const int*>(row_start);
  if (F == 36) {
    segsum_rowblock<36><<<n_rows, threads, shared, stream>>>(
        o, s, p, rs, aligned(src, 16) ? 1 : 0);
  } else if (F == 6) {
    segsum_rowblock<6><<<n_rows, threads, shared, stream>>>(
        o, s, p, rs, aligned(src, 8) ? 1 : 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
