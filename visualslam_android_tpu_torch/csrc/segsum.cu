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
// Order. A block owns one output row. Thread t of its T threads takes the
// row's terms j = row_start[r] + t, + t + T, ... in that order into F
// registers; the T partial sums then go through a tree of fixed shape in
// shared memory (at each level, slot u takes slot u + s). T depends only on
// the shapes (M terms, n_rows rows). There are no float atomics, so the
// same inputs give the same bits on every run, whatever order the blocks
// run in. A row with no terms writes nothing.
//
// What bounds it on the H100: bytes. A call reads each term's F floats and
// its perm entry once, row_start once, and reads and writes each non-empty
// output row: (M F + M + n_rows + 1) * 4 + 2 * rows_hit * F * 4 bytes,
// against M F float adds (at 67 TFLOP/s, far below the bytes' time). At
// 3.35 TB/s: one chunk of the 128-slot Schur pairs (1024 points x 16^2
// pairs x 144 B) is 37.7 MB, ~11 us; U over 2048 x 16 terms is 4.7 MB,
// ~1.4 us; the CG product over the same terms (F = 6) 0.9 MB, ~0.3 us,
// below a launch's latency.
//
// What the design does about it: every term is read once, as whole
// 16-byte (F = 36) or 8-byte (F = 6) vectors, so a warp's loads fill the
// sectors they touch; perm is read coalesced; no output row is read or
// written more than once, and an empty row costs two int reads. Rows are
// short in the pair sums (16 terms on average at 128 slots) and long in U
// (~1000 at 32 slots): T grows with the mean row length M / n_rows, about
// four terms a thread (32 threads up to a mean of 128 terms, 256 from a
// mean of 1024), so a long row is spread over a block and a short one
// wastes little. A later version can give short rows one warp each,
// several rows a block.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

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
segmented_sum_kernel(float* __restrict__ out, const float* __restrict__ src,
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

bool aligned(const void* p, unsigned long bytes) {
  return reinterpret_cast<unsigned long>(p) % bytes == 0;
}

}  // namespace

// out [n_rows, F] f32, src [n_terms, F] f32, perm [n_terms] int32,
// row_start [n_rows + 1] int32, all on the device of the current context;
// threads a power of two in [32, 256]. Returns the cudaError_t of the
// launch (0 when it was accepted).
extern "C" int segmented_sum(void* out, const void* src, const void* perm,
                             const void* row_start, int n_rows, int F,
                             int threads, cudaStream_t stream) {
  if (n_rows < 1 || threads < 32 || threads > kMaxThreads ||
      (threads & (threads - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = static_cast<size_t>(F) * threads * sizeof(float);
  float* o = static_cast<float*>(out);
  const float* s = static_cast<const float*>(src);
  const int* p = static_cast<const int*>(perm);
  const int* rs = static_cast<const int*>(row_start);
  if (F == 36) {
    segmented_sum_kernel<36><<<n_rows, threads, shared, stream>>>(
        o, s, p, rs, aligned(src, 16) ? 1 : 0);
  } else if (F == 6) {
    segmented_sum_kernel<6><<<n_rows, threads, shared, stream>>>(
        o, s, p, rs, aligned(src, 8) ? 1 : 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
