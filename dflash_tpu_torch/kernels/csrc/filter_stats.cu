// One-pass statistics of f32 logits rows for exact top-k / top-p sampling:
// Hopper port of dflash_tpu/kernels/filter_stats.py::filter_stats_tpu (the
// pl.pallas_call at :117).  See dflash_tpu_torch/kernels/filter_stats.py for
// the function and its plain version.
//
// Per row of x [N, V] and each of its T <= 64 thresholds thr [N, T] (ordered
// float bits, uint32): count_ge, count_gt, the softmax mass strictly above the
// threshold (normalized over the full row); and the row's logsumexp and min.
//
// Where it differs from the TPU.  The Pallas kernel walks V on a sequential
// grid and carries (m, s, counts, masses) across grid steps in VMEM.  Blocks
// on the card run in parallel and share nothing, so the work is split in two
// passes:
//   1. stats_partial, grid (ceil(V / kChunk), N): each block takes kChunk
//      logits of one row, finds their max m_b, and writes its partials
//      (m_b, s_b = sum exp(x - m_b), min_b, and per threshold cge_b, cgt_b,
//      sgt_b = sum over x > thr of exp(x - m_b)).  With kChunk = 1024 a
//      151,936-wide row gives 149 blocks, so even N = 1 spreads over the
//      card's 132 SMs.
//   2. stats_merge, grid N: merges a row's partials, m = max m_b,
//      s = sum s_b e^(m_b - m), sgt likewise, counts as integer sums; lane l
//      of a warp takes partials l, l + 32, ... and a shuffle tree sums the
//      lanes, warp w taking thresholds w, w + 8, ...  The order is fixed and
//      there are no atomics: the result is the same in every run.
// Inside a block the chunk's ordered bits u and e = exp(x - m_b) are staged in
// shared memory; then lane l of each warp owns thresholds l and l + 32 and
// walks its warp's 128 staged elements (every lane reads the same address, a
// broadcast), and the 8 warps' counts are summed in warp order.
//
// What bounds it on the H100: at [16, 151,936] f32 the logits are 9.72 MB,
// 2.9 us at 3.35 TB/s.  The threshold loop costs ~3 operations per element
// per threshold: at T = 32 that is 16 * 151,936 * 32 * 3 = 233 M operations,
// 3.5 us at 67 TF/s f32, so from T ~ 32 up the arithmetic, not the memory,
// is the bound.  Each logit is read from device memory once; the threshold
// loop runs from shared memory.  Not done yet: hiding the threshold loop
// behind the next chunk's load, and giving idle lanes (T < 32) elements.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dflash_fs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;  // logits per block (kernels/filter_stats.py CHUNK)
constexpr int kPerThread = kChunk / kThreads;
constexpr int kPerWarp = kChunk / kWarps;
constexpr int kMaxThr = 64;

// Ordered float bits: unsigned comparison of the results is the float order
// (negative floats reverse, positives offset), as sampling._float_bits_ordered.
__device__ __forceinline__ uint32_t ordered_bits(float x) {
  const int b = __float_as_int(x);
  return b < 0 ? (uint32_t)~b : ((uint32_t)b ^ 0x80000000u);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <typename V>
__device__ __forceinline__ V warp_sum(V x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Block-wide reduction in a fixed order (warp shuffle tree, then warps in
// order); every thread gets the result.
template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, red[w]);
  return r;
}

struct Partials {
  float* m;    // [N, nb]
  float* s;    // [N, nb]
  float* mn;   // [N, nb]
  int* cge;    // [N, nb, T]
  int* cgt;    // [N, nb, T]
  float* sgt;  // [N, nb, T]
};

__global__ void __launch_bounds__(kThreads)
stats_partial(const float* __restrict__ x, const uint32_t* __restrict__ thr, int V, int T, int nb,
              Partials p) {
  __shared__ uint32_t su[kChunk];
  __shared__ float se[kChunk];
  __shared__ float red[kWarps];
  __shared__ int wcge[kWarps][kMaxThr];
  __shared__ int wcgt[kWarps][kMaxThr];
  __shared__ float wsgt[kWarps][kMaxThr];
  const int row = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xr = x + (long)row * V + (long)blk * kChunk;
  const int n = min(kChunk, V - blk * kChunk);

  float vals[kPerThread];
  float mx = -INFINITY, mn = INFINITY;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int idx = tid + i * kThreads;
    vals[i] = idx < n ? xr[idx] : -INFINITY;
    if (idx < n) {
      mx = fmaxf(mx, vals[i]);
      mn = fminf(mn, vals[i]);
    }
  }
  const float m = block_reduce(mx, red, [](float a, float b) { return fmaxf(a, b); });
  mn = block_reduce(mn, red, [](float a, float b) { return fminf(a, b); });
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int idx = tid + i * kThreads;
    const float e = idx < n ? expf(vals[i] - m) : 0.f;
    su[idx] = ordered_bits(vals[i]);
    se[idx] = e;
    sum += e;
  }
  const float s = block_reduce(sum, red, [](float a, float b) { return a + b; });
  // (block_reduce's barriers also make su / se visible to every warp)

  const int j0 = warp * kPerWarp, j1 = min(j0 + kPerWarp, n);
  for (int t = lane; t < T; t += 32) {
    const uint32_t th = thr[(long)row * T + t];
    int cge = 0, cgt = 0;
    float sgt = 0.f;
    for (int j = j0; j < j1; ++j) {
      const uint32_t u = su[j];
      cge += u >= th;
      const bool gt = u > th;
      cgt += gt;
      sgt += gt ? se[j] : 0.f;
    }
    wcge[warp][t] = cge;
    wcgt[warp][t] = cgt;
    wsgt[warp][t] = sgt;
  }
  __syncthreads();
  const long o = (long)row * nb + blk;
  if (tid < T) {
    int a = 0, b = 0;
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += wcge[w][tid];
      b += wcgt[w][tid];
      c += wsgt[w][tid];
    }
    p.cge[o * T + tid] = a;
    p.cgt[o * T + tid] = b;
    p.sgt[o * T + tid] = c;
  }
  if (tid == 0) {
    p.m[o] = m;
    p.s[o] = s;
    p.mn[o] = mn;
  }
}

__global__ void __launch_bounds__(kThreads)
stats_merge(int T, int nb, Partials p, int* __restrict__ cge, int* __restrict__ cgt,
            float* __restrict__ mass_gt, float* __restrict__ lse, float* __restrict__ row_min) {
  const int row = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long base = (long)row * nb;
  float M = -INFINITY, mn = INFINITY;
  for (int b = lane; b < nb; b += 32) {
    M = fmaxf(M, p.m[base + b]);
    mn = fminf(mn, p.mn[base + b]);
  }
  M = warp_max(M);
  float s = 0.f;
  for (int b = lane; b < nb; b += 32) s += p.s[base + b] * expf(p.m[base + b] - M);
  s = warp_sum(s);
  for (int t = warp; t < T; t += kWarps) {
    int a = 0, c = 0;
    float g = 0.f;
    for (int b = lane; b < nb; b += 32) {
      const long o = (base + b) * T + t;
      a += p.cge[o];
      c += p.cgt[o];
      g += p.sgt[o] * expf(p.m[base + b] - M);
    }
    a = warp_sum(a);
    c = warp_sum(c);
    g = warp_sum(g);
    if (lane == 0) {
      cge[(long)row * T + t] = a;
      cgt[(long)row * T + t] = c;
      mass_gt[(long)row * T + t] = g / s;
    }
  }
  mn = warp_min(mn);
  if (threadIdx.x == 0) {
    lse[row] = M + logf(s);
    row_min[row] = mn;
  }
}

}  // namespace dflash_fs

// x [N, V] f32, thr [N, T] uint32 (T <= 64), workspace of
// N * ceil(V / 1024) * (3 + 3T) 4-byte words; outputs count_ge / count_gt
// [N, T] int32, mass_gt [N, T] f32, lse / row_min [N] f32.  Two launches on
// `stream`.  Returns a cudaError_t (0 = launched).
extern "C" int dflash_filter_stats(const void* x, const void* thr, void* workspace, void* cge,
                                   void* cgt, void* mass_gt, void* lse, void* row_min, int N,
                                   int V, int T, void* stream) {
  using namespace dflash_fs;
  if (N <= 0 || V <= 0 || T <= 0 || T > kMaxThr) return (int)cudaErrorInvalidValue;
  const int nb = (V + kChunk - 1) / kChunk;
  const long rows = (long)N * nb;
  float* w = (float*)workspace;
  Partials p{w, w + rows, w + 2 * rows, (int*)(w + 3 * rows), (int*)(w + 3 * rows + rows * T),
             w + 3 * rows + 2 * rows * T};
  cudaStream_t s = (cudaStream_t)stream;
  stats_partial<<<dim3(nb, N), kThreads, 0, s>>>((const float*)x, (const uint32_t*)thr, V, T, nb, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_merge<<<N, kThreads, 0, s>>>(T, nb, p, (int*)cge, (int*)cgt, (float*)mass_gt, (float*)lse,
                                    (float*)row_min);
  return (int)cudaGetLastError();
}
