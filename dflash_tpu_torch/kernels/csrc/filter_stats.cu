// One-pass statistics of f32 logits rows for exact top-k / top-p sampling:
// Hopper port of dflash_tpu/kernels/filter_stats.py::filter_stats_tpu (the
// pl.pallas_call at :117).  See dflash_tpu_torch/kernels/filter_stats.py for
// the function, its plain version and the plan (chunk, blocks per row).
//
// Per row of x [N, V] and each of its T <= 64 thresholds thr [N, T] (ordered
// float bits, 0 .. 2^32 - 1 held in int64 as the wrapper takes them; the
// kernel reads their low words, so a call needs no conversion launch):
// count_ge, count_gt, the softmax mass strictly above the threshold
// (normalized over the full row); and the row's logsumexp and min.
//
// Where it differs from the TPU.  The Pallas kernel walks V on a sequential
// grid and carries (m, s, counts, masses) across grid steps in VMEM.  Blocks
// on the card run in parallel, so each block takes one chunk of a row (grid
// (blocks_per_row, N)), writes its partials, and the row's last block to
// finish merges them, all in one launch:
//   * Each thread holds K logits of the chunk in registers as ordered bits u
//     and e = exp(x - m_b), m_b the block max (16-byte loads where the chunk
//     is whole and aligned, else scalar loads; both put the same logits in
//     the same registers).  Block max, min and sum of e are fixed-order
//     reductions (warp shuffle tree, then warps in order).
//   * The thresholds loop outside, the registers inside: a thread compares
//     kGroup thresholds (shared-memory broadcasts) with all K of its
//     elements, so every lane works for any T.  count_ge and count_gt share
//     one int32 (ge in the low 16 bits, gt in the high 16; a block holds at
//     most 8192 logits, so neither overflows); the mass is a predicated f32
//     add: two compares and three predicated adds per element and
//     threshold (count_above).  The kGroup sums of a warp are reduced by a
//     transposing shuffle tree (halve the values at each of the first two
//     levels), so a warp spends 6 shuffles per value type on 4 thresholds;
//     warps are then summed in warp order.
//   * Merge in the same launch, without float atomics: each block writes
//     (m_b, s_b, min_b, packed counts[T], sgt[T]) to the workspace, fences,
//     and counts itself done on its row's int32 counter.  The block that
//     takes the count to blocks_per_row - 1 fences again, reads the row's
//     partials past L1 (__ldcg), takes M = max m_b, rescales s_b and sgt by
//     e^(m_b - M) and sums the counts as integers: each of its threads sums
//     one threshold over every G-th block (G = min(256 / T, 32)), 4 blocks'
//     loads in flight at once (more cost registers: at 16 the 4096-logit
//     instance rose from 64 to 116 registers and 4 to 2 blocks an SM), and
//     the G groups are summed in order.  It then resets the
//     counter to 0 for the next launch.  The order of every sum is fixed by
//     block and thread index, so the result does not depend on which block
//     came last: two calls give the same bits.
//
// What bounds it on the H100: at [16, 151,936] f32 the logits are 9.72 MB,
// 2.9 us at 3.35 TB/s; the threshold loop is 5 instructions per element and
// threshold, two of them compares on the half-rate integer pipe: from T ~ 16
// up the instruction issue, not the memory, bounds it.  Each logit is read
// from device memory once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dflash_fs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxThr = 64;
constexpr int kGroup = 4;  // thresholds per pass over the registers
constexpr int kMaxBlocksPerRow = 2048;  // kernels/filter_stats.py MAX_BLOCKS_PER_ROW
constexpr int kMergeBatch = 4;  // blocks whose partials a merging thread loads at once
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGroup == 4, "transpose_sum4 reduces 4 thresholds");
static_assert(kWarps * kMaxThr >= 2 * kThreads, "the merge's group sums reuse the warp sums' arrays");

// Ordered float bits: unsigned comparison of the results is the float order
// (negative floats reverse, positives offset), as sampling._float_bits_ordered.
__device__ __forceinline__ uint32_t ordered_bits(float x) {
  const int b = __float_as_int(x);
  return b < 0 ? (uint32_t)~b : ((uint32_t)b ^ 0x80000000u);
}

template <typename V>
__device__ __forceinline__ V warp_sum(V x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Block-wide max and min in a fixed order; every thread gets both.
__device__ __forceinline__ void block_max_min(float& mx, float& mn, float (*red)[kWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
  }
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = mx;
    red[1][threadIdx.x >> 5] = mn;
  }
  __syncthreads();
  mx = red[0][0];
  mn = red[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    mx = fmaxf(mx, red[0][w]);
    mn = fminf(mn, red[1][w]);
  }
}

// Block-wide sum in a fixed order (shuffle tree, then warps in order).
__device__ __forceinline__ float block_sum(float v, float (*red)[kWarps]) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[0][threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[0][w];
  return r;
}

// Sum 4 per-lane values over the warp; lane l ends with the total of value
// 2 * bit4(l) + bit3(l).  The first two levels exchange halves of the
// values (each lane keeps the half its partner does not), the last three
// are a plain butterfly.
template <typename V>
__device__ __forceinline__ V transpose_sum4(const V (&a)[4], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8;
  const V k0 = h4 ? a[2] : a[0], k1 = h4 ? a[3] : a[1];
  const V s0 = h4 ? a[0] : a[2], s1 = h4 ? a[1] : a[3];
  const V b0 = k0 + __shfl_xor_sync(kFull, s0, 16);
  const V b1 = k1 + __shfl_xor_sync(kFull, s1, 16);
  V c = (h3 ? b1 : b0) + __shfl_xor_sync(kFull, h3 ? b0 : b1, 8);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  return c;
}

// Workspace of one launch, N * blocks_per_row * (3 + 2T) 4-byte words.
struct Partials {
  float* m;    // [N, bpr]
  float* s;    // [N, bpr]
  float* mn;   // [N, bpr]
  int* cnt;    // [N, bpr, T]: count_ge | count_gt << 16
  float* sgt;  // [N, bpr, T]
};

// count += (u >= th) + ((u > th) << 16); sgt += u > th ? e : 0, as two
// compares and three predicated adds (written in C, the compiler selects the
// first increment and adds it: one instruction more on the hot loop).
__device__ __forceinline__ void count_above(int& count, float& sgt, uint32_t u, uint32_t th, float e) {
  asm("{\n\t.reg .pred ge, gt;\n\t"
      "setp.ge.u32 ge, %2, %3;\n\t"
      "setp.gt.u32 gt, %2, %3;\n\t"
      "@ge add.s32 %0, %0, 1;\n\t"
      "@gt add.s32 %0, %0, 65536;\n\t"
      "@gt add.f32 %1, %1, %4;\n\t}"
      : "+r"(count), "+f"(sgt)
      : "r"(u), "r"(th), "f"(e));
}

struct Outputs {
  int* cge;
  int* cgt;
  float* mass_gt;
  float* lse;
  float* row_min;
};

template <int K>  // logits per thread, a multiple of 4
__global__ void __launch_bounds__(kThreads, 2)
filter_stats_kernel(const float* __restrict__ x, const int64_t* __restrict__ thr, int V, int T,
                    Partials p, int* __restrict__ counters, Outputs out) {
  constexpr int kChunk = K * kThreads;
  __shared__ uint32_t sth[kMaxThr];
  __shared__ int wcnt[kWarps][kMaxThr];
  __shared__ float wsgt[kWarps][kMaxThr];
  __shared__ float red[2][kWarps];
  __shared__ float scale[kMaxBlocksPerRow];  // the merge's: m_b, then e^(m_b - M)
  __shared__ float sums[kMaxBlocksPerRow];   // the merge's s_b
  __shared__ bool is_last;
  const int row = blockIdx.y, blk = blockIdx.x, bpr = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Tg = (T + kGroup - 1) / kGroup * kGroup;
  if (tid < Tg) sth[tid] = tid < T ? (uint32_t)thr[(long)row * T + tid] : 0xFFFFFFFFu;  // padding: dropped
  const float* xr = x + (long)row * V + (long)blk * kChunk;
  const int n = min(kChunk, V - blk * kChunk);  // logits of this chunk

  // Logit 4 * (i * kThreads + tid) + c of the chunk goes to register 4i + c.
  // Past the row's end: e = 0 and u = 0, which counts in no count_gt and in
  // count_ge only for a threshold of 0, fixed below.
  uint32_t u[K];
  float e[K];
  float mx = -INFINITY, mn = INFINITY;
  if (n == kChunk && (reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(xr) + i * kThreads + tid);
      const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        e[4 * i + c] = v[c];
        u[4 * i + c] = ordered_bits(v[c]);
        mx = fmaxf(mx, v[c]);
        mn = fminf(mn, v[c]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < K / 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int idx = 4 * (i * kThreads + tid) + c;
        const bool ok = idx < n;
        const float v = ok ? __ldg(xr + idx) : -INFINITY;
        e[4 * i + c] = v;
        u[4 * i + c] = ok ? ordered_bits(v) : 0u;
        mx = fmaxf(mx, v);
        if (ok) mn = fminf(mn, v);
      }
  }
  block_max_min(mx, mn, red);  // (its barriers also publish sth)
  const float m = mx;
  const float m_ref = m == -INFINITY ? 0.f : m;  // a chunk of -inf logits: every e is 0
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    e[i] = expf(e[i] - m_ref);
    sum += e[i];
  }
  const float s = block_sum(sum, red);

  for (int t0 = 0; t0 < Tg; t0 += kGroup) {
    uint32_t th[kGroup];
    int cnt[kGroup];
    float sgt[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      th[g] = sth[t0 + g];
      cnt[g] = 0;
      sgt[g] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int g = 0; g < kGroup; ++g) count_above(cnt[g], sgt[g], u[i], th[g], e[i]);
    const int c = transpose_sum4(cnt, lane);
    const float f = transpose_sum4(sgt, lane);
    if ((lane & 7) == 0) {
      wcnt[warp][t0 + (lane >> 3)] = c;  // lanes 0, 8, 16, 24: thresholds t0 .. t0 + 3
      wsgt[warp][t0 + (lane >> 3)] = f;
    }
  }
  __syncthreads();

  const long pb = (long)row * bpr + blk;
  if (tid < T) {
    int c = 0;
    float f = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      c += wcnt[w][tid];
      f += wsgt[w][tid];
    }
    if (sth[tid] == 0u) c = (c & ~0xFFFF) | n;  // every logit is >= 0; padding is not
    p.cnt[pb * T + tid] = c;
    p.sgt[pb * T + tid] = f;
  }
  if (tid == 0) {
    p.m[pb] = m;
    p.s[pb] = s;
    p.mn[pb] = mn;
  }

  // In-launch merge: the row's last block sums the partials in block order.
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[row], 1) == bpr - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long base = (long)row * bpr;
  float M = -INFINITY, lo = INFINITY;
  for (int b = tid; b < bpr; b += kThreads) {
    scale[b] = __ldcg(p.m + base + b);
    sums[b] = __ldcg(p.s + base + b);
    M = fmaxf(M, scale[b]);
    lo = fminf(lo, __ldcg(p.mn + base + b));
  }
  block_max_min(M, lo, red);
  float total = 0.f;
  for (int b = tid; b < bpr; b += kThreads) {
    const float sc = scale[b] == -INFINITY ? 0.f : expf(scale[b] - M);
    scale[b] = sc;
    total += sums[b] * sc;
  }
  total = block_sum(total, red);  // (its barriers also publish scale)
  // Thread tid takes threshold tid % T of blocks tid / T, + G, + 2G, ... (G =
  // min(256 / T, 32) groups), kMergeBatch blocks' loads in flight at once;
  // then the groups are summed in order.
  const int groups = min(kThreads / T, 32), t = tid % T, grp = tid / T;
  int ge = 0, gt = 0;
  float g = 0.f;
  if (grp < groups) {
    for (int b0 = grp; b0 < bpr; b0 += kMergeBatch * groups) {
      int c[kMergeBatch];
      float f[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int b = b0 + j * groups;
        c[j] = b < bpr ? __ldcg(p.cnt + (base + b) * T + t) : 0;
        f[j] = b < bpr ? __ldcg(p.sgt + (base + b) * T + t) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int b = b0 + j * groups;
        if (b < bpr) {
          ge += c[j] & 0xFFFF;
          gt += (int)((unsigned)c[j] >> 16);
          g += f[j] * scale[b];
        }
      }
    }
  }
  int* gge = &wcnt[0][0];  // [groups][T] each; the block's own sums are written out
  int* ggt = gge + kThreads;
  float* gg = &wsgt[0][0];
  gge[tid] = ge;
  ggt[tid] = gt;
  gg[tid] = g;
  __syncthreads();
  if (tid < T) {
    for (int j = 1; j < groups; ++j) {
      ge += gge[j * T + tid];
      gt += ggt[j * T + tid];
      g += gg[j * T + tid];
    }
    out.cge[(long)row * T + tid] = ge;
    out.cgt[(long)row * T + tid] = gt;
    out.mass_gt[(long)row * T + tid] = g / total;
  }
  if (tid == 0) {
    out.lse[row] = M + logf(total);
    out.row_min[row] = lo;
    counters[row] = 0;  // ready for the next launch
  }
}

template <int K>
static cudaError_t launch(const float* x, const int64_t* thr, float* w, int* counters, Outputs out,
                          int N, int V, int T, cudaStream_t stream) {
  const int bpr = (V + K * kThreads - 1) / (K * kThreads);
  if (bpr > kMaxBlocksPerRow) return cudaErrorInvalidValue;
  const long rows = (long)N * bpr;
  Partials p{w, w + rows, w + 2 * rows, (int*)(w + 3 * rows), w + 3 * rows + rows * T};
  filter_stats_kernel<K><<<dim3(bpr, N), kThreads, 0, stream>>>(x, thr, V, T, p, counters, out);
  return cudaGetLastError();
}

}  // namespace dflash_fs

// x [N, V] f32, thr [N, T] int64 holding 0 .. 2^32 - 1 (T <= 64); chunk: logits per block, 256 *
// {4, 8, 16, 32} (kernels/filter_stats.py plan); workspace of
// N * ceil(V / chunk) * (3 + 2T) 4-byte words; counters: >= N int32, zero,
// left zero; outputs count_ge / count_gt [N, T] int32, mass_gt [N, T] f32,
// lse / row_min [N] f32.  One launch on `stream`.  Returns a cudaError_t
// (0 = launched).
extern "C" int dflash_filter_stats(const void* x, const void* thr, void* workspace, void* counters,
                                   void* cge, void* cgt, void* mass_gt, void* lse, void* row_min,
                                   int N, int V, int T, int chunk, void* stream) {
  using namespace dflash_fs;
  if (N <= 0 || N > 65535 || V <= 0 || T <= 0 || T > kMaxThr) return (int)cudaErrorInvalidValue;
  const Outputs out{(int*)cge, (int*)cgt, (float*)mass_gt, (float*)lse, (float*)row_min};
  const float* xf = (const float*)x;
  const int64_t* th = (const int64_t*)thr;
  float* w = (float*)workspace;
  int* c = (int*)counters;
  cudaStream_t s = (cudaStream_t)stream;
  switch (chunk) {
    case 4 * kThreads: return (int)launch<4>(xf, th, w, c, out, N, V, T, s);
    case 8 * kThreads: return (int)launch<8>(xf, th, w, c, out, N, V, T, s);
    case 16 * kThreads: return (int)launch<16>(xf, th, w, c, out, N, V, T, s);
    case 32 * kThreads: return (int)launch<32>(xf, th, w, c, out, N, V, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
