// FMA building blocks of the f32 branches of the port's three attention
// kernels (prefill_flash.cu, verify_fused.cu, attention.cu; their bf16
// branches run on attn_mma.cuh): one thread block owns RQ query rows of ONE
// query head and walks key tiles of 32 rows through shared memory with an f32
// online softmax.
//
// Layout inside a block of 4 warps: warp w owns query rows [w*RPW, (w+1)*RPW);
// in the score step lane j computes the scores of key j of the tile for those
// rows (a D-long dot product against shared memory), in the value step lane j
// owns output columns {j, j+32, j+64, ...} and the probabilities of key j are
// broadcast from lane j by a warp shuffle.  The softmax state (m, l) of a row
// is replicated across its warp's lanes; the accumulator stays in registers.
//
// Masked keys are excluded by selecting -1e30 before the max and zero AFTER
// the exponential, so a row whose tile is fully masked adds nothing (an
// all-masked row would otherwise see exp(-1e30 - -1e30) = 1).  Key rows past
// the valid range are zero-filled in shared memory, never read from the cache.
//
// Key rows may be int8 (the quantized ctx cache): they are staged as exact
// floats, and each key's per-row scales enter as the score multiplier (its
// key scale times the softmax scale) and the value weight (its value scale,
// applied to p after l has summed the unscaled p).  Unscaled rows pass the
// softmax scale and 1.0, which leaves every number as it was.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dflash {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTile = 32;  // keys per tile: one per lane
constexpr float kNeg = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// 16 bytes of f32 -> 4 floats.
__device__ __forceinline__ void unpack16(const float* src, float* dst) {
  const float4 raw = *reinterpret_cast<const float4*>(src);
  dst[0] = raw.x; dst[1] = raw.y; dst[2] = raw.z; dst[3] = raw.w;
}

// 16 int8 values -> exact floats.
__device__ __forceinline__ void unpack16(const int8_t* src, float* dst) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[4 * i + b] = (float)(int8_t)(w[i] >> (8 * b));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, int RQ>
struct Smem {
  float q[RQ][D];
  float k[kKeyTile][D + 1];  // +1 pad: lane j reads row j without bank conflicts
  float v[kKeyTile][D];
};

// Copy `nrows` rows of D elements (row r at src + r*stride) into dst[r][0..D),
// zero-filling rows [nrows, NR).  Loads are 16 bytes per thread.
template <typename T, int D, int NR, int LD>
__device__ __forceinline__ void load_rows(float (*dst)[LD], const T* src, int nrows, long stride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int idx = threadIdx.x; idx < NR * CHUNKS; idx += kThreads) {
    const int r = idx / CHUNKS, c0 = (idx % CHUNKS) * VEC;
    float vals[VEC];
    if (r < nrows) {
      unpack16(src + r * stride + c0, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r][c0 + e] = vals[e];
  }
}

// Online-softmax state of the RPW rows a warp owns.
template <int D, int RPW>
struct RowState {
  float m[RPW], l[RPW], acc[RPW][D / 32];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      m[r] = kNeg;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;
    }
  }
};

// One flash step over the key tile in shared memory.  valid(r, j): may local
// query row r attend key j of the tile (j < 32)?  It must be false for keys
// past the tile's valid rows.  kmul / vmul: this lane's key's score multiplier
// and value weight (see the top of this file).
template <int D, int RQ, int RPW, typename Valid>
__device__ __forceinline__ void attend_tile(const Smem<D, RQ>& sm, RowState<D, RPW>& st,
                                            float kmul, float vmul, Valid valid) {
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPW;
  float s[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    const float kc = sm.k[lane][c];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = fmaf(sm.q[row0 + r][c], kc, s[r]);
  }
  float p[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const bool ok = valid(row0 + r, lane);
    const float sr = ok ? s[r] * kmul : kNeg;
    const float m_new = fmaxf(st.m[r], warp_max(sr));
    const float alpha = expf(st.m[r] - m_new);
    p[r] = ok ? expf(sr - m_new) : 0.f;
    st.l[r] = st.l[r] * alpha + warp_sum(p[r]);
    p[r] *= vmul;
    st.m[r] = m_new;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) st.acc[r][c] *= alpha;
  }
#pragma unroll 4
  for (int j = 0; j < kKeyTile; ++j) {
    float vj[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) vj[c] = sm.v[j][lane + 32 * c];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) st.acc[r][c] = fmaf(pj, vj[c], st.acc[r][c]);
    }
  }
}

// out row (row0 + local row) = acc / l, for rows < n_rows.
template <typename T, int D, int RPW>
__device__ __forceinline__ void store_rows(T* out, const RowState<D, RPW>& st, int row0,
                                           int n_rows, long stride) {
  const int lane = threadIdx.x & 31;
  const int local0 = (threadIdx.x >> 5) * RPW;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + local0 + r;
    if (row >= n_rows) continue;
    const float denom = fmaxf(st.l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 32; ++c) out[row * stride + lane + 32 * c] = from_f32<T>(st.acc[r][c] / denom);
  }
}

}  // namespace dflash
