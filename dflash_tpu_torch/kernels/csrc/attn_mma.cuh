// Tensor-core building blocks of the port's bf16 attention kernels
// (prefill_flash.cu, attention.cu, verify_fused.cu), FlashAttention-2 shaped.
//
// A block stages R packed query rows (the g query heads of one kv head side
// by side) and walks key tiles of N rows.  Warp w owns packed rows
// [16w, 16w + 16): S = Q K^T and O += P V run as mma.sync m16n8k16 (bf16 in,
// f32 accumulate) with operands from ldmatrix (V through ldmatrix.trans, since
// it is stored [key][d]).  The online softmax lives on the accumulator
// fragments: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, its
// row max and sum reduce over the lane quad by shuffles, and P becomes the
// bf16 A operand of the value product in registers.  l sums the f32 p before
// it is rounded to bf16, as the Pallas kernels do.
//
// K/V tiles are staged as bf16 with 16-byte cp.async copies into two buffers,
// so the next tile's load overlaps this tile's products.  Rows are padded by
// 16 bytes (pitch D + 8), which puts the 8 rows an ldmatrix reads on 8
// distinct 16-byte bank groups.  Rows past the valid range are zero-filled in
// shared memory, never loaded: mma computes 0 * NaN = NaN, so stale cache rows
// must not reach it.  Masked keys get -1e30 before the max and p = 0 after
// the exponential, so a fully masked row or tile adds nothing; the state is
// kept in the log2 domain (scores times scale * log2(e), exp2).
//
// A tile step takes its mask as a predicate keep(h, j) on (the lane's row h,
// tile key j), and optional per-key multipliers (KeyScales: the int8 ctx's
// key scale times scale * log2(e) on the score, its value scale on p after l
// has summed p).  The causal step of the first two kernels is the predicate
// key0 + j <= position with no multipliers, the same arithmetic as before.
// Split kernels write (acc, m, l) partials per split (store_split) and a
// second, programmatic-dependent launch merges them in split order
// (launch_merge), so the bits do not change from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dflash {
namespace mma {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// R query rows, N keys per K/V tile (both multiples of 16).
template <int D, int R, int N>
struct Smem {
  bf16 q[R][D + 8];
  bf16 k[2][N][D + 8];
  bf16 v[2][N][D + 8];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage NR rows of D bf16 into dst: row r from src(r), or zeros where src(r)
// is null.  One 16-byte cp.async per thread and chunk; the caller commits.
template <int D, int NR, int NT, typename Src>
__device__ __forceinline__ void stage_rows(bf16 (*dst)[D + 8], Src src) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < NR * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bf16* s = src(r);
    if (s) {
      cp_async16(&dst[r][c], s + c);
    } else {
      *reinterpret_cast<uint4*>(&dst[r][c]) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// No per-key multipliers: the score is scaled by scale * log2(e) alone.
struct NoScale {
  static constexpr bool kScaled = false;
};

// Per-key multipliers of a staged tile, in shared memory: key[j] multiplies
// key j's score (in place of scale * log2(e)), val[j] its p after l summed it.
struct KeyScales {
  static constexpr bool kScaled = true;
  const float* key;
  const float* val;
};

// A warp's 16 query rows (this lane's rows r0 = 16w + g and r0 + 8 of the
// block, index h = 0, 1): the output accumulator, the softmax state, and a
// per-row index (the row's position for the causal step, against which the
// mask is taken: key index <= position; the kernel's own row index for other
// masks).  Q is read from shared memory for every tile (ldmatrix), which
// keeps registers for the accumulator.
template <int D, int N>
struct Warp {
  static_assert(N <= 64, "one mask bit per score element of a lane");
  float o[D / 8][4];
  float m[2], l[2];
  int pos[2];

  // row(r): the position (index) of the block's packed row r.
  template <typename Row>
  __device__ __forceinline__ void init(Row row) {
    const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNeg;
      l[h] = 0.f;
      pos[h] = row(r0 + 8 * h);
    }
  }

  // One causal flash step over a staged N-key tile whose first key has index
  // key0.  MASK: key key0 + j is masked for a row iff it is past the row's
  // position; it must be set for any tile that holds such a key, including
  // the zero-filled rows past the valid range.
  template <bool MASK>
  __device__ __forceinline__ void tile(const bf16 (*q_s)[D + 8], const bf16 (*k)[D + 8],
                                       const bf16 (*v)[D + 8], float scale_log2, int key0) {
    this->template tile<MASK>(q_s, k, v, scale_log2, [&](int h, int j) { return key0 + j <= pos[h]; },
                              NoScale{});
  }

  // One flash step over a staged N-key tile.  MASK: keep(h, j) says whether
  // row h attends tile key j (evaluated once per element); it must be set for
  // any tile that holds a masked key, including zero-filled rows.  Scales:
  // NoScale or KeyScales.
  template <bool MASK, typename Keep, typename Scales>
  __device__ __forceinline__ void tile(const bf16 (*q_s)[D + 8], const bf16 (*k)[D + 8],
                                       const bf16 (*v)[D + 8], float scale_log2, Keep keep,
                                       const Scales& sc) {
    const int lane = threadIdx.x & 31, t = lane & 3, w = threadIdx.x >> 5;
    float s[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, &q_s[16 * w + (lane & 15)][16 * kk + (lane >> 4) * 8]);
#pragma unroll
      for (int jj = 0; jj < N / 16; ++jj) {
        uint32_t b[4];
        ldmatrix_x4(b, &k[16 * jj + (lane & 7) + ((lane >> 4) << 3)][16 * kk + ((lane >> 3) & 1) * 8]);
        mma16816(s[2 * jj], a, b[0], b[1]);
        mma16816(s[2 * jj + 1], a, b[2], b[3]);
      }
    }
    // element (j, e): row h = e >> 1, key 8j + 2t + (e & 1)
    float mx[2] = {m[0], m[1]};
    uint32_t kept = 0;  // MASK: bit 4j + e set iff the element is attended
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        float x;
        if constexpr (Scales::kScaled) {
          x = s[j][e] * sc.key[col];
        } else {
          x = s[j][e] * scale_log2;
        }
        if (MASK) {
          if (keep(e >> 1, col)) {
            kept |= 1u << (4 * j + e);
          } else {
            x = kNeg;
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !MASK || ((kept >> (4 * j + e)) & 1u);
        const float p = ok ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
        rs[e >> 1] += p;
        if constexpr (Scales::kScaled) {
          s[j][e] = p * sc.val[8 * j + 2 * t + (e & 1)];
        } else {
          s[j][e] = p;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[c][0] *= alpha[0];
      o[c][1] *= alpha[0];
      o[c][2] *= alpha[1];
      o[c][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &v[16 * kk + (lane & 15)][16 * jj + (lane >> 4) * 8]);
        mma16816(o[2 * jj], a, b[0], b[1]);
        mma16816(o[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }

  // Sum l over the lane quad (each lane summed its own columns).
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }

  // Row h's normalized output, columns 8c + 2t and 8c + 2t + 1, into dst[0..D).
  __device__ __forceinline__ void store(bf16* dst, int h) const {
    const int t = threadIdx.x & 3;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c + 2 * t) =
          __floats2bfloat162_rn(o[c][2 * h] * inv, o[c][2 * h + 1] * inv);
  }
};

// Run tiles [0, n_tiles >= 1) staged by stage(tile, buffer) with cp.async, two
// buffers deep: tile i + 1 loads while step(i, buffer) computes tile i.  The Q
// rows must already be issued (uncommitted) by the caller; they join tile 0's
// group.  step runs after a barrier, and the next stage after another.
template <typename Stage, typename Step>
__device__ __forceinline__ void pipeline(int n_tiles, Stage stage, Step step) {
  stage(0, 0);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      stage(i + 1, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    step(i, i & 1);
    __syncthreads();  // buffer i & 1 is free for tile i + 2
  }
}

// Walk causal key tiles [0, n_tiles) staged by stage_kv(tile, buffer) into
// sm.k / sm.v.  Tile i holds keys key0 + i * N ..; masked(i): does it hold a
// key past some row's position?
template <int D, int R, int N, typename Stage, typename Masked>
__device__ __forceinline__ void walk(Smem<D, R, N>& sm, Warp<D, N>& w, int n_tiles, int key0,
                                     float scale_log2, Stage stage_kv, Masked masked) {
  pipeline(n_tiles, stage_kv, [&](int i, int b) {
    if (masked(i)) {
      w.template tile<true>(sm.q, sm.k[b], sm.v[b], scale_log2, key0 + i * N);
    } else {
      w.template tile<false>(sm.q, sm.k[b], sm.v[b], scale_log2, key0 + i * N);
    }
  });
}

// Epilogue of a split kernel over packed rows [p_base, +16 * warps) of kv head
// hk (packed row p is query head hk * g + p / R at query row p % R; out
// [R, nh * D]; M = g * R rows).  ws == nullptr: one split, write the
// normalized rows.  Else write split blockIdx.x's f32 partials for
// merge_splits: acc at ws[row * D] and (m, l) at ws[gridDim.x * n_kv * M * D
// + 2 * row], row = (split * n_kv + hk) * M + p.  Call after w.finish().
template <int D, int N>
__device__ __forceinline__ void store_split(const Warp<D, N>& w, bf16* out, float* ws, int p_base, int R,
                                            int nh, int n_kv, int hk) {
  const int g = nh / n_kv, M = g * R, split = blockIdx.x;
  const long q_stride = (long)nh * D;
  const int t = threadIdx.x & 3;
  const int r0 = p_base + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = r0 + 8 * h;
    if (p >= M) continue;
    if (ws == nullptr) {
      w.store(out + (p % R) * q_stride + (hk * g + p / R) * D, h);
      continue;
    }
    const long row = ((long)split * n_kv + hk) * M + p;
    float* acc = ws + row * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(acc + 8 * c + 2 * t) = make_float2(w.o[c][2 * h], w.o[c][2 * h + 1]);
    if (t == 0) {
      float* ml = ws + (long)gridDim.x * n_kv * M * D + 2 * row;
      ml[0] = w.m[h];
      ml[1] = w.l[h];
    }
  }
}

// One warp per (kv head, packed row): the splits' partials in split order.
// A row that a split masks entirely (l = 0) merges with weight 0.  Request
// lane blockIdx.y (gridDim.y lanes, 1 for a single request) reads its own
// workspace (n_splits * n_kv * M * (D + 2) floats a lane) and writes its own
// output rows (R * nh * D a lane).
template <int D>
__global__ void __launch_bounds__(128)
merge_splits(const float* __restrict__ ws, bf16* __restrict__ out, int R, int nh, int n_kv, int n_splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel's partials are written
  const int g = nh / n_kv, M = g * R;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);  // hk * M + p
  if (row >= n_kv * M) return;
  const int hk = row / M, p = row % M, lane = threadIdx.x & 31;
  const long per_split = (long)n_kv * M;
  ws += (long)blockIdx.y * n_splits * per_split * (D + 2);
  out += (long)blockIdx.y * R * nh * D;
  const float* ml = ws + n_splits * per_split * D;
  float m_max = kNeg;
  for (int s = 0; s < n_splits; ++s) {
    const float* x = ml + 2 * (s * per_split + row);
    if (x[1] > 0.f) m_max = fmaxf(m_max, x[0]);
  }
  float acc[D / 32], den = 0.f;
#pragma unroll
  for (int c = 0; c < D / 32; ++c) acc[c] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* x = ml + 2 * (s * per_split + row);
    if (!(x[1] > 0.f)) continue;  // every key of the split masked for this row: weight 0
    const float wgt = exp2f(x[0] - m_max);
    den += wgt * x[1];
    const float* a = ws + (s * per_split + row) * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[c] += wgt * a[lane + 32 * c];
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  bf16* dst = out + (long)(p % R) * nh * D + (hk * g + p / R) * D;
#pragma unroll
  for (int c = 0; c < D / 32; ++c) dst[lane + 32 * c] = __float2bfloat16(acc[c] * inv);
}

// Launch merge_splits as a programmatic dependent launch: its grid is
// scheduled while the split grid runs and waits in griddepcontrol.wait for
// the split grid's results (the split kernel calls
// griddepcontrol.launch_dependents early).  lanes: request lanes, each with
// its own workspace and output rows.
template <int D>
__host__ cudaError_t launch_merge(const float* ws, bf16* out, int R, int nh, int n_kv, int n_splits,
                                  cudaStream_t stream, int lanes = 1) {
  const int M = (nh / n_kv) * R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_kv * M + 3) / 4, lanes);
  cfg.blockDim = dim3(128);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, merge_splits<D>, ws, out, R, nh, n_kv, n_splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Allow a kernel more than 48 KB of dynamic shared memory (once per process).
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

}  // namespace mma
}  // namespace dflash
