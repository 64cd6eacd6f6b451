// int8 weight-only matmul of every projection of the int8 serving path:
// Hopper port of dflash_tpu/kernels/matmul_q.py::matmul_int8 (the
// pl.pallas_call at :56).  See dflash_tpu_torch/kernels/matmul_q.py for what
// bounds it, what each variant does about that, and which variant runs when
// (matmul_q.plan: the variant, its tile and its K split, from the shape).
//
// out[s, c] = (sum_k x[s, k] * float(w[k, c])) * scale[c]   for c < n
// x [S, K] float or bf16 (row stride K); w [K, N_pad] int8 (row stride N_pad);
// scale [N_pad] f32; out [S, n] float or bf16 (row stride n).
//
// Variants: fma (f32 x, every S), ragged (bf16 x, N_pad % 16 != 0), stream
// (bf16 x, S <= 32) and wgmma (bf16 x, S > 32), in that order below.
//
// FMA variant (f32 x): grid (ceil(S / RT), ceil(N_pad / kCols),
// ksplit).  A block owns RT rows, kCols = 128 columns and K range
// [z * K/ksplit, (z+1) * K/ksplit).  Lane l of every warp owns columns
// 4l .. 4l+3 of the tile and reads them with one 4-byte load per weight row: a
// warp reads a whole 128-byte line per row.  Warp w takes the row quads
// k0 + 4 * (w + kWarps * i) of each kChunk-row chunk, whose x values all rows
// of the tile stage in shared memory as f32.  Per (row, column) a lane sums its
// rows in increasing k with fmaf, the 4 warps' sums are added as
// (w0 + w2) + (w1 + w3), and the ksplit partial sums, when there are several,
// in increasing z by a second kernel.  None of that depends on S, RT or the
// row's place in the tile, so every row is computed bit for bit alike.
#include <cuda.h>  // CUtensorMap; the encoder is looked up in the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace dflash_mm {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;   // columns per block: 4 per lane
constexpr int kChunk = 256;  // k rows of x staged in shared memory at a time

__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Four int8 values packed in a word -> exact floats.  b ^ 0x80 is b + 128 as
// an unsigned byte; placed in the low mantissa byte of 2^23 it gives the
// float 2^23 + b + 128, and subtracting 2^23 + 128 leaves b exactly.  One
// byte permute and one add per value instead of an int-to-float conversion.
__device__ __forceinline__ void unpack4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) - 8388736.f;
  }
}

template <int RT>
struct Smem {
  union {
    float x[RT][kChunk];                      // staged x rows of one chunk
    float red[2][RT][kCols];                  // warps 2 and 3's sums
  };
};

template <typename T, typename O, int RT>
__global__ void __launch_bounds__(kThreads)
matmul_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, O* __restrict__ out,
                   float* __restrict__ partial, int S, int K, int N_pad, int n) {
  __shared__ __align__(16) Smem<RT> sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * RT;
  const int col = blockIdx.y * kCols + 4 * lane;  // this lane's first column
  const bool col_ok = col < N_pad;                // N_pad % 4 == 0: all 4 or none
  const int klen = K / gridDim.z;
  const int kbeg = blockIdx.z * klen, kend = kbeg + klen;

  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kChunk) {
    const int len = min(kChunk, kend - k0);  // a multiple of 4
    __syncthreads();                         // the previous chunk is consumed
    for (int i = threadIdx.x; i < RT * kChunk; i += kThreads) {
      const int r = i / kChunk, kk = i % kChunk;
      const int row = row0 + r;
      sm.x[r][kk] = (row < S && kk < len) ? to_f32(x[(long)row * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      const int8_t* wp = w + (long)k0 * N_pad + col;
#pragma unroll 4
      for (int kk = 4 * warp; kk < len; kk += 4 * kWarps) {
        float wf[4][4];  // [k row of the quad][column]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unpack4(__ldg(reinterpret_cast<const uint32_t*>(wp + (long)(kk + j) * N_pad)), wf[j]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(&sm.x[r][kk]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(xv.x, wf[0][c], acc[r][c]);
            acc[r][c] = fmaf(xv.y, wf[1][c], acc[r][c]);
            acc[r][c] = fmaf(xv.z, wf[2][c], acc[r][c]);
            acc[r][c] = fmaf(xv.w, wf[3][c], acc[r][c]);
          }
        }
      }
    }
  }

  // Fixed-order sum over the warps: (w0 + w2) + (w1 + w3).
  __syncthreads();  // x is no longer read: its space holds the partial sums
  if (warp >= 2) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sm.red[warp - 2][r][4 * lane + c] = acc[r][c];
  }
  __syncthreads();
  if (warp < 2) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += sm.red[warp][r][4 * lane + c];
  }
  __syncthreads();
  if (warp == 1) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sm.red[0][r][4 * lane + c] = acc[r][c];
  }
  __syncthreads();
  if (warp != 0 || !col_ok) return;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row0 + r;
    if (row >= S) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sum = acc[r][c] + sm.red[0][r][4 * lane + c];
      if (partial != nullptr) {
        partial[((long)blockIdx.z * S + row) * N_pad + col + c] = sum;
      } else if (col + c < n) {
        store(out + (long)row * n + col + c, sum * scale[col + c]);
      }
    }
  }
}

// Ragged variant: bf16 x with N_pad % 16 != 0, a width whose weight rows TMA
// and 16-byte copies cannot address (no projection of a model has one: the
// quantizer pads N to 512).  S <= 32: mma.sync m16n8k16 (bf16 in, f32
// accumulate) on 16-row tiles, grid (ceil(S / 16), ceil(N_pad / kCols)), with
// the sum over warps of the FMA variant; no K split.
// The weights go from device memory straight into the B fragments, without
// shared memory: a fragment needs rows k .. k+1 and k+8 .. k+9 of one column,
// and a 4-byte load gives 4 columns of one row, so lane (g, t) (g = lane / 4,
// t = lane % 4) loads rows 2t, 2t+1, 2t+8, 2t+9 at columns 4g .. 4g+3 of each
// 32-column group and feeds 4 mma tiles with them: column 4g + i of the group
// is column g of tile i.  A warp's 4-byte loads cover whole 32-byte sectors.
// The int8 values become bf16 exactly (|b| <= 127).  The accumulator then
// holds, for rows g and g+8, columns 8t .. 8t+7 of each group.
__device__ __forceinline__ uint32_t bf16x2(uint32_t lo, uint32_t hi, int i) {
  // byte i of lo and of hi (already ^ 0x80808080) -> two bf16, lo in the low half
  const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540u | i)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540u | i)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);  // exact: low halves are 0
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct SmemMma {
  union {
    __nv_bfloat16 x[16][kChunk + 8];  // +8: the A-fragment loads hit 32 distinct banks
    float red[2][16][kCols];
  };
};

// This lane's accumulator slots: c0/c1 of tile i of group cg sit at row g,
// columns 32cg + 8t + i and 32cg + 8t + 4 + i; c2/c3 at row g + 8.
__device__ __forceinline__ int mma_row(int g, int c) { return g + 8 * (c >> 1); }
__device__ __forceinline__ int mma_col(int t, int cg, int i, int c) {
  return 32 * cg + 8 * t + 4 * (c & 1) + i;
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
matmul_int8_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale, O* __restrict__ out, int S, int K, int N_pad,
                       int n) {
  __shared__ __align__(16) SmemMma sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 16;
  const int col0 = blockIdx.y * kCols;

  float acc[4][4][4];  // [32-column group][tile][c0..c3]
#pragma unroll
  for (int cg = 0; cg < 4; ++cg)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[cg][i][c] = 0.f;
  bool cg_ok[4];  // this lane's 4 load columns exist (N_pad % 4 == 0: all or none)
#pragma unroll
  for (int cg = 0; cg < 4; ++cg) cg_ok[cg] = col0 + 32 * cg + 4 * g < N_pad;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int len = min(kChunk, K - k0);  // a multiple of 16
    __syncthreads();                      // the previous chunk is consumed
    for (int i = threadIdx.x; i < 16 * kChunk; i += kThreads) {
      const int r = i / kChunk, kk = i % kChunk;
      const int row = row0 + r;
      sm.x[r][kk] = (row < S && kk < len) ? x[(long)row * K + k0 + kk] : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 16 * warp; kk < len; kk += 16 * kWarps) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&sm.x[g][kk + 2 * t]);
      a[1] = *reinterpret_cast<const uint32_t*>(&sm.x[g + 8][kk + 2 * t]);
      a[2] = *reinterpret_cast<const uint32_t*>(&sm.x[g][kk + 2 * t + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&sm.x[g + 8][kk + 2 * t + 8]);
      const int8_t* wp = w + (long)(k0 + kk + 2 * t) * N_pad + col0 + 4 * g;
      // Every lane runs every mma (mma.sync is warp-wide); lanes past the
      // last column feed zeros.
#pragma unroll
      for (int cg = 0; cg < 4; ++cg) {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(wp + 32 * cg);
        const long r1 = N_pad / 4;  // one weight row, in words
        const bool ok = cg_ok[cg];
        const uint32_t w0 = (ok ? __ldg(p) : 0u) ^ 0x80808080u;
        const uint32_t w1 = (ok ? __ldg(p + r1) : 0u) ^ 0x80808080u;
        const uint32_t w8 = (ok ? __ldg(p + 8 * r1) : 0u) ^ 0x80808080u;
        const uint32_t w9 = (ok ? __ldg(p + 9 * r1) : 0u) ^ 0x80808080u;
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(acc[cg][i], a, bf16x2(w0, w1, i), bf16x2(w8, w9, i));
      }
    }
  }

  // Fixed-order sum over the warps, (w0 + w2) + (w1 + w3), as above.
  __syncthreads();  // x is no longer read: its space holds the partial sums
  if (warp >= 2) {
#pragma unroll
    for (int cg = 0; cg < 4; ++cg)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sm.red[warp - 2][mma_row(g, c)][mma_col(t, cg, i, c)] = acc[cg][i][c];
  }
  __syncthreads();
  if (warp < 2) {
#pragma unroll
    for (int cg = 0; cg < 4; ++cg)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[cg][i][c] += sm.red[warp][mma_row(g, c)][mma_col(t, cg, i, c)];
  }
  __syncthreads();
  if (warp == 1) {
#pragma unroll
    for (int cg = 0; cg < 4; ++cg)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sm.red[0][mma_row(g, c)][mma_col(t, cg, i, c)] = acc[cg][i][c];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int cg = 0; cg < 4; ++cg) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = mma_row(g, c), cc = mma_col(t, cg, i, c);
        const int row = row0 + r, col = col0 + cc;
        if (row < S && col < n) store(out + (long)row * n + col, (acc[cg][i][c] + sm.red[0][r][cc]) * scale[col]);
      }
  }
}

// Ragged variant, S > 32: 64 rows per block, so each weight fragment feeds 4
// row tiles, and warp w owns the 32-column group w with the whole K range (no
// sum across warps).  Same fragments and column map as above.
struct SmemRows {
  __nv_bfloat16 x[64][kChunk + 8];
};

template <typename O>
__global__ void __launch_bounds__(kThreads)
matmul_int8_mma_rows_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                            const float* __restrict__ scale, O* __restrict__ out, int S, int K, int N_pad,
                            int n) {
  __shared__ __align__(16) SmemRows sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 64;
  const int col0 = blockIdx.y * kCols + 32 * warp;  // this warp's column group
  const bool ok = col0 + 4 * g < N_pad;

  float acc[4][4][4];  // [16-row tile][column tile][c0..c3]
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int len = min(kChunk, K - k0);  // a multiple of 16
    __syncthreads();
    // 8 bf16 (16 bytes) per load: K % 16 == 0 keeps rows and chunks aligned
    for (int i = threadIdx.x; i < 64 * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), kk = 8 * (i % (kChunk / 8));
      const int row = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < S && kk < len) v = *reinterpret_cast<const uint4*>(x + (long)row * K + k0 + kk);
      *reinterpret_cast<uint4*>(&sm.x[r][kk]) = v;
    }
    __syncthreads();
    const int8_t* wp = w + (long)(k0 + 2 * t) * N_pad + col0 + 4 * g;
    const long r1 = N_pad / 4;  // one weight row, in words
#pragma unroll 2
    for (int kk = 0; kk < len; kk += 16) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(wp + (long)kk * N_pad);
      const uint32_t w0 = (ok ? __ldg(p) : 0u) ^ 0x80808080u;
      const uint32_t w1 = (ok ? __ldg(p + r1) : 0u) ^ 0x80808080u;
      const uint32_t w8 = (ok ? __ldg(p + 8 * r1) : 0u) ^ 0x80808080u;
      const uint32_t w9 = (ok ? __ldg(p + 9 * r1) : 0u) ^ 0x80808080u;
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[i][0] = bf16x2(w0, w1, i);
        b[i][1] = bf16x2(w8, w9, i);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(&sm.x[16 * m + g][kk + 2 * t]);
        a[1] = *reinterpret_cast<const uint32_t*>(&sm.x[16 * m + g + 8][kk + 2 * t]);
        a[2] = *reinterpret_cast<const uint32_t*>(&sm.x[16 * m + g][kk + 2 * t + 8]);
        a[3] = *reinterpret_cast<const uint32_t*>(&sm.x[16 * m + g + 8][kk + 2 * t + 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(acc[m][i], a, b[i][0], b[i][1]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row0 + 16 * m + mma_row(g, c), col = col0 + mma_col(t, 0, i, c);
        if (row < S && col < n) store(out + (long)row * n + col, acc[m][i][c] * scale[col]);
      }
}

// out[s, c] = (partial[0, s, c] + partial[1, s, c] + ...) * scale[c], c < n.
template <typename O>
__global__ void reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                              O* __restrict__ out, int S, int N_pad, int n, int ksplit) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)S * n) return;
  const int row = (int)(idx / n), col = (int)(idx % n);
  float sum = partial[(long)row * N_pad + col];
  for (int z = 1; z < ksplit; ++z) sum += partial[((long)z * S + row) * N_pad + col];
  store(out + idx, sum * scale[col]);
}

// After the main kernel: its launch error, or the second pass over the K split.
template <typename O>
static cudaError_t finish(float* partial, const float* scale, void* out, int S, int N_pad, int n,
                          int ksplit, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const long total = (long)S * n;
  reduce_kernel<O><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(partial, scale, (O*)out, S,
                                                                        N_pad, n, ksplit);
  return cudaGetLastError();
}

template <typename T, typename O, int RT>
static cudaError_t launch_rt(const void* x, const int8_t* w, const float* scale, void* out,
                             float* partial, int S, int K, int N_pad, int n, int ksplit,
                             cudaStream_t stream) {
  dim3 grid((S + RT - 1) / RT, (N_pad + kCols - 1) / kCols, ksplit);
  matmul_int8_kernel<T, O, RT><<<grid, kThreads, 0, stream>>>(
      (const T*)x, w, scale, (O*)out, ksplit > 1 ? partial : nullptr, S, K, N_pad, n);
  return finish<O>(partial, scale, out, S, N_pad, n, ksplit, stream);
}

// Ragged variant: one launch, no K split.
template <typename O>
static cudaError_t launch_ragged(const void* x, const int8_t* w, const float* scale, void* out, int S,
                                 int K, int N_pad, int n, cudaStream_t stream) {
  if (S <= 32) {
    dim3 grid((S + 15) / 16, (N_pad + kCols - 1) / kCols);
    matmul_int8_mma_kernel<O><<<grid, kThreads, 0, stream>>>((const __nv_bfloat16*)x, w, scale, (O*)out, S, K,
                                                             N_pad, n);
  } else {
    dim3 grid((S + 63) / 64, (N_pad + kCols - 1) / kCols);
    matmul_int8_mma_rows_kernel<O><<<grid, kThreads, 0, stream>>>((const __nv_bfloat16*)x, w, scale,
                                                                  (O*)out, S, K, N_pad, n);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Shared by the stream and wgmma variants.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row r, column c) in a tile of 128-byte rows whose 16-byte
// chunks are permuted by chunk ^ (r % 8), the layout TMA's 128-byte swizzle
// writes (the tile starts on a 1024-byte boundary).  A lane (g, t) reads the 4
// columns 4g.. of rows 2t, 2t + 1, 2t + 8, 2t + 9 of a k16 slice: the rows of
// one load are 2 apart, so their chunks, and banks, all differ.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// Tensor-core sums are promoted into f32 registers every kPromote stages of
// 64 k (see the wgmma variant): no chain of tensor-core accumulations runs
// longer than 256 k.
constexpr int kPromote = 4;

__device__ __forceinline__ float cvt_out(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 cvt_out(float v, __nv_bfloat16) { return __float2bfloat16(v); }

template <int B>
struct alignas(B) Bytes {
  unsigned char b[B];
};

// C consecutive output columns col.. of one row (col % C == 0), times their
// scales: one vector store when all lie below n and n keeps them aligned.
template <typename O, int C>
__device__ __forceinline__ void store_scaled(O* row_out, int col, const float* v,
                                             const float* __restrict__ scale, int n) {
  if (col + C <= n && n % C == 0) {
    alignas(C * sizeof(O)) O tmp[C];
#pragma unroll
    for (int j = 0; j < C; ++j) tmp[j] = cvt_out(v[j] * scale[col + j], O());
    using Vec = Bytes<C * (int)sizeof(O)>;
    *reinterpret_cast<Vec*>(row_out + col) = *reinterpret_cast<const Vec*>(tmp);
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (col + j < n) store(row_out + col + j, v[j] * scale[col + j]);
  }
}

// ---------------------------------------------------------------------------
// Stream variant: bf16 x, 1 <= S <= 32 (the AR step's S = 1, verify's 16, the
// draft's 15-16).  Bound by the weight bytes; every weight byte crosses device
// memory once and stays int8 until it reaches the registers.
//
// Grid (ceil(N_pad / kCols), split): a block owns kCols = 128 columns and the
// K range [z * K/split, (z+1) * K/split), walked in stages of kStreamK rows
// through a ring of kStreamStages shared-memory stages filled by 16-byte
// cp.async copies (3 stages, 24 KB of weight, in flight per block while one
// is consumed, and several blocks per SM; a deeper ring, with fewer blocks
// per SM, was slower on the H100).  A stage also holds the stage's k
// range of x's S rows (rows past S are zeros, written once: S = 1 is a
// zero-padded m16 tile).  Warp w owns the 32-column group w over the whole
// range: per k16 slice it reads x's A fragments by ldmatrix and its weight
// words from the swizzled int8 tile, widens them exactly to bf16 and runs
// mma.sync m16n8k16 (f32 accumulate, promoted into f32 registers every
// kPromote stages), with the column map of the ragged
// variant (column 4g + i of the group is column g of n8 tile i).
//
// With split > 1 each block writes its f32 partial tile; the last block of
// a column tile to finish (an integer counter after __threadfence; no float
// atomics) sums the partials in increasing z, scales and stores, and resets
// the counter.  The split is a function of (K, N_pad) only, and a row's sum
// never depends on the other rows, so rows are bit-identical for every S in
// 1 .. 32: a bf16 AR step equals the same row of a verify.
// ---------------------------------------------------------------------------

constexpr int kStreamK = 64;      // k rows of one stage
constexpr int kStreamStages = 4;  // ring depth

template <int MT>  // m16 row tiles: 16 * MT rows of x
struct SmemStream {
  int8_t w[kStreamStages][kStreamK * kCols];                // swizzled (swz)
  __nv_bfloat16 x[kStreamStages][16 * MT][kStreamK + 8];  // +8: ldmatrix rows on distinct banks
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

template <typename O, int MT>
__global__ void __launch_bounds__(kThreads)
matmul_int8_stream_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                          const float* __restrict__ scale, O* __restrict__ out,
                          float* __restrict__ partial, int* __restrict__ counters, int S, int K,
                          int N_pad, int n) {
  extern __shared__ __align__(128) unsigned char stream_smem[];
  SmemStream<MT>& sm = *reinterpret_cast<SmemStream<MT>*>(stream_smem);
  __shared__ int is_last;
  constexpr int XCH = kStreamK / 8;  // 16-byte chunks of a staged x row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kCols;
  const int klen = K / gridDim.y;
  const int kbeg = blockIdx.y * klen, kend = kbeg + klen;
  const int n_steps = (klen + kStreamK - 1) / kStreamK;

  for (int i = threadIdx.x; i < kStreamStages * 16 * MT * XCH; i += kThreads) {
    const int st = i / (16 * MT * XCH), r = (i / XCH) % (16 * MT), c = i % XCH;
    if (r >= S) *reinterpret_cast<uint4*>(&sm.x[st][r][8 * c]) = make_uint4(0u, 0u, 0u, 0u);
  }
  // Stage `step` of this block's range: the weight rows (columns past N_pad
  // are not loaded: their outputs are never stored) and x's S rows.
  auto load = [&](int step) {
    const int st = step % kStreamStages;
    const int k0 = kbeg + step * kStreamK, len = min(kStreamK, kend - k0);
    for (int i = threadIdx.x; i < kStreamK * 8; i += kThreads) {
      const int r = i >> 3, c = 16 * (i & 7);
      if (r < len && col0 + c < N_pad) cp_async16(&sm.w[st][swz(r, c)], w + (long)(k0 + r) * N_pad + col0 + c);
    }
    for (int i = threadIdx.x; i < S * XCH; i += kThreads) {
      const int r = i / XCH, c = 8 * (i % XCH);
      if (c < len) cp_async16(&sm.x[st][r][c], x + (long)r * K + k0 + c);
    }
  };

  float acc[MT][4][4], part[MT][4][4];  // [m16 tile][n8 tile][c0..c3]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][i][c] = part[m][i][c] = 0.f;
  const int cw = 32 * warp + 4 * g;  // this lane's 4 weight columns in the tile

#pragma unroll
  for (int s = 0; s < kStreamStages - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStreamStages - 2>();
    __syncthreads();  // stage `step` landed; stage step - 1 is consumed by every warp
    if (step + kStreamStages - 1 < n_steps) load(step + kStreamStages - 1);
    cp_async_commit();
    const int st = step % kStreamStages;
    const int len = min(kStreamK, kend - (kbeg + step * kStreamK));  // a multiple of 16
    const int8_t* wt = sm.w[st];
#pragma unroll
    for (int kk = 0; kk < kStreamK; kk += 16) {
      if (kk >= len) break;
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) ldmatrix_x4(a[m], &sm.x[st][16 * m + (lane & 15)][kk + 8 * (lane >> 4)]);
      const int r = kk + 2 * t;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wt + swz(r, cw)) ^ 0x80808080u;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wt + swz(r + 1, cw)) ^ 0x80808080u;
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wt + swz(r + 8, cw)) ^ 0x80808080u;
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wt + swz(r + 9, cw)) ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b0 = bf16x2(w0, w1, i), b1 = bf16x2(w8, w9, i);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(part[m][i], a[m], b0, b1);
      }
    }
    if (step % kPromote == kPromote - 1 || step == n_steps - 1) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[m][i][c] += part[m][i][c];
            part[m][i][c] = 0.f;
          }
    }
  }

  // This lane holds, for rows 16m + g and 16m + g + 8, the 8 columns
  // 32 * warp + 8t .. + 7 (c0/c1 of n8 tile i at 8t + i and 8t + 4 + i).
  const bool split = gridDim.y > 1;
  const int col = col0 + 32 * warp + 8 * t;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * m + g + 8 * h;
      if (row >= S || col >= N_pad) continue;
      float v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = acc[m][i][2 * h];
        v[4 + i] = acc[m][i][2 * h + 1];
      }
      if (split) {
        float4* p = reinterpret_cast<float4*>(partial + ((long)blockIdx.y * S + row) * N_pad + col);
        p[0] = make_float4(v[0], v[1], v[2], v[3]);
        p[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        store_scaled<O, 8>(out + (long)row * n, col, v, scale, n);
      }
    }
  if (!split) return;

  // In-launch merge: the column tile's last block sums the partials in z order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&counters[blockIdx.x], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < S * (kCols / 4); i += kThreads) {
    const int row = i / (kCols / 4), c = col0 + 4 * (i % (kCols / 4));
    if (c >= N_pad) continue;
    const float* p = partial + (long)row * N_pad + c;
    float4 sum = __ldcg(reinterpret_cast<const float4*>(p));
#pragma unroll 8
    for (int z = 1; z < (int)gridDim.y; ++z) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p + (long)z * S * N_pad));
      sum.x += q.x;
      sum.y += q.y;
      sum.z += q.z;
      sum.w += q.w;
    }
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
    store_scaled<O, 4>(out + (long)row * n, c, v, scale, n);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

template <typename O, int MT>
static cudaError_t launch_stream(const void* x, const int8_t* w, const float* scale, void* out,
                                 float* partial, int* counters, int S, int K, int N_pad, int n,
                                 int split, cudaStream_t stream) {
  auto kernel = matmul_int8_stream_kernel<O, MT>;
  const int smem = (int)sizeof(SmemStream<MT>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N_pad + kCols - 1) / kCols, split);
  kernel<<<grid, kThreads, smem, stream>>>((const __nv_bfloat16*)x, w, scale, (O*)out, partial, counters,
                                           S, K, N_pad, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma variant: bf16 x, S > 32 (the prompt).  Bound by operations.
//
// wgmma has no bf16 x int8 form, so the weight has to be widened on chip.
// The operands are swapped, out^T = W^T x^T: the weight is widened in
// registers and fed as wgmma's register A operand, and x is B, read by wgmma
// from shared memory as TMA wrote it.  That needs no widening pass through
// shared memory and no second copy of the weight tile (CUTLASS's mixed-input
// GEMMs do the same), and x [S, K] is already the K-major B operand.
//
// Block: 2 consumer warpgroups and 1 producer warpgroup; grid (ceil(S / BS),
// ceil(N_pad / 128)), the row tiles of one column tile side by side so that
// they share the weight through L2.  The producer's lane 0 fills a ring of
// kTmaStages stages by TMA: x [BS rows][64 k] as bf16 and the weight box
// [64 k][128 columns] as int8, both with the 128-byte swizzle; mbarriers hand
// a full stage to the consumers (transaction bytes) and an empty one back
// (one arrival per consumer thread).  Warpgroup wg owns 64 columns: its warp
// ww's lane (g, t) reads 2 columns (a half word) of 4 weight rows per k16
// slice, widens them exactly to bf16 and forms the A fragment of the m64
// tile, in which row g of warp ww's 16 rows is column 16ww + 2g of the
// warpgroup's 64 and row g + 8 the next column.  Each k16 slice issues one
// wgmma.mma_async m64nBSk16 (f32 accumulate).
//
// A long chain of wgmma accumulations loses more than f32 rounding would (on
// the H100, a K = 4096 chain erred by 7.8e-5 where chains of 8 k16 steps
// erred by 2.9e-6), so the wgmmas sum kPromote stages (256 k) into a partial
// accumulator, which is then added to the f32 accumulator in registers.  In
// between, a warpgroup waits only for the stage before the one it has just
// issued (wgmma.wait_group 1) and hands that stage back: the widening of the
// next stage overlaps the tensor cores' work on this one.  No K split: each
// output is summed in one block, in one order, in one launch.  TMA
// zero-fills rows past S, k past K and columns past N_pad; columns past n are
// never written.
// ---------------------------------------------------------------------------

constexpr int kTmaK = 64;       // k per stage: one 128-byte row of x
constexpr int kTmaStages = 4;
constexpr int kTmaThreads = 3 * 128;  // 2 consumer warpgroups, 1 producer warpgroup

template <int BS>
struct SmemTma {  // every tile a multiple of 1024 bytes, from a 1024-byte aligned base
  __nv_bfloat16 x[kTmaStages][BS * kTmaK];
  int8_t w[kTmaStages][kTmaK * 128];
  uint64_t full[kTmaStages], empty[kTmaStages];
};

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
// Waits until the phase of the given parity completes.  The loop is inside
// the asm, so the compiler sees no divergent path next to in-flight wgmmas;
// a wait that cannot end (a fault in the pipeline) traps after 2^26 tries,
// so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :
      : "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory descriptor of a K-major B tile with 128-byte rows, 128-byte
// swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The compiler must neither read a wgmma's registers before the wait nor
// reuse them while it runs: these keep each value live and in place.
__device__ __forceinline__ void keep_reg(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void keep_reg(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// D[64 x N] (+)= A[64 x 16] (bf16, registers) * B[16 x N] (bf16, shared
// memory); scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float* d, const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


template <typename O, int BS>
__global__ void __launch_bounds__(kTmaThreads, 1)
matmul_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                         const float* __restrict__ scale, O* __restrict__ out, int S, int K, int n) {
  extern __shared__ unsigned char tma_smem[];
  const uint32_t raw = smem_u32(tma_smem);
  SmemTma<BS>& sm = *reinterpret_cast<SmemTma<BS>*>(tma_smem + (((raw + 1023u) & ~1023u) - raw));
  const int s0 = blockIdx.x * BS, col0 = blockIdx.y * 128;
  const int n_steps = (K + kTmaK - 1) / kTmaK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kTmaStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 256);  // one arrival per consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Producer and consumers part here for good (setmaxnreg needs paths that
  // never meet again): the producer warpgroup gives up registers, the
  // consumers take them for their two accumulators.
  if (wg == 2) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      constexpr uint32_t kBytes = BS * kTmaK * 2 + kTmaK * 128;
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % kTmaStages;
        if (step >= kTmaStages) mbar_wait(&sm.empty[st], (step / kTmaStages - 1) & 1);
        mbar_expect_tx(&sm.full[st], kBytes);
        tma_load(sm.x[st], &tm_x, &sm.full[st], step * kTmaK, s0);
        tma_load(sm.w[st], &tm_w, &sm.full[st], col0, step * kTmaK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, ww = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int cb = 64 * wg + 16 * ww + 2 * g;  // this lane's 2 columns in the block's 128
    float acc[BS / 2], part[BS / 2];
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) acc[i] = part[i] = 0.f;
    uint32_t a0[4][4], a1[4][4];  // the A fragments of two consecutive stages

    // Widen stage `step`'s weight into a (all 4 k16 slices first, so their
    // loads overlap) and issue its 4 wgmmas as one group;
    // `fresh` starts a new partial sum.  Control flow around the wgmmas is
    // uniform by construction (no branch depends on the lane or the step), so
    // the compiler keeps them asynchronous.
    auto issue = [&](int step, uint32_t(&a)[4][4], bool fresh) {
      const int st = step % kTmaStages;
      mbar_wait(&sm.full[st], (step / kTmaStages) & 1);
      const int8_t* wt = sm.w[st];
      const uint32_t xa = smem_u32(sm.x[st]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int r = 16 * kk + 2 * t;
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(wt + swz(r, cb)) ^ 0x8080u;
        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(wt + swz(r + 1, cb)) ^ 0x8080u;
        const uint32_t w8 = *reinterpret_cast<const uint16_t*>(wt + swz(r + 8, cb)) ^ 0x8080u;
        const uint32_t w9 = *reinterpret_cast<const uint16_t*>(wt + swz(r + 9, cb)) ^ 0x8080u;
        a[kk][0] = bf16x2(w0, w1, 0);
        a[kk][1] = bf16x2(w0, w1, 1);
        a[kk][2] = bf16x2(w8, w9, 0);
        a[kk][3] = bf16x2(w8, w9, 1);
      }
      wgmma_fence();  // the A registers just written, and the partial accumulator
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<BS>(part, a[kk], desc_b128(xa + 32 * kk), kk > 0 || !fresh);
      wgmma_commit();
    };
    auto keep_a = [&](uint32_t(&a)[4][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) keep_reg(a[kk][j]);
    };
    auto promote = [&]() {
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) {
        keep_reg(part[i]);
        acc[i] += part[i];
      }
    };

    // Groups of kPromote stages: each stage is handed back once the next one
    // is issued (wait_group 1); the group drains and promotes at its end.
    const int n_full = n_steps / kPromote * kPromote;
    for (int step0 = 0; step0 < n_full; step0 += kPromote) {
#pragma unroll
      for (int j = 0; j < kPromote; ++j) {
        issue(step0 + j, (j & 1) ? a1 : a0, j == 0);
        if (j > 0) {
          wgmma_wait<1>();
          keep_a((j & 1) ? a0 : a1);
          mbar_arrive(&sm.empty[(step0 + j - 1) % kTmaStages]);
        }
      }
      wgmma_wait<0>();
      keep_a(((kPromote - 1) & 1) ? a1 : a0);
      promote();
      mbar_arrive(&sm.empty[(step0 + kPromote - 1) % kTmaStages]);
    }
    // The last n_steps % kPromote stages (K % 256 != 0), one at a time.
    for (int step = n_full; step < n_steps; ++step) {
      issue(step, a0, step == n_full);
      wgmma_wait<0>();
      keep_a(a0);
      mbar_arrive(&sm.empty[step % kTmaStages]);
    }
    if (n_full < n_steps) promote();

    // acc[4j + e] is (column cb, row s0 + 8j + 2t + e), acc[4j + 2 + e] the
    // next column.
    const int col = col0 + cb;
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = s0 + 8 * j + 2 * t + e;
        if (s >= S) continue;
        const float v[2] = {acc[4 * j + e], acc[4 * j + 2 + e]};
        store_scaled<O, 2>(out + (long)s * n, col, v, scale, n);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the process has loaded (the
// library is built without linking the driver).
static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
  }();
  return fn;
}

// A 2-D row-major tensor [outer][inner] with rows of row_bytes, read in boxes
// [box_outer][box_inner] with the 128-byte swizzle; out-of-range elements read as 0.
static bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
                      uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename O, int BS>
static cudaError_t launch_wgmma(const void* x, const int8_t* w, const float* scale, void* out, int S, int K,
                                int N_pad, int n, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w;
  if (!encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, S, (uint64_t)K * 2, kTmaK, BS) ||
      !encode_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N_pad, K, N_pad, 128, kTmaK))
    return cudaErrorInvalidValue;
  auto kernel = matmul_int8_wgmma_kernel<O, BS>;
  const int smem = (int)sizeof(SmemTma<BS>) + 1024;  // + the alignment of the base
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BS - 1) / BS, (N_pad + 127) / 128);
  kernel<<<grid, kTmaThreads, smem, stream>>>(tm_x, tm_w, scale, (O*)out, S, K, n);
  return cudaGetLastError();
}

// The plan's variant (0 fma, 1 ragged, 2 stream, 3 wgmma) with its tile
// (rows, cols) and K split; anything the plan never produces is refused.
template <typename O>
static cudaError_t launch(int variant, int x_dtype, const void* x, const int8_t* w, const float* scale,
                          void* out, float* partial, int* counters, int S, int K, int N_pad, int n, int rows,
                          int cols, int split, cudaStream_t stream) {
  if (variant == 0 && x_dtype == 0 && cols == kCols) {
    if (rows == 1) return launch_rt<float, O, 1>(x, w, scale, out, partial, S, K, N_pad, n, split, stream);
    if (rows == 4) return launch_rt<float, O, 4>(x, w, scale, out, partial, S, K, N_pad, n, split, stream);
    if (rows == 16) return launch_rt<float, O, 16>(x, w, scale, out, partial, S, K, N_pad, n, split, stream);
    return cudaErrorInvalidValue;
  }
  if (x_dtype != 1) return cudaErrorInvalidValue;
  if (variant == 1 && split == 1) return launch_ragged<O>(x, w, scale, out, S, K, N_pad, n, stream);
  if (N_pad % 16) return cudaErrorInvalidValue;
  if (variant == 2 && cols == kCols && S <= rows && (split == 1 || counters != nullptr)) {
    if (rows == 16) return launch_stream<O, 1>(x, w, scale, out, partial, counters, S, K, N_pad, n, split, stream);
    if (rows == 32) return launch_stream<O, 2>(x, w, scale, out, partial, counters, S, K, N_pad, n, split, stream);
  }
  if (variant == 3 && split == 1) {
    if (rows == 160 && cols == 128) return launch_wgmma<O, 160>(x, w, scale, out, S, K, N_pad, n, stream);
    if (rows == 128 && cols == 128) return launch_wgmma<O, 128>(x, w, scale, out, S, K, N_pad, n, stream);
    if (rows == 64 && cols == 128) return launch_wgmma<O, 64>(x, w, scale, out, S, K, N_pad, n, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dflash_mm

// x_dtype / out_dtype: 0 = float32, 1 = bfloat16.  variant, rows, cols, split:
// matmul_q.plan's.  partial: [split, S, N_pad] f32 scratch when split > 1,
// else unused; counters: zeroed int32, one per column tile, for the stream
// variant's in-launch merge (left zeroed).  K % (16 * split) == 0 and
// N_pad % 4 == 0 (the wrapper checks).  Returns a cudaError_t (0 = launched).
extern "C" int dflash_matmul_int8(int variant, int x_dtype, int out_dtype, const void* x, const void* w,
                                  const void* scale, void* out, void* partial, void* counters, int S, int K,
                                  int N_pad, int n, int rows, int cols, int split, void* stream) {
  using namespace dflash_mm;
  const int8_t* wq = (const int8_t*)w;
  const float* sc = (const float*)scale;
  float* part = (float*)partial;
  cudaStream_t s = (cudaStream_t)stream;
  if (split < 1 || K % (16 * split) || N_pad % 4 || (split > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    return launch<float>(variant, x_dtype, x, wq, sc, out, part, (int*)counters, S, K, N_pad, n, rows, cols, split, s);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(variant, x_dtype, x, wq, sc, out, part, (int*)counters, S, K, N_pad, n, rows,
                                 cols, split, s);
  return (int)cudaErrorInvalidValue;
}
