// int8 weight-only matmul of every projection of the int8 serving path:
// Hopper port of dflash_tpu/kernels/matmul_q.py::matmul_int8 (the
// pl.pallas_call at :56).  See dflash_tpu_torch/kernels/matmul_q.py for what
// bounds it, what this design does about that, and which variant runs when.
//
// out[s, c] = (sum_k x[s, k] * float(w[k, c])) * scale[c]   for c < n
// x [S, K] float or bf16 (row stride K); w [K, N_pad] int8 (row stride N_pad);
// scale [N_pad] f32; out [S, n] float or bf16 (row stride n).
//
// FMA variant (f32 x, and S = 1): grid (ceil(S / RT), ceil(N_pad / kCols),
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dflash_mm {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;   // columns per block: 4 per lane
constexpr int kChunk = 256;  // k rows of x staged in shared memory at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// bf16 x, 1 < S <= 32: the products run on the tensor cores, mma.sync
// m16n8k16 (bf16 in, f32 accumulate), on the same grid, K partition and sum
// over warps as above with RT = 16.
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
                       const float* __restrict__ scale, O* __restrict__ out,
                       float* __restrict__ partial, int S, int K, int N_pad, int n) {
  __shared__ __align__(16) SmemMma sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 16;
  const int col0 = blockIdx.y * kCols;
  const int klen = K / gridDim.z;
  const int kbeg = blockIdx.z * klen, kend = kbeg + klen;

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

  for (int k0 = kbeg; k0 < kend; k0 += kChunk) {
    const int len = min(kChunk, kend - k0);  // a multiple of 16
    __syncthreads();                         // the previous chunk is consumed
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
        if (row >= S || col >= N_pad) continue;
        const float sum = acc[cg][i][c] + sm.red[0][r][cc];
        if (partial != nullptr) {
          partial[((long)blockIdx.z * S + row) * N_pad + col] = sum;
        } else if (col < n) {
          store(out + (long)row * n + col, sum * scale[col]);
        }
      }
  }
}

// bf16 x, prompts (S > 32): 64 rows per block, so each weight fragment feeds 4
// row tiles, and warp w owns the 32-column group w with the block's whole K
// range (no sum across warps).  Same fragments and column map as above.
struct SmemRows {
  __nv_bfloat16 x[64][kChunk + 8];
};

template <typename O>
__global__ void __launch_bounds__(kThreads)
matmul_int8_mma_rows_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                            const float* __restrict__ scale, O* __restrict__ out,
                            float* __restrict__ partial, int S, int K, int N_pad, int n) {
  __shared__ __align__(16) SmemRows sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 64;
  const int col0 = blockIdx.y * kCols + 32 * warp;  // this warp's column group
  const int klen = K / gridDim.z;
  const int kbeg = blockIdx.z * klen, kend = kbeg + klen;
  const bool ok = col0 + 4 * g < N_pad;

  float acc[4][4][4];  // [16-row tile][column tile][c0..c3]
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][i][c] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kChunk) {
    const int len = min(kChunk, kend - k0);  // a multiple of 16
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
        if (row >= S || col >= N_pad) continue;
        if (partial != nullptr) {
          partial[((long)blockIdx.z * S + row) * N_pad + col] = acc[m][i][c];
        } else if (col < n) {
          store(out + (long)row * n + col, acc[m][i][c] * scale[col]);
        }
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

template <typename O>
static cudaError_t launch_mma(const void* x, const int8_t* w, const float* scale, void* out,
                              float* partial, int S, int K, int N_pad, int n, int ksplit,
                              cudaStream_t stream) {
  dim3 grid((S + 15) / 16, (N_pad + kCols - 1) / kCols, ksplit);
  matmul_int8_mma_kernel<O><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, w, scale, (O*)out, ksplit > 1 ? partial : nullptr, S, K, N_pad, n);
  return finish<O>(partial, scale, out, S, N_pad, n, ksplit, stream);
}

template <typename O>
static cudaError_t launch_mma_rows(const void* x, const int8_t* w, const float* scale, void* out,
                                   float* partial, int S, int K, int N_pad, int n, int ksplit,
                                   cudaStream_t stream) {
  dim3 grid((S + 63) / 64, (N_pad + kCols - 1) / kCols, ksplit);
  matmul_int8_mma_rows_kernel<O><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, w, scale, (O*)out, ksplit > 1 ? partial : nullptr, S, K, N_pad, n);
  return finish<O>(partial, scale, out, S, N_pad, n, ksplit, stream);
}

// S = 1 (the AR step's GEMV): FMA units, one row per block, both x dtypes.
// bf16 x, S > 1: tensor cores, 16-row tiles up to S = 32 (verify, draft),
// 64-row tiles beyond (prefill).  f32 x, S > 1: FMA units, 4- or 16-row tiles.
template <typename T, typename O>
static cudaError_t launch(const void* x, const int8_t* w, const float* scale, void* out,
                          float* partial, int S, int K, int N_pad, int n, int ksplit,
                          cudaStream_t stream) {
  if (S == 1) return launch_rt<T, O, 1>(x, w, scale, out, partial, S, K, N_pad, n, ksplit, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (S <= 32) return launch_mma<O>(x, w, scale, out, partial, S, K, N_pad, n, ksplit, stream);
    return launch_mma_rows<O>(x, w, scale, out, partial, S, K, N_pad, n, ksplit, stream);
  } else {
    if (S <= 4) return launch_rt<T, O, 4>(x, w, scale, out, partial, S, K, N_pad, n, ksplit, stream);
    return launch_rt<T, O, 16>(x, w, scale, out, partial, S, K, N_pad, n, ksplit, stream);
  }
}

}  // namespace dflash_mm

// x_dtype / out_dtype: 0 = float32, 1 = bfloat16.  partial: [ksplit, S, N_pad]
// f32 scratch when ksplit > 1, else unused.  K % (16 * ksplit) == 0 and
// N_pad % 4 == 0 (the wrapper checks).  Returns a cudaError_t (0 = launched).
extern "C" int dflash_matmul_int8(int x_dtype, int out_dtype, const void* x, const void* w,
                                  const void* scale, void* out, void* partial, int S, int K,
                                  int N_pad, int n, int ksplit, void* stream) {
  using namespace dflash_mm;
  const int8_t* wq = (const int8_t*)w;
  const float* sc = (const float*)scale;
  float* part = (float*)partial;
  cudaStream_t s = (cudaStream_t)stream;
  if (ksplit < 1 || K % (16 * ksplit) || N_pad % 4 || (ksplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, wq, sc, out, part, S, K, N_pad, n, ksplit, s);
  if (x_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, wq, sc, out, part, S, K, N_pad, n, ksplit, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, wq, sc, out, part, S, K, N_pad, n, ksplit, s);
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, wq, sc, out, part, S, K, N_pad, n, ksplit, s);
  return (int)cudaErrorInvalidValue;
}
