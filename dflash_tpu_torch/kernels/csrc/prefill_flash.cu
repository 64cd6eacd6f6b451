// Causal GQA flash attention of the target prefill: Hopper port of
// dflash_tpu/kernels/prefill_flash.py::_flash_lanes (the pl.pallas_call at
// :111).  See dflash_tpu_torch/kernels/prefill_flash.py for what bounds it and
// what this design does about that.
//
// q [L, S, nh, D], k/v [L, S, n_kv, D] (L request lanes, one prompt bucket
// S for all); query row i of a lane attends key rows j <= i of the same lane.
// Any S: the ragged last tile is masked.  Output [L, S, nh*D] in T.  Lanes
// are the third grid axis (the Pallas kernel's lane grid dimension); a lane's
// blocks compute exactly what a single-lane call on its rows computes.
//
// bf16: tensor cores (attn_mma.cuh).  Grid (n_kv, ceil(S / QR), L): one block of
// 4 warps per (kv head, tile of QR = 64 / g positions) serves all g query
// heads of the kv head as 64 packed rows (head-major: packed row p is query
// head hk * g + p / QR at position row0 + p % QR), so each K/V tile is staged
// once for the g heads.  Key tiles of 64 rows run only up to the block's last
// position; only the tile(s) crossing the diagonal are masked.
//
// f32: the FMA walk of attn_tile.cuh.  Grid (nh, ceil(S / RQ), L): one
// block per (query head, tile of RQ rows, lane).  A block walks key tiles only up to
// its last row's diagonal, so tiles above the diagonal are neither loaded nor
// computed.
//
// Both run the row tiles from the last (the most keys) to the first, so the
// longest blocks start first.
#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace dflash {

constexpr int kRowsPerWarp = 4;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prefill_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S, int nh, int n_kv,
                     float scale) {
  constexpr int RQ = kWarps * kRowsPerWarp;
  __shared__ Smem<D, RQ> sm;
  const int h = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * RQ;
  const int hk = h / (nh / n_kv);
  const long q_stride = (long)nh * D;
  const long kv_stride = (long)n_kv * D;
  q += (long)blockIdx.z * S * q_stride;  // the request lane's rows
  out += (long)blockIdx.z * S * q_stride;
  k += (long)blockIdx.z * S * kv_stride;
  v += (long)blockIdx.z * S * kv_stride;

  load_rows<T, D, RQ, D>(sm.q, q + row0 * q_stride + h * D, min(RQ, S - row0), q_stride);
  RowState<D, kRowsPerWarp> st;
  st.init();

  const int n_keys = min(row0 + RQ, S);  // keys any row of this tile attends
  for (int t0 = 0; t0 < n_keys; t0 += kKeyTile) {
    const int nk = min(kKeyTile, n_keys - t0);
    __syncthreads();  // the previous tile has been consumed
    load_rows<T, D, kKeyTile, D + 1>(sm.k, k + t0 * kv_stride + hk * D, nk, kv_stride);
    load_rows<T, D, kKeyTile, D>(sm.v, v + t0 * kv_stride + hk * D, nk, kv_stride);
    __syncthreads();
    attend_tile<D, RQ, kRowsPerWarp>(sm, st, scale, 1.f,
                                     [&](int r, int j) { return j < nk && t0 + j <= row0 + r; });
  }

  store_rows<T, D, kRowsPerWarp>(out + h * D, st, row0, S, q_stride);
}

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // packed query rows per block
constexpr int kMmaKeys = 64;              // keys per K/V tile

template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps)
prefill_flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S,
                         int nh, int n_kv, float scale_log2) {
  using mma::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<mma::Smem<D, kMmaRows, kMmaKeys>*>(smem_raw);
  const int g = nh / n_kv, QR = kMmaRows / g, used = g * QR;
  const int hk = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * QR;
  const long q_stride = (long)nh * D;
  const long kv_stride = (long)n_kv * D;
  q += (long)blockIdx.z * S * q_stride;  // the request lane's rows
  out += (long)blockIdx.z * S * q_stride;
  k += (long)blockIdx.z * S * kv_stride;
  v += (long)blockIdx.z * S * kv_stride;

  // packed row p: query head hk * g + p / QR at position row0 + p % QR
  mma::stage_rows<D, kMmaRows, 32 * kMmaWarps>(sm.q, [&](int p) -> const bf16* {
    const int pos = row0 + p % QR;
    return p < used && pos < S ? q + pos * q_stride + (hk * g + p / QR) * D : nullptr;
  });
  const int n_keys = min(row0 + QR, S);  // keys any row of this block attends
  auto stage_kv = [&](int tile, int buf) {
    const int t0 = tile * kMmaKeys, nk = min(kMmaKeys, n_keys - t0);
    const bf16* kb = k + t0 * kv_stride + hk * D;
    const bf16* vb = v + t0 * kv_stride + hk * D;
    mma::stage_rows<D, kMmaKeys, 32 * kMmaWarps>(sm.k[buf], [&](int r) { return r < nk ? kb + r * kv_stride : nullptr; });
    mma::stage_rows<D, kMmaKeys, 32 * kMmaWarps>(sm.v[buf], [&](int r) { return r < nk ? vb + r * kv_stride : nullptr; });
  };

  mma::Warp<D, kMmaKeys> w;
  w.init([&](int p) { return row0 + p % QR; });
  mma::walk(sm, w, (n_keys + kMmaKeys - 1) / kMmaKeys, 0, scale_log2, stage_kv,
            [&](int i) { return (i + 1) * kMmaKeys - 1 > row0; });  // crosses the diagonal
  w.finish();
  const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = r0 + 8 * h, pos = w.pos[h];
    if (p < used && pos < S) w.store(out + pos * q_stride + (hk * g + p / QR) * D, h);
  }
}

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v, void* out, int L, int S, int nh,
                          int n_kv, float scale, cudaStream_t stream) {
  constexpr int RQ = kWarps * kRowsPerWarp;
  dim3 grid(nh, (S + RQ - 1) / RQ, L);
  prefill_flash_kernel<T, D><<<grid, kThreads, 0, stream>>>((const T*)q, (const T*)k,
                                                            (const T*)v, (T*)out, S, nh, n_kv,
                                                            scale);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int L, int S, int nh,
                              int n_kv, float scale, cudaStream_t stream) {
  static bool smem_set = false;
  constexpr int smem = sizeof(mma::Smem<D, kMmaRows, kMmaKeys>);
  cudaError_t err = mma::allow_smem(prefill_flash_mma_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int QR = kMmaRows / (nh / n_kv);
  dim3 grid(n_kv, (S + QR - 1) / QR, L);
  prefill_flash_mma_kernel<D><<<grid, 32 * kMmaWarps, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S,
      nh, n_kv, scale * mma::kLog2e);
  return cudaGetLastError();
}

}  // namespace dflash

// dtype: 0 = float32, 1 = bfloat16.  L request lanes of S rows each (q
// [L, S, nh, D], k/v [L, S, n_kv, D], out [L, S, nh * D]).  Returns a
// cudaError_t (0 = launched).  bf16 takes g = nh / n_kv <= 64 query heads per
// kv head.
extern "C" int dflash_prefill_flash(int dtype, int head_dim, const void* q, const void* k,
                                    const void* v, void* out, int L, int S, int nh, int n_kv,
                                    float scale, void* stream) {
  using namespace dflash;
  cudaStream_t s = (cudaStream_t)stream;
  if (L < 1 || L > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(q, k, v, out, L, S, nh, n_kv, scale, s);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(q, k, v, out, L, S, nh, n_kv, scale, s);
  if (dtype == 1 && nh / n_kv > kMmaRows) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 128) return launch_mma<128>(q, k, v, out, L, S, nh, n_kv, scale, s);
  if (dtype == 1 && head_dim == 64) return launch_mma<64>(q, k, v, out, L, S, nh, n_kv, scale, s);
  return (int)cudaErrorInvalidValue;
}
