// Causal GQA flash attention of the target prefill: Hopper port of
// dflash_tpu/kernels/prefill_flash.py::_flash_lanes (the pl.pallas_call at
// :111).  See dflash_tpu_torch/kernels/prefill_flash.py for what bounds it and
// what this design does about that.
//
// q [S, nh, D], k/v [S, n_kv, D]; query row i attends key rows j <= i.  Any S:
// the ragged last tile is masked.  Output [S, nh*D] in T.
//
// Grid (nh, ceil(S / RQ)): one block per (query head, tile of RQ rows).  A
// block walks key tiles only up to its last row's diagonal, so tiles above
// the diagonal are neither loaded nor computed.  Block y runs the row tiles
// from the last (the most keys) to the first, so the longest blocks start first.
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

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v, void* out, int S, int nh,
                          int n_kv, float scale, cudaStream_t stream) {
  constexpr int RQ = kWarps * kRowsPerWarp;
  dim3 grid(nh, (S + RQ - 1) / RQ);
  prefill_flash_kernel<T, D><<<grid, kThreads, 0, stream>>>((const T*)q, (const T*)k,
                                                            (const T*)v, (T*)out, S, nh, n_kv,
                                                            scale);
  return cudaGetLastError();
}

}  // namespace dflash

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int dflash_prefill_flash(int dtype, int head_dim, const void* q, const void* k,
                                    const void* v, void* out, int S, int nh, int n_kv,
                                    float scale, void* stream) {
  using namespace dflash;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(q, k, v, out, S, nh, n_kv, scale, s);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(q, k, v, out, S, nh, n_kv, scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, S, nh, n_kv, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, S, nh, n_kv, scale, s);
  return (int)cudaErrorInvalidValue;
}
