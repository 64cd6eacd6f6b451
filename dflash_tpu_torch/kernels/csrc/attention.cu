// Frontier-bounded causal verify attention over the KV cache, batch 1:
// Hopper port of dflash_tpu/kernels/attention.py::_call_kernel (the
// pl.pallas_call at :113, under verify_attention).  See
// dflash_tpu_torch/kernels/attention.py for what bounds it and what this
// design does about that.
//
// q [B, nh, D] (block rows at positions start .. start + B - 1), cache K/V
// [T, n_kv, D] whose rows start .. start + B - 1 already hold the block's own
// K/V.  Query row r attends key j iff j <= start + r.  Rows at or past
// start + B are stale cache contents and are never loaded: a block walks key
// tiles only below start + (its last row) + 1, and the ragged last tile is
// zero-filled in shared memory.  Query head h reads kv head h / (nh / n_kv).
// Output [B, nh*D] in T.
//
// The single-part case of verify_fused.cu: the same tile walk and f32 online
// softmax (attn_tile.cuh), without the block part.
// Grid (nh, ceil(B / RQ)): one block per (query head, tile of RQ rows).
#include "attn_tile.cuh"

namespace dflash {

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
verify_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int B, int nh, int n_kv,
                        int start, float scale) {
  constexpr int RQ = kWarps * RPW;
  __shared__ Smem<D, RQ> sm;
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * RQ;
  const int hk = h / (nh / n_kv);
  const long q_stride = (long)nh * D;
  const long kv_stride = (long)n_kv * D;

  load_rows<T, D, RQ, D>(sm.q, q + row0 * q_stride + h * D, min(RQ, B - row0), q_stride);
  RowState<D, RPW> st;
  st.init();

  const int n_keys = start + min(row0 + RQ, B);  // keys any row of this tile attends
  for (int t0 = 0; t0 < n_keys; t0 += kKeyTile) {
    const int nk = min(kKeyTile, n_keys - t0);
    __syncthreads();  // the previous tile has been consumed
    load_rows<T, D, kKeyTile, D + 1>(sm.k, k + t0 * kv_stride + hk * D, nk, kv_stride);
    load_rows<T, D, kKeyTile, D>(sm.v, v + t0 * kv_stride + hk * D, nk, kv_stride);
    __syncthreads();
    attend_tile<D, RQ, RPW>(sm, st, scale, 1.f,
                            [&](int r, int j) { return j < nk && t0 + j <= start + row0 + r; });
  }

  store_rows<T, D, RPW>(out + h * D, st, row0, B, q_stride);
}

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int nh,
                          int n_kv, int start, float scale, cudaStream_t stream) {
  // Few rows (the AR step's B = 1): one row per warp, so idle rows cost less.
  if (B <= kWarps) {
    dim3 grid(nh, (B + kWarps - 1) / kWarps);
    verify_attention_kernel<T, D, 1><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, B, nh, n_kv, start, scale);
  } else {
    constexpr int RQ = kWarps * 4;
    dim3 grid(nh, (B + RQ - 1) / RQ);
    verify_attention_kernel<T, D, 4><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, B, nh, n_kv, start, scale);
  }
  return cudaGetLastError();
}

}  // namespace dflash

// dtype: 0 = float32, 1 = bfloat16 (q, cache K/V, out).  Returns a
// cudaError_t (0 = launched).
extern "C" int dflash_verify_attention(int dtype, int head_dim, const void* q, const void* k,
                                       const void* v, void* out, int B, int nh, int n_kv,
                                       int start, float scale, void* stream) {
  using namespace dflash;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, B, nh, n_kv, start, scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, B, nh, n_kv, start, scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, nh, n_kv, start, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, nh, n_kv, start, scale, s);
  return (int)cudaErrorInvalidValue;
}
