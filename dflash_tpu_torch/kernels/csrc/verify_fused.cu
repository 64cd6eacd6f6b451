// Two-part GQA attention of the verify, the AR step and the draft:
// Hopper port of dflash_tpu/kernels/verify_fused.py::_fused_lanes (the
// pl.pallas_call at :219), both of its branches.  See
// dflash_tpu_torch/kernels/verify_fused.py for what bounds it and what this
// design does about that.
//
// Queries q [R, nh, D] (R = C*B rows); part one is the shared ctx K/V
// [T, n_kv, D], read ONLY for rows < ctx_len (rows at or past the frontier are
// stale cache contents and are never loaded); part two is the block K/V
// [R, n_kv, D] under an [R, R] mask (the wrapper folds candidate isolation into
// it).  Both parts run through one f32 online softmax, so no merge pass is
// needed.  Query head h reads kv head h / (nh / n_kv).  Output [R, nh*D] in T.
//
// The ctx K/V are in q's type T, or int8 (C = int8_t) with f32 scales
// [T, n_kv] per row and kv head: the key scale multiplies the score,
// s * (ks[t] * scale), and the value scale the probability after l has summed
// it unscaled, as the Pallas kernel orders it (_kernel :98-122).  The block
// K/V are always in T.
//
// Grid (nh, ceil(R / RQ)): one block per (query head, tile of RQ rows).
#include <type_traits>

#include "attn_tile.cuh"

namespace dflash {

template <typename T, typename C, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
verify_fused_kernel(const T* __restrict__ q, const C* __restrict__ ctx_k,
                    const float* __restrict__ ctx_ks, const C* __restrict__ ctx_v,
                    const float* __restrict__ ctx_vs, const T* __restrict__ blk_k,
                    const T* __restrict__ blk_v, const uint8_t* __restrict__ mask,
                    T* __restrict__ out, int R, int nh, int n_kv, int ctx_len, float scale) {
  constexpr int RQ = kWarps * RPW;
  constexpr bool kQuant = std::is_same<C, int8_t>::value;
  __shared__ Smem<D, RQ> sm;
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * RQ;
  const int hk = h / (nh / n_kv);
  const int lane = threadIdx.x & 31;
  const long q_stride = (long)nh * D;
  const long kv_stride = (long)n_kv * D;

  load_rows<T, D, RQ, D>(sm.q, q + row0 * q_stride + h * D, min(RQ, R - row0), q_stride);
  RowState<D, RPW> st;
  st.init();

  // Part one: ctx rows [0, ctx_len).  ctx_len == 0 runs no tile.
  for (int t0 = 0; t0 < ctx_len; t0 += kKeyTile) {
    const int nk = min(kKeyTile, ctx_len - t0);
    __syncthreads();  // the previous tile has been consumed
    load_rows<C, D, kKeyTile, D + 1>(sm.k, ctx_k + t0 * kv_stride + hk * D, nk, kv_stride);
    load_rows<C, D, kKeyTile, D>(sm.v, ctx_v + t0 * kv_stride + hk * D, nk, kv_stride);
    float kmul = scale, vmul = 1.f;
    if (kQuant && lane < nk) {  // this lane's key row t0 + lane
      kmul = ctx_ks[(long)(t0 + lane) * n_kv + hk] * scale;
      vmul = ctx_vs[(long)(t0 + lane) * n_kv + hk];
    }
    __syncthreads();
    attend_tile<D, RQ, RPW>(sm, st, kmul, vmul, [&](int r, int j) { return j < nk; });
  }

  // Part two: the R block rows, mask[row, key] per (query row, key row).
  for (int t0 = 0; t0 < R; t0 += kKeyTile) {
    const int nk = min(kKeyTile, R - t0);
    __syncthreads();
    load_rows<T, D, kKeyTile, D + 1>(sm.k, blk_k + t0 * kv_stride + hk * D, nk, kv_stride);
    load_rows<T, D, kKeyTile, D>(sm.v, blk_v + t0 * kv_stride + hk * D, nk, kv_stride);
    __syncthreads();
    attend_tile<D, RQ, RPW>(sm, st, scale, 1.f, [&](int r, int j) {
      const int row = row0 + r;
      return j < nk && row < R && mask[(long)row * R + t0 + j] != 0;
    });
  }

  store_rows<T, D, RPW>(out + h * D, st, row0, R, q_stride);
}

template <typename T, typename C, int D>
static cudaError_t launch(const void* q, const void* ck, const float* cks, const void* cv,
                          const float* cvs, const void* bk, const void* bv, const uint8_t* mask,
                          void* out, int R, int nh, int n_kv, int ctx_len, float scale,
                          cudaStream_t stream) {
  // Few rows (the AR step's R = 1): one row per warp, so idle rows cost less.
  if (R <= kWarps) {
    dim3 grid(nh, (R + kWarps - 1) / kWarps);
    verify_fused_kernel<T, C, D, 1><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const C*)ck, cks, (const C*)cv, cvs, (const T*)bk, (const T*)bv, mask,
        (T*)out, R, nh, n_kv, ctx_len, scale);
  } else {
    constexpr int RQ = kWarps * 4;
    dim3 grid(nh, (R + RQ - 1) / RQ);
    verify_fused_kernel<T, C, D, 4><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const C*)ck, cks, (const C*)cv, cvs, (const T*)bk, (const T*)bv, mask,
        (T*)out, R, nh, n_kv, ctx_len, scale);
  }
  return cudaGetLastError();
}

// The ctx type: T itself, or int8 with scales.
template <typename T, int D>
static cudaError_t launch_ctx(bool quant, const void* q, const void* ck, const float* cks,
                              const void* cv, const float* cvs, const void* bk, const void* bv,
                              const uint8_t* mask, void* out, int R, int nh, int n_kv, int ctx_len,
                              float scale, cudaStream_t stream) {
  if (quant)
    return launch<T, int8_t, D>(q, ck, cks, cv, cvs, bk, bv, mask, out, R, nh, n_kv, ctx_len,
                                scale, stream);
  return launch<T, T, D>(q, ck, nullptr, cv, nullptr, bk, bv, mask, out, R, nh, n_kv, ctx_len,
                         scale, stream);
}

static cudaError_t dispatch(int dtype, int head_dim, bool quant, const void* q, const void* ck,
                            const float* cks, const void* cv, const float* cvs, const void* bk,
                            const void* bv, const void* mask, void* out, int R, int nh, int n_kv,
                            int ctx_len, float scale, void* stream) {
  const uint8_t* m = (const uint8_t*)mask;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && head_dim == 128)
    return launch_ctx<float, 128>(quant, q, ck, cks, cv, cvs, bk, bv, m, out, R, nh, n_kv, ctx_len,
                                  scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch_ctx<float, 64>(quant, q, ck, cks, cv, cvs, bk, bv, m, out, R, nh, n_kv, ctx_len,
                                 scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_ctx<__nv_bfloat16, 128>(quant, q, ck, cks, cv, cvs, bk, bv, m, out, R, nh, n_kv,
                                          ctx_len, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_ctx<__nv_bfloat16, 64>(quant, q, ck, cks, cv, cvs, bk, bv, m, out, R, nh, n_kv,
                                         ctx_len, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace dflash

// dtype: 0 = float32, 1 = bfloat16 (q, block K/V, out; and the ctx K/V).
// Returns a cudaError_t (0 = launched).
extern "C" int dflash_verify_fused(int dtype, int head_dim, const void* q, const void* ctx_k,
                                   const void* ctx_v, const void* blk_k, const void* blk_v,
                                   const void* mask, void* out, int R, int nh, int n_kv,
                                   int ctx_len, float scale, void* stream) {
  return (int)dflash::dispatch(dtype, head_dim, false, q, ctx_k, nullptr, ctx_v, nullptr, blk_k,
                               blk_v, mask, out, R, nh, n_kv, ctx_len, scale, stream);
}

// The int8 ctx: ctx_k / ctx_v [T, n_kv, D] int8, ctx_ks / ctx_vs [T, n_kv] f32.
extern "C" int dflash_verify_fused_int8(int dtype, int head_dim, const void* q, const void* ctx_k,
                                        const void* ctx_ks, const void* ctx_v, const void* ctx_vs,
                                        const void* blk_k, const void* blk_v, const void* mask,
                                        void* out, int R, int nh, int n_kv, int ctx_len,
                                        float scale, void* stream) {
  return (int)dflash::dispatch(dtype, head_dim, true, q, ctx_k, (const float*)ctx_ks, ctx_v,
                               (const float*)ctx_vs, blk_k, blk_v, mask, out, R, nh, n_kv, ctx_len,
                               scale, stream);
}
