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
// it).  The result is the softmax over both parts.  Query head h reads kv
// head h / (nh / n_kv).  Output [R, nh*D] in T.
//
// The ctx K/V are in q's type T, or int8 with f32 scales [T, n_kv] per row
// and kv head: the key scale multiplies the score, s * (ks[t] * scale), and
// the value scale the probability after l has summed it unscaled, as the
// Pallas kernel orders it (_kernel :98-122).  The block K/V are always in T.
//
// bf16 (either ctx): tensor cores (attn_mma.cuh), attention.cu's split design
// with one more part.  The M = g * R query rows of one kv head are packed
// head-major (packed row p is query head hk * g + p / R at block row p % R)
// and served together, 16 rows a warp, 4 warps (64 rows) a block; at R = 1
// the 4 rows fill one padded m16 tile and the idle warps only stage.  Grid
// (n_ctx_splits + 1, n_kv, row groups): splits [0, n_ctx_splits) walk the
// ctx keys below ctx_len, split_tiles 64-key tiles each (only the ragged last
// tile masked), and split n_ctx_splits walks the R block keys under the mask
// (mask[row * R + key], never by position: the draft's mask is all-true and
// C > 1 isolates candidates), so a block never mixes the two sources.  With
// ctx_len == 0 that is the only split and the block writes the output;
// otherwise each split writes f32 partials and a second, programmatic
// dependent launch merges them in split order (no atomics: the same bits on
// every run).  int8 ctx tiles are staged with cp.async as int8 (16 values per
// 16 bytes) with their scales, then widened exactly to bf16 in the padded
// tile that ldmatrix reads; the key scales (times scale * log2 e) and value
// scales enter the tile step as per-key multipliers.  Rows and scales past
// ctx_len are zero-filled in shared memory, never loaded.
//
// f32 (either ctx): the FMA walk of attn_tile.cuh, both parts through one f32
// online softmax, grid (nh, ceil(R / RQ)): one block per (query head, tile of
// RQ rows).  A row's result does not depend on R, which the exact f32
// spec == AR run needs.
#include <type_traits>

#include "attn_mma.cuh"
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

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // packed query rows per block
constexpr int kMmaKeys = 64;              // keys per tile: verify_fused.py's KEY_TILE

// Shared memory of the bf16 kernel: the tiles ldmatrix reads, and for an int8
// ctx the int8 staging of two tiles and their scales.
template <int D, bool QUANT>
struct MmaSmem {
  mma::Smem<D, kMmaRows, kMmaKeys> t;
};
template <int D>
struct MmaSmem<D, true> {
  mma::Smem<D, kMmaRows, kMmaKeys> t;
  alignas(16) int8_t k8[2][kMmaKeys][D];
  alignas(16) int8_t v8[2][kMmaKeys][D];
  float ks[2][kMmaKeys], vs[2][kMmaKeys];
};

// 16 int8 values -> 16 bf16 (exact) at dst.
__device__ __forceinline__ void widen16(mma::bf16* dst, const int8_t* src) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[2 * i] = mma::pack_bf16((float)(int8_t)(w[i] & 0xff), (float)(int8_t)((w[i] >> 8) & 0xff));
    h[2 * i + 1] = mma::pack_bf16((float)(int8_t)((w[i] >> 16) & 0xff), (float)(int8_t)(w[i] >> 24));
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// Packed rows [kMmaRows * blockIdx.z, +kMmaRows) of kv head blockIdx.y over
// split blockIdx.x: ctx keys [split * split_tiles * 64, ..) below ctx_len
// for split < n_ctx_splits, else the R block keys.  ws == nullptr: one split,
// write out.  QUANT: the ctx K/V are int8 with scales ks / vs.
template <int D, bool QUANT>
__global__ void __launch_bounds__(32 * kMmaWarps)
verify_fused_mma_kernel(const mma::bf16* __restrict__ q, const void* __restrict__ ctx_k,
                        const float* __restrict__ ctx_ks, const void* __restrict__ ctx_v,
                        const float* __restrict__ ctx_vs, const mma::bf16* __restrict__ blk_k,
                        const mma::bf16* __restrict__ blk_v, const uint8_t* __restrict__ mask,
                        mma::bf16* __restrict__ out, float* __restrict__ ws, int R, int nh, int n_kv,
                        int ctx_len, int n_ctx_splits, int split_tiles, float scale_log2) {
  using mma::bf16;
  constexpr int NT = 32 * kMmaWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& all = *reinterpret_cast<MmaSmem<D, QUANT>*>(smem_raw);
  auto& sm = all.t;
  const int g = nh / n_kv, M = g * R;
  const int split = blockIdx.x, hk = blockIdx.y, p_base = blockIdx.z * kMmaRows;
  const long q_stride = (long)nh * D;
  const long kv_stride = (long)n_kv * D;

  mma::stage_rows<D, kMmaRows, NT>(sm.q, [&](int pl) -> const bf16* {
    const int p = p_base + pl;
    return p < M ? q + (p % R) * q_stride + (hk * g + p / R) * D : nullptr;
  });
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  mma::Warp<D, kMmaKeys> w;
  w.init([&](int pl) { return (p_base + pl) % R; });  // the packed row's block row
  const bool active = 16 * (threadIdx.x >> 5) < M - p_base;  // the warp holds a packed row

  // Stage rows t0 .. t0 + nk - 1 of bf16 K/V (row r at k + r * kv_stride + hk * D) into buffer buf.
  auto stage_bf16 = [&](const bf16* k, const bf16* v, int t0, int nk, int buf) {
    const bf16* kb = k + t0 * kv_stride + hk * D;
    const bf16* vb = v + t0 * kv_stride + hk * D;
    mma::stage_rows<D, kMmaKeys, NT>(sm.k[buf], [&](int r) { return r < nk ? kb + r * kv_stride : nullptr; });
    mma::stage_rows<D, kMmaKeys, NT>(sm.v[buf], [&](int r) { return r < nk ? vb + r * kv_stride : nullptr; });
  };

  if (split < n_ctx_splits) {  // part one: ctx keys [key0, key_end)
    const int key0 = split * split_tiles * kMmaKeys;
    const int key_end = min(key0 + split_tiles * kMmaKeys, ctx_len);
    const int n_tiles = (key_end - key0 + kMmaKeys - 1) / kMmaKeys;
    auto attend = [&](int i, int b, const auto& sc) {  // only the ragged last tile is masked
      if (!active) return;
      const int t0 = key0 + i * kMmaKeys;
      if (t0 + kMmaKeys > key_end) {
        w.template tile<true>(sm.q, sm.k[b], sm.v[b], scale_log2, [&](int, int j) { return t0 + j < key_end; },
                              sc);
      } else {
        w.template tile<false>(sm.q, sm.k[b], sm.v[b], scale_log2, [](int, int) { return true; }, sc);
      }
    };
    if constexpr (!QUANT) {
      mma::pipeline(n_tiles, [&](int tile, int buf) {
        const int t0 = key0 + tile * kMmaKeys;
        stage_bf16(static_cast<const bf16*>(ctx_k), static_cast<const bf16*>(ctx_v), t0,
                   min(kMmaKeys, key_end - t0), buf);
      }, [&](int i, int b) { attend(i, b, mma::NoScale{}); });
    } else {
      const int8_t* k = static_cast<const int8_t*>(ctx_k);
      const int8_t* v = static_cast<const int8_t*>(ctx_v);
      constexpr int CH = D / 16;  // 16-byte chunks of an int8 row
      auto stage = [&](int tile, int buf) {
        const int t0 = key0 + tile * kMmaKeys, nk = min(kMmaKeys, key_end - t0);
        for (int idx = threadIdx.x; idx < 2 * kMmaKeys * CH; idx += NT) {
          const int part = idx / (kMmaKeys * CH), r = (idx / CH) % kMmaKeys, c = (idx % CH) * 16;
          int8_t* dst = part ? &all.v8[buf][r][c] : &all.k8[buf][r][c];
          if (r < nk) {
            mma::cp_async16(dst, (part ? v : k) + (t0 + r) * kv_stride + hk * D + c);
          } else {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        for (int idx = threadIdx.x; idx < 2 * kMmaKeys; idx += NT) {
          const int part = idx / kMmaKeys, r = idx % kMmaKeys;
          float* dst = part ? &all.vs[buf][r] : &all.ks[buf][r];
          if (r < nk) {
            mma::cp_async4(dst, (part ? ctx_vs : ctx_ks) + (long)(t0 + r) * n_kv + hk);
          } else {
            *dst = 0.f;  // scales past the frontier may be NaN or stale
          }
        }
      };
      mma::pipeline(n_tiles, stage, [&](int i, int b) {  // widen the staged int8 tile, then attend
        for (int idx = threadIdx.x; idx < 2 * kMmaKeys * CH; idx += NT) {
          const int part = idx / (kMmaKeys * CH), r = (idx / CH) % kMmaKeys, c = (idx % CH) * 16;
          widen16(part ? &sm.v[b][r][c] : &sm.k[b][r][c], part ? &all.v8[b][r][c] : &all.k8[b][r][c]);
        }
        if (threadIdx.x < kMmaKeys) all.ks[b][threadIdx.x] *= scale_log2;
        __syncthreads();
        attend(i, b, mma::KeyScales{all.ks[b], all.vs[b]});
      });
    }
  } else {  // part two: the R block keys under the mask
    mma::pipeline((R + kMmaKeys - 1) / kMmaKeys, [&](int tile, int buf) {
      stage_bf16(blk_k, blk_v, tile * kMmaKeys, min(kMmaKeys, R - tile * kMmaKeys), buf);
    }, [&](int i, int b) {
      if (!active) return;
      const int t0 = i * kMmaKeys;
      w.template tile<true>(sm.q, sm.k[b], sm.v[b], scale_log2, [&](int h, int j) {
        return t0 + j < R && mask[(long)w.pos[h] * R + t0 + j] != 0;
      }, mma::NoScale{});
    });
  }
  w.finish();
  mma::store_split(w, out, ws, p_base, R, nh, n_kv, hk);
}

// bf16 q, block K/V and out; the ctx in bf16 or (QUANT) int8 with scales.
template <int D, bool QUANT>
static cudaError_t launch_mma(const void* q, const void* ck, const float* cks, const void* cv,
                              const float* cvs, const void* bk, const void* bv, const uint8_t* mask,
                              void* out, float* ws, int R, int nh, int n_kv, int ctx_len, int split_tiles,
                              float scale, cudaStream_t stream) {
  if (split_tiles < 1) return cudaErrorInvalidValue;
  const int M = (nh / n_kv) * R;
  const int n_ctx_tiles = (ctx_len + kMmaKeys - 1) / kMmaKeys;
  const int n_ctx_splits = (n_ctx_tiles + split_tiles - 1) / split_tiles;
  const int n_splits = n_ctx_splits + 1;  // + the block part
  if (n_splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  if (n_splits == 1) ws = nullptr;
  static bool smem_set = false;
  constexpr int smem = sizeof(MmaSmem<D, QUANT>);
  cudaError_t err = mma::allow_smem(verify_fused_mma_kernel<D, QUANT>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(n_splits, n_kv, (M + kMmaRows - 1) / kMmaRows);
  using mma::bf16;
  verify_fused_mma_kernel<D, QUANT><<<grid, 32 * kMmaWarps, smem, stream>>>(
      (const bf16*)q, ck, cks, cv, cvs, (const bf16*)bk, (const bf16*)bv, mask, (bf16*)out, ws, R, nh, n_kv,
      ctx_len, n_ctx_splits, split_tiles, scale * mma::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return err;
  return mma::launch_merge<D>(ws, (bf16*)out, R, nh, n_kv, n_splits, stream);
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
                            const void* bv, const void* mask, void* out, void* workspace, int R, int nh,
                            int n_kv, int ctx_len, int split_tiles, float scale, void* stream) {
  const uint8_t* m = (const uint8_t*)mask;
  float* ws = (float*)workspace;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && head_dim == 128)
    return launch_ctx<float, 128>(quant, q, ck, cks, cv, cvs, bk, bv, m, out, R, nh, n_kv, ctx_len,
                                  scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch_ctx<float, 64>(quant, q, ck, cks, cv, cvs, bk, bv, m, out, R, nh, n_kv, ctx_len,
                                 scale, s);
  if (dtype == 1 && head_dim == 128)
    return quant ? launch_mma<128, true>(q, ck, cks, cv, cvs, bk, bv, m, out, ws, R, nh, n_kv, ctx_len,
                                         split_tiles, scale, s)
                 : launch_mma<128, false>(q, ck, nullptr, cv, nullptr, bk, bv, m, out, ws, R, nh, n_kv,
                                          ctx_len, split_tiles, scale, s);
  if (dtype == 1 && head_dim == 64)
    return quant ? launch_mma<64, true>(q, ck, cks, cv, cvs, bk, bv, m, out, ws, R, nh, n_kv, ctx_len,
                                        split_tiles, scale, s)
                 : launch_mma<64, false>(q, ck, nullptr, cv, nullptr, bk, bv, m, out, ws, R, nh, n_kv,
                                         ctx_len, split_tiles, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace dflash

// dtype: 0 = float32, 1 = bfloat16 (q, block K/V, out; and the ctx K/V).
// bf16 only: split_tiles = 64-key ctx tiles per split, workspace =
// n_splits * n_kv * g * R * (D + 2) floats, n_splits = ceil(ceil(ctx_len / 64)
// / split_tiles) + 1, when n_splits > 1 (else may be null).  Returns a
// cudaError_t (0 = launched).
extern "C" int dflash_verify_fused(int dtype, int head_dim, const void* q, const void* ctx_k,
                                   const void* ctx_v, const void* blk_k, const void* blk_v,
                                   const void* mask, void* out, void* workspace, int R, int nh, int n_kv,
                                   int ctx_len, int split_tiles, float scale, void* stream) {
  return (int)dflash::dispatch(dtype, head_dim, false, q, ctx_k, nullptr, ctx_v, nullptr, blk_k, blk_v,
                               mask, out, workspace, R, nh, n_kv, ctx_len, split_tiles, scale, stream);
}

// The int8 ctx: ctx_k / ctx_v [T, n_kv, D] int8, ctx_ks / ctx_vs [T, n_kv] f32.
extern "C" int dflash_verify_fused_int8(int dtype, int head_dim, const void* q, const void* ctx_k,
                                        const void* ctx_ks, const void* ctx_v, const void* ctx_vs,
                                        const void* blk_k, const void* blk_v, const void* mask,
                                        void* out, void* workspace, int R, int nh, int n_kv, int ctx_len,
                                        int split_tiles, float scale, void* stream) {
  return (int)dflash::dispatch(dtype, head_dim, true, q, ctx_k, (const float*)ctx_ks, ctx_v,
                               (const float*)ctx_vs, blk_k, blk_v, mask, out, workspace, R, nh, n_kv,
                               ctx_len, split_tiles, scale, stream);
}
