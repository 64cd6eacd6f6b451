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
// tiles only below start + B, and the ragged last tile is zero-filled in
// shared memory.  Query head h reads kv head h / (nh / n_kv).  Output
// [B, nh*D] in T.
//
// bf16: tensor cores (attn_mma.cuh), split over the keys.  The M = g * B
// query rows of one kv head are packed head-major (packed row p is query head
// hk * g + p / B at row p % B) and served together, 16 rows a warp, 4 warps
// (64 rows) a block, so each K/V tile is staged once for the g heads; at B = 1
// the 4 rows fill one padded m16 tile and the other warps only stage.  The
// keys below start + B are cut into splits of split_tiles 64-key tiles: grid
// (n_splits, n_kv, row groups).  With one split the block writes the output;
// otherwise each block writes its rows' (m, l, unnormalized acc) in f32 to a
// workspace and a second launch merges the splits of each row in split order
// (no atomics), so every run gives the same bits.  A row that a split masks
// entirely (l = 0) merges with weight 0.  The merge is a programmatic
// dependent launch: it is scheduled while the split grid runs.  The epilogue
// and the merge (store_split, merge_splits) are attn_mma.cuh's, shared with
// verify_fused.cu.
//
// f32: the single-part case of verify_fused.cu: the same tile walk
// and f32 online softmax (attn_tile.cuh), without the block part.  Grid
// (nh, ceil(B / RQ)): one block per (query head, tile of RQ rows).
#include "attn_mma.cuh"
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

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // packed query rows per block
constexpr int kMmaKeys = 64;              // keys per tile: attention.py's KEY_TILE

// Packed rows [kMmaRows * blockIdx.z, +kMmaRows) of kv head blockIdx.y over
// the keys of split blockIdx.x.  ws == nullptr: one split, write out.
template <int D>
__global__ void __launch_bounds__(32 * kMmaWarps)
verify_attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ ws, int B, int nh, int n_kv, int start, int split_tiles,
                            float scale_log2) {
  using mma::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<mma::Smem<D, kMmaRows, kMmaKeys>*>(smem_raw);
  const int g = nh / n_kv, M = g * B;
  const int split = blockIdx.x, hk = blockIdx.y, p_base = blockIdx.z * kMmaRows;
  const long q_stride = (long)nh * D;
  const long kv_stride = (long)n_kv * D;

  // packed row p: query head hk * g + p / B at row p % B (position start + p % B)
  mma::stage_rows<D, kMmaRows, 32 * kMmaWarps>(sm.q, [&](int pl) -> const bf16* {
    const int p = p_base + pl;
    return p < M ? q + (p % B) * q_stride + (hk * g + p / B) * D : nullptr;
  });
  const int n_keys = start + B;
  const int key0 = split * split_tiles * kMmaKeys;
  const int key_end = min(key0 + split_tiles * kMmaKeys, n_keys);
  auto stage_kv = [&](int tile, int buf) {
    const int t0 = key0 + tile * kMmaKeys, nk = min(kMmaKeys, key_end - t0);
    const bf16* kb = k + t0 * kv_stride + hk * D;
    const bf16* vb = v + t0 * kv_stride + hk * D;
    mma::stage_rows<D, kMmaKeys, 32 * kMmaWarps>(sm.k[buf], [&](int r) { return r < nk ? kb + r * kv_stride : nullptr; });
    mma::stage_rows<D, kMmaKeys, 32 * kMmaWarps>(sm.v[buf], [&](int r) { return r < nk ? vb + r * kv_stride : nullptr; });
  };

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  mma::Warp<D, kMmaKeys> w;
  w.init([&](int pl) { return start + (p_base + pl) % B; });
  mma::walk(sm, w, (key_end - key0 + kMmaKeys - 1) / kMmaKeys, key0, scale_log2, stage_kv,
            [&](int i) { return key0 + (i + 1) * kMmaKeys - 1 > start; });  // reaches the block's keys
  w.finish();
  mma::store_split(w, out, ws, p_base, B, nh, n_kv, hk);
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

template <int D>
static cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* ws, int B,
                              int nh, int n_kv, int start, int split_tiles, float scale,
                              cudaStream_t stream) {
  const int M = (nh / n_kv) * B;
  const int n_tiles = (start + B + kMmaKeys - 1) / kMmaKeys;
  if (split_tiles < 1) return cudaErrorInvalidValue;
  const int n_splits = (n_tiles + split_tiles - 1) / split_tiles;
  if (n_splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  if (n_splits == 1) ws = nullptr;
  static bool smem_set = false;
  constexpr int smem = sizeof(mma::Smem<D, kMmaRows, kMmaKeys>);
  cudaError_t err = mma::allow_smem(verify_attention_mma_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(n_splits, n_kv, (M + kMmaRows - 1) / kMmaRows);
  verify_attention_mma_kernel<D><<<grid, 32 * kMmaWarps, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)out, ws,
      B, nh, n_kv, start, split_tiles, scale * mma::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return err;
  return mma::launch_merge<D>(ws, (__nv_bfloat16*)out, B, nh, n_kv, n_splits, stream);
}

}  // namespace dflash

// dtype: 0 = float32, 1 = bfloat16 (q, cache K/V, out).  bf16 only:
// split_tiles = 64-key tiles per split, workspace = n_splits * n_kv * g * B *
// (D + 2) floats when there is more than one split (else may be null).
// Returns a cudaError_t (0 = launched).
extern "C" int dflash_verify_attention(int dtype, int head_dim, const void* q, const void* k,
                                       const void* v, void* out, void* workspace, int B, int nh,
                                       int n_kv, int start, int split_tiles, float scale,
                                       void* stream) {
  using namespace dflash;
  cudaStream_t s = (cudaStream_t)stream;
  float* ws = (float*)workspace;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, out, B, nh, n_kv, start, scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, out, B, nh, n_kv, start, scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch_mma<128>(q, k, v, out, ws, B, nh, n_kv, start, split_tiles, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_mma<64>(q, k, v, out, ws, B, nh, n_kv, start, split_tiles, scale, s);
  return (int)cudaErrorInvalidValue;
}
