// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bias_bwd.cu): the logit bias of a tile, the mask and the tile
// pruning of the causal and sliding-window variants, and the 64-row WMMA
// tile helpers of the bucket-table gradient kernel (flash_bias_bwd.cu).
//
// Bias.  The logits of query row i and key column j get, in f32 and before
// any mask, either
//   - bias[h, i, j] from an additive (Hq, Sq, Skv) bf16 bias shared across
//     the batch (T5's materialized relative-position bias), or
//   - table[h, ids[j - i + S - 1]] from an (Hq, buckets) bf16 table and the
//     int32 bucket id of every distance (the in-kernel bucket bias; Sq ==
//     Skv == S).  The ids are computed once on the host with the exact f32
//     arithmetic of the reference, never here: one ulp of a device logf
//     would move a distance across a bucket edge.  A 64 x 64 tile spans
//     127 distances; the block stages their biases in shared memory
//     (stage_diag) and reads diag[c - r + 63] for in-tile row r, column c.
// With neither pointer set there is no bias.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tdx_flash {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int MAX_BUCKETS = 256;  // the Python wrappers check it
constexpr int NDIAG = 127;        // distances a 64 x 64 tile spans

struct BiasArgs {
  const bf16* bias;   // (Hq, Sq, Skv) or null
  const bf16* table;  // (Hq, buckets) or null
  const int* ids;     // (2S - 1,) bucket id of distance j - i at j - i + S - 1
  int buckets;
};

// diag[d] = the bias of distance k0 - q0 + d - 63 for head h (0 where the
// distance is out of range: those pairs are masked anyway).
__device__ __forceinline__ void stage_diag(float* diag, const BiasArgs& a, int h,
                                           int q0, int k0, int S, int tid,
                                           int nthreads) {
  if (a.table == nullptr) return;
  for (int d = tid; d < NDIAG; d += nthreads) {
    const int rel = k0 - q0 + d - 63;
    float val = 0.f;
    if (rel > -S && rel < S)
      val = __bfloat162float(a.table[h * a.buckets + a.ids[rel + S - 1]]);
    diag[d] = val;
  }
}

// The bias of global (qi, kj), in-tile (r, c), head h.
__device__ __forceinline__ float bias_at(const BiasArgs& a, const float* diag,
                                         int h, int Sq, int Skv, int qi, int kj,
                                         int r, int c) {
  if (a.bias != nullptr)
    return (qi < Sq && kj < Skv)
               ? __bfloat162float(a.bias[((long long)h * Sq + qi) * Skv + kj])
               : 0.f;
  if (a.table != nullptr) return diag[c - r + 63];
  return 0.f;
}

// ---- the backward's tiles: 64 rows, 8 warps -----------------------------------

constexpr int BT = 64;  // rows of every tile (query and key tiles alike)
constexpr int BWD_WARPS = 8;
constexpr int BWD_THREADS = BWD_WARPS * 32;

template <int D>
struct BwdLayout {
  static constexpr int LDH = D + 8;   // bf16 Q/dO/K/V tiles
  static constexpr int LDS = BT + 4;  // fp32 64x64 products S, dP
  static constexpr int LDP = BT + 8;  // bf16 64x64 P, dS
  static constexpr int LDO = D + 4;   // fp32 staging of a 64 x D accumulator
  static constexpr int NF = D / 32;   // accumulator fragments per warp
  static constexpr size_t tile = size_t(BT) * LDH * 2;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + tile;
  static constexpr size_t k_off = do_off + tile;
  static constexpr size_t v_off = k_off + tile;
  static constexpr size_t s_off = v_off + tile;
  static constexpr size_t dp_off = s_off + size_t(BT) * LDS * 4;
  static constexpr size_t p_off = dp_off + size_t(BT) * LDS * 4;
  static constexpr size_t ds_off = p_off + size_t(BT) * LDP * 2;
  static constexpr size_t lse_off = ds_off + size_t(BT) * LDP * 2;
  static constexpr size_t dl_off = lse_off + BT * 4;
  static constexpr size_t diag_off = dl_off + BT * 4;
  // the bias gradients' per-distance and per-bucket partial sums
  static constexpr size_t dsum_off = diag_off + 128 * 4;
  static constexpr size_t part_off = dsum_off + 128 * 4;
  static constexpr size_t bytes = part_off + MAX_BUCKETS * 4;
  // the epilogue stages one accumulator over S and dP
  static_assert(size_t(BT) * LDO * 4 <= p_off - s_off, "staging too small");
};

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long gstride, int valid) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < BT * CHUNKS; idx += BWD_THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * gstride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// lse of the tile's rows into shared memory (0 for rows past the end).
__device__ __forceinline__ void load_lse(float* dst, const float* src, int valid) {
  for (int i = threadIdx.x; i < BT; i += BWD_THREADS) dst[i] = i < valid ? src[i] : 0.f;
}

// delta = rowsum(dO * O) for the tile's rows: four threads a row, O read
// from device memory with 16-byte loads, dO from the tile in shared memory.
template <int D>
__device__ __forceinline__ void tile_delta(float* delta, const bf16* dOs,
                                           const bf16* obase, long long gstride,
                                           int valid) {
  using L = BwdLayout<D>;
  const int r = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  float acc = 0.f;
  if (r < valid) {
    for (int c = part * 8; c < D; c += 32) {
      const uint4 raw = *reinterpret_cast<const uint4*>(obase + r * gstride + c);
      const bf16* o8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc += __bfloat162float(o8[j]) * __bfloat162float(dOs[r * L::LDH + c + j]);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) delta[r] = acc;
}

// out (64x64 fp32) = A B^T for A, B 64 x D row-major bf16 tiles; 16 output
// tiles of 16x16, two per warp.
template <int D>
__device__ __forceinline__ void gemm_abt(float* out, const bf16* A, const bf16* B,
                                         int warp) {
  using L = BwdLayout<D>;
#pragma unroll
  for (int t = warp * 2; t < warp * 2 + 2; ++t) {
    const int tm = t / 4, tn = t % 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, A + tm * 16 * L::LDH + kk * 16, L::LDH);
      wmma::load_matrix_sync(fb, B + tn * 16 * L::LDH + kk * 16, L::LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + tm * 16 * L::LDS + tn * 16, acc, L::LDS,
                            wmma::mem_row_major);
  }
}

// Whether query row qi sees key kj in an Sq x Skv attention whose mask is
// end-aligned by diag = Skv - Sq: in range, under the diagonal (kj <= qi +
// diag) when causal, and inside the sliding-window band (kj > qi + diag -
// window) when window > 0; window <= 0 means no band.  The one mask test of
// every flash kernel (the TPU kernels' _tile_mask).
__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv, int causal,
                                        int window) {
  const int diag = Skv - Sq;
  return qi < Sq && kj < Skv && (!causal || kj <= qi + diag) &&
         (window <= 0 || kj > qi + diag - window);
}

// Tile pruning by the band (the TPU kernels' _block_visible), for tiles of
// `tile` rows.  The start of the first key tile that query rows q0.. can
// see: the first key row q0 sees, q0 + diag - window + 1, rounded down to a
// tile (0 without a window).
__host__ __device__ inline int band_kv_begin(int q0, int diag, int window, int tile) {
  if (window <= 0) return 0;
  const int first = q0 + diag - window + 1;
  return first <= 0 ? 0 : first / tile * tile;
}

// One past the last query row that sees any key of the tile k0..k0+tile-1:
// row i sees key j only if i < j - diag + window (Sq without a window).
__host__ __device__ inline int band_q_end(int k0, int diag, int window, int tile,
                                          int Sq) {
  if (window <= 0) return Sq;
  const int end = k0 + tile - 1 - diag + window;
  return end < Sq ? end : Sq;
}

__host__ __device__ inline bool bad_shape(int B, int S, int Hq, int Hkv) {
  return B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0;
}

inline BiasArgs bias_args(const void* bias, const void* table, const void* ids,
                          int buckets) {
  BiasArgs a;
  a.bias = static_cast<const bf16*>(bias);
  a.table = static_cast<const bf16*>(table);
  a.ids = static_cast<const int*>(ids);
  a.buckets = buckets;
  return a;
}

}  // namespace tdx_flash
