// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the bias arguments, the mask and the tile pruning of the causal and
// sliding-window variants.
//
// Bias.  The logits of query row i and key column j get, in f32 and before
// any mask, either
//   - bias[h, i, j] from an additive (Hq, Sq, Skv) bf16 bias shared across
//     the batch (T5's materialized relative-position bias), or
//   - table[h, ids[j - i + S - 1]] from an (Hq, buckets) bf16 table and the
//     int32 bucket id of every distance (the in-kernel bucket bias; Sq ==
//     Skv == S).  The ids are computed once on the host with the exact f32
//     arithmetic of the reference, never here: one ulp of a device logf
//     would move a distance across a bucket edge.  A kernel stages the
//     biases of a tile's distances in shared memory and reads them by
//     c - r for in-tile row r, column c.
// With neither pointer set there is no bias.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdx_flash {

typedef __nv_bfloat16 bf16;

constexpr int MAX_BUCKETS = 256;  // the Python wrappers check it

struct BiasArgs {
  const bf16* bias;   // (Hq, Sq, Skv) or null
  const bf16* table;  // (Hq, buckets) or null
  const int* ids;     // (2S - 1,) bucket id of distance j - i at j - i + S - 1
  int buckets;
};

// Whether query row qi sees key kj in an Sq x Skv attention whose mask is
// end-aligned by diag = Skv - Sq: in range, under the diagonal (kj <= qi +
// diag) when causal, and inside the sliding-window band (kj > qi + diag -
// window) when window > 0; window <= 0 means no band (the TPU kernels'
// _tile_mask, element by element).
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
