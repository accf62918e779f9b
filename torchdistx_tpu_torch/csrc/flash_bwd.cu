// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel, its
// delta pre-pass, the dQ kernel and the dbias / dtable kernel; bf16 in,
// bf16 or f32 out, f32 recompute and accumulation.
//
// Replaces the Pallas kernels torchdistx_tpu/ops/flash_attention.py
// _bwd_dkv_kernel (K/V-stationary: dK, dV) and _bwd_dq_kernel
// (Q-stationary: dQ), launched by _flash_backward_core, in every variant:
// causal (the Llama and GPT-2 training paths, T5's decoder) or not (T5's
// encoder), with no bias, an additive bias or T5's bucket table
// (flash_common.cuh), or with the sliding window (Mistral; causal, no
// bias); D 64 and 128; GQA.  And _bwd_dbias_kernel (launched by
// _flash_dbias) and _bwd_dtable_kernel (launched by _flash_dtable): the
// gradients of T5's additive bias and of its bucket table.
//
// Both recompute the probabilities from the forward's saved row
// log-sum-exp, p = exp(q.k * scale + bias - lse) (the lse includes the
// bias), with delta = rowsum(dO * O) (FlashAttention-2):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dK = dS^T Q,  dQ = dS K.
//
// What bounds them on an H100: operations.  At the llama_1b training shape
// (B 2, S 2048, 16 heads, D 128) dK/dV is four products over the 2.1M
// causal pairs of each head (7e10 flops against ~100 MB of inputs and
// outputs), far right of the card's ridge point; a bias adds 2 bytes a
// pair, still far right.
//
// dK/dV, the Hopper design.  A block owns 128 key rows of one KV head: two
// consumer warpgroups of 64 rows each and a producer warpgroup.  The
// producer loads K and V once by TMA, then streams the query tiles (64
// rows of Q and dO by TMA, their lse and delta rows by its first warp)
// through a 2-stage ring of full / empty mbarriers, over the n_rep query
// heads of the group, so the GQA group sum stays in registers (no atomics:
// dK and dV are the same bits on every launch).  It then idles with 24
// registers, so the consumers run with 240 (setmaxnreg).  Per query tile a
// consumer runs S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 from
// shared memory (K-major), forms P^T = exp2(S^T scale log2 e + bias log2 e
// - lse log2 e) and dS^T = P^T (dP^T - delta) scale in registers, and
// accumulates dV += P^T dO and dK += dS^T Q with wgmma taking P^T and dS^T
// as bf16 register A operands and dO, Q MN-major from shared memory: S, P,
// dP and dS never touch shared memory, and dK, dV live in registers for
// the whole loop (2 x 64 f32 a thread at D 128).  Each warpgroup stages
// its 64 x 64 tile of the additive bias in shared memory with coalesced
// loads, or the bucket biases of the tile's 127 distances, while the
// tile's first two products run.  Only tiles
// that cross the diagonal, the band's edge or the ragged end are masked,
// each key row by two query-column bounds.  delta is computed once per
// (b, h, row) by the pre-pass
// flash_bwd_delta_kernel into (B, Hq, S) f32, 4 bytes a row read S/128
// times, where the JAX kernel recomputes it from O in every tile (which
// saves HBM on the TPU).
//
// dQ, the same Hopper design with the roles turned: a block owns 128 query
// rows of one query head (two consumer warpgroups of 64 and a producer
// warpgroup).  The producer loads Q and dO once by TMA, then streams the
// K/V tiles of 64 keys of the head's kv group through a 2-stage ring.  Per
// tile a consumer runs S = Q K^T and dP = dO V^T as wgmma m64n64k16 from
// shared memory (K-major), forms P = exp2(S scale log2 e + bias log2 e -
// lse log2 e) and dS = P (dP - delta) scale in registers, and accumulates
// dQ += dS K with dS as the bf16 register A operand and K MN-major, as the
// forward does P V: S, P, dP and dS never touch shared memory, dQ stays in
// registers (64 f32 a thread at D 128), and 64-key tiles keep S, dP and dQ
// in the consumers' 240 registers.  lse and delta are read once per row
// (delta from the pre-pass, O is not read at all); a tile past a
// warpgroup's diagonal or below its band is skipped, and only tiles that
// cross the diagonal, the band's edge or the ragged end are masked.  Each
// block owns its rows, so dQ has no atomics and is the same bits on every
// launch.  The additive bias and the bucket biases are staged per
// warpgroup as for dK/dV.
//
// dbias, the dQ design with the loop turned to the batch: the bias is
// shared across the batch, so dbias[h] = sum_b p_b * (dP_b - delta_b), with
// no scale (the bias enters the logits unscaled).  A block owns one (128
// query rows x 64 keys, head) tile of it, 64 rows per consumer warpgroup,
// and loops over the batch inside, b = 0..B-1: the producer streams Q_b,
// dO_b (rows q0.., head h), K_b and V_b (rows k0.., head h / n_rep) by TMA
// through a 2-stage ring (96 KB a stage at D 128).  The tile's biases are
// read once before the loop into registers (log2 units); per b a consumer
// runs S = Q K^T and dP = dO V^T as dQ does, forms P in registers, frees
// the stage once both products are done and adds P (dP - delta_b) into 32
// f32 registers.  delta_b comes from the pre-pass (O is not read).  Each
// element is stored once in bf16 after the loop: no atomics, the batch sum
// in a fixed order, the same bits on every launch.  A causal tile wholly
// above the diagonal loads nothing and stores zeros.  What bounds it:
// bytes (the bias read and dbias written once, 2 bytes a pair each, and
// the inputs), where the recomputed products cost 4 D flops a pair and
// batch row; its blocks read Q and dO once per key tile and K and V once
// per query tile, from L2.
//
// dtable, the same kernel with another epilogue (one template): the tile's
// bias is the bucket bias, table[h, ids[j - i + S - 1]], staged once into
// the tile's 191 distances as dQ stages it; after the batch loop the tile
// is folded in a fixed order.  It goes to shared memory over the ring's
// stages with every element outside the visible region zeroed (rows and
// key columns past S, the causal upper triangle: TMA zero-fills K and V
// past S, so there S = dP = 0 while p = exp(bias - lse) is not), one
// thread a distance sums its diagonal in row order, and one thread a
// bucket sums the distances of its bucket in distance order into the
// tile's (Hq, tiles, buckets) f32 partials (4 * buckets bytes a tile, no
// atomics; a causal tile wholly above the diagonal writes zeros and folds
// nothing).  A second kernel sums each (h, bucket) over the tiles in tile
// order and writes the bf16 table gradient: the same bits on every launch.
// The scratch: 128 KB at Hq 32, S 512, 32 buckets; 16 MB at Hq 32, S 2048,
// 256 buckets.  What bounds it: bytes, as dbias, less the (Hq, S, S) bias
// and dbias.
//
// Output type: bf16, the gradients of one attention call; or f32 (the JAX
// kernels' dq_dtype / part_dtype = float32), which ring attention's
// backward asks for: it adds one block's partial gradients per hop into
// f32 accumulators that travel the ring.  The accumulators are f32 in
// either case; only the store differs.
//
// Layout: q, o, dO, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D); lse and
// delta (B, Hq, S) f32.  Sq == Skv.  The kernels and the pre-pass take q,
// k, v, o and dO with any strides TMA takes (hopper.cuh); the outputs are
// contiguous.  Causal tiles above the diagonal are
// skipped; with a window, tiles wholly below the band are skipped too: dQ
// starts its key loop at the first tile the band reaches (band_kv_begin),
// dK/dV stops its query loop after the last query tile that sees the key
// tile (band_q_end), so the work grows with S * window.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tdx_flash;
using tdx_hopper::Strides;

// ---- dK/dV ------------------------------------------------------------------------

namespace hop {

using namespace tdx_hopper;

constexpr int BKV = 128;  // key rows of a block, 64 per consumer warpgroup
constexpr int BQ = 64;    // query rows of a streamed tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int PANEL_KV = BKV * 128;  // bytes of a 64-column panel of a K/V tile
constexpr int PANEL_Q = BQ * 128;    // ... of a Q/dO tile
constexpr int NDIST = 2 * 64 - 1;    // distances of a warpgroup's 64 x 64 tile
constexpr int LDB = 72;  // bf16 row stride of a staged 64 x 64 bias tile (conflict-free)
constexpr float LOG2E = 1.4426950408889634f;

enum { NO_BIAS = 0, ADD_BIAS = 1, TABLE_BIAS = 2 };

template <int D>
struct Smem {
  static constexpr int KV_TILE = BKV * D * 2;
  static constexpr int Q_TILE = BQ * D * 2;
  static constexpr int k_off = 0;
  static constexpr int v_off = KV_TILE;
  static constexpr int q_off = 2 * KV_TILE;
  static constexpr int do_off = q_off + STAGES * Q_TILE;
  static constexpr int ld_off = do_off + STAGES * Q_TILE;  // per stage: lse, delta rows
  static constexpr int diag_off = ld_off + STAGES * 2 * BQ * 4;  // 2 warpgroups x 2 buffers
  static constexpr int bias_off = diag_off + 2 * 2 * 128 * 4;  // 2 warpgroups x 2 buffers
  static constexpr int bar_off = bias_off + 2 * 2 * BQ * LDB * 2;
  static constexpr int bytes = bar_off + (1 + 2 * STAGES) * 8 + 1024;
};

__device__ __forceinline__ void put2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

template <int D>
__device__ __forceinline__ void acc_rs(float (&d)[D / 2], const uint32_t* a, uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

template <int D, int BIAS, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     OutT* __restrict__ dk, OutT* __restrict__ dv, BiasArgs ba, int S, int Hq,
                     int Hkv, int causal, int window, float scale, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BKV;
  const int n_rep = Hq / Hkv;
  // causal: query rows i see key j iff j <= i, so the tiles from the
  // diagonal on; with a window, up to the last row the band reaches
  const int q_begin = causal ? k0 : 0;
  const int q_end = band_q_end(k0, 0, window, BKV, S);
  const int nq = (q_end - q_begin + BQ - 1) / BQ;
  const int ntiles = n_rep * nq;

  if (threadIdx.x == 0) {
    bar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, 1 + 32);  // the TMA thread's expect_tx, the warp's lse rows
      bar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: its first warp keeps the ring full -----------------------
    reg_dealloc<24>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        bar_expect_tx(full_kv, 2 * L::KV_TILE);
        for (int p = 0; p < D / 64; ++p) {
          tma_load(smem + L::k_off + p * PANEL_KV, &tk, full_kv, p * 64, hk, k0, b);
          tma_load(smem + L::v_off + p * PANEL_KV, &tv, full_kv, p * 64, hk, k0, b);
        }
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        const int h = hk * n_rep + t / nq;
        const int q0 = q_begin + (t % nq) * BQ;
        bar_wait(empty + st, ((t / STAGES) & 1) ^ 1);
        if (lane == 0) {
          bar_expect_tx(full + st, 2 * L::Q_TILE);
          for (int p = 0; p < D / 64; ++p) {
            tma_load(smem + L::q_off + st * L::Q_TILE + p * PANEL_Q, &tq, full + st, p * 64, h,
                     q0, b);
            tma_load(smem + L::do_off + st * L::Q_TILE + p * PANEL_Q, &tdo, full + st, p * 64,
                     h, q0, b);
          }
        }
        float* rows = reinterpret_cast<float*>(smem + L::ld_off) + st * 2 * BQ;
        const long long base = ((long long)b * Hq + h) * S;
        for (int i = lane; i < BQ; i += 32) {
          const int qi = q0 + i;
          rows[i] = qi < S ? lse[base + qi] : 0.f;
          rows[BQ + i] = qi < S ? delta[base + qi] : 0.f;
        }
        bar_arrive(full + st);
      }
    }
    return;
  }

  // ---- consumers: 64 key rows each ------------------------------------------------
  reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kw = k0 + 64 * wg;          // this warpgroup's first key row
  const int r0 = 16 * warp + lane / 4;  // the thread's rows: r0 and r0 + 8
  const int cq = 2 * (lane % 4);        // its columns in each 8-column chunk
  float* dist = reinterpret_cast<float*>(smem + L::diag_off) + wg * 2 * 128;
  bf16* btile = reinterpret_cast<bf16*>(smem + L::bias_off) + wg * 2 * BQ * LDB;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint64_t dka = desc_sw128(smem + L::k_off + wg * 64 * 128, 16, 1024);
  const uint64_t dva = desc_sw128(smem + L::v_off + wg * 64 * 128, 16, 1024);
  bar_wait(full_kv, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const int h = hk * n_rep + t / nq;
    const int q0 = q_begin + (t % nq) * BQ;
    float* dcur = dist + (t & 1) * 128;
    bf16* bcur = btile + (t & 1) * BQ * LDB;
    const uint64_t dqk = desc_sw128(smem + L::q_off + st * L::Q_TILE, 16, 1024);
    const uint64_t dok = desc_sw128(smem + L::do_off + st * L::Q_TILE, 16, 1024);
    bar_wait(full + st, ph);

    // S^T = K Q^T and dP^T = V dO^T, in flight together
    float s[BQ / 2], dp[BQ / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_add(dka, (kk / 4) * PANEL_KV + (kk % 4) * 32),
                   desc_add(dqk, (kk / 4) * PANEL_Q + (kk % 4) * 32), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_add(dva, (kk / 4) * PANEL_KV + (kk % 4) * 32),
                   desc_add(dok, (kk / 4) * PANEL_Q + (kk % 4) * 32), kk > 0);
    wg_commit();
    // the tile's biases, staged while the products run
    if constexpr (BIAS == ADD_BIAS) {
      // bcur[c * LDB + r] = bias[h, q0 + c, kw + r], 0 past the ends: rows
      // of 64 keys read two at a time by consecutive threads
      const bf16* src = ba.bias + ((long long)h * S + q0) * S + kw;
      const bool inside = q0 + BQ <= S && kw + 64 <= S && S % 2 == 0;
      constexpr int PAIRS = BQ * 32 / 128;  // a thread's pairs: all loads, then all stores
      __nv_bfloat162 pr[PAIRS];
#pragma unroll
      for (int it = 0; it < PAIRS; ++it) {
        const int c = (tid + 128 * it) / 32, r = (tid % 32) * 2;
        if (inside) {
          pr[it] = *reinterpret_cast<const __nv_bfloat162*>(src + (long long)c * S + r);
        } else {
          const bool row = q0 + c < S;
          pr[it].x = row && kw + r < S ? src[(long long)c * S + r] : __float2bfloat16(0.f);
          pr[it].y = row && kw + r + 1 < S ? src[(long long)c * S + r + 1]
                                           : __float2bfloat16(0.f);
        }
      }
#pragma unroll
      for (int it = 0; it < PAIRS; ++it)
        *reinterpret_cast<__nv_bfloat162*>(bcur + (tid + 128 * it) / 32 * LDB +
                                           (tid % 32) * 2) = pr[it];
    }
    if constexpr (BIAS == TABLE_BIAS) {
      // dcur[r - c + 63] = the bias of distance kw + r - (q0 + c)
      for (int d = tid; d < NDIST; d += 128) {
        const int rel = kw - q0 + d - 63;
        float val = 0.f;
        if (rel > -S && rel < S)
          val = __bfloat162float(ba.table[h * ba.buckets + ba.ids[rel + S - 1]]);
        dcur[d] = val;
      }
    }
    if constexpr (BIAS != NO_BIAS) named_sync(1 + wg, 128);
    const float* rows = reinterpret_cast<const float*>(smem + L::ld_off) + st * 2 * BQ;
    wg_wait<1>();
    fence_regs(s);

    // P^T = exp2(S^T scale log2 e + bias log2 e - lse log2 e)
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = 8 * (i / 4) + cq + (i % 2);
      float x = s[i] * scale_log2;
      if constexpr (BIAS == ADD_BIAS)
        x = fmaf(__bfloat162float(bcur[c * LDB + r0 + 8 * ((i / 2) % 2)]), LOG2E, x);
      if constexpr (BIAS == TABLE_BIAS)
        x = fmaf(dcur[r0 + 8 * ((i / 2) % 2) - c + 63], LOG2E, x);
      s[i] = exp2_ftz(fmaf(-rows[c], LOG2E, x));
    }
    // the mask, only in tiles that cross the diagonal, the band's edge or
    // the ragged end: key row kj sees the tile's query columns lo <= c < hi
    // (rows past S are never stored and need none)
    if (q0 + BQ > S || (causal && kw + 63 > q0) ||
        (window > 0 && kw <= q0 + BQ - 1 - window)) {
      int lo[2], hi[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = kw + r0 + 8 * j;
        lo[j] = (causal ? kj - q0 : 0) - cq;
        hi[j] = (window > 0 ? min(S, kj + window) : S) - q0 - cq;
      }
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = 8 * (i / 4) + (i % 2);  // less the thread's cq
        const int j = (i / 2) % 2;
        if (c < lo[j] || c >= hi[j]) s[i] = 0.f;
      }
    }
    wg_wait<0>();
    fence_regs(dp);

    // dS^T = P^T (dP^T - delta) scale; both as bf16 register A operands
    uint32_t pa[BQ / 4], dsa[BQ / 4];
#pragma unroll
    for (int i = 0; i < BQ / 2; i += 2) {
      const int c = 8 * (i / 4) + cq;
      const float ds0 = s[i] * (dp[i] - rows[BQ + c]) * scale;
      const float ds1 = s[i + 1] * (dp[i + 1] - rows[BQ + c + 1]) * scale;
      pa[i / 2] = pack_bf16(s[i], s[i + 1]);
      dsa[i / 2] = pack_bf16(ds0, ds1);
    }

    // dV += P^T dO, dK += dS^T Q: dO and Q MN-major
    const uint64_t dom = desc_sw128(smem + L::do_off + st * L::Q_TILE, PANEL_Q, 1024);
    const uint64_t dqm = desc_sw128(smem + L::q_off + st * L::Q_TILE, PANEL_Q, 1024);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_rs<D>(dv_acc, pa + 4 * kk, desc_add(dom, kk * 2048));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_rs<D>(dk_acc, dsa + 4 * kk, desc_add(dqm, kk * 2048));
    wg_commit();
    wg_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    bar_arrive(empty + st);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int kj = kw + r0 + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + cq;
    if (kj < S) {
      const long long off = (((long long)b * S + kj) * Hkv + hk) * D + c;
      put2(dk + off, dk_acc[i], dk_acc[i + 1]);
      put2(dv + off, dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] in f32: one warp a
// (b, s, h) row, rows in memory order.
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int S, int H, int D, Strides so,
                       Strides sd, long long nrows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= nrows) return;
  const int h = (int)(row % H);
  const int s = (int)((row / H) % S);
  const long long b = row / ((long long)H * S);
  const bf16* op = o + b * so.b + s * so.s + h * so.h;
  const bf16* dp = dout + b * sd.b + s * sd.s + h * sd.h;
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dp + c));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(b * H + h) * S + s] = acc;
}

template <int D, int BIAS, typename OutT>
cudaError_t launch_dkv(const CUtensorMap* maps, const float* lse, const float* delta, void* dk,
                       void* dv, const BiasArgs& ba, int B, int S, int Hq, int Hkv, int causal,
                       int window, float scale, cudaStream_t stream) {
  const int smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, BIAS, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (S + BKV - 1) / BKV);
  flash_bwd_dkv_kernel<D, BIAS, OutT><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<OutT*>(dk),
      static_cast<OutT*>(dv), ba, S, Hq, Hkv, causal, window, scale,
      (float)(scale * 1.4426950408889634));
  return cudaGetLastError();
}

template <int D, typename OutT>
cudaError_t launch_dkv_d(const CUtensorMap* maps, const float* lse, const float* delta,
                         void* dk, void* dv, const BiasArgs& ba, int B, int S, int Hq,
                         int Hkv, int causal, int window, float scale, cudaStream_t st) {
  if (ba.bias != nullptr)
    return launch_dkv<D, ADD_BIAS, OutT>(maps, lse, delta, dk, dv, ba, B, S, Hq, Hkv, causal,
                                         window, scale, st);
  if (ba.table != nullptr)
    return launch_dkv<D, TABLE_BIAS, OutT>(maps, lse, delta, dk, dv, ba, B, S, Hq, Hkv,
                                           causal, window, scale, st);
  return launch_dkv<D, NO_BIAS, OutT>(maps, lse, delta, dk, dv, ba, B, S, Hq, Hkv, causal,
                                      window, scale, st);
}

}  // namespace hop

// ---- dQ ---------------------------------------------------------------------------

namespace hop {

constexpr int DQ_BQ = 128;  // query rows of a dQ block, 64 per consumer warpgroup
constexpr int DQ_BK = 64;   // key rows of a streamed K/V tile
constexpr int PANEL_DQ = DQ_BQ * 128;  // bytes of a 64-column panel of the Q/dO tiles
constexpr int PANEL_K = DQ_BK * 128;   // ... of a K/V tile

template <int D>
struct DqSmem {
  static constexpr int Q_TILE = DQ_BQ * D * 2;
  static constexpr int KV_TILE = DQ_BK * D * 2;
  static constexpr int q_off = 0;
  static constexpr int do_off = Q_TILE;
  static constexpr int k_off = 2 * Q_TILE;
  static constexpr int v_off = k_off + STAGES * KV_TILE;
  static constexpr int diag_off = v_off + STAGES * KV_TILE;  // 2 warpgroups x 2 buffers
  static constexpr int bias_off = diag_off + 2 * 2 * 128 * 4;  // 2 warpgroups x 2 buffers
  static constexpr int bar_off = bias_off + 2 * 2 * 64 * LDB * 2;
  static constexpr int bytes = bar_off + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D, int BIAS, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    OutT* __restrict__ dq, BiasArgs ba, int S, int Hq, int Hkv, int causal,
                    int window, float scale, float scale_log2) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;  // heaviest causal tiles first
  // from the first key tile the band reaches to the last key a row sees
  const int kv_end = causal ? min(S, q0 + DQ_BQ) : S;
  const int kv_begin = band_kv_begin(q0, 0, window, DQ_BK);
  const int ntiles = (kv_end - kv_begin + DQ_BK - 1) / DQ_BK;

  if (threadIdx.x == 0) {
    bar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full --------------------------
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      bar_expect_tx(full_q, 2 * L::Q_TILE);
      for (int p = 0; p < D / 64; ++p) {
        tma_load(smem + L::q_off + p * PANEL_DQ, &tq, full_q, p * 64, h, q0, b);
        tma_load(smem + L::do_off + p * PANEL_DQ, &tdo, full_q, p * 64, h, q0, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        const int k0 = kv_begin + t * DQ_BK;
        bar_wait(empty + st, ((t / STAGES) & 1) ^ 1);
        bar_expect_tx(full + st, 2 * L::KV_TILE);
        for (int p = 0; p < D / 64; ++p) {
          tma_load(smem + L::k_off + st * L::KV_TILE + p * PANEL_K, &tk, full + st, p * 64, hk,
                   k0, b);
          tma_load(smem + L::v_off + st * L::KV_TILE + p * PANEL_K, &tv, full + st, p * 64, hk,
                   k0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each -----------------------------------------------
  reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qw = q0 + 64 * wg;          // this warpgroup's first query row
  const int r0 = 16 * warp + lane / 4;  // the thread's rows: r0 and r0 + 8
  const int cq = 2 * (lane % 4);        // its columns in each 8-column chunk
  float* dist = reinterpret_cast<float*>(smem + L::diag_off) + wg * 2 * 128;
  bf16* btile = reinterpret_cast<bf16*>(smem + L::bias_off) + wg * 2 * 64 * LDB;

  // the thread's two rows' lse (in log2 units) and delta, from the pre-pass
  float lse2[2], dl[2];
  const long long srow = ((long long)b * Hq + h) * S;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = qw + r0 + 8 * j;
    lse2[j] = qi < S ? lse[srow + qi] * LOG2E : 0.f;
    dl[j] = qi < S ? delta[srow + qi] : 0.f;
  }

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  const uint64_t dqa = desc_sw128(smem + L::q_off + wg * 64 * 128, 16, 1024);
  const uint64_t doa = desc_sw128(smem + L::do_off + wg * 64 * 128, 16, 1024);
  bar_wait(full_q, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const int k0 = kv_begin + t * DQ_BK;
    bar_wait(full + st, ph);
    // a tile this warpgroup's rows see nothing of: past the diagonal, wholly
    // below the band, or rows past S
    if (qw >= S || (causal && k0 > qw + 63) || (window > 0 && k0 + DQ_BK - 1 <= qw - window)) {
      bar_arrive(empty + st);
      continue;
    }
    float* dcur = dist + (t & 1) * 128;
    bf16* bcur = btile + (t & 1) * 64 * LDB;
    const uint64_t dkk = desc_sw128(smem + L::k_off + st * L::KV_TILE, 16, 1024);
    const uint64_t dvk = desc_sw128(smem + L::v_off + st * L::KV_TILE, 16, 1024);

    // S = Q K^T and dP = dO V^T, in flight together
    float s[DQ_BK / 2], dp[DQ_BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_add(dqa, (kk / 4) * PANEL_DQ + (kk % 4) * 32),
                   desc_add(dkk, (kk / 4) * PANEL_K + (kk % 4) * 32), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_add(doa, (kk / 4) * PANEL_DQ + (kk % 4) * 32),
                   desc_add(dvk, (kk / 4) * PANEL_K + (kk % 4) * 32), kk > 0);
    wg_commit();
    // the tile's biases, staged while the products run
    if constexpr (BIAS == ADD_BIAS) {
      // bcur[r * LDB + c] = bias[h, qw + r, k0 + c], 0 past the ends: rows
      // of 64 keys read two at a time by consecutive threads
      const bf16* src = ba.bias + ((long long)h * S + qw) * S + k0;
      const bool inside = qw + 64 <= S && k0 + DQ_BK <= S && S % 2 == 0;
      constexpr int PAIRS = 64 * 32 / 128;  // a thread's pairs: all loads, then all stores
      __nv_bfloat162 pr[PAIRS];
#pragma unroll
      for (int it = 0; it < PAIRS; ++it) {
        const int r = (tid + 128 * it) / 32, c = (tid % 32) * 2;
        if (inside) {
          pr[it] = *reinterpret_cast<const __nv_bfloat162*>(src + (long long)r * S + c);
        } else {
          const bool row = qw + r < S;
          pr[it].x = row && k0 + c < S ? src[(long long)r * S + c] : __float2bfloat16(0.f);
          pr[it].y = row && k0 + c + 1 < S ? src[(long long)r * S + c + 1]
                                           : __float2bfloat16(0.f);
        }
      }
#pragma unroll
      for (int it = 0; it < PAIRS; ++it)
        *reinterpret_cast<__nv_bfloat162*>(bcur + (tid + 128 * it) / 32 * LDB +
                                           (tid % 32) * 2) = pr[it];
    }
    if constexpr (BIAS == TABLE_BIAS) {
      // dcur[c - r + 63] = the bias of distance k0 + c - (qw + r)
      for (int d = tid; d < NDIST; d += 128) {
        const int rel = k0 - qw + d - 63;
        float val = 0.f;
        if (rel > -S && rel < S)
          val = __bfloat162float(ba.table[h * ba.buckets + ba.ids[rel + S - 1]]);
        dcur[d] = val;
      }
    }
    if constexpr (BIAS != NO_BIAS) named_sync(1 + wg, 128);
    wg_wait<1>();
    fence_regs(s);

    // P = exp2(S scale log2 e + bias log2 e - lse log2 e)
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; ++i) {
      const int j = (i / 2) % 2;
      const int c = 8 * (i / 4) + cq + (i % 2);
      float x = s[i] * scale_log2;
      if constexpr (BIAS == ADD_BIAS)
        x = fmaf(__bfloat162float(bcur[(r0 + 8 * j) * LDB + c]), LOG2E, x);
      if constexpr (BIAS == TABLE_BIAS) x = fmaf(dcur[c - r0 - 8 * j + 63], LOG2E, x);
      s[i] = exp2_ftz(x - lse2[j]);
    }
    // the mask, only in tiles that cross the diagonal, the band's edge or
    // the ragged end: query row qi sees the tile's key columns lo <= c < hi
    // (rows past S are never stored and need none)
    if (k0 + DQ_BK > S || (causal && k0 + DQ_BK - 1 > qw) ||
        (window > 0 && k0 <= qw + 63 - window)) {
      int lo[2], hi[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = qw + r0 + 8 * j;
        hi[j] = (causal ? min(S, qi + 1) : S) - k0 - cq;
        lo[j] = (window > 0 ? qi - window + 1 - k0 : 0) - cq;
      }
#pragma unroll
      for (int i = 0; i < DQ_BK / 2; ++i) {
        const int c = 8 * (i / 4) + (i % 2);  // less the thread's cq
        const int j = (i / 2) % 2;
        if (c < lo[j] || c >= hi[j]) s[i] = 0.f;
      }
    }
    wg_wait<0>();
    fence_regs(dp);

    // dS = P (dP - delta) scale, as the bf16 register A operand
    uint32_t dsa[DQ_BK / 4];
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; i += 2) {
      const int j = (i / 2) % 2;
      dsa[i / 2] = pack_bf16(s[i] * (dp[i] - dl[j]) * scale,
                             s[i + 1] * (dp[i + 1] - dl[j]) * scale);
    }

    // dQ += dS K: K MN-major
    const uint64_t dkm = desc_sw128(smem + L::k_off + st * L::KV_TILE, PANEL_K, 1024);
    fence_regs(dq_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk)
      acc_rs<D>(dq_acc, dsa + 4 * kk, desc_add(dkm, kk * 2048));
    wg_commit();
    wg_wait<0>();
    fence_regs(dq_acc);
    bar_arrive(empty + st);
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int qi = qw + r0 + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + cq;
    if (qi < S) put2(dq + (((long long)b * S + qi) * Hq + h) * D + c, dq_acc[i], dq_acc[i + 1]);
  }
}

template <int D, int BIAS, typename OutT>
cudaError_t launch_dq(const CUtensorMap* maps, const float* lse, const float* delta, void* dq,
                      const BiasArgs& ba, int B, int S, int Hq, int Hkv, int causal, int window,
                      float scale, cudaStream_t stream) {
  const int smem = DqSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, BIAS, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (S + DQ_BQ - 1) / DQ_BQ);
  flash_bwd_dq_kernel<D, BIAS, OutT><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<OutT*>(dq), ba, S, Hq, Hkv,
      causal, window, scale, (float)(scale * 1.4426950408889634));
  return cudaGetLastError();
}

template <int D, typename OutT>
cudaError_t launch_dq_d(const CUtensorMap* maps, const float* lse, const float* delta,
                        void* dq, const BiasArgs& ba, int B, int S, int Hq, int Hkv,
                        int causal, int window, float scale, cudaStream_t st) {
  if (ba.bias != nullptr)
    return launch_dq<D, ADD_BIAS, OutT>(maps, lse, delta, dq, ba, B, S, Hq, Hkv, causal,
                                        window, scale, st);
  if (ba.table != nullptr)
    return launch_dq<D, TABLE_BIAS, OutT>(maps, lse, delta, dq, ba, B, S, Hq, Hkv, causal,
                                          window, scale, st);
  return launch_dq<D, NO_BIAS, OutT>(maps, lse, delta, dq, ba, B, S, Hq, Hkv, causal, window,
                                     scale, st);
}

}  // namespace hop

// ---- dbias and dtable ---------------------------------------------------------------

namespace hop {

constexpr int TILE_DIST = DQ_BQ + DQ_BK - 1;  // distances c - r of a 128 x 64 tile: 191
constexpr int LDF = DQ_BK + 1;  // f32 row stride of the folded tile: diagonals conflict-free

template <int D>
struct DbSmem {
  static constexpr int Q_TILE = DQ_BQ * D * 2;
  static constexpr int KV_TILE = DQ_BK * D * 2;
  static constexpr int q_off = 0;  // within a stage: Q_b, dO_b, K_b, V_b
  static constexpr int do_off = Q_TILE;
  static constexpr int k_off = 2 * Q_TILE;
  static constexpr int v_off = k_off + KV_TILE;
  static constexpr int STAGE = v_off + KV_TILE;  // 96 KB at D 128
  static constexpr int bar_off = STAGES * STAGE;
  // dtable: the bias, the bucket id and the sum of each of the tile's distances
  static constexpr int dist_off = bar_off + 2 * STAGES * 8;
  static constexpr int bytes = dist_off + 3 * 192 * 4 + 1024;
  // the fold writes the f32 tile over the ring's stages
  static_assert(DQ_BQ * LDF * 4 <= STAGES * STAGE, "the folded tile does not fit");
};

// One (128 query rows x 64 keys, head) tile of the batch sum of
// p * (dP - delta), and its epilogue: BIAS == ADD_BIAS stores it as the
// bf16 dbias, from the (Hq, S, S) bias; BIAS == TABLE_BIAS folds it into
// the tile's bucket partials, out = (Hq, tiles, buckets) f32, from the
// table and the bucket ids.
template <int D, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_bias_grad_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           void* __restrict__ out, BiasArgs ba, int B, int S, int Hq, int Hkv,
                           int causal, float scale_log2) {
  static_assert(BIAS == ADD_BIAS || BIAS == TABLE_BIAS, "a bias gradient needs a bias");
  using L = DbSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * DQ_BK;
  const int q0 = blockIdx.y * DQ_BQ;
  const int h = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  // a causal tile wholly above the diagonal: zeros, nothing loaded
  const int nb = causal && k0 > q0 + DQ_BQ - 1 ? 0 : B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread streams the batch rows through the ring -------
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      for (int b = 0; b < nb; ++b) {
        const int st = b % STAGES;
        unsigned char* base = smem + st * L::STAGE;
        bar_wait(empty + st, ((b / STAGES) & 1) ^ 1);
        bar_expect_tx(full + st, L::STAGE);
        for (int p = 0; p < D / 64; ++p) {
          tma_load(base + L::q_off + p * PANEL_DQ, &tq, full + st, p * 64, h, q0, b);
          tma_load(base + L::do_off + p * PANEL_DQ, &tdo, full + st, p * 64, h, q0, b);
          tma_load(base + L::k_off + p * PANEL_K, &tk, full + st, p * 64, hk, k0, b);
          tma_load(base + L::v_off + p * PANEL_K, &tv, full + st, p * 64, hk, k0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows x 64 keys each ------------------------------------
  reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int qw = q0 + 64 * wg;                        // this warpgroup's first query row
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // the thread's rows: r0 and r0 + 8
  const int cq = 2 * (tid % 4);                      // its columns in each 8-column chunk
  // a warpgroup whose rows see nothing of the tile (past S, or all above
  // the diagonal) computes nothing
  const bool idle = qw >= S || (causal && k0 > qw + 63);
  [[maybe_unused]] const bool pairs = S % 2 == 0;  // dbias: bf16 pairs 4-byte aligned
  float* dist_bias = reinterpret_cast<float*>(smem + L::dist_off);
  int* dist_id = reinterpret_cast<int*>(dist_bias + 192);
  float* dist_sum = reinterpret_cast<float*>(dist_id + 192);
  float* part = nullptr;  // dtable: this tile's bucket partials
  if constexpr (BIAS == TABLE_BIAS) {
    const long long tile_idx = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    part = static_cast<float*>(out) +
           ((long long)h * gridDim.x * gridDim.y + tile_idx) * ba.buckets;
    if (nb == 0) {  // above the diagonal: zero partials, no fold
      for (int t = threadIdx.x; t < ba.buckets; t += 256) part[t] = 0.f;
      return;
    }
  }

  // the tile's bias in log2 units, batch-shared: read once
  float bias2[DQ_BK / 2];
  if constexpr (BIAS == ADD_BIAS) {
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; i += 2) {
      const int qi = qw + r0 + 8 * ((i / 2) % 2);
      const int kj = k0 + 8 * (i / 4) + cq;
      float2 bv = make_float2(0.f, 0.f);
      const bf16* src = ba.bias + ((long long)h * S + qi) * S + kj;
      if (!idle && qi < S) {
        if (pairs && kj + 1 < S) {
          bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
        } else {
          if (kj < S) bv.x = __bfloat162float(src[0]);
          if (kj + 1 < S) bv.y = __bfloat162float(src[1]);
        }
      }
      bias2[i] = bv.x * LOG2E;
      bias2[i + 1] = bv.y * LOG2E;
    }
  } else {
    // the bias and bucket id of each distance c - r = d - 127 of the tile,
    // k0 - q0 + d - 127 globally (id -1 and bias 0 out of range: those
    // pairs are masked), staged once by both warpgroups
    if (threadIdx.x < TILE_DIST) {
      const int rel = k0 - q0 + (int)threadIdx.x - (DQ_BQ - 1);
      const bool in = rel > -S && rel < S;
      const int id = in ? ba.ids[rel + S - 1] : -1;
      dist_id[threadIdx.x] = id;
      dist_bias[threadIdx.x] = in ? __bfloat162float(ba.table[h * ba.buckets + id]) : 0.f;
    }
    named_sync(1, 256);
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; ++i) {
      const int r = 64 * wg + r0 + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + cq + (i % 2);
      bias2[i] = dist_bias[c - r + DQ_BQ - 1] * LOG2E;
    }
  }
  // causal, a tile the diagonal crosses: row qi sees the columns c < hi
  // (less the thread's cq)
  const bool crosses = causal && k0 + DQ_BK - 1 > qw;
  int hi[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) hi[j] = qw + r0 + 8 * j + 1 - k0 - cq;

  float acc[DQ_BK / 2];
#pragma unroll
  for (int i = 0; i < DQ_BK / 2; ++i) acc[i] = 0.f;

  for (int b = 0; b < nb; ++b) {
    const int st = b % STAGES;
    // the batch row's lse (log2 units) and delta of the thread's rows,
    // read while its tiles land
    float lse2[2], dl[2];
    const long long srow = ((long long)b * Hq + h) * S;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qi = qw + r0 + 8 * j;
      lse2[j] = qi < S ? lse[srow + qi] * LOG2E : 0.f;
      dl[j] = qi < S ? delta[srow + qi] : 0.f;
    }
    bar_wait(full + st, (b / STAGES) & 1);
    if (idle) {
      bar_arrive(empty + st);
      continue;
    }
    const unsigned char* base = smem + st * L::STAGE;
    const uint64_t dqa = desc_sw128(base + L::q_off + wg * 64 * 128, 16, 1024);
    const uint64_t doa = desc_sw128(base + L::do_off + wg * 64 * 128, 16, 1024);
    const uint64_t dkk = desc_sw128(base + L::k_off, 16, 1024);
    const uint64_t dvk = desc_sw128(base + L::v_off, 16, 1024);

    // S = Q K^T and dP = dO V^T, in flight together
    float s[DQ_BK / 2], dp[DQ_BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_add(dqa, (kk / 4) * PANEL_DQ + (kk % 4) * 32),
                   desc_add(dkk, (kk / 4) * PANEL_K + (kk % 4) * 32), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_add(doa, (kk / 4) * PANEL_DQ + (kk % 4) * 32),
                   desc_add(dvk, (kk / 4) * PANEL_K + (kk % 4) * 32), kk > 0);
    wg_commit();
    wg_wait<1>();
    fence_regs(s);

    // P = exp2(S scale log2 e + bias log2 e - lse log2 e)
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; ++i)
      s[i] = exp2_ftz(fmaf(s[i], scale_log2, bias2[i]) - lse2[(i / 2) % 2]);
    if (crosses) {
#pragma unroll
      for (int i = 0; i < DQ_BK / 2; ++i)
        if (8 * (i / 4) + (i % 2) >= hi[(i / 2) % 2]) s[i] = 0.f;
    }
    wg_wait<0>();
    fence_regs(dp);
    bar_arrive(empty + st);  // both products have read the stage

    // the logit gradient, unscaled (the bias enters the logits unscaled)
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; ++i)
      acc[i] = fmaf(s[i], dp[i] - dl[(i / 2) % 2], acc[i]);
  }

  if constexpr (BIAS == ADD_BIAS) {
    // each element stored once, in bf16 (key columns past S are never
    // stored and need no mask)
    bf16* dbias = static_cast<bf16*>(out);
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; i += 2) {
      const int qi = qw + r0 + 8 * ((i / 2) % 2);
      const int kj = k0 + 8 * (i / 4) + cq;
      if (qi >= S) continue;
      bf16* dst = dbias + ((long long)h * S + qi) * S + kj;
      if (pairs && kj + 1 < S) {
        put2(dst, acc[i], acc[i + 1]);
      } else {
        if (kj < S) dst[0] = __float2bfloat16(acc[i]);
        if (kj + 1 < S) dst[1] = __float2bfloat16(acc[i + 1]);
      }
    }
  } else {
    // The fold, in a fixed order.  The f32 tile goes over the ring's stages
    // (free once both warpgroups are past their last product), zero outside
    // the visible region: rows past S, the causal upper triangle, and key
    // columns past S, where TMA zero-filled K and V, so S = dP = 0 but
    // p = exp(bias - lse) is not, and p (0 - delta) would land in a real
    // bucket.  Each distance's diagonal is summed in row order, then the
    // distances into their buckets in distance order: no atomics.
    float* tile = reinterpret_cast<float*>(smem);
    named_sync(1, 256);
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; ++i) {
      const int r = 64 * wg + r0 + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + cq + (i % 2);
      tile[r * LDF + c] = visible(q0 + r, k0 + c, S, S, causal, 0) ? acc[i] : 0.f;
    }
    named_sync(1, 256);
    if (threadIdx.x < TILE_DIST) {
      const int dd = (int)threadIdx.x - (DQ_BQ - 1);  // c - r
      float sum = 0.f;
      for (int r = max(0, -dd); r < min(DQ_BQ, DQ_BK - dd); ++r) sum += tile[r * LDF + r + dd];
      dist_sum[threadIdx.x] = sum;
    }
    named_sync(1, 256);
    for (int t = threadIdx.x; t < ba.buckets; t += 256) {
      float sum = 0.f;
      for (int d = 0; d < TILE_DIST; ++d)
        if (dist_id[d] == t) sum += dist_sum[d];
      part[t] = sum;
    }
  }
}

// dtable[h, t] = the sum over the tiles of their partials of bucket t, in
// tile order; one block a head, one thread a bucket.
__global__ void __launch_bounds__(MAX_BUCKETS)
flash_bwd_dtable_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dtable,
                               int ntiles, int buckets) {
  const int h = blockIdx.x;
  const int t = threadIdx.x;
  if (t >= buckets) return;
  const float* p = part + (long long)h * ntiles * buckets + t;
  float sum = 0.f;
#pragma unroll 8
  for (int i = 0; i < ntiles; ++i) sum += p[(long long)i * buckets];
  dtable[h * buckets + t] = __float2bfloat16(sum);
}

inline int dtable_tiles(int S) {
  return ((S + DQ_BK - 1) / DQ_BK) * ((S + DQ_BQ - 1) / DQ_BQ);
}

template <int D, int BIAS>
cudaError_t launch_bias_grad(const CUtensorMap* maps, const float* lse, const float* delta,
                             void* out, const BiasArgs& ba, int B, int S, int Hq, int Hkv,
                             int causal, float scale, cudaStream_t stream) {
  const int smem = DbSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_bias_grad_kernel<D, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + DQ_BK - 1) / DQ_BK, (S + DQ_BQ - 1) / DQ_BQ, Hq);
  flash_bwd_bias_grad_kernel<D, BIAS><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, out, ba, B, S, Hq, Hkv, causal,
      (float)(scale * 1.4426950408889634));
  return cudaGetLastError();
}

template <int BIAS>
cudaError_t launch_bias_grad_d(const CUtensorMap* maps, const float* lse, const float* delta,
                               void* out, const BiasArgs& ba, int B, int S, int Hq, int Hkv,
                               int D, int causal, float scale, cudaStream_t st) {
  if (D == 128)
    return launch_bias_grad<128, BIAS>(maps, lse, delta, out, ba, B, S, Hq, Hkv, causal, scale,
                                       st);
  return launch_bias_grad<64, BIAS>(maps, lse, delta, out, ba, B, S, Hq, Hkv, causal, scale,
                                    st);
}

}  // namespace hop

bool bad_args(const void* bias, const void* table, const void* ids, int buckets,
              int causal, int window) {
  if (window > 0 && (!causal || bias != nullptr || table != nullptr)) return true;
  return table != nullptr && (ids == nullptr || buckets < 1 || buckets > MAX_BUCKETS);
}

// The tensor maps of q, k, v and dO (strides: q's, k's, v's and dO's (batch,
// seq, head), in elements), boxes of `qrows` query and `krows` key rows.
bool bwd_maps(CUtensorMap* maps, const void* q, const void* k, const void* v,
              const void* dout, int B, int S, int Hq, int Hkv, int D,
              const long long* strides, int qrows, int krows) {
  using tdx_hopper::map_bshd;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides sdo{strides[9], strides[10], strides[11]};
  return map_bshd(&maps[0], q, B, S, Hq, D, sq, qrows) &&
         map_bshd(&maps[1], k, B, S, Hkv, D, sk, krows) &&
         map_bshd(&maps[2], v, B, S, Hkv, D, sv, krows) &&
         map_bshd(&maps[3], dout, B, S, Hq, D, sdo, qrows);
}

template <typename OutT>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* delta, void* dqo, const void* bias, const void* table, const void* ids,
       int buckets, int B, int S, int Hq, int Hkv, int D, int causal, int window, float scale,
       const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const BiasArgs ba = bias_args(bias, table, ids, buckets);
  if (bad_shape(B, S, Hq, Hkv) || bad_args(bias, table, ids, buckets, causal, window) ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!bwd_maps(maps, q, k, v, dout, B, S, Hq, Hkv, D, strides, hop::DQ_BQ, hop::DQ_BK))
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return (int)hop::launch_dq_d<128, OutT>(maps, l, dl, dqo, ba, B, S, Hq, Hkv, causal,
                                            window, scale, st);
  return (int)hop::launch_dq_d<64, OutT>(maps, l, dl, dqo, ba, B, S, Hq, Hkv, causal, window,
                                         scale, st);
}

template <typename OutT>
int dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dk, void* dv, const void* bias, const void* table,
        const void* ids, int buckets, int B, int S, int Hq, int Hkv, int D, int causal,
        int window, float scale, const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const BiasArgs ba = bias_args(bias, table, ids, buckets);
  if (bad_shape(B, S, Hq, Hkv) || bad_args(bias, table, ids, buckets, causal, window) ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!bwd_maps(maps, q, k, v, dout, B, S, Hq, Hkv, D, strides, hop::BQ, hop::BKV))
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return (int)hop::launch_dkv_d<128, OutT>(maps, l, dl, dk, dv, ba, B, S, Hq, Hkv, causal,
                                             window, scale, st);
  return (int)hop::launch_dkv_d<64, OutT>(maps, l, dl, dk, dv, ba, B, S, Hq, Hkv, causal,
                                          window, scale, st);
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it does not take (for dK/dV, a tensor
// map that cannot be encoded included); the Python wrappers raise on
// anything but 0.  bias, table and ids as in flash_common.cuh (null when
// unused); window > 0 sets the sliding window (causal only, no bias),
// window <= 0 none.  The _bf16 functions write bf16 gradients, the _f32
// ones f32 gradients; the inputs are bf16 in both.

// delta (B, H, S) f32 = rowsum(dO * O); strides: o's then dO's (batch, seq,
// head), in elements.
extern "C" int tdx_flash_bwd_delta(const void* o, const void* dout, void* delta, int B,
                                   int S, int H, int D, const long long* strides,
                                   void* stream) {
  if (B < 1 || S < 1 || H < 1 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S * H;
  const Strides so{strides[0], strides[1], strides[2]};
  const Strides sd{strides[3], strides[4], strides[5]};
  hop::flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), S, H, D, so, sd, rows);
  return (int)cudaGetLastError();
}

// dK/dV or dQ from q, k, v, dO, lse and the pre-pass's delta; strides: q's,
// k's, v's and dO's (batch, seq, head), in elements.
#define TDX_DKV_ARGS                                                            \
  const void *q, const void *k, const void *v, const void *dout, const void *lse, \
      const void *delta, void *dk, void *dv, const void *bias, const void *table, \
      const void *ids, int buckets, int B, int S, int Hq, int Hkv, int D,         \
      int causal, int window, float scale, const long long *strides, void *stream
#define TDX_DQ_ARGS                                                             \
  const void *q, const void *k, const void *v, const void *dout, const void *lse, \
      const void *delta, void *dqo, const void *bias, const void *table,          \
      const void *ids, int buckets, int B, int S, int Hq, int Hkv, int D,         \
      int causal, int window, float scale, const long long *strides, void *stream

extern "C" int tdx_flash_bwd_dkv_bf16(TDX_DKV_ARGS) {
  return dkv<bf16>(q, k, v, dout, lse, delta, dk, dv, bias, table, ids, buckets, B, S, Hq,
                   Hkv, D, causal, window, scale, strides, stream);
}

extern "C" int tdx_flash_bwd_dkv_f32(TDX_DKV_ARGS) {
  return dkv<float>(q, k, v, dout, lse, delta, dk, dv, bias, table, ids, buckets, B, S, Hq,
                    Hkv, D, causal, window, scale, strides, stream);
}

extern "C" int tdx_flash_bwd_dq_bf16(TDX_DQ_ARGS) {
  return dq<bf16>(q, k, v, dout, lse, delta, dqo, bias, table, ids, buckets, B, S, Hq, Hkv, D,
                  causal, window, scale, strides, stream);
}

extern "C" int tdx_flash_bwd_dq_f32(TDX_DQ_ARGS) {
  return dq<float>(q, k, v, dout, lse, delta, dqo, bias, table, ids, buckets, B, S, Hq, Hkv,
                   D, causal, window, scale, strides, stream);
}

// dbias (Hq, S, S) bf16 = the batch sum of p * (dP - delta) (no scale: the
// bias enters the logits unscaled), from q, k, v, dO, lse, the pre-pass's
// delta and the additive bias; the table and the window are refused.
extern "C" int tdx_flash_bwd_dbias_bf16(TDX_DQ_ARGS) {
  if (bias == nullptr || table != nullptr || window > 0 || bad_shape(B, S, Hq, Hkv) ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!bwd_maps(maps, q, k, v, dout, B, S, Hq, Hkv, D, strides, hop::DQ_BQ, hop::DQ_BK))
    return (int)cudaErrorInvalidValue;
  return (int)hop::launch_bias_grad_d<hop::ADD_BIAS>(
      maps, static_cast<const float*>(lse), static_cast<const float*>(delta), dqo,
      bias_args(bias, nullptr, nullptr, 0), B, S, Hq, Hkv, D, causal, scale,
      static_cast<cudaStream_t>(stream));
}

// The tiles of dtable's (Hq, tiles, buckets) f32 scratch at length S.
extern "C" int tdx_flash_bwd_dtable_tiles(int S) { return hop::dtable_tiles(S); }

// dtable (Hq, buckets) bf16 = the batch sum of p * (dP - delta) added up
// per bucket id, from q, k, v, dO, lse, the pre-pass's delta, the table
// and the bucket ids: per tile into `part`, (Hq, tdx_flash_bwd_dtable_tiles(S),
// buckets) f32, then summed in tile order by a second kernel.  The same
// bits on every launch.  The additive bias and the window are refused.
extern "C" int tdx_flash_bwd_dtable_bf16(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, void* part, void* dtable,
                                         const void* bias, const void* table,
                                         const void* ids, int buckets, int B, int S, int Hq,
                                         int Hkv, int D, int causal, int window, float scale,
                                         const long long* strides, void* stream) {
  if (bias != nullptr || table == nullptr || ids == nullptr || buckets < 1 ||
      buckets > MAX_BUCKETS || window > 0 || bad_shape(B, S, Hq, Hkv) ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!bwd_maps(maps, q, k, v, dout, B, S, Hq, Hkv, D, strides, hop::DQ_BQ, hop::DQ_BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = hop::launch_bias_grad_d<hop::TABLE_BIAS>(
      maps, static_cast<const float*>(lse), static_cast<const float*>(delta), part,
      bias_args(nullptr, table, ids, buckets), B, S, Hq, Hkv, D, causal, scale, st);
  if (err != cudaSuccess) return (int)err;
  hop::flash_bwd_dtable_reduce_kernel<<<Hq, (buckets + 31) / 32 * 32, 0, st>>>(
      static_cast<const float*>(part), static_cast<bf16*>(dtable), hop::dtable_tiles(S),
      buckets);
  return (int)cudaGetLastError();
}
