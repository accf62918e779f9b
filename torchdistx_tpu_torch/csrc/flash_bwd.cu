// Flash-attention backward for Hopper (sm_90a): the dK/dV kernel, its
// delta pre-pass and the dQ kernel; bf16 in, bf16 or f32 out, f32
// recompute and accumulation.
//
// Replaces the Pallas kernels torchdistx_tpu/ops/flash_attention.py
// _bwd_dkv_kernel (K/V-stationary: dK, dV) and _bwd_dq_kernel
// (Q-stationary: dQ), launched by _flash_backward_core, in every variant:
// causal (the Llama and GPT-2 training paths, T5's decoder) or not (T5's
// encoder), with no bias, an additive bias or T5's bucket table
// (flash_common.cuh), or with the sliding window (Mistral; causal, no
// bias); D 64 and 128; GQA.  The gradient of the bias itself is
// flash_bias_bwd.cu's.
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
// dQ is still the first version: a block holds one 64-row query tile
// stationary, streams K/V tiles through shared memory with synchronous
// loads, and runs every product with warp-level WMMA 16x16x16 bf16
// fragments (BwdLayout, load_tile, tile_delta, gemm_abt of
// flash_common.cuh); its f32 accumulator stays in registers.  It
// recomputes Q.K^T and dO.V^T, as the JAX design does.
//
// Output type: bf16, the gradients of one attention call; or f32 (the JAX
// kernels' dq_dtype / part_dtype = float32), which ring attention's
// backward asks for: it adds one block's partial gradients per hop into
// f32 accumulators that travel the ring.  The accumulators are f32 in
// either case; only the store differs.
//
// Layout: q, o, dO, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D); lse and
// delta (B, Hq, S) f32.  Sq == Skv.  dK/dV and the pre-pass take q, k, v,
// o and dO with any strides TMA takes (hopper.cuh), dQ contiguous ones;
// the outputs are contiguous.  Causal tiles above the diagonal are
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

// P and dS of one 64x64 tile (rows q0.., columns k0..), masked.
template <int D>
__device__ __forceinline__ void ds_tile(const float* Ss, const float* dPs, bf16* Ps,
                                        bf16* dSs, const float* lse,
                                        const float* delta, const BiasArgs& ba,
                                        const float* dist_bias, int h, int q0,
                                        int k0, int S, int causal, int window,
                                        float scale) {
  using L = BwdLayout<D>;
  for (int i = threadIdx.x; i < BT * BT; i += BWD_THREADS) {
    const int r = i / BT, c = i % BT;
    const int qi = q0 + r, kj = k0 + c;
    float p = 0.f;
    if (visible(qi, kj, S, S, causal, window))
      p = expf(Ss[r * L::LDS + c] * scale +
               bias_at(ba, dist_bias, h, S, S, qi, kj, r, c) - lse[r]);
    const float ds = p * (dPs[r * L::LDS + c] - delta[r]) * scale;
    Ps[r * L::LDP + c] = __float2bfloat16(p);
    dSs[r * L::LDP + c] = __float2bfloat16(ds);
  }
}

// acc += A B, A 64x64 bf16 (LDP), B 64 x D bf16 (LDH): dQ += dS K.
template <int D>
__device__ __forceinline__ void acc_ab(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const bf16* A,
    const bf16* B, int warp) {
  using L = BwdLayout<D>;
  const int rm = (warp % 4) * 16;
  const int cn = (warp / 4) * (D / 2);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, A + rm * L::LDP + kk * 16, L::LDP);
#pragma unroll
    for (int f = 0; f < L::NF; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, B + kk * 16 * L::LDH + cn + f * 16, L::LDH);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
}

__device__ __forceinline__ void put(bf16* dst, float x) { *dst = __float2bfloat16(x); }
__device__ __forceinline__ void put(float* dst, float x) { *dst = x; }

// Write this block's 64 x D accumulator (spread over the warps' fragments)
// as rows of a (B, S, H, D) bf16 or f32 tensor, through fp32 staging in
// `stage`.
template <int D, typename OutT>
__device__ __forceinline__ void store_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, float* stage,
    OutT* gbase, long long gstride, int valid, int warp) {
  using L = BwdLayout<D>;
  const int rm = (warp % 4) * 16;
  const int cn = (warp / 4) * (D / 2);
  __syncthreads();
#pragma unroll
  for (int f = 0; f < L::NF; ++f)
    wmma::store_matrix_sync(stage + rm * L::LDO + cn + f * 16, acc[f], L::LDO,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BT * D; i += BWD_THREADS) {
    const int r = i / D, c = i % D;
    if (r < valid) put(gbase + r * gstride + c, stage[r * L::LDO + c]);
  }
}

template <int D, typename OutT>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    OutT* __restrict__ dq, BiasArgs ba, int S, int Hq, int Hkv,
                    int causal, int window, float scale) {
  using L = BwdLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::dl_off);
  float* dist_bias = reinterpret_cast<float*>(smem + L::diag_off);

  const int q0 = blockIdx.x * BT;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const long long qstride = (long long)Hq * D;
  const long long kstride = (long long)Hkv * D;
  const int qvalid = min(BT, S - q0);
  const long long qoff = ((long long)b * S + q0) * qstride + (long long)h * D;

  load_tile<D>(Qs, L::LDH, q + qoff, qstride, qvalid);
  load_tile<D>(dOs, L::LDH, dout + qoff, qstride, qvalid);
  load_lse(lse_s, lse + ((long long)b * Hq + h) * S + q0, qvalid);
  __syncthreads();
  tile_delta<D>(delta_s, dOs, o + qoff, qstride, qvalid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_q[L::NF];
#pragma unroll
  for (int f = 0; f < L::NF; ++f) wmma::fill_fragment(acc_q[f], 0.f);

  // causal: key tiles up to the diagonal, from the first the band reaches,
  // as the forward walks them
  const int kv_end = causal ? min(S, q0 + BT) : S;
  for (int k0 = band_kv_begin(q0, 0, window, BT); k0 < kv_end; k0 += BT) {
    const int kvalid = min(BT, S - k0);
    const long long koff = ((long long)b * S + k0) * kstride + (long long)hk * D;
    __syncthreads();  // the previous tile is fully consumed
    load_tile<D>(Ks, L::LDH, k + koff, kstride, kvalid);
    load_tile<D>(Vs, L::LDH, v + koff, kstride, kvalid);
    stage_diag(dist_bias, ba, h, q0, k0, S, threadIdx.x, BWD_THREADS);
    __syncthreads();
    gemm_abt<D>(Ss, Qs, Ks, warp);
    gemm_abt<D>(dPs, dOs, Vs, warp);
    __syncthreads();
    ds_tile<D>(Ss, dPs, Ps, dSs, lse_s, delta_s, ba, dist_bias, h, q0, k0, S,
               causal, window, scale);
    __syncthreads();
    acc_ab<D>(acc_q, dSs, Ks, warp);
  }

  store_acc<D, OutT>(acc_q, Ss, dq + qoff, qstride, qvalid, warp);
}

template <int D, typename OutT>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dq,
                      const BiasArgs& ba, int B, int S, int Hq, int Hkv,
                      int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = BwdLayout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BT - 1) / BT, B * Hq);
  flash_bwd_dq_kernel<D, OutT><<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<OutT*>(dq), ba, S, Hq,
      Hkv, causal, window, scale);
  return cudaGetLastError();
}

bool bad_args(const void* bias, const void* table, const void* ids, int buckets,
              int causal, int window) {
  if (window > 0 && (!causal || bias != nullptr || table != nullptr)) return true;
  return table != nullptr && (ids == nullptr || buckets < 1 || buckets > MAX_BUCKETS);
}

template <typename OutT>
int dq(const void* q, const void* k, const void* v, const void* o,
       const void* dout, const void* lse, void* dqo, const void* bias,
       const void* table, const void* ids, int buckets, int B, int S, int Hq,
       int Hkv, int D, int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const BiasArgs ba = bias_args(bias, table, ids, buckets);
  if (bad_shape(B, S, Hq, Hkv) || bad_args(bias, table, ids, buckets, causal, window))
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return (int)launch_dq<128, OutT>(q, k, v, o, dout, l, dqo, ba, B, S, Hq, Hkv, causal, window, scale, st);
  if (D == 64)
    return (int)launch_dq<64, OutT>(q, k, v, o, dout, l, dqo, ba, B, S, Hq, Hkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
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
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides sdo{strides[9], strides[10], strides[11]};
  using tdx_hopper::map_bshd;
  if (!map_bshd(&maps[0], q, B, S, Hq, D, sq, hop::BQ) ||
      !map_bshd(&maps[1], k, B, S, Hkv, D, sk, hop::BKV) ||
      !map_bshd(&maps[2], v, B, S, Hkv, D, sv, hop::BKV) ||
      !map_bshd(&maps[3], dout, B, S, Hq, D, sdo, hop::BQ))
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

// dK/dV from q, k, v, dO, lse and the pre-pass's delta; strides: q's, k's,
// v's and dO's (batch, seq, head), in elements.
#define TDX_DKV_ARGS                                                            \
  const void *q, const void *k, const void *v, const void *dout, const void *lse, \
      const void *delta, void *dk, void *dv, const void *bias, const void *table, \
      const void *ids, int buckets, int B, int S, int Hq, int Hkv, int D,         \
      int causal, int window, float scale, const long long *strides, void *stream
#define TDX_DQ_ARGS                                                           \
  const void *q, const void *k, const void *v, const void *o,                 \
      const void *dout, const void *lse, void *dqo, const void *bias,         \
      const void *table, const void *ids, int buckets, int B, int S, int Hq,  \
      int Hkv, int D, int causal, int window, float scale, void *stream

extern "C" int tdx_flash_bwd_dkv_bf16(TDX_DKV_ARGS) {
  return dkv<bf16>(q, k, v, dout, lse, delta, dk, dv, bias, table, ids, buckets, B, S, Hq,
                   Hkv, D, causal, window, scale, strides, stream);
}

extern "C" int tdx_flash_bwd_dkv_f32(TDX_DKV_ARGS) {
  return dkv<float>(q, k, v, dout, lse, delta, dk, dv, bias, table, ids, buckets, B, S, Hq,
                    Hkv, D, causal, window, scale, strides, stream);
}

extern "C" int tdx_flash_bwd_dq_bf16(TDX_DQ_ARGS) {
  return dq<bf16>(q, k, v, o, dout, lse, dqo, bias, table, ids, buckets, B, S, Hq,
                  Hkv, D, causal, window, scale, stream);
}

extern "C" int tdx_flash_bwd_dq_f32(TDX_DQ_ARGS) {
  return dq<float>(q, k, v, o, dout, lse, dqo, bias, table, ids, buckets, B, S,
                   Hq, Hkv, D, causal, window, scale, stream);
}
