// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax state
// and accumulation.
//
// Replaces the Pallas kernel torchdistx_tpu/ops/flash_attention.py:_kernel
// (launched by _flash_forward) in all its variants: causal or not, with
// Sq != Skv and the end-aligned mask (query i sees keys j <= i + Skv - Sq);
// plain bf16 output (the serving engine's prefill), with the row
// log-sum-exp (emit_lse: the training forward, whose lse the backward
// kernels consume), or the (m, l) residuals (emit_residuals: ring
// attention's per-hop block); with no bias, an additive (Hq, Sq, Skv)
// bias, or T5's bucket table (flash_common.cuh), the bias added in f32 to
// the scaled logits before the mask (the lse then includes it); or, causal
// only and without a bias, the sliding window of Mistral and Mixtral:
// query i sees keys i + diag - window < j <= i + diag.
//
// The residuals variant writes the raw f32 accumulator sum_j exp(s_ij -
// m_i) v_j (no divide by l, no bf16 rounding) as (B, Sq, Hq, D) f32, and
// each row's running max m and sum l as (B, Hq, Sq) f32, so that ring
// attention can merge the blocks of several hops in f32 (ops/attention.py
// _ring_combine).  m is in natural-log units of the scaled, biased logits.
//
// What bounds it on an H100: operations.  The causal prefill at S 2048,
// D 128 does 2 * pairs * 2D flops per head against 4 * S * D * 2 bytes of
// input and output, hundreds of flops per byte, far right of the card's
// ridge point.  So the logits stay on chip (online softmax over K/V tiles,
// the TPU kernel's scheme) and the design feeds the tensor cores at their
// Hopper rate:
//   - a block owns 128 query rows of one head: two consumer warpgroups of
//     64 rows each, and one producer warpgroup whose single thread starts
//     TMA loads (Q once; K and V tiles of 128 rows through a 2-stage ring
//     of full / empty mbarriers) and then idles with 24 registers, so the
//     consumers run with 240 (setmaxnreg);
//   - S = Q K^T is wgmma m64n128k16 with Q and K both read from shared
//     memory (K-major); O += P V is wgmma with P converted to bf16 in
//     registers (the accumulator's layout is the A operand's) and V read
//     MN-major from shared memory;
//   - O and the row state (m, l) stay in registers for the whole loop.  A
//     thread owns two rows; their max reduces over the 4 lanes of a quad
//     with 2 shuffles, their sum only once, in the epilogue;
//   - the softmax runs in the exp2 domain (scale * log2 e folded into one
//     multiply, ex2.approx.ftz); m and lse go back to natural-log units in
//     the epilogue;
//   - only tiles that cross the diagonal, the band's edge or the ragged
//     end are masked, each row by two column bounds (two compares and a
//     select an element); interior tiles run unmasked.  A per-element
//     mask test compiled to about a thousand integer and predicate
//     instructions a tile, more instruction slots than the products';
//   - the additive bias is read in the accumulator's (row, col) layout,
//     its loads started before the wait on S; the bucket biases of a tile's
//     191 distances are staged per warpgroup in shared memory while S
//     runs;
//   - causal grids run the heaviest query tiles first (the query tile is
//     the slow grid index, reversed), so no long tile is left for the tail;
//   - the epilogue normalises in registers and stores O through a
//     128-byte-swizzled stage in Q's shared memory with a TMA store.
// Masked logits take the TPU kernel's finite -1e30 (here -1e30 * log2 e):
// a row whose first visited tile lies wholly outside its band keeps that m
// and gets p = 1 for those columns, and the next tile's correction
// exp2(-1e30 log2 e - m) = 0 cancels them, exactly as in the Pallas kernel.
// K/V tiles wholly above the diagonal or below the band are never loaded,
// so a windowed prefill costs S * window, not S^2.
//
// Layout: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), any strides TMA takes
// (hopper.cuh; the wrapper checks them), o contiguous like q.  GQA: query
// head h reads kv head h / (Hq / Hkv) in place.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tdx_hopper;
using tdx_flash::BiasArgs;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;  // query rows of a block, 64 per consumer warpgroup
constexpr int BK = 128;  // key rows of a tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int PANEL = BQ * 128;  // bytes of a 64-column panel of a 128-row tile
constexpr int NDIST = BQ / 2 + BK - 1;  // distances of a warpgroup's 64 x 128 tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG2 = -1e30f * LOG2E;  // the TPU kernel's -1e30, in log2 units

enum { NO_BIAS = 0, ADD_BIAS = 1, TABLE_BIAS = 2 };

// What the epilogue writes: o (and lse when not null), or with acc set the
// residuals acc, m and l instead.
struct Outs {
  bf16* o;
  float* lse;
  float* acc;
  float* m;
  float* l;
};

template <int D>
struct Smem {
  static constexpr int TILE = BQ * D * 2;  // a 128-row Q, K or V tile
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + TILE;
  static constexpr int v_off = k_off + STAGES * TILE;
  static constexpr int diag_off = v_off + STAGES * TILE;  // 2 warpgroups x 2 buffers
  static constexpr int bar_off = diag_off + 2 * 2 * 192 * 4;
  static constexpr int bytes = bar_off + (1 + 3 * STAGES) * 8 + 1024;
};

template <int D, int BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 Outs out, BiasArgs ba, int Sq, int Skv, int Hq, int Hkv, float scale_log2,
                 int causal, int window) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int diag = Skv - Sq;
  // from the first key tile the band reaches to the last key a row sees
  const int kv_end = causal ? min(Skv, q0 + BQ + diag) : Skv;
  const int kv_begin = tdx_flash::band_kv_begin(q0, diag, window, BK);
  const int ntiles = (kv_end - kv_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    bar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full_k + s, 1);
      bar_init(full_v + s, 1);
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
      bar_expect_tx(full_q, L::TILE);
      for (int p = 0; p < D / 64; ++p)
        tma_load(smem + L::q_off + p * PANEL, &tq, full_q, p * 64, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        bar_wait(empty + st, ((t / STAGES) & 1) ^ 1);
        const int k0 = kv_begin + t * BK;
        bar_expect_tx(full_k + st, L::TILE);
        for (int p = 0; p < D / 64; ++p)
          tma_load(smem + L::k_off + st * L::TILE + p * PANEL, &tk, full_k + st, p * 64, hk,
                   k0, b);
        bar_expect_tx(full_v + st, L::TILE);
        for (int p = 0; p < D / 64; ++p)
          tma_load(smem + L::v_off + st * L::TILE + p * PANEL, &tv, full_v + st, p * 64, hk,
                   k0, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each --------------------------------------------
  reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qw = q0 + 64 * wg;           // this warpgroup's first query row
  const int r0 = 16 * warp + lane / 4;   // the thread's rows: r0 and r0 + 8
  const int cq = 2 * (lane % 4);         // its columns in each 8-column chunk
  float* dist = reinterpret_cast<float*>(smem + L::diag_off) + wg * 2 * 192;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG2, NEG2};
  float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad at the end

  const uint64_t dq = desc_sw128(smem + L::q_off + wg * 64 * 128, 16, 1024);
  bar_wait(full_q, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const int k0 = kv_begin + t * BK;
    float* dcur = dist + (t & 1) * 192;
    const uint64_t dk = desc_sw128(smem + L::k_off + st * L::TILE, 16, 1024);
    bar_wait(full_k + st, ph);

    float s[BK / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
      wgmma_ss_n128(s, desc_add(dq, off), desc_add(dk, off), kk > 0);
    }
    wg_commit();

    uint32_t braw[BIAS == ADD_BIAS ? BK / 4 : 1];
    if constexpr (BIAS == ADD_BIAS) {
      // the bias pairs of the thread's (row, column pair)s, loaded while
      // the product runs: from two row pointers in a tile inside the bias,
      // element by element with 0 past the ends at the edges (those logits
      // are masked)
      const bf16* row0 = ba.bias + ((long long)h * Sq + qw + r0) * Skv + k0 + cq;
      const long long down = 8LL * Skv;
      if (qw + 64 <= Sq && k0 + BK <= Skv && Skv % 2 == 0) {
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2)
          braw[i / 2] = *reinterpret_cast<const uint32_t*>(
              row0 + ((i / 2) % 2) * down + 8 * (i / 4));
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const int qi = qw + r0 + 8 * ((i / 2) % 2);
          const int kj = k0 + 8 * (i / 4) + cq;
          const bf16* src = row0 + ((i / 2) % 2) * down + 8 * (i / 4);
          bf16 lo = __float2bfloat16(0.f), hi = lo;
          if (qi < Sq && kj < Skv) lo = src[0];
          if (qi < Sq && kj + 1 < Skv) hi = src[1];
          __nv_bfloat162 pr(lo, hi);
          braw[i / 2] = *reinterpret_cast<uint32_t*>(&pr);
        }
      }
    }
    if constexpr (BIAS == TABLE_BIAS) {
      // dcur[c - r + 63] = the bias of distance k0 + c - (qw + r)
      for (int d = tid; d < NDIST; d += 128) {
        const int rel = k0 - qw + d - 63;
        float val = 0.f;
        if (rel > -Skv && rel < Skv)
          val = __bfloat162float(ba.table[h * ba.buckets + ba.ids[rel + Skv - 1]]);
        dcur[d] = val;
      }
    }
    if constexpr (BIAS == TABLE_BIAS) named_sync(1 + wg, 128);
    wg_wait<0>();
    fence_regs(s);

    // logits in log2 units
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = s[i] * scale_log2;
      if constexpr (BIAS == ADD_BIAS) {
        const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(&braw[i / 2]);
        x = fmaf(__bfloat162float(i % 2 ? pr.y : pr.x), LOG2E, x);
      }
      if constexpr (BIAS == TABLE_BIAS) {
        const int r = r0 + 8 * ((i / 2) % 2);
        const int c = 8 * (i / 4) + cq + (i % 2);
        x = fmaf(dcur[c - r + 63], LOG2E, x);
      }
      s[i] = x;
    }
    // the mask, only in tiles that cross the diagonal, the band's edge or
    // the ragged end: row qi sees the tile's columns lo <= c < hi (rows past
    // Sq are never stored and need none)
    if (k0 + BK > Skv || (causal && k0 + BK - 1 > qw + diag) ||
        (window > 0 && k0 <= qw + 63 + diag - window)) {
      int lo[2], hi[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = qw + r0 + 8 * j;
        hi[j] = (causal ? min(Skv, qi + diag + 1) : Skv) - k0 - cq;
        lo[j] = (window > 0 ? qi + diag - window + 1 - k0 : 0) - cq;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int c = 8 * (i / 4) + (i % 2);  // less the thread's cq
        const int j = (i / 2) % 2;
        if (c < lo[j] || c >= hi[j]) s[i] = NEG2;
      }
    }

    // online softmax: the new row max over the quad, the correction, p
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      alpha[j] = exp2_ftz(m[j] - mx[j]);
      m[j] = mx[j];
      l[j] *= alpha[j];
    }
    uint32_t pa[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int j = (i / 2) % 2;
      const float p0 = exp2_ftz(s[i] - mx[j]);
      const float p1 = exp2_ftz(s[i + 1] - mx[j]);
      l[j] += p0 + p1;
      pa[i / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // O += P V, P from registers
    const uint64_t dv = desc_sw128(smem + L::v_off + st * L::TILE, PANEL, 1024);
    bar_wait(full_v + st, ph);
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (D == 128)
        wgmma_rs_n128(o, pa + 4 * kk, desc_add(dv, kk * 2048));
      else
        wgmma_rs_n64(o, pa + 4 * kk, desc_add(dv, kk * 2048));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    bar_arrive(empty + st);
  }

  // ---- epilogue --------------------------------------------------------------------
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  const long long qstride = (long long)Hq * D;
  const long long srow = ((long long)b * Hq + h) * Sq;  // (B, Hq, Sq) row base
  if (out.acc != nullptr) {
    // the (m, l) residuals: the raw accumulator and each row's state
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int qi = qw + r0 + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + cq;
      if (qi < Sq)
        *reinterpret_cast<float2*>(out.acc + ((long long)b * Sq + qi) * qstride +
                                   (long long)h * D + c) = make_float2(o[i], o[i + 1]);
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = qw + r0 + 8 * j;
        if (qi < Sq) {
          out.m[srow + qi] = m[j] * LN2;
          out.l[srow + qi] = l[j];
        }
      }
    }
    return;
  }

  // normalise, stage the warpgroup's 64 rows in its half of Q's tile (the
  // same swizzled panels), then one TMA store a panel
  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) inv[j] = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = 64 * wg + r0 + 8 * ((i / 2) % 2);
    const int chunk = (i / 4) % 8;
    const int p = (i / 4) / 8;
    const float f = inv[(i / 2) % 2];
    unsigned char* dst = smem + L::q_off + p * PANEL + row * 128 +
                         ((chunk ^ (row % 8)) * 16) + cq * 2;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[i] * f, o[i + 1] * f);
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (tid == 0) {
    for (int p = 0; p < D / 64; ++p)
      tma_store(&to, smem + L::q_off + p * PANEL + wg * 64 * 128, p * 64, h, qw, b);
    tma_store_wait();
  }
  if (out.lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qi = qw + r0 + 8 * j;
      if (qi < Sq) out.lse[srow + qi] = (m[j] + log2f(fmaxf(l[j], 1e-30f))) * LN2;
    }
  }
}

template <int D, int BIAS>
cudaError_t launch(const CUtensorMap* maps, const Outs& out, const BiasArgs& ba, int B,
                   int Sq, int Skv, int Hq, int Hkv, float scale, int causal, int window,
                   cudaStream_t stream) {
  const int smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D, BIAS><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], out, ba, Sq, Skv, Hq, Hkv,
      (float)(scale * 1.4426950408889634), causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const CUtensorMap* maps, const Outs& out, const BiasArgs& ba, int B,
                     int Sq, int Skv, int Hq, int Hkv, float scale, int causal, int window,
                     cudaStream_t st) {
  if (ba.bias != nullptr)
    return launch<D, ADD_BIAS>(maps, out, ba, B, Sq, Skv, Hq, Hkv, scale, causal, window, st);
  if (ba.table != nullptr)
    return launch<D, TABLE_BIAS>(maps, out, ba, B, Sq, Skv, Hq, Hkv, scale, causal, window,
                                 st);
  return launch<D, NO_BIAS>(maps, out, ba, B, Sq, Skv, Hq, Hkv, scale, causal, window, st);
}

// strides: q, k, v, each (batch, seq, head) in elements; o is contiguous.
int run(const void* q, const void* k, const void* v, const Outs& out, const void* bias,
        const void* table, const void* ids, int buckets, int B, int Sq, int Skv, int Hq,
        int Hkv, int D, float scale, int causal, int window, const long long* strides,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BiasArgs ba = tdx_flash::bias_args(bias, table, ids, buckets);
  if (Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (table != nullptr && (Sq != Skv || ids == nullptr || buckets < 1 ||
                           buckets > tdx_flash::MAX_BUCKETS))
    return (int)cudaErrorInvalidValue;
  if (window > 0 && (!causal || bias != nullptr || table != nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{(long long)Sq * Hq * D, (long long)Hq * D, D};
  bool ok = map_bshd(&maps[0], q, B, Sq, Hq, D, sq, BQ) &&
            map_bshd(&maps[1], k, B, Skv, Hkv, D, sk, BK) &&
            map_bshd(&maps[2], v, B, Skv, Hkv, D, sv, BK);
  ok = ok && (out.o == nullptr ? map_bshd(&maps[3], q, B, Sq, Hq, D, sq, 64)
                               : map_bshd(&maps[3], out.o, B, Sq, Hq, D, so, 64));
  if (!ok) return (int)cudaErrorInvalidValue;
  if (D == 128)
    return (int)launch_d<128>(maps, out, ba, B, Sq, Skv, Hq, Hkv, scale, causal, window, st);
  return (int)launch_d<64>(maps, out, ba, B, Sq, Skv, Hq, Hkv, scale, causal, window, st);
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it does not take (a tensor map that
// cannot be encoded included); the Python wrapper raises on anything but
// 0.  bias, table and ids as in flash_common.cuh (null when unused); window
// > 0 sets the sliding window (causal only, no bias), window <= 0 none.
// strides: 9 element strides, (batch, seq, head) of q, k and v.

// The bf16 output o (contiguous); the lse too when its pointer is not null.
extern "C" int tdx_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse_out, const void* bias, const void* table,
                                  const void* ids, int buckets, int B, int Sq, int Skv,
                                  int Hq, int Hkv, int D, float scale, int causal,
                                  int window, const long long* strides, void* stream) {
  Outs out{static_cast<bf16*>(o), static_cast<float*>(lse_out), nullptr, nullptr, nullptr};
  return run(q, k, v, out, bias, table, ids, buckets, B, Sq, Skv, Hq, Hkv, D, scale, causal,
             window, strides, stream);
}

// The (m, l) residuals: acc (B, Sq, Hq, D) f32, m and l (B, Hq, Sq) f32;
// no bias or an additive one, no window, no bucket table.
extern "C" int tdx_flash_fwd_residuals_bf16(const void* q, const void* k, const void* v,
                                            void* acc, void* m, void* l, const void* bias,
                                            int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                            float scale, int causal,
                                            const long long* strides, void* stream) {
  if (acc == nullptr || m == nullptr || l == nullptr) return (int)cudaErrorInvalidValue;
  Outs out{nullptr, nullptr, static_cast<float*>(acc), static_cast<float*>(m),
           static_cast<float*>(l)};
  return run(q, k, v, out, bias, nullptr, nullptr, 0, B, Sq, Skv, Hq, Hkv, D, scale, causal,
             0, strides, stream);
}
