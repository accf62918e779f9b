// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax
// state and accumulation.
//
// Replaces the Pallas kernel torchdistx_tpu/ops/flash_attention.py:_kernel
// (launched by _flash_forward) in all its variants: causal or not; plain
// bf16 output (the cold prefill of the serving engine), with the row
// log-sum-exp (emit_lse: the training forward, whose lse the backward
// kernels in flash_bwd.cu and flash_bias_bwd.cu consume), or the (m, l)
// residuals (emit_residuals: ring attention's per-hop block, below); with
// no bias, an additive (Hq, Sq, Skv) bias, or T5's bucket table
// (flash_common.cuh), the bias added in f32 to the scaled logits before
// the mask as the TPU kernel adds it (the lse then includes the bias, as
// the backward expects); or, causal only and without a bias, the sliding
// window of Mistral and Mixtral: query i sees keys j with
// i + diag - window < j <= i + diag.
//
// The residuals variant runs the same loop; only its epilogue differs.  It
// writes the raw f32 accumulator sum_j exp(s_ij - m_i) v_j (no divide by l,
// no bf16 rounding) as (B, Sq, Hq, D) f32, and each row's running max m
// and running sum l as (B, Hq, Sq) f32, so that ring attention can merge
// the blocks of several hops in f32 (ops/attention.py _ring_combine, which
// rescales by exp(m - m')).  m stays in the natural-log domain of the
// scaled and biased logits, as the loop computes it with expf.  The ring
// takes it with no bias or an additive bias (the column slice of its
// (Hq, Sq, S) bias), never with the window or the bucket table.
//
// What bounds it on an H100: operations.  Causal prefill at S = 2048,
// D = 128 does ~2 * S^2 * D flops per head against ~4 * S * D * 2 bytes of
// input and output, hundreds of flops per byte, far right of the card's
// ridge point (the bias adds 2 bytes per pair, still far right).  The
// design therefore keeps the logits out of device memory
// (online softmax over K/V tiles in shared memory, the TPU kernel's scheme)
// and runs both products, Q.K^T and P.V, on the tensor cores through
// warp-level WMMA 16x16x16 bf16 fragments with fp32 accumulators.  It is the
// simple first version: no TMA, no wgmma, no warp specialisation, and the
// fp32 output accumulator lives in shared memory so each warp can rescale
// its rows by the online-softmax correction (WMMA fragments do not expose
// their row mapping).
//
// Layout: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o like q, all contiguous
// (the JAX package's layout; no transpose on the host); lse, when its
// pointer is not null, (B, Hq, Sq) f32, lse = m + log(max(l, 1e-30)) in
// units of the scaled logits, as the TPU kernel's emit_lse branch.  Grid
// (ceil(Sq / 64), B * Hq); block of 4 warps, each warp owning 16 query rows.
// GQA: query head h reads kv head h / (Hq / Hkv) in place.  The causal mask
// is end-aligned (query i sees keys j <= i + Skv - Sq) like the TPU kernel;
// K/V tiles entirely above the diagonal, or entirely below the window's
// band, are never loaded (the key loop runs from the first tile the band
// reaches), so a windowed prefill costs S * window, not S^2; the ragged
// last tile of Q and of K/V is masked here (zero-filled rows, -1e30 logits).
// Masked logits take the TPU kernel's finite -1e30, not -inf: a row whose
// first visited tile lies wholly outside its band keeps m = -1e30 and gets
// p = 1 for those columns, and the next tile's correction exp(-1e30 - m)
// = 0 cancels them, exactly as in the Pallas kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

using tdx_flash::BiasArgs;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // the TPU kernel's _NEG_INF

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
struct Layout {
  static constexpr int LDH = D + 8;   // bf16 Q/K/V tiles (row stride, elements)
  static constexpr int LDS = BK + 4;  // fp32 logits
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // fp32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * LDH * 2;
  static constexpr size_t v_off = k_off + size_t(BK) * LDH * 2;
  static constexpr size_t s_off = v_off + size_t(BK) * LDH * 2;
  static constexpr size_t p_off = s_off + size_t(BQ) * LDS * 4;
  static constexpr size_t o_off = p_off + size_t(BQ) * LDP * 2;
  static constexpr size_t m_off = o_off + size_t(BQ) * LDO * 4;
  static constexpr size_t l_off = m_off + size_t(BQ) * 4;
  static constexpr size_t c_off = l_off + size_t(BQ) * 4;
  static constexpr size_t d_off = c_off + size_t(BQ) * 4;  // bucket biases
  static constexpr size_t bytes = d_off + 128 * 4;
};

// Copy a 64-row tile into shared memory with 16-byte loads; rows at or
// past `valid` are zero-filled so masked columns never meet NaN or Inf.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long gstride, int valid) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + r * gstride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, Outs out, BiasArgs ba, int Sq,
                 int Skv, int Hq, int Hkv, float scale, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* ms = reinterpret_cast<float*>(smem + L::m_off);
  float* ls = reinterpret_cast<float*>(smem + L::l_off);
  float* cs = reinterpret_cast<float*>(smem + L::c_off);
  float* dist_bias = reinterpret_cast<float*>(smem + L::d_off);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int diag = Skv - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  const long long qstride = (long long)Hq * D;   // between sequence rows
  const long long kstride = (long long)Hkv * D;
  const bf16* qbase = q + ((long long)b * Sq + q0) * qstride + (long long)h * D;
  const bf16* kbase = k + (long long)b * Skv * kstride + (long long)hk * D;
  const bf16* vbase = v + (long long)b * Skv * kstride + (long long)hk * D;

  load_tile<D>(Qs, L::LDH, qbase, qstride, min(BQ, Sq - q0));
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    ms[i] = NEG_INF;
    ls[i] = 0.f;
  }

  // block pruning: from the first key tile the band reaches to the last
  // key any row of this Q tile can see
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q0 + BQ + diag);
  const int kv_begin = tdx_flash::band_kv_begin(q0, diag, window, BK);

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed; Q/O/m/l init visible
    load_tile<D>(Ks, L::LDH, kbase + k0 * kstride, kstride, min(BK, Skv - k0));
    load_tile<D>(Vs, L::LDH, vbase + k0 * kstride, kstride, min(BK, Skv - k0));
    tdx_flash::stage_diag(dist_bias, ba, h, q0, k0, Skv, threadIdx.x, NTHREADS);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (fp32 accumulate)
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + r0 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(fb, Ks + n * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * L::LDS + n * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // the bias (0 without one) of each lane's 2 columns in this warp's 16
    // rows, all loads issued before the softmax waits on any of them
    float bias_reg[16][2];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int r = r0 + rr, c = lane + 32 * t;
        bias_reg[rr][t] = tdx_flash::bias_at(ba, dist_bias, h, Sq, Skv, q0 + r, k0 + c, r, c);
      }

    // online softmax, one row at a time across the warp (2 columns a lane),
    // on the scaled and biased logits
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int qi = q0 + r;
      float s[2];
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const bool vis = tdx_flash::visible(qi, k0 + c, Sq, Skv, causal, window);
        s[t] = vis ? Ss[r * L::LDS + c] * scale + bias_reg[rr][t] : NEG_INF;
        mx = fmaxf(mx, s[t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p = expf(s[t] - m_new);
        sum += p;
        Ps[r * L::LDP + lane + 32 * t] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ms[r] = m_new;
        ls[r] = ls[r] * corr + sum;
        cs[r] = corr;
      }
    }
    __syncwarp();

    // rescale this warp's accumulator rows by the correction
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = r0 + i / D;
      Os[r * L::LDO + i % D] *= cs[r];
    }
    __syncwarp();

    // O += P V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + r0 * L::LDO + n * 16, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + r0 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Os + r0 * L::LDO + n * 16, acc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (out.acc != nullptr) {
    // the (m, l) residuals: the raw accumulator and each row's state
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = r0 + i / D;
      const int c = i % D;
      const int qi = q0 + r;
      if (qi < Sq)
        out.acc[((long long)b * Sq + qi) * qstride + (long long)h * D + c] =
            Os[r * L::LDO + c];
    }
    if (lane < 16) {
      const int r = r0 + lane;
      const int qi = q0 + r;
      if (qi < Sq) {
        out.m[((long long)b * Hq + h) * Sq + qi] = ms[r];
        out.l[((long long)b * Hq + h) * Sq + qi] = ls[r];
      }
    }
    return;
  }

  // normalise and store this warp's rows
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D;
    const int c = i % D;
    const int qi = q0 + r;
    if (qi < Sq) {
      const float val = Os[r * L::LDO + c] / fmaxf(ls[r], 1e-30f);
      out.o[((long long)b * Sq + qi) * qstride + (long long)h * D + c] =
          __float2bfloat16(val);
    }
  }
  if (out.lse != nullptr && lane < 16) {
    const int r = r0 + lane;
    const int qi = q0 + r;
    if (qi < Sq)
      out.lse[((long long)b * Hq + h) * Sq + qi] = ms[r] + logf(fmaxf(ls[r], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const Outs& out,
                   const BiasArgs& ba, int B, int Sq, int Skv, int Hq, int Hkv,
                   float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), out, ba, Sq, Skv, Hq, Hkv, scale, causal,
      window);
  return cudaGetLastError();
}

int run(const void* q, const void* k, const void* v, const Outs& out,
        const void* bias, const void* table, const void* ids, int buckets, int B,
        int Sq, int Skv, int Hq, int Hkv, int D, float scale, int causal,
        int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BiasArgs ba = tdx_flash::bias_args(bias, table, ids, buckets);
  if (Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (table != nullptr && (Sq != Skv || ids == nullptr || buckets < 1 ||
                           buckets > tdx_flash::MAX_BUCKETS))
    return (int)cudaErrorInvalidValue;
  if (window > 0 && (!causal || bias != nullptr || table != nullptr))
    return (int)cudaErrorInvalidValue;
  if (D == 128) return (int)launch<128>(q, k, v, out, ba, B, Sq, Skv, Hq, Hkv, scale, causal, window, st);
  if (D == 64) return (int)launch<64>(q, k, v, out, ba, B, Sq, Skv, Hq, Hkv, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success); the
// Python wrapper raises on anything else.  bias, table and ids as in
// flash_common.cuh (null when unused); window > 0 sets the sliding window
// (causal only, no bias), window <= 0 none.

// The bf16 output o; the lse too when its pointer is not null.
extern "C" int tdx_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse_out, const void* bias,
                                  const void* table, const void* ids, int buckets,
                                  int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                  float scale, int causal, int window,
                                  void* stream) {
  Outs out{static_cast<bf16*>(o), static_cast<float*>(lse_out), nullptr, nullptr,
           nullptr};
  return run(q, k, v, out, bias, table, ids, buckets, B, Sq, Skv, Hq, Hkv, D,
             scale, causal, window, stream);
}

// The (m, l) residuals: acc (B, Sq, Hq, D) f32, m and l (B, Hq, Sq) f32;
// no bias or an additive one, no window, no bucket table.
extern "C" int tdx_flash_fwd_residuals_bf16(const void* q, const void* k,
                                            const void* v, void* acc, void* m,
                                            void* l, const void* bias, int B,
                                            int Sq, int Skv, int Hq, int Hkv,
                                            int D, float scale, int causal,
                                            void* stream) {
  if (acc == nullptr || m == nullptr || l == nullptr)
    return (int)cudaErrorInvalidValue;
  Outs out{nullptr, nullptr, static_cast<float*>(acc), static_cast<float*>(m),
           static_cast<float*>(l)};
  return run(q, k, v, out, bias, nullptr, nullptr, 0, B, Sq, Skv, Hq, Hkv, D,
             scale, causal, 0, stream);
}
