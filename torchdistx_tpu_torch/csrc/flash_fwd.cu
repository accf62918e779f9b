// Causal flash-attention forward for Hopper (sm_90a), bf16 in and out,
// fp32 softmax state and accumulation.
//
// Replaces the Pallas kernel torchdistx_tpu/ops/flash_attention.py:_kernel
// (launched by _flash_forward), in its causal / no-bias / no-window
// variant, plain output (the cold prefill of the serving engine) or with
// the row log-sum-exp (emit_lse: the training forward, whose lse the
// backward kernels in flash_bwd.cu consume).
//
// What bounds it on an H100: operations.  Causal prefill at S = 2048,
// D = 128 does ~2 * S^2 * D flops per head against ~4 * S * D * 2 bytes of
// input and output, hundreds of flops per byte, far right of the card's
// ridge point.  The design therefore keeps the logits out of device memory
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
// K/V tiles entirely above the diagonal are never loaded, and the ragged
// last tile of Q and of K/V is masked here (zero-filled rows, -1e30 logits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // the TPU kernel's _NEG_INF

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
  static constexpr size_t bytes = c_off + size_t(BQ) * 4;
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
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                 float scale, int causal) {
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

  // block pruning: the last key any row of this Q tile can see
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q0 + BQ + diag);
  const int n_kt = (kv_end + BK - 1) / BK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile fully consumed; Q/O/m/l init visible
    load_tile<D>(Ks, L::LDH, kbase + k0 * kstride, kstride, min(BK, Skv - k0));
    load_tile<D>(Vs, L::LDH, vbase + k0 * kstride, kstride, min(BK, Skv - k0));
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

    // online softmax, one row at a time across the warp (2 columns a lane)
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int qi = q0 + r;
      float s[2];
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int col = k0 + c;
        const bool vis = col < Skv && (!causal || col <= qi + diag);
        s[t] = vis ? Ss[r * L::LDS + c] * scale : NEG_INF;
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

  // normalise and store this warp's rows
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D;
    const int c = i % D;
    const int qi = q0 + r;
    if (qi < Sq) {
      const float val = Os[r * L::LDO + c] / fmaxf(ls[r], 1e-30f);
      o[((long long)b * Sq + qi) * qstride + (long long)h * D + c] =
          __float2bfloat16(val);
    }
  }
  if (lse != nullptr && lane < 16) {
    const int r = r0 + lane;
    const int qi = q0 + r;
    if (qi < Sq)
      lse[((long long)b * Hq + h) * Sq + qi] = ms[r] + logf(fmaxf(ls[r], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B,
                   int Sq, int Skv, int Hq, int Hkv, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Skv, Hq,
      Hkv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the Python
// wrapper raises on anything else.  A null lse is not written.
extern "C" int tdx_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse_out, int B, int Sq, int Skv,
                                  int Hq, int Hkv, int D, float scale, int causal,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (D == 128) return (int)launch<128>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, causal, st);
  if (D == 64) return (int)launch<64>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
