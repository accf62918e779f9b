// Causal flash-attention backward for Hopper (sm_90a): two kernels, bf16 in
// and out, fp32 recompute and accumulation.
//
// Replaces the Pallas kernels torchdistx_tpu/ops/flash_attention.py
// _bwd_dkv_kernel (K/V-stationary: dK, dV) and _bwd_dq_kernel
// (Q-stationary: dQ), launched by _flash_backward_core, in their causal /
// no-bias / no-window variant: the training path of the Llama models.
//
// Both recompute the probabilities from the forward's saved row
// log-sum-exp, p = exp(q.k * scale - lse), and take delta = rowsum(dO * O)
// in-kernel from the O rows as the TPU kernels do (FlashAttention-2):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dK = dS^T Q,  dQ = dS K.
//
// What bounds them on an H100: operations.  At the llama_1b training shape
// (B 2, S 2048, 16 heads, D 128) the least work is five products over the
// 2.1M causal pairs of each head (1e11 flops against ~134 MB of inputs and
// outputs), far right of the card's ridge point.  The design therefore
// keeps S, P, dP and dS out of device memory: each block holds one 64-row
// tile stationary, streams the other operand's 64-row tiles through shared
// memory, and runs every product on the tensor cores through warp-level
// WMMA 16x16x16 bf16 fragments with fp32 accumulators.  The accumulators
// that only ever grow (dK and dV, or dQ) stay in registers for the whole
// loop: eight warps, each owning 16 rows by half the head dimension.  The
// JAX design recomputes Q.K^T and dO.V^T in both kernels; so does this one.
// It is the simple first version: no TMA, no wgmma, one block per SM.
//
// GQA: a dK/dV block owns one KV head and loops over the n_rep query heads
// of its group itself, so the group sum happens in its registers and no f32
// partials per query head reach device memory.
//
// Layout: q, o, dO, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D); lse
// (B, Hq, S) f32; all contiguous (the JAX package's layout).  Sq == Skv,
// causal, end-aligned.  The ragged last tile is masked here: zero-filled
// rows, probabilities of masked pairs set to 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 64;  // rows of every tile (query and key tiles alike)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

template <int D>
struct Layout {
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
  static constexpr size_t bytes = dl_off + BT * 4;
  // the epilogue stages one accumulator over S and dP
  static_assert(size_t(BT) * LDO * 4 <= p_off - s_off, "staging too small");
};

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long gstride, int valid) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < BT * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * gstride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// lse of the tile's rows into shared memory (0 for rows past the end).
__device__ __forceinline__ void load_lse(float* dst, const float* src, int valid) {
  for (int i = threadIdx.x; i < BT; i += NTHREADS) dst[i] = i < valid ? src[i] : 0.f;
}

// delta = rowsum(dO * O) for the tile's rows: four threads a row, O read
// from device memory with 16-byte loads, dO from the tile in shared memory.
template <int D>
__device__ __forceinline__ void tile_delta(float* delta, const bf16* dOs,
                                           const bf16* obase, long long gstride,
                                           int valid) {
  using L = Layout<D>;
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
  using L = Layout<D>;
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

// P and dS of one 64x64 tile (rows q0.., columns k0..), causal-masked.
template <int D>
__device__ __forceinline__ void ds_tile(const float* Ss, const float* dPs, bf16* Ps,
                                        bf16* dSs, const float* lse,
                                        const float* delta, int q0, int k0, int S,
                                        float scale) {
  using L = Layout<D>;
  for (int i = threadIdx.x; i < BT * BT; i += NTHREADS) {
    const int r = i / BT, c = i % BT;
    const int qi = q0 + r, kj = k0 + c;
    const bool vis = qi < S && kj <= qi;
    const float p = vis ? expf(Ss[r * L::LDS + c] * scale - lse[r]) : 0.f;
    const float ds = p * (dPs[r * L::LDS + c] - delta[r]) * scale;
    Ps[r * L::LDP + c] = __float2bfloat16(p);
    dSs[r * L::LDP + c] = __float2bfloat16(ds);
  }
}

// acc (this warp's 16 rows x D/2 columns) += A^T B, A 64x64 bf16 (LDP),
// B 64 x D bf16 (LDH): dV += P^T dO and dK += dS^T Q.
template <int D>
__device__ __forceinline__ void acc_atb(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const bf16* A,
    const bf16* B, int warp) {
  using L = Layout<D>;
  const int rm = (warp % 4) * 16;
  const int cn = (warp / 4) * (D / 2);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
    wmma::load_matrix_sync(fa, A + kk * 16 * L::LDP + rm, L::LDP);
#pragma unroll
    for (int f = 0; f < L::NF; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, B + kk * 16 * L::LDH + cn + f * 16, L::LDH);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
}

// acc += A B, A 64x64 bf16 (LDP), B 64 x D bf16 (LDH): dQ += dS K.
template <int D>
__device__ __forceinline__ void acc_ab(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const bf16* A,
    const bf16* B, int warp) {
  using L = Layout<D>;
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

// Write this block's 64 x D accumulator (spread over the warps' fragments)
// as bf16 rows of a (B, S, H, D) tensor, through fp32 staging in `stage`.
template <int D>
__device__ __forceinline__ void store_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, float* stage,
    bf16* gbase, long long gstride, int valid, int warp) {
  using L = Layout<D>;
  const int rm = (warp % 4) * 16;
  const int cn = (warp / 4) * (D / 2);
  __syncthreads();
#pragma unroll
  for (int f = 0; f < L::NF; ++f)
    wmma::store_matrix_sync(stage + rm * L::LDO + cn + f * 16, acc[f], L::LDO,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BT * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (r < valid) gbase[r * gstride + c] = __float2bfloat16(stage[r * L::LDO + c]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Hq,
                     int Hkv, float scale) {
  using L = Layout<D>;
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

  const int k0 = blockIdx.x * BT;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int n_rep = Hq / Hkv;
  const int warp = threadIdx.x / 32;
  const long long qstride = (long long)Hq * D;
  const long long kstride = (long long)Hkv * D;
  const int kvalid = min(BT, S - k0);

  const long long koff = ((long long)b * S + k0) * kstride + (long long)hk * D;
  load_tile<D>(Ks, L::LDH, k + koff, kstride, kvalid);
  load_tile<D>(Vs, L::LDH, v + koff, kstride, kvalid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_k[L::NF], acc_v[L::NF];
#pragma unroll
  for (int f = 0; f < L::NF; ++f) {
    wmma::fill_fragment(acc_k[f], 0.f);
    wmma::fill_fragment(acc_v[f], 0.f);
  }

  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    // query rows i see key j iff j <= i: tiles from the diagonal to the end
    for (int q0 = k0; q0 < S; q0 += BT) {
      const int qvalid = min(BT, S - q0);
      const long long qoff = ((long long)b * S + q0) * qstride + (long long)h * D;
      __syncthreads();  // the previous tile is fully consumed
      load_tile<D>(Qs, L::LDH, q + qoff, qstride, qvalid);
      load_tile<D>(dOs, L::LDH, dout + qoff, qstride, qvalid);
      load_lse(lse_s, lse + ((long long)b * Hq + h) * S + q0, qvalid);
      __syncthreads();
      tile_delta<D>(delta_s, dOs, o + qoff, qstride, qvalid);
      gemm_abt<D>(Ss, Qs, Ks, warp);
      gemm_abt<D>(dPs, dOs, Vs, warp);
      __syncthreads();
      ds_tile<D>(Ss, dPs, Ps, dSs, lse_s, delta_s, q0, k0, S, scale);
      __syncthreads();
      acc_atb<D>(acc_v, Ps, dOs, warp);
      acc_atb<D>(acc_k, dSs, Qs, warp);
    }
  }

  store_acc<D>(acc_k, Ss, dk + koff, kstride, kvalid, warp);
  store_acc<D>(acc_v, Ss, dv + koff, kstride, kvalid, warp);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    bf16* __restrict__ dq, int S, int Hq, int Hkv, float scale) {
  using L = Layout<D>;
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

  // key tiles up to the diagonal, as the forward walks them
  const int kv_end = min(S, q0 + BT);
  for (int k0 = 0; k0 < kv_end; k0 += BT) {
    const int kvalid = min(BT, S - k0);
    const long long koff = ((long long)b * S + k0) * kstride + (long long)hk * D;
    __syncthreads();  // the previous tile is fully consumed
    load_tile<D>(Ks, L::LDH, k + koff, kstride, kvalid);
    load_tile<D>(Vs, L::LDH, v + koff, kstride, kvalid);
    __syncthreads();
    gemm_abt<D>(Ss, Qs, Ks, warp);
    gemm_abt<D>(dPs, dOs, Vs, warp);
    __syncthreads();
    ds_tile<D>(Ss, dPs, Ps, dSs, lse_s, delta_s, q0, k0, S, scale);
    __syncthreads();
    acc_ab<D>(acc_q, dSs, Ks, warp);
  }

  store_acc<D>(acc_q, Ss, dq + qoff, qstride, qvalid, warp);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dk, void* dv,
                       int B, int S, int Hq, int Hkv, float scale,
                       cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BT - 1) / BT, B * Hkv);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, Hq, Hkv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, void* dq, int B, int S,
                      int Hq, int Hkv, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BT - 1) / BT, B * Hq);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), S, Hq, Hkv,
      scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int Hq, int Hkv) {
  return B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0;
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success); the
// Python wrappers raise on anything else.
extern "C" int tdx_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout,
                                      const void* lse, void* dk, void* dv, int B,
                                      int S, int Hq, int Hkv, int D, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (bad_shape(B, S, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  if (D == 128) return (int)launch_dkv<128>(q, k, v, o, dout, l, dk, dv, B, S, Hq, Hkv, scale, st);
  if (D == 64) return (int)launch_dkv<64>(q, k, v, o, dout, l, dk, dv, B, S, Hq, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int tdx_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout,
                                     const void* lse, void* dq, int B, int S,
                                     int Hq, int Hkv, int D, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (bad_shape(B, S, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  if (D == 128) return (int)launch_dq<128>(q, k, v, o, dout, l, dq, B, S, Hq, Hkv, scale, st);
  if (D == 64) return (int)launch_dq<64>(q, k, v, o, dout, l, dq, B, S, Hq, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}
