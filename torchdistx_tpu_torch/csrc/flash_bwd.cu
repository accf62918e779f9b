// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in, bf16
// or f32 out, fp32 recompute and accumulation.
//
// Replaces the Pallas kernels torchdistx_tpu/ops/flash_attention.py
// _bwd_dkv_kernel (K/V-stationary: dK, dV) and _bwd_dq_kernel
// (Q-stationary: dQ), launched by _flash_backward_core, in every variant:
// causal (the Llama and GPT-2 training paths, T5's decoder) or not (T5's
// encoder), with no bias, an additive bias or T5's bucket table
// (flash_common.cuh), or with the sliding window (Mistral; causal, no
// bias).  The gradient of the bias itself is flash_bias_bwd.cu's.
//
// Both recompute the probabilities from the forward's saved row
// log-sum-exp, p = exp(q.k * scale + bias - lse) (the lse includes the
// bias), and take delta = rowsum(dO * O) in-kernel from the O rows as the
// TPU kernels do (FlashAttention-2):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dK = dS^T Q,  dQ = dS K.
//
// What bounds them on an H100: operations.  At the llama_1b training shape
// (B 2, S 2048, 16 heads, D 128) the least work is five products over the
// 2.1M causal pairs of each head (1e11 flops against ~134 MB of inputs and
// outputs), far right of the card's ridge point; a bias adds 2 bytes a
// pair, still far right.  The design therefore
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
// Output type: bf16, the gradients of one attention call; or f32 (the JAX
// kernels' dq_dtype / part_dtype = float32), which ring attention's
// backward asks for: it adds one block's partial gradients per hop into
// f32 accumulators that travel the ring, and a bf16 rounding per hop would
// add up.  The accumulators are f32 in either case; only the store differs.
//
// Layout: q, o, dO, dq (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D); lse
// (B, Hq, S) f32; all contiguous (the JAX package's layout).  Sq == Skv.
// Causal tiles above the diagonal are skipped; without the causal mask
// every tile is visited.  With a window, tiles wholly below the band are
// skipped too: dQ starts its key loop at the first tile the band reaches
// (band_kv_begin), dK/dV stops its query loop after the last query tile
// that sees the key tile (band_q_end), so the work grows with S * window.
// The ragged last tile is masked here: zero-filled rows, probabilities of
// masked pairs set to 0.

#include "flash_common.cuh"

namespace {

using namespace tdx_flash;

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

// acc (this warp's 16 rows x D/2 columns) += A^T B, A 64x64 bf16 (LDP),
// B 64 x D bf16 (LDH): dV += P^T dO and dK += dS^T Q.
template <int D>
__device__ __forceinline__ void acc_atb(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const bf16* A,
    const bf16* B, int warp) {
  using L = BwdLayout<D>;
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
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     OutT* __restrict__ dk, OutT* __restrict__ dv, BiasArgs ba,
                     int S, int Hq, int Hkv, int causal, int window, float scale) {
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
    // causal: query rows i see key j iff j <= i, so the tiles from the
    // diagonal on; with a window, up to the last row the band reaches
    const int q_end = band_q_end(k0, 0, window, BT, S);
    for (int q0 = causal ? k0 : 0; q0 < q_end; q0 += BT) {
      const int qvalid = min(BT, S - q0);
      const long long qoff = ((long long)b * S + q0) * qstride + (long long)h * D;
      __syncthreads();  // the previous tile is fully consumed
      load_tile<D>(Qs, L::LDH, q + qoff, qstride, qvalid);
      load_tile<D>(dOs, L::LDH, dout + qoff, qstride, qvalid);
      load_lse(lse_s, lse + ((long long)b * Hq + h) * S + q0, qvalid);
      stage_diag(dist_bias, ba, h, q0, k0, S, threadIdx.x, BWD_THREADS);
      __syncthreads();
      tile_delta<D>(delta_s, dOs, o + qoff, qstride, qvalid);
      gemm_abt<D>(Ss, Qs, Ks, warp);
      gemm_abt<D>(dPs, dOs, Vs, warp);
      __syncthreads();
      ds_tile<D>(Ss, dPs, Ps, dSs, lse_s, delta_s, ba, dist_bias, h, q0, k0, S,
                 causal, window, scale);
      __syncthreads();
      acc_atb<D>(acc_v, Ps, dOs, warp);
      acc_atb<D>(acc_k, dSs, Qs, warp);
    }
  }

  store_acc<D, OutT>(acc_k, Ss, dk + koff, kstride, kvalid, warp);
  store_acc<D, OutT>(acc_v, Ss, dv + koff, kstride, kvalid, warp);
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
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dk, void* dv,
                       const BiasArgs& ba, int B, int S, int Hq, int Hkv,
                       int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = BwdLayout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BT - 1) / BT, B * Hkv);
  flash_bwd_dkv_kernel<D, OutT><<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<OutT*>(dk),
      static_cast<OutT*>(dv), ba, S, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
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
int dkv(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* dk, void* dv, const void* bias,
        const void* table, const void* ids, int buckets, int B, int S, int Hq,
        int Hkv, int D, int causal, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const BiasArgs ba = bias_args(bias, table, ids, buckets);
  if (bad_shape(B, S, Hq, Hkv) || bad_args(bias, table, ids, buckets, causal, window))
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return (int)launch_dkv<128, OutT>(q, k, v, o, dout, l, dk, dv, ba, B, S, Hq, Hkv, causal, window, scale, st);
  if (D == 64)
    return (int)launch_dkv<64, OutT>(q, k, v, o, dout, l, dk, dv, ba, B, S, Hq, Hkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
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

}  // namespace

// Each returns cudaGetLastError() after the launch (0 on success); the
// Python wrappers raise on anything else.  bias, table and ids as in
// flash_common.cuh (null when unused); window > 0 sets the sliding window
// (causal only, no bias), window <= 0 none.  The _bf16 functions write
// bf16 gradients, the _f32 ones f32 gradients; the inputs are bf16 in both.
#define TDX_DKV_ARGS                                                          \
  const void *q, const void *k, const void *v, const void *o,                 \
      const void *dout, const void *lse, void *dk, void *dv, const void *bias, \
      const void *table, const void *ids, int buckets, int B, int S, int Hq,  \
      int Hkv, int D, int causal, int window, float scale, void *stream
#define TDX_DQ_ARGS                                                           \
  const void *q, const void *k, const void *v, const void *o,                 \
      const void *dout, const void *lse, void *dqo, const void *bias,         \
      const void *table, const void *ids, int buckets, int B, int S, int Hq,  \
      int Hkv, int D, int causal, int window, float scale, void *stream

extern "C" int tdx_flash_bwd_dkv_bf16(TDX_DKV_ARGS) {
  return dkv<bf16>(q, k, v, o, dout, lse, dk, dv, bias, table, ids, buckets, B, S,
                   Hq, Hkv, D, causal, window, scale, stream);
}

extern "C" int tdx_flash_bwd_dkv_f32(TDX_DKV_ARGS) {
  return dkv<float>(q, k, v, o, dout, lse, dk, dv, bias, table, ids, buckets, B,
                    S, Hq, Hkv, D, causal, window, scale, stream);
}

extern "C" int tdx_flash_bwd_dq_bf16(TDX_DQ_ARGS) {
  return dq<bf16>(q, k, v, o, dout, lse, dqo, bias, table, ids, buckets, B, S, Hq,
                  Hkv, D, causal, window, scale, stream);
}

extern "C" int tdx_flash_bwd_dq_f32(TDX_DQ_ARGS) {
  return dq<float>(q, k, v, o, dout, lse, dqo, bias, table, ids, buckets, B, S,
                   Hq, Hkv, D, causal, window, scale, stream);
}
