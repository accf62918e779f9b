// Gradient of the flash-attention bucket table for Hopper (sm_90a): bf16
// in, fp32 recompute and accumulation.
//
// Replaces the Pallas kernel torchdistx_tpu/ops/flash_attention.py
// _bwd_dtable_kernel (launched by _flash_dtable): the training path of T5
// with the in-kernel bucket bias, whose relative-position table is shared
// across the batch (and, per stack, across layers).  The bias enters the
// logits unscaled, so its gradient is the logit-space one,
//   dlogits = p * (dP - delta),  p = exp(q.k * scale + bias - lse),
//   dP = dO V^T,  delta = rowsum(dO * O),
// summed over the batch and over every (row, col) whose distance falls in
// one bucket: dtable, (Hq, buckets).  (The additive bias's gradient, dbias,
// is flash_bwd.cu's Hopper kernel.)
//
// What bounds it on an H100: bytes.  Each pair of each head and batch row
// costs the two recomputed products Q.K^T and dO.V^T, 4 * D flops, against
// the inputs read once.  The design keeps every intermediate out of device
// memory: a block owns one (64 x 64, head) tile of the logit gradient,
// loops over the batch inside, recomputes both products with WMMA
// 16x16x16 bf16 fragments (fp32 accumulators, shared-memory tiles), keeps
// its 16 dlogits per thread in registers across the batch, folds the tile
// into its 127 distances and those into bucket partials in shared memory,
// then adds one f32 atomic per (block, bucket) into an (Hq, buckets) f32
// buffer the wrapper zeroed (and casts to the table's dtype): the order of
// those atomics is not fixed.  Causal tiles above the diagonal do no work.
//
// Grid (ceil(S / 64), ceil(S / 64), Hq); 8 warps.  Layout as flash_bwd.cu;
// Sq == Skv == S.

#include "flash_common.cuh"

namespace {

using namespace tdx_flash;

constexpr int PER_THREAD = BT * BT / BWD_THREADS;  // 16 elements

// Thread t's j-th element of the tile: row t / 64 + 4 j, column t % 64.
__device__ __forceinline__ int tile_row(int j) { return threadIdx.x / BT + 4 * j; }
__device__ __forceinline__ int tile_col() { return threadIdx.x % BT; }

// Shared memory of the block and the batch loop: acc[j] += dlogits of the
// thread's elements, summed over the batch.  `bias` holds the elements'
// bias (read once before the loop).
template <int D>
__device__ __forceinline__ void accumulate(
    float (&acc)[PER_THREAD], const float (&bias)[PER_THREAD],
    unsigned char* smem, const bf16* q, const bf16* k, const bf16* v,
    const bf16* o, const bf16* dout, const float* lse, int B, int S, int Hq,
    int Hkv, int h, int q0, int k0, int causal, float scale) {
  using L = BwdLayout<D>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::dl_off);

  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const long long qstride = (long long)Hq * D;
  const long long kstride = (long long)Hkv * D;
  const int qvalid = min(BT, S - q0);
  const int kvalid = min(BT, S - k0);
  const int c = tile_col();

#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) acc[j] = 0.f;

  for (int b = 0; b < B; ++b) {
    const long long qoff = ((long long)b * S + q0) * qstride + (long long)h * D;
    const long long koff = ((long long)b * S + k0) * kstride + (long long)hk * D;
    __syncthreads();  // the previous batch row's tiles are fully consumed
    load_tile<D>(Qs, L::LDH, q + qoff, qstride, qvalid);
    load_tile<D>(dOs, L::LDH, dout + qoff, qstride, qvalid);
    load_tile<D>(Ks, L::LDH, k + koff, kstride, kvalid);
    load_tile<D>(Vs, L::LDH, v + koff, kstride, kvalid);
    load_lse(lse_s, lse + ((long long)b * Hq + h) * S + q0, qvalid);
    __syncthreads();
    tile_delta<D>(delta_s, dOs, o + qoff, qstride, qvalid);
    gemm_abt<D>(Ss, Qs, Ks, warp);
    gemm_abt<D>(dPs, dOs, Vs, warp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int r = tile_row(j);
      if (visible(q0 + r, k0 + c, S, S, causal, 0)) {
        const float p = expf(Ss[r * L::LDS + c] * scale + bias[j] - lse_s[r]);
        acc[j] += p * (dPs[r * L::LDS + c] - delta_s[r]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dtable_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ dtable, BiasArgs ba, int B, int S,
                        int Hq, int Hkv, int causal, float scale) {
  using L = BwdLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* dist_bias = reinterpret_cast<float*>(smem + L::diag_off);
  float* dist_sum = reinterpret_cast<float*>(smem + L::dsum_off);
  float* part = reinterpret_cast<float*>(smem + L::part_off);
  const int q0 = blockIdx.x * BT;
  const int k0 = blockIdx.y * BT;
  const int h = blockIdx.z;
  const int c = tile_col();
  if (causal && k0 > q0 + BT - 1) return;  // above the diagonal: nothing to add

  stage_diag(dist_bias, ba, h, q0, k0, S, threadIdx.x, BWD_THREADS);
  for (int i = threadIdx.x; i < 128; i += BWD_THREADS) dist_sum[i] = 0.f;
  for (int i = threadIdx.x; i < ba.buckets; i += BWD_THREADS) part[i] = 0.f;
  __syncthreads();
  float bias[PER_THREAD], acc[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    bias[j] = bias_at(ba, dist_bias, h, S, S, q0 + tile_row(j), k0 + c, tile_row(j), c);
  accumulate<D>(acc, bias, smem, q, k, v, o, dout, lse, B, S, Hq, Hkv, h, q0, k0,
                causal, scale);

  // the tile's dlogits by distance (a warp's 32 lanes hit 32 distances),
  // the distances by bucket, then one global atomic per bucket
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (acc[j] != 0.f) atomicAdd(&dist_sum[c - tile_row(j) + 63], acc[j]);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < NDIAG; d += BWD_THREADS) {
    const int rel = k0 - q0 + d - 63;
    if (rel > -S && rel < S && dist_sum[d] != 0.f)
      atomicAdd(&part[ba.ids[rel + S - 1]], dist_sum[d]);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ba.buckets; t += BWD_THREADS) {
    if (part[t] != 0.f) atomicAdd(&dtable[h * ba.buckets + t], part[t]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* dtable, const BiasArgs& ba,
                   int B, int S, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = BwdLayout<D>::bytes;
  dim3 grid((S + BT - 1) / BT, (S + BT - 1) / BT, Hq);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dtable_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dtable_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, dtable, ba, B, S, Hq,
      Hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the Python
// wrapper raises on anything else.  Inputs as flash_bwd.cu's (the window
// must be off: it excludes a bias); it needs the table and ids and adds
// into (Hq, buckets) f32.
extern "C" int tdx_flash_bwd_dtable_bf16(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout,
                                         const void* lse, void* dtable,
                                         const void* bias, const void* table,
                                         const void* ids, int buckets, int B, int S,
                                         int Hq, int Hkv, int D, int causal,
                                         int window, float scale, void* stream) {
  if (table == nullptr || ids == nullptr || bias != nullptr || buckets < 1 ||
      buckets > MAX_BUCKETS || window > 0 || bad_shape(B, S, Hq, Hkv) ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const BiasArgs ba = bias_args(nullptr, table, ids, buckets);
  const float* l = static_cast<const float*>(lse);
  float* out = static_cast<float*>(dtable);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, dout, l, out, ba, B, S, Hq, Hkv, causal, scale, st);
  return (int)launch<64>(q, k, v, o, dout, l, out, ba, B, S, Hq, Hkv, causal, scale, st);
}
