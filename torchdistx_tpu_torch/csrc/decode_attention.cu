// One-token-per-slot decode attention over the serving slab, for Hopper
// (sm_90a), bf16 in and out, fp32 softmax state and accumulation.
//
// Replaces the Pallas kernel torchdistx_tpu/ops/decode_attention.py:
// _decode_kernel (launched by decode_attention), unquantized variant.
//
// What bounds it on an H100: bytes.  Each slot's query meets every visible
// K/V row once, 2 flops per byte of cache read, far left of the card's
// ridge point; the time is the visible K/V rows over the memory rate.  The
// design reads each visible row exactly once, straight out of the native
// (B, max_len, Hkv, D) slab with 16-byte loads (one row of one kv head is
// D * 2 contiguous bytes, read by D / 8 neighbouring lanes), prunes by depth
// (only rows 0..positions[b] are streamed), and folds GQA: the
// n_rep = Hq / Hkv query heads of one kv head are computed together, so no
// K/V is repeated.
//
// Grid (Hkv, B): one block per (slot, kv head).  At the llama3_8b serving
// geometry that is B * Hkv = 64 blocks for 132 SMs, so the card is not
// filled; splitting each slot's key range over several blocks with a second
// combine pass (flash-decoding) is the later design.  Inside a block, the
// key rows are dealt round-robin to groups of D / 8 lanes; each group keeps
// its own online-softmax state per query row in registers, and the groups
// are merged through shared memory at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's _NEG_INF

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int D, int NREP, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ck,
              const bf16* __restrict__ cv, const int* __restrict__ pos,
              bf16* __restrict__ o, int max_len, int Hq, int Hkv,
              float scale) {
  constexpr int LPK = D / 8;            // lanes per key row
  constexpr int KPW = 32 / LPK;         // key rows per warp per step
  constexpr int NGROUPS = NWARPS * KPW; // key rows per block per step
  __shared__ float m_s[NGROUPS][NREP];
  __shared__ float l_s[NGROUPS][NREP];
  __shared__ float acc_s[NGROUPS][NREP][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPK;
  const int grp = warp * KPW + lane / LPK;
  const int p = min(max(pos[b], 0), max_len - 1);

  float qf[NREP][8];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + ((long long)b * Hq + h * NREP + r) * D + sub * 8);
    unpack8(raw, qf[r]);
  }
  float m[NREP], l[NREP], acc[NREP][8];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  const long long rstride = (long long)Hkv * D;
  const bf16* kb = ck + (long long)b * max_len * rstride + (long long)h * D + sub * 8;
  const bf16* vb = cv + (long long)b * max_len * rstride + (long long)h * D + sub * 8;

  // j0 is warp-uniform, so every lane reaches the shuffles below
  for (int j0 = warp * KPW; j0 <= p; j0 += NGROUPS) {
    const int j = j0 + lane / LPK;
    const bool valid = j <= p;
    uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
    uint4 vraw = make_uint4(0u, 0u, 0u, 0u);
    if (valid) {
      kraw = *reinterpret_cast<const uint4*>(kb + j * rstride);
      vraw = *reinterpret_cast<const uint4*>(vb + j * rstride);
    }
    float kf[8], vf[8];
    unpack8(kraw, kf);
    unpack8(vraw, vf);
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s += qf[r][e] * kf[e];
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      if (valid) {
        const float m_new = fmaxf(m[r], s);
        const float corr = expf(m[r] - m_new);
        const float pe = expf(s - m_new);
        l[r] = l[r] * corr + pe;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = acc[r][e] * corr + pe * vf[e];
        m[r] = m_new;
      }
    }
  }

  // merge the groups' online-softmax states
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (sub == 0) {
      m_s[grp][r] = m[r];
      l_s[grp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc_s[grp][r][sub * 8 + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NREP * D; i += NWARPS * 32) {
    const int r = i / D;
    const int c = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int g = 0; g < NGROUPS; ++g) M = fmaxf(M, m_s[g][r]);
    float Lsum = 0.f, O = 0.f;
#pragma unroll
    for (int g = 0; g < NGROUPS; ++g) {
      const float w = expf(m_s[g][r] - M);
      Lsum += l_s[g][r] * w;
      O += acc_s[g][r][c] * w;
    }
    o[((long long)b * Hq + h * NREP + r) * D + c] =
        __float2bfloat16(O / fmaxf(Lsum, 1e-30f));
  }
}

template <int D, int NREP>
cudaError_t launch(const void* q, const void* ck, const void* cv,
                   const void* pos, void* o, int B, int max_len, int Hq,
                   int Hkv, float scale, cudaStream_t stream) {
  // shared memory: NWARPS * NREP KB; keep it at 32 KB
  constexpr int NWARPS = NREP <= 4 ? 8 : 4;
  dim3 grid(Hkv, B);
  decode_kernel<D, NREP, NWARPS><<<grid, NWARPS * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ck),
      static_cast<const bf16*>(cv), static_cast<const int*>(pos),
      static_cast<bf16*>(o), max_len, Hq, Hkv, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_rep(int n_rep, const void* q, const void* ck,
                         const void* cv, const void* pos, void* o, int B,
                         int max_len, int Hq, int Hkv, float scale,
                         cudaStream_t st) {
  switch (n_rep) {
    case 1: return launch<D, 1>(q, ck, cv, pos, o, B, max_len, Hq, Hkv, scale, st);
    case 2: return launch<D, 2>(q, ck, cv, pos, o, B, max_len, Hq, Hkv, scale, st);
    case 4: return launch<D, 4>(q, ck, cv, pos, o, B, max_len, Hq, Hkv, scale, st);
    case 8: return launch<D, 8>(q, ck, cv, pos, o, B, max_len, Hq, Hkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the Python
// wrapper raises on anything else.
extern "C" int tdx_decode_attention_bf16(const void* q, const void* ck,
                                         const void* cv, const void* pos,
                                         void* o, int B, int max_len, int Hq,
                                         int Hkv, int D, float scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || max_len < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int n_rep = Hq / Hkv;
  if (D == 128) return (int)dispatch_rep<128>(n_rep, q, ck, cv, pos, o, B, max_len, Hq, Hkv, scale, st);
  if (D == 64) return (int)dispatch_rep<64>(n_rep, q, ck, cv, pos, o, B, max_len, Hq, Hkv, scale, st);
  return (int)cudaErrorInvalidValue;
}
