// Slot decode attention over the serving cache, for Hopper (sm_90a): bf16
// queries and outputs, fp32 softmax state and accumulation, the cache in
// bf16 or int8 with one f32 power-of-two scale per (row, kv head), laid out
// as the contiguous slab (B, max_len, Hkv, D) or as page pools
// (num_pages, page_size, Hkv, D) read through per-slot page tables.
//
// Replaces the Pallas kernels of torchdistx_tpu/ops/decode_attention.py:
//   _decode_kernel               (decode_attention, bf16 and int8)
//   _decode_block_kernel         (decode_attention_block)
//   _paged_decode_kernel         (paged_decode_attention)
//   _paged_decode_block_kernel   (paged_decode_attention_block)
//
// What bounds them on an H100: bytes.  Each slot's query rows meet every
// visible K/V row once, a few flops per byte of cache read, far left of the
// card's ridge point; the time is the visible K/V rows (plus scales) over the
// memory rate.  Both bodies read each visible row exactly once per block,
// with 16-byte loads, prune by depth (only rows up to the slot's deepest
// query row are streamed) and fold GQA: the n_rep = Hq / Hkv query heads of
// one kv head are computed together, so no K/V is repeated.  int8 halves the
// bytes; the scale adds 4 / D.
//
// Slab and pages share each body: the only difference is where key row j of
// slot b lives (kv_row below).  A greedy paged engine therefore gives the
// slab engine's streams bit for bit.  Grid (Hkv, B): one block per
// (slot, kv head); at the llama3_8b serving geometry that is 64 blocks for
// 132 SMs, so the card is not filled (splitting the key range over blocks
// with a combine pass is the later design).
//
// One token per slot (decode_kernel): key rows are dealt round-robin to
// groups of D / 8 lanes; each group keeps its own online-softmax state and a
// D / 8-wide accumulator per query row in registers, and the groups are
// merged through shared memory at the end.
//
// S tokens per slot, the speculative verify (decode_block_kernel): the
// S * n_rep query rows (20 at llama3_8b with S = 5) would not fit that
// register layout, so the block stages 32 key rows at a time in shared
// memory as f32 (int8 dequantized on the way in: q * scale, exact for a
// power-of-two scale) and each warp owns a few query rows: a lane scores one
// key of the tile, the warp reduces the row's max and sum, and each lane
// accumulates D / 32 output columns of P.V.  Row r is token r / n_rep of
// head r % n_rep and sees keys j <= pos + min(r / n_rep, S - 1); the tiles
// stop at pos + S - 1, capped at max_len - 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernels' _NEG_INF
constexpr int SMEM_DEFAULT = 48 * 1024;

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack_int8(const int8_t* v, int n, float s,
                                            float* out) {
#pragma unroll
  for (int i = 0; i < n; ++i) out[i] = static_cast<float>(v[i]) * s;
}

// The row index of key row j of slot b in the flattened (rows, Hkv, D) data
// and (rows, Hkv) scales: b * max_len + j in the slab, through the slot's
// page-table row (staged in shared memory) in the pools.
template <bool PAGED>
__device__ __forceinline__ long long kv_row(int j, int b, int max_len,
                                            const int* table_s, int ps) {
  if (PAGED) return (long long)table_s[j / ps] * ps + (j % ps);
  return (long long)b * max_len + j;
}

// 8 consecutive elements (from element 8 * sub) of one kv head's row, as f32.
template <bool QUANT>
__device__ __forceinline__ void load8(const void* data, const float* scales,
                                      long long row, int Hkv, int h, int D,
                                      int sub, float* out) {
  const long long off = (row * Hkv + h) * D + sub * 8;
  if (QUANT) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(data) + off);
    unpack_int8(reinterpret_cast<const int8_t*>(&raw), 8,
                scales[row * Hkv + h], out);
  } else {
    unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(data) + off),
            out);
  }
}

// One 16-byte chunk (chunk c) of one kv head's row, as f32: 8 bf16 or 16 int8.
template <bool QUANT>
__device__ __forceinline__ void load_chunk(const void* data,
                                           const float* scales, long long row,
                                           int Hkv, int h, int D, int c,
                                           float* out) {
  if (QUANT) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const int8_t*>(data) + (row * Hkv + h) * D + c * 16);
    unpack_int8(reinterpret_cast<const int8_t*>(&raw), 16,
                scales[row * Hkv + h], out);
  } else {
    unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(data) +
                                            (row * Hkv + h) * D + c * 8),
            out);
  }
}

template <bool PAGED>
__device__ __forceinline__ void stage_table(int* table_s, const int* tables,
                                            int b, int pp, int n) {
  if (PAGED) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      table_s[i] = tables[(long long)b * pp + i];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// one token per slot
// ---------------------------------------------------------------------------

template <int D, int NREP, int NWARPS, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(NWARPS * 32)
decode_kernel(const bf16* __restrict__ q, const void* __restrict__ ck,
              const void* __restrict__ cv, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ pos,
              const int* __restrict__ tables, bf16* __restrict__ o,
              int max_len, int Hq, int Hkv, int ps, int pp, float scale) {
  constexpr int LPK = D / 8;            // lanes per key row
  constexpr int KPW = 32 / LPK;         // key rows per warp per step
  constexpr int NGROUPS = NWARPS * KPW; // key rows per block per step
  __shared__ float m_s[NGROUPS][NREP];
  __shared__ float l_s[NGROUPS][NREP];
  __shared__ float acc_s[NGROUPS][NREP][D];
  extern __shared__ int table_s[];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPK;
  const int grp = warp * KPW + lane / LPK;
  const int p = min(max(pos[b], 0), max_len - 1);
  stage_table<PAGED>(table_s, tables, b, pp, p / ps + 1);

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

  // j0 is warp-uniform, so every lane reaches the shuffles below
  for (int j0 = warp * KPW; j0 <= p; j0 += NGROUPS) {
    const int j = j0 + lane / LPK;
    const bool valid = j <= p;
    float kf[8], vf[8];
    if (valid) {
      const long long row = kv_row<PAGED>(j, b, max_len, table_s, ps);
      load8<QUANT>(ck, ks, row, Hkv, h, D, sub, kf);
      load8<QUANT>(cv, vs, row, Hkv, h, D, sub, vf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
    }
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

// ---------------------------------------------------------------------------
// S tokens per slot (speculative verify)
// ---------------------------------------------------------------------------

constexpr int TK = 32;          // key rows per shared-memory tile
constexpr int BLOCK_WARPS = 8;  // warps of the block kernel

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ constexpr int block_k_stride(int D) { return D + 4; }

// dynamic shared memory of the block kernel, in bytes
size_t block_smem_bytes(int R, int D, int rpw, int pp, bool paged) {
  const size_t floats = (size_t)R * D + (size_t)TK * block_k_stride(D) +
                        (size_t)TK * D + (size_t)BLOCK_WARPS * rpw * TK;
  return floats * 4 + (paged ? (size_t)pp * 4 : 0);
}

template <int D, int RPW, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(BLOCK_WARPS * 32)
decode_block_kernel(const bf16* __restrict__ q, const void* __restrict__ ck,
                    const void* __restrict__ cv, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    const int* __restrict__ tables, bf16* __restrict__ o,
                    int max_len, int S, int Hq, int Hkv, int ps, int pp,
                    float scale) {
  constexpr int KS = block_k_stride(D);  // padded K row: conflict-free float4 reads
  constexpr int CPL = D / 32;            // output columns per lane
  constexpr int EPC = QUANT ? 16 : 8;    // elements per 16-byte chunk
  constexpr int CPR = D / EPC;           // chunks per key row
  constexpr int NT = BLOCK_WARPS * 32;
  extern __shared__ float smem[];
  const int n_rep = Hq / Hkv;
  const int R = S * n_rep;
  float* q_s = smem;              // [R][D]
  float* k_s = q_s + R * D;       // [TK][KS]
  float* v_s = k_s + TK * KS;     // [TK][D]
  float* p_s = v_s + TK * D;      // [BLOCK_WARPS][RPW][TK]
  int* table_s = reinterpret_cast<int*>(p_s + BLOCK_WARPS * RPW * TK);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int p = min(max(pos[b], 0), max_len - 1);
  const int last = min(p + S - 1, max_len - 1);  // the deepest visible row
  stage_table<PAGED>(table_s, tables, b, pp, last / ps + 1);

  // query row r: token r / n_rep of query head h * n_rep + r % n_rep
  for (int i = tid; i < R * (D / 8); i += NT) {
    const int r = i / (D / 8);
    const int c = i % (D / 8);
    const int hq = h * n_rep + r % n_rep;
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(
                q + (((long long)b * S + r / n_rep) * Hq + hq) * D + c * 8),
            f);
    float4* dst = reinterpret_cast<float4*>(q_s + r * D + c * 8);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }

  // this warp's rows: warp, warp + BLOCK_WARPS, ... (clamped for the reads)
  int qrow[RPW], depth[RPW];
  float m[RPW], l[RPW], acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * BLOCK_WARPS;
    qrow[i] = min(r, R - 1);
    depth[i] = p + min(r / n_rep, S - 1);
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[i][e] = 0.f;
  }
  __syncthreads();

  for (int j0 = 0; j0 <= last; j0 += TK) {
    // stage K/V rows j0 .. j0 + TK - 1 as f32 (rows past `last` as zeros)
    for (int i = tid; i < TK * CPR; i += NT) {
      const int jj = i / CPR;
      const int c = i % CPR;
      const int j = j0 + jj;
      float kf[EPC], vf[EPC];
      if (j <= last) {
        const long long row = kv_row<PAGED>(j, b, max_len, table_s, ps);
        load_chunk<QUANT>(ck, ks, row, Hkv, h, D, c, kf);
        load_chunk<QUANT>(cv, vs, row, Hkv, h, D, c, vf);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) kf[e] = vf[e] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(k_s + jj * KS + c * EPC);
      float4* vd = reinterpret_cast<float4*>(v_s + jj * D + c * EPC);
#pragma unroll
      for (int e = 0; e < EPC / 4; ++e) {
        kd[e] = make_float4(kf[4 * e], kf[4 * e + 1], kf[4 * e + 2], kf[4 * e + 3]);
        vd[e] = make_float4(vf[4 * e], vf[4 * e + 1], vf[4 * e + 2], vf[4 * e + 3]);
      }
    }
    __syncthreads();

    // scores: lane `lane` takes key j0 + lane against every row of the warp
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const float* krow = k_s + lane * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + qrow[i] * D + d);
        s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    const int j = j0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (warp + i * BLOCK_WARPS >= R) break;  // warp-uniform
      const bool valid = j <= depth[i] && j <= last;
      const float sv = valid ? s[i] * scale : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float corr = expf(m[i] - m_new);
      const float pe = valid ? expf(sv - m_new) : 0.f;
      l[i] = l[i] * corr + warp_sum(pe);
      p_s[(warp * RPW + i) * TK + lane] = pe;
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncwarp();

    // P.V: lane `lane` owns output columns lane * CPL .. + CPL - 1
    const int nk = min(TK, last - j0 + 1);
    for (int jj = 0; jj < nk; ++jj) {
      float vv[CPL];
      const float* vrow = v_s + jj * D + lane * CPL;
      if constexpr (CPL == 4) {
        const float4 t = *reinterpret_cast<const float4*>(vrow);
        vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
      } else {
#pragma unroll
        for (int e = 0; e < CPL; ++e) vv[e] = vrow[e];
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (warp + i * BLOCK_WARPS >= R) break;
        const float pj = p_s[(warp * RPW + i) * TK + jj];
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[i][e] += pj * vv[e];
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * BLOCK_WARPS;
    if (r >= R) break;
    const int hq = h * n_rep + r % n_rep;
    bf16* dst = o + (((long long)b * S + r / n_rep) * Hq + hq) * D + lane * CPL;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < CPL; ++e) dst[e] = __float2bfloat16(acc[i][e] / den);
  }
}

// ---------------------------------------------------------------------------
// launch and dispatch
// ---------------------------------------------------------------------------

struct Args {
  const void* q; const void* ck; const void* cv; const void* ks; const void* vs;
  const void* pos; const void* tables; void* o;
  int B, S, max_len, Hq, Hkv, D, ps, pp;
  float scale;
  cudaStream_t stream;
};

// above 48 KB a block's shared memory needs the opt-in for its dynamic part
template <typename K>
cudaError_t allow_smem(K kernel, size_t stat, size_t dyn) {
  if (stat + dyn <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dyn);
}

template <int D, int NREP, bool PAGED, bool QUANT>
cudaError_t launch_one(const Args& a) {
  // static shared memory: about NWARPS * NREP KB; keep it near 32 KB
  constexpr int NWARPS = NREP <= 4 ? 8 : 4;
  constexpr size_t STAT = (size_t)NWARPS * (32 / (D / 8)) * NREP * (D + 2) * 4;
  auto kernel = decode_kernel<D, NREP, NWARPS, PAGED, QUANT>;
  const size_t dyn = PAGED ? (size_t)a.pp * 4 : 0;
  cudaError_t err = allow_smem(kernel, STAT, dyn);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.Hkv, a.B), NWARPS * 32, dyn, a.stream>>>(
      static_cast<const bf16*>(a.q), a.ck, a.cv,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.pos), static_cast<const int*>(a.tables),
      static_cast<bf16*>(a.o), a.max_len, a.Hq, a.Hkv, a.ps, a.pp, a.scale);
  return cudaGetLastError();
}

template <int D, int RPW, bool PAGED, bool QUANT>
cudaError_t launch_block(const Args& a) {
  auto kernel = decode_block_kernel<D, RPW, PAGED, QUANT>;
  const size_t dyn = block_smem_bytes(a.S * (a.Hq / a.Hkv), D, RPW, a.pp, PAGED);
  cudaError_t err = allow_smem(kernel, 0, dyn);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.Hkv, a.B), BLOCK_WARPS * 32, dyn, a.stream>>>(
      static_cast<const bf16*>(a.q), a.ck, a.cv,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.pos), static_cast<const int*>(a.tables),
      static_cast<bf16*>(a.o), a.max_len, a.S, a.Hq, a.Hkv, a.ps, a.pp, a.scale);
  return cudaGetLastError();
}

template <int D, bool PAGED, bool QUANT>
cudaError_t dispatch(const Args& a) {
  const int n_rep = a.Hq / a.Hkv;
  if (a.S == 1) {
    switch (n_rep) {
      case 1: return launch_one<D, 1, PAGED, QUANT>(a);
      case 2: return launch_one<D, 2, PAGED, QUANT>(a);
      case 4: return launch_one<D, 4, PAGED, QUANT>(a);
      case 8: return launch_one<D, 8, PAGED, QUANT>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  const int rows = a.S * n_rep;
  const int rpw = (rows + BLOCK_WARPS - 1) / BLOCK_WARPS;
  if (rpw <= 1) return launch_block<D, 1, PAGED, QUANT>(a);
  if (rpw <= 2) return launch_block<D, 2, PAGED, QUANT>(a);
  if (rpw <= 4) return launch_block<D, 4, PAGED, QUANT>(a);
  if (rpw <= 8) return launch_block<D, 8, PAGED, QUANT>(a);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t dispatch_layout(const Args& a, bool paged, bool quant) {
  if (paged) return quant ? dispatch<D, true, true>(a) : dispatch<D, true, false>(a);
  return quant ? dispatch<D, false, true>(a) : dispatch<D, false, false>(a);
}

}  // namespace

// One entry point for every variant.  q (B, S, Hq, D) bf16; ck/cv the slab
// (B, max_len, Hkv, D) or, with paged != 0, the pools (num_pages, ps, Hkv, D)
// read through tables (B, pp) int32 (max_len is then pp * ps); bf16, or int8
// with quant != 0 and f32 scales ks/vs of the data's rows x Hkv; pos (B,)
// int32; o (B, S, Hq, D) bf16.  Returns cudaGetLastError() after the launch
// (0 on success); the Python wrapper raises on anything else.
extern "C" int tdx_decode_attention(const void* q, const void* ck,
                                    const void* cv, const void* ks,
                                    const void* vs, const void* pos,
                                    const void* tables, void* o, int B, int S,
                                    int max_len, int Hq, int Hkv, int D,
                                    int ps, int pp, int paged, int quant,
                                    float scale, void* stream) {
  if (B < 1 || S < 1 || max_len < 1 || Hkv < 1 || Hq % Hkv != 0 || ps < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, ck, cv, ks, vs, pos, tables, o, B, S, max_len, Hq, Hkv, D,
               ps, pp, scale, static_cast<cudaStream_t>(stream)};
  if (D == 128) return (int)dispatch_layout<128>(a, paged != 0, quant != 0);
  if (D == 64) return (int)dispatch_layout<64>(a, paged != 0, quant != 0);
  return (int)cudaErrorInvalidValue;
}
