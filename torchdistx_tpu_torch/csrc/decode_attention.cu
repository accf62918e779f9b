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
// memory rate.  The kernel reads each visible row exactly once, prunes by
// depth (only rows up to the slot's deepest query row are streamed) and
// folds GQA: the n_rep = Hq / Hkv query heads of one kv head are computed
// together, so no K/V is repeated.  int8 halves the bytes; the scale adds
// 4 / D.
//
// Slab and pages share one body: the only difference is where key row j of
// slot b lives.  A greedy paged engine therefore gives the slab engine's
// streams bit for bit.
//
// One kernel serves one token per slot (decode, S = 1) and the speculative
// verify (S tokens per slot): decode_split_kernel, then
// decode_combine_kernel.  Row r of a (slot, kv head) is token r / n_rep of
// query head h * n_rep + r % n_rep and sees keys j <= pos + min(r / n_rep,
// S - 1); the deepest visible row is last = min(pos + S - 1, max_len - 1).
// The design:
//   - the key range is split over blocks, grid (splits, Hkv, B): split i
//     holds keys [i * split, (i + 1) * split), boundaries that depend on
//     the key index alone (never on the layout or on max_len), so slab and
//     pages split alike; a block whose range starts past `last` exits at
//     once.  At the llama3_8b serving geometry (8 slots, 8 kv heads) a
//     2048-deep slot gives 8 splits of 256 keys: up to 512 blocks for 132
//     SMs, where (slot, kv head) alone would give 64;
//   - K/V tiles of 64 rows are staged as bf16 through a 2-stage cp.async
//     pipeline, 16-byte chunks addressed by key row (the page indirection
//     is per row), so a tile's loads are in flight while the previous one
//     is multiplied; an int8 tile is copied raw with its scales, and each
//     thread dequantizes the chunks it copied into one bf16 tile as q x
//     scale (exact: an int8 value times a power-of-two scale is a bf16);
//   - both products run on the tensor cores, mma.sync m16n8k16 bf16 with
//     f32 accumulation: the S * n_rep rows are padded to m-tiles of 16 (a
//     decode step's 4 rows at llama3_8b to one m-tile, the verify's 20 to
//     two), and warp WN m + d owns m-tile m and share d of WN of the output
//     columns: it scores its 16 rows against the tile's 64 keys (the
//     shares' warps compute the same scores), keeps the rows' online
//     softmax in registers (exp2 units), and feeds P, rounded to bf16 as
//     the TPU kernel's default-precision product rounds it, to P V straight
//     from the score fragments as the A operand.  WN is 2 for the verify;
//     one token's single m-tile would leave a block of two warps, so there
//     each warp owns 32 columns (WN 4 at D 128);
//   - each split writes its rows' raw f32 accumulator and (m, l) to f32
//     scratch that the wrapper allocates; the combine kernel merges a
//     slot's splits in split order (no atomics), so two launches give the
//     same bits.
// Masked keys take the TPU kernel's -1e30 in the max and 0 in P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using tdx_hopper::exp2_ftz;
using tdx_hopper::pack_bf16;
using tdx_hopper::smem_u32;

constexpr float NEG2 = -1e30f * 1.4426950408889634f;  // the TPU kernels' -1e30, in log2 units
constexpr int SMEM_DEFAULT = 48 * 1024;
// warps across the output columns of one m-tile (see the header): two for
// the verify; one token's warps own 32 columns each (4 at D 128, 2 at D 64)
constexpr int WN_BLOCK = 2;
constexpr int COLS_ONE = 32;

// ---------------------------------------------------------------------------
// the split kernel and the combine
// ---------------------------------------------------------------------------

constexpr int TK = 64;       // key rows of a tile
constexpr int KSTAGES = 2;   // tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

// 16 bytes (4 for a scale) from global to shared memory, asynchronously;
// zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving a row address
// of matrix l / 8; .trans delivers each transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of the split kernel: the query rows, the bf16 K/V tiles,
// for int8 the raw tiles and their scales per stage, then the slot's
// page-table entries for the split's keys.
template <int D, int MT, bool QUANT>
struct BlockSmem {
  static constexpr int LDK = D + 8;  // bf16 row stride: conflict-free ldmatrix
  static constexpr int ROWS = 16 * MT;
  static constexpr int TILE = TK * LDK * 2;         // bytes of one bf16 K or V tile
  static constexpr int NBUF = QUANT ? 1 : KSTAGES;  // int8 converts into one
  static constexpr int RAW = TK * D;                // bytes of one int8 K or V tile
  static constexpr int NCH = RAW / 16;              // its 16-byte chunks
  static constexpr int q_off = 0;
  static constexpr int kv_off = q_off + ROWS * LDK * 2;
  static constexpr int raw_off = kv_off + NBUF * 2 * TILE;
  static constexpr int sc_off = raw_off + (QUANT ? KSTAGES * 2 * RAW : 0);
  static constexpr int tab_off = sc_off + (QUANT ? KSTAGES * 2 * NCH * 4 : 0);
  static size_t bytes(int ntab) { return (size_t)tab_off + (size_t)ntab * 4; }
};

template <int D, int MT, int WN, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(MT * WN * 32)
decode_split_kernel(const bf16* __restrict__ q, const void* __restrict__ ck,
                          const void* __restrict__ cv, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ pos,
                          const int* __restrict__ tables, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int max_len, int S, int Hq, int Hkv,
                          int ps, int pp, int split, float scale_log2) {
  using L = BlockSmem<D, MT, QUANT>;
  constexpr int NT = MT * WN * 32;
  constexpr int LDK = L::LDK;
  constexpr int NO = D / (8 * WN);  // 8-column n-tiles of a warp's share of the output
  static_assert(NO % 2 == 0, "P V loads 16 columns at a time");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q_off);
  int* tab_s = reinterpret_cast<int*>(smem + L::tab_off);

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_rep = Hq / Hkv;
  const int R = S * n_rep;
  const int p = min(max(pos[b], 0), max_len - 1);
  const int last = min(p + S - 1, max_len - 1);
  const int k_begin = sp * split;
  if (k_begin > last) return;
  const int k_end = min(k_begin + split, last + 1);
  const int ntiles = (k_end - k_begin + TK - 1) / TK;
  const int page0 = k_begin / ps;
  if (PAGED)
    for (int i = tid; i <= (k_end - 1) / ps - page0; i += NT)
      tab_s[i] = tables[(long long)b * pp + page0 + i];
  // query row r: token r / n_rep of head h * n_rep + r % n_rep; zeros past R
  for (int i = tid; i < L::ROWS * (D / 8); i += NT) {
    const int r = i / (D / 8);
    const int c = i % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < R)
      val = *reinterpret_cast<const uint4*>(
          q + (((long long)b * S + r / n_rep) * Hq + h * n_rep + r % n_rep) * D + c * 8);
    *reinterpret_cast<uint4*>(q_s + r * LDK + c * 8) = val;
  }
  __syncthreads();  // the table entries, before the first loads

  // the index of key row j in the data: the slab row, or through the table
  // entries staged from page page0 on
  auto row_of = [&](int j) -> long long {
    if (PAGED) return (long long)tab_s[j / ps - page0] * ps + j % ps;
    return (long long)b * max_len + j;
  };

  // tile t of the split into stage st: bf16 rows straight into their tile,
  // int8 rows and their scales raw (zeros past k_end)
  auto load_tile = [&](int t, int st) {
    const int j0 = k_begin + t * TK;
    if constexpr (!QUANT) {
      constexpr int CPR = D / 8;
      bf16* kd = reinterpret_cast<bf16*>(smem + L::kv_off + st * 2 * L::TILE);
      bf16* vd = kd + TK * LDK;
      for (int i = tid; i < TK * CPR; i += NT) {
        const int jj = i / CPR;
        const int c = i % CPR;
        const int j = j0 + jj;
        const bool ok = j < k_end;
        const long long row = ok ? row_of(j) : 0;
        const long long off = (row * Hkv + h) * D + c * 8;
        cp_async16(kd + jj * LDK + c * 8, static_cast<const bf16*>(ck) + (ok ? off : 0), ok);
        cp_async16(vd + jj * LDK + c * 8, static_cast<const bf16*>(cv) + (ok ? off : 0), ok);
      }
    } else {
      constexpr int CPR = D / 16;
      int8_t* kr = reinterpret_cast<int8_t*>(smem + L::raw_off + st * 2 * L::RAW);
      int8_t* vr = kr + L::RAW;
      float* ksc = reinterpret_cast<float*>(smem + L::sc_off) + st * 2 * L::NCH;
      float* vsc = ksc + L::NCH;
      for (int i = tid; i < L::NCH; i += NT) {
        const int j = j0 + i / CPR;
        const bool ok = j < k_end;
        const long long row = ok ? row_of(j) : 0;
        const long long off = (row * Hkv + h) * D + (i % CPR) * 16;
        cp_async16(kr + i * 16, static_cast<const int8_t*>(ck) + (ok ? off : 0), ok);
        cp_async16(vr + i * 16, static_cast<const int8_t*>(cv) + (ok ? off : 0), ok);
        cp_async4(ksc + i, ks + (ok ? row * Hkv + h : 0), ok);
        cp_async4(vsc + i, vs + (ok ? row * Hkv + h : 0), ok);
      }
    }
  };

  // int8: this thread's own chunks of stage st, dequantized into the bf16 tile
  auto convert = [&](int st) {
    constexpr int CPR = D / 16;
    const int8_t* kr = reinterpret_cast<const int8_t*>(smem + L::raw_off + st * 2 * L::RAW);
    const float* ksc = reinterpret_cast<const float*>(smem + L::sc_off) + st * 2 * L::NCH;
    bf16* kd = reinterpret_cast<bf16*>(smem + L::kv_off);
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      for (int i = tid; i < L::NCH; i += NT) {
        const int4 raw = *reinterpret_cast<const int4*>(kr + kv * L::RAW + i * 16);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw);
        const float s = ksc[kv * L::NCH + i];
        uint32_t out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          out[e] = pack_bf16(static_cast<float>(v8[2 * e]) * s,
                             static_cast<float>(v8[2 * e + 1]) * s);
        uint4* dst = reinterpret_cast<uint4*>(kd + kv * TK * LDK + (i / CPR) * LDK +
                                              (i % CPR) * 16);
        dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
        dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < KSTAGES; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }

  // warp WN mi + dh: rows 16 mi.. of the block, output columns dh * D / WN..
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int mi = warp / WN;
  const int dh = warp % WN;
  const int g = lane / 4;         // the thread's rows: 16 mi + g and + 8
  const int cq = 2 * (lane % 4);  // its columns in each 8-column n-tile
  uint32_t qa[D / 16][4];         // the m-tile's Q fragments, every k-step
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qa[kk], q_s + (mi * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LDK + kk * 16 +
                        8 * (lane / 16));
  int lim[2];  // the last key each row sees
#pragma unroll
  for (int j = 0; j < 2; ++j) lim[j] = min(p + min((mi * 16 + g + 8 * j) / n_rep, S - 1), last);
  float m[2] = {NEG2, NEG2};
  float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad at the end
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<KSTAGES - 1>();
    if constexpr (QUANT) convert(t % KSTAGES);
    __syncthreads();  // tile t in shared memory for every warp
    const bf16* kt = reinterpret_cast<const bf16*>(
        smem + L::kv_off + (QUANT ? 0 : (t % KSTAGES) * 2 * L::TILE));
    const bf16* vt = kt + TK * LDK;

    // scores of the m-tile against the tile's 64 keys
    float s[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, kt + (np * 16 + lane % 8 + 8 * (lane / 16)) * LDK + kk * 16 +
                        8 * ((lane / 8) % 2));
        mma_bf16(s[2 * np], qa[kk], bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bb[2], bb[3]);
      }
    }

    // online softmax in log2 units: the rows' new max over the quad, P
    const int j0 = k_begin + t * TK + cq;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e / 2;
        const float x = j0 + 8 * n + (e % 2) <= lim[j] ? s[n][e] * scale_log2 : NEG2;
        s[n][e] = x;
        mx[j] = fmaxf(mx[j], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      corr[j] = exp2_ftz(m[j] - mx[j]);
      m[j] = mx[j];
      l[j] *= corr[j];
    }
    uint32_t pa[TK / 16][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok0 = j0 + 8 * n <= lim[j];
        const bool ok1 = j0 + 8 * n + 1 <= lim[j];
        const float p0 = ok0 ? exp2_ftz(s[n][2 * j] - mx[j]) : 0.f;
        const float p1 = ok1 ? exp2_ftz(s[n][2 * j + 1] - mx[j]) : 0.f;
        l[j] += p0 + p1;
        pa[n / 2][(n % 2) * 2 + j] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V over this warp's share of the columns
#pragma unroll
    for (int kt2 = 0; kt2 < TK / 16; ++kt2) {
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vt + (kt2 * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LDK + dh * (D / WN) +
                          np * 16 + 8 * (lane / 16));
        mma_bf16(acc[2 * np], pa[kt2], bb[0], bb[1]);
        mma_bf16(acc[2 * np + 1], pa[kt2], bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with the tile's buffers
    if (t + KSTAGES < ntiles) load_tile(t + KSTAGES, t % KSTAGES);
    cp_async_commit();
  }

  // the split's raw accumulator and (m, l) of its real rows
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  const long long base = ((long long)(b * Hkv + h) * gridDim.x + sp) * R;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = mi * 16 + g + 8 * j;
    if (r >= R) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(part_acc + (base + r) * D + dh * (D / WN) + 8 * n + cq) =
          make_float2(acc[n][2 * j], acc[n][2 * j + 1]);
    if (dh == 0 && lane % 4 == 0)
      *reinterpret_cast<float2*>(part_ml + (base + r) * 2) = make_float2(m[j], l[j]);
  }
}

// out = the splits of one (slot, kv head, row) merged in split order: grid
// (R, Hkv, B), one thread a column
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                            const float* __restrict__ part_ml,
                                            const int* __restrict__ pos, bf16* __restrict__ o,
                                            int max_len, int S, int Hq, int Hkv, int D,
                                            int split, int nsplit) {
  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = threadIdx.x;
  const int n_rep = Hq / Hkv;
  const int R = S * n_rep;
  const int p = min(max(pos[b], 0), max_len - 1);
  const int n = min(p + S - 1, max_len - 1) / split + 1;  // the splits that ran
  const long long base = (long long)(b * Hkv + h) * nsplit * R + r;
  float M = NEG2;
  for (int i = 0; i < n; ++i) M = fmaxf(M, part_ml[(base + (long long)i * R) * 2]);
  float lsum = 0.f, out = 0.f;
  for (int i = 0; i < n; ++i) {
    const long long row = base + (long long)i * R;
    const float w = exp2f(part_ml[row * 2] - M);
    lsum += part_ml[row * 2 + 1] * w;
    out += part_acc[row * D + c] * w;
  }
  o[(((long long)b * S + r / n_rep) * Hq + h * n_rep + r % n_rep) * D + c] =
      __float2bfloat16(out / fmaxf(lsum, 1e-30f));
}

// ---------------------------------------------------------------------------
// launch and dispatch
// ---------------------------------------------------------------------------

struct Args {
  const void* q; const void* ck; const void* cv; const void* ks; const void* vs;
  const void* pos; const void* tables; void* o; float* part;
  int B, S, max_len, Hq, Hkv, D, ps, pp, split, nsplit;
  float scale;
  cudaStream_t stream;
};

// above 48 KB a block's (dynamic) shared memory needs the opt-in
template <typename K>
cudaError_t allow_smem(K kernel, size_t dyn) {
  if (dyn <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dyn);
}

template <int D, int MT, int WN, bool PAGED, bool QUANT>
cudaError_t launch(const Args& a) {
  using L = BlockSmem<D, MT, QUANT>;
  auto kernel = decode_split_kernel<D, MT, WN, PAGED, QUANT>;
  const size_t dyn = L::bytes(PAGED ? a.split / a.ps + 2 : 0);
  cudaError_t err = allow_smem(kernel, dyn);
  if (err != cudaSuccess) return err;
  const int R = a.S * (a.Hq / a.Hkv);
  float* part_ml = a.part + (long long)a.B * a.Hkv * a.nsplit * R * D;
  kernel<<<dim3(a.nsplit, a.Hkv, a.B), MT * WN * 32, dyn, a.stream>>>(
      static_cast<const bf16*>(a.q), a.ck, a.cv, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.tables), a.part, part_ml, a.max_len, a.S, a.Hq, a.Hkv, a.ps,
      a.pp, a.split, a.scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<dim3(R, a.Hkv, a.B), D, 0, a.stream>>>(
      a.part, part_ml, static_cast<const int*>(a.pos), static_cast<bf16*>(a.o), a.max_len,
      a.S, a.Hq, a.Hkv, D, a.split, a.nsplit);
  return cudaGetLastError();
}

template <int D, int WN, bool PAGED, bool QUANT>
cudaError_t dispatch_rows(const Args& a) {
  switch ((a.S * (a.Hq / a.Hkv) + 15) / 16) {
    case 1: return launch<D, 1, WN, PAGED, QUANT>(a);
    case 2: return launch<D, 2, WN, PAGED, QUANT>(a);
    case 3: return launch<D, 3, WN, PAGED, QUANT>(a);
    case 4: return launch<D, 4, WN, PAGED, QUANT>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, bool PAGED, bool QUANT>
cudaError_t dispatch(const Args& a) {
  // the splits cover every key and are whole tiles
  if (a.part == nullptr || a.split < TK || a.split % TK != 0 ||
      (long long)a.nsplit * a.split < a.max_len)
    return cudaErrorInvalidValue;
  if (a.S == 1) return dispatch_rows<D, D / COLS_ONE, PAGED, QUANT>(a);
  return dispatch_rows<D, WN_BLOCK, PAGED, QUANT>(a);
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
// int32; o (B, S, Hq, D) bf16; S * Hq / Hkv <= 64.  `split` keys a split (a
// multiple of 64), nsplit splits (nsplit * split >= max_len), and part, f32
// scratch of B * Hkv * nsplit * S * Hq / Hkv * (D + 2) floats.  Returns
// cudaGetLastError() after the launches (0 on success); the Python wrapper
// raises on anything else.
extern "C" int tdx_decode_attention(const void* q, const void* ck,
                                    const void* cv, const void* ks,
                                    const void* vs, const void* pos,
                                    const void* tables, void* o, void* part, int B, int S,
                                    int max_len, int Hq, int Hkv, int D,
                                    int ps, int pp, int paged, int quant, int split,
                                    int nsplit, float scale, void* stream) {
  if (B < 1 || S < 1 || max_len < 1 || Hkv < 1 || Hq % Hkv != 0 || ps < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, ck, cv, ks, vs, pos, tables, o, static_cast<float*>(part), B, S, max_len,
               Hq, Hkv, D, ps, pp, split, nsplit, scale, static_cast<cudaStream_t>(stream)};
  if (D == 128) return (int)dispatch_layout<128>(a, paged != 0, quant != 0);
  if (D == 64) return (int)dispatch_layout<64>(a, paged != 0, quant != 0);
  return (int)cudaErrorInvalidValue;
}
