// Fused LM-head cross-entropy for Hopper (sm_90a): the forward and the
// backward, bf16 operands, fp32 logits, softmax statistics and
// accumulation.
//
// Replaces the Pallas kernels of torchdistx_tpu/ops/fused_ce.py:
//   fused_ce_fwd  <- _fwd_kernel: per token, the online max / sum-exp over
//                    the vocab and the label logit; emits loss_i = lse_i -
//                    z_{y_i} and lse_i (f32);
//   fused_ce_bwd  <- _dx_kernel and _dw_kernel: from (X, W, lse) the
//                    probabilities dP = softmax - onehot, then dX = dP W
//                    and dW = dP^T X, in one backward that computes the
//                    logits once for both.
// The mean over the N true tokens (1/N) and the cotangent g are applied in
// the backward's epilogues, which read g from device memory (no host sync).
//
// What bounds them on an H100: operations.  The logits are an N x V x D
// product (2NVD flops) against inputs read once (X and W, ~140 MB at the
// llama_1b and GPT-2 shapes), far right of the card's ridge point.
//
// Forward: the (N, V) logits never reach device memory.  It is a fourth
// pass, STATS, of the kernel whose other three are the backward's
// (fused_ce_kernel): the LOGITS pass's mainloop (X and W rows K-major,
// 128 x 256 logits tiles in registers, below) with an
// epilogue that folds each tile into per-token running (max, sum-exp) and
// the label logit in registers.  A block takes 128 tokens and a range of
// FWD_TILES consecutive 256-column vocab tiles (2048 columns); its producer
// streams the k-blocks of every tile of the range through the ring without
// a break, so the next tile's loads overlap this tile's epilogue.  Each
// thread holds two token rows x 64 columns of a tile and reduces them over
// the four threads of its quad with two shuffles.  Partial (max, sum-exp,
// z_y) per vocab range go to a small workspace, and a second kernel merges
// them per token in range order (an exact log-sum-exp merge, the same bits
// on every launch).  The forward's logits are the same wgmma products, in
// the same k order and tiling, as the backward's LOGITS pass, so the
// backward's exp(z - lse) is formed from the lse of the same numbers.
//
// Backward: 6NVD flops in three passes over each chunk of the vocab, where
// the TPU kernels pay 8NVD (each of dX and dW recomputes the logits).  The
// TPU kernels keep a (256, D) f32 dX or a (512, D) f32 dW accumulator in
// VMEM for a whole pass over the other dimension; an SM has 227 KB of
// shared memory (a 128 x 2048 f32 tile is 1 MB), so here the probabilities
// of one vocab chunk of Vc columns are written once to a bf16 (N, Vc) dP
// panel in device memory (at most 256 MiB: 4 chunks at GPT-2-large's N
// 8192, V 50257, one at llama_1b's N 4096, V 32000), and every output tile
// is owned by one block, which sums its whole reduction in registers.  For
// each chunk, in order:
//   1. LOGITS: dP[t, c] = exp(X[t] . W[v0 + c] - lse[t]) - (v0 + c ==
//      y[t]) (K = D), stored as bf16, unscaled, in [-1, 1]: the rounding
//      the TPU kernel's default-precision products apply; columns past V
//      and rows past N are 0;
//   2. DW: dW[v0 + m] = dP^T X (K = N, complete in one pass), times g / N
//      in f32, stored as bf16 once; dP^T is read MN-major from shared
//      memory, as X is;
//   3. DX: dX += dP W[chunk] (K = Vc, W MN-major): the block adds the
//      chunk's sum to its tile of an f32 (N, D) workspace in chunk order;
//      the last chunk's epilogue applies g / N and stores bf16.
// No atomics, and every sum is taken in a fixed order, so dX and dW are the
// same bits on every launch.  Each pass is one kernel: 128 x 256 output
// tiles, two consumer warpgroups of 64 rows each running wgmma m64n256k16
// with the accumulator in registers (128 f32 a thread; 240 registers after
// setmaxnreg), and a producer thread feeding 64-deep k-blocks by TMA
// (128-byte swizzle, ragged edges zero-filled) through a 4-stage ring of
// full / empty mbarriers (48 KB a stage): a 128 x 256 tile's stage feeds
// twice the products of a 128 x 128 tile's 32 KB, so each flop reads a
// quarter fewer bytes from L2.
//
// Padding: nothing is padded in memory.  Rows past N and vocab columns past
// V are zero-filled in the staged tiles and masked out of the softmax and
// of dP; GPT-2's V = 50257 needs no copy of W.  Requirements: x (N, D), w
// (V, D) bf16 contiguous, 16-byte aligned, D % 8 == 0; labels (N,) int32;
// lse (N,) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// ---- the forward's combine ------------------------------------------------------

// One thread per token: merge the vocab ranges' (max, sum-exp, z_y).
__global__ void fused_ce_combine_kernel(const float* __restrict__ m_part,
                                        const float* __restrict__ l_part,
                                        const float* __restrict__ zy_part,
                                        float* __restrict__ loss, float* __restrict__ lse,
                                        int N, int n_split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float m = -1e30f;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, m_part[(long long)s * N + i]);
  float l = 0.f, zy = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long o = (long long)s * N + i;
    l += l_part[o] * expf(m_part[o] - m);
    zy += zy_part[o];
  }
  const float out = m + logf(fmaxf(l, 1e-30f));
  lse[i] = out;
  loss[i] = out - zy;
}

// ---- the wgmma passes: the forward's STATS, the backward's LOGITS, DW, DX ----------

namespace hop {

using namespace tdx_hopper;

constexpr int TM = 128;  // output rows of a block: 64 per consumer warpgroup
constexpr int TN = 256;  // output columns of a block
constexpr int TK = 64;   // depth of a k-block: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int THREADS = 384;           // consumer warpgroups 0, 1; producer 2
constexpr int PANEL = 64 * TK * 2;     // bytes of a 64 x 64 swizzled panel
constexpr int A_BYTES = TM * TK * 2;   // a stage's A tile: two panels
constexpr int STAGE_BYTES = A_BYTES + TN * TK * 2;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // 197,696
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FWD_TILES = 8;  // 256-column vocab tiles of a forward block
constexpr float NEG = -1e30f;  // a logit out of the max and the sum: exp2 of it is 0

enum Pass { LOGITS = 0, DW = 1, DX = 2, STATS = 3 };

// The map of a row-major (rows, cols) bf16 matrix, boxes of 64 columns x
// box_rows rows, 128-byte swizzled; what lies outside reads as zeros.
bool map_2d(CUtensorMap* map, const void* ptr, long long rows, long long cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the box at (column c0, row c1) of a 2-D map
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// d (64 x 256, f32) += A (64 x 16) B (16 x 256), both from shared memory;
// TA, TB: A, B MN-major (1) or K-major (0)
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

struct Params {
  const float* lse;
  const int* labels;
  const float* g;
  bf16* out;   // LOGITS: the panel; DW: the chunk's rows of dW; DX: dX
  float* ws;   // DX: the f32 (N, D) sum over the chunks so far; STATS: the
               // (3, n_split, N) partials (max, sum-exp, label logit)
  int N, D;
  int v0, cw;  // the chunk's first vocab row and its width (<= ld); STATS: 0, V
  int ld;      // the panel's row stride
  int nk;      // k-blocks of a tile
  int first, last;
  float inv_n;
};

// The quad's (threads 4r .. 4r + 3 of a warp, which hold one row's 64
// columns of a tile between them) max or sum of v.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// LOGITS and STATS: rows are tokens, columns the vocab, grid (row tiles,
// column tiles or ranges): the blocks in flight share W's tiles and read X,
// which L2 holds (21 MB at GPT-2-large's N 8192), where llama_1b's W (131
// MB) would be read from memory once per row tile.  A STATS block walks the
// FWD_TILES tiles of its range, the ring running on across tiles.  DW: rows
// the chunk's vocab, columns D; DX: rows tokens, columns D; grid (column
// tiles, row tiles).
template <int PASS>
__global__ void __launch_bounds__(THREADS, 1)
fused_ce_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  constexpr bool ROWS_X = PASS == LOGITS || PASS == STATS;  // token rows, vocab columns
  const int m0 = (ROWS_X ? blockIdx.x : blockIdx.y) * TM;
  // the first column of the block's first tile, and its tiles
  const int n_begin = (ROWS_X ? blockIdx.y : blockIdx.x) * TN * (PASS == STATS ? FWD_TILES : 1);
  const int ntile = PASS == STATS ? min(FWD_TILES, (p.cw - n_begin + TN - 1) / TN) : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full, across tiles --------------
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      for (int t = 0, it = 0; t < ntile; ++t) {
        const int n0 = n_begin + t * TN;
        for (int kb = 0; kb < p.nk; ++kb, ++it) {
          const int st = it % STAGES;
          const int k0 = kb * TK;
          unsigned char* a = smem + st * STAGE_BYTES;
          unsigned char* b = a + A_BYTES;
          bar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
          bar_expect_tx(full + st, STAGE_BYTES);
          if (ROWS_X) {
            tma_load_2d(a, &ta, full + st, k0, m0);          // X rows m0.., K-major
            tma_load_2d(b, &tb, full + st, k0, p.v0 + n0);   // W rows v0 + n0.., K-major
          } else if (PASS == DW) {
            for (int h = 0; h < 2; ++h)  // dP, MN-major
              tma_load_2d(a + h * PANEL, &ta, full + st, m0 + 64 * h, k0);
            for (int h = 0; h < TN / 64; ++h)  // X, MN-major
              tma_load_2d(b + h * PANEL, &tb, full + st, n0 + 64 * h, k0);
          } else {
            tma_load_2d(a, &ta, full + st, k0, m0);  // dP rows m0.., K-major
            for (int h = 0; h < TN / 64; ++h)        // W rows v0 + k0.., MN-major
              tma_load_2d(b + h * PANEL, &tb, full + st, n0 + 64 * h, p.v0 + k0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 output rows each ------------------------------------------
  reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // the thread's rows: r0 and r0 + 8
  const int cq = 2 * (tid % 4);                      // its columns in each 8-column chunk
  // STATS: the running (max, sum-exp, label logit) of the thread's two rows
  // over the range; sum-exp relative to the max, the label logit held by the
  // one thread of the quad whose column it is (0 in the others)
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f}, zy[2] = {0.f, 0.f};
  int label[2] = {-1, -1};
  if constexpr (PASS == STATS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + 64 * wg + r0 + 8 * h;
      if (t < p.N) label[h] = p.labels[t];
    }
  }
  float acc[TN / 2];

  for (int t = 0, it = 0; t < ntile; ++t) {
    const int n0 = n_begin + t * TN;
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < p.nk; ++kb, ++it) {
      const int st = it % STAGES;
      const unsigned char* a = smem + st * STAGE_BYTES;
      const unsigned char* b = a + A_BYTES;
      // K-major: the warpgroup's 64 rows (A) or all 256 (B), a 16-deep step
      // +32 bytes; MN-major: the warpgroup's 64-column panel (A) or all four
      // (B), a 16-deep step +2048 bytes
      const uint64_t da = PASS == DW ? desc_sw128(a + wg * PANEL, PANEL, 1024)
                                     : desc_sw128(a + wg * 64 * 128, 16, 1024);
      const uint64_t db = ROWS_X ? desc_sw128(b, 16, 1024) : desc_sw128(b, PANEL, 1024);
      constexpr uint32_t STEP_A = PASS == DW ? 2048 : 32;
      constexpr uint32_t STEP_B = ROWS_X ? 32 : 2048;
      bar_wait(full + st, (it / STAGES) & 1);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        mma<PASS == DW, !ROWS_X>(acc, desc_add(da, kk * STEP_A), desc_add(db, kk * STEP_B));
      wg_commit();
      wg_wait<1>();
      fence_regs(acc);
      // the previous k-block's products are done: its stage is free
      if (kb > 0) bar_arrive(empty + (it - 1) % STAGES);
    }
    wg_wait<0>();
    fence_regs(acc);
    // the tile's last k-block is done too: the producer may run on into the
    // next tile while this epilogue runs
    bar_arrive(empty + (it - 1) % STAGES);

    // acc[4 j + 2 h + e]: row r0 + 8 h, column 8 j + cq + e of the warpgroup's tile
    if constexpr (PASS == STATS) {
      // columns past V read zero-filled W rows, which give logit 0: out of
      // the max and the sum
      const int lim = p.cw - n0;
      if (lim < TN) {
#pragma unroll
        for (int i = 0; i < TN / 2; ++i)
          if (8 * (i / 4) + cq + (i % 2) >= lim) acc[i] = NEG;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
          mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
        mx = quad_max(mx);  // finite: column 0 of the tile lies inside V
        const float mx2 = mx * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          sum += exp2_ftz(fmaf(acc[4 * j + 2 * h], LOG2E, -mx2));
          sum += exp2_ftz(fmaf(acc[4 * j + 2 * h + 1], LOG2E, -mx2));
        }
        sum = quad_sum(sum);
        const float m_new = fmaxf(m_run[h], mx);
        l_run[h] = l_run[h] * exp2_ftz((m_run[h] - m_new) * LOG2E) +
                   sum * exp2_ftz((mx - m_new) * LOG2E);
        m_run[h] = m_new;
        // the label logit: matched inside V only
        const int lab = label[h] - n0;
        if (lab >= 0 && lab < min(lim, TN)) {
#pragma unroll
          for (int j = 0; j < TN / 8; ++j) {
            const int c = 8 * j + cq;
            if (c == lab) zy[h] += acc[4 * j + 2 * h];
            if (c + 1 == lab) zy[h] += acc[4 * j + 2 * h + 1];
          }
        }
      }
    } else if constexpr (PASS == LOGITS) {
      const int lim = p.cw - n0;  // the tile's columns inside the chunk (and V)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = m0 + 64 * wg + r0 + 8 * h;
        if (t >= p.N) continue;
        const float lse2 = p.lse[t] * LOG2E;
        const int lab = p.labels[t] - p.v0 - n0;
        bf16* row = p.out + (long long)t * p.ld + n0;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int c = 8 * j + cq;
          float e0 = c < lim ? exp2_ftz(fmaf(acc[4 * j + 2 * h], LOG2E, -lse2)) : 0.f;
          float e1 = c + 1 < lim ? exp2_ftz(fmaf(acc[4 * j + 2 * h + 1], LOG2E, -lse2)) : 0.f;
          if (c == lab && c < lim) e0 -= 1.f;
          if (c + 1 == lab && c + 1 < lim) e1 -= 1.f;
          *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(e0, e1);
        }
      }
    } else {
      const float gs = p.g[0] * p.inv_n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 64 * wg + r0 + 8 * h;  // DW: the chunk's vocab row; DX: a token
        if (r >= (PASS == DW ? p.cw : p.N)) continue;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int d = n0 + 8 * j + cq;
          if (d >= p.D) continue;
          float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
          const long long off = (long long)r * p.D + d;
          if (PASS == DX && !p.first) {
            const float2 s = *reinterpret_cast<const float2*>(p.ws + off);
            a0 += s.x;
            a1 += s.y;
          }
          if (PASS == DW || p.last)
            *reinterpret_cast<uint32_t*>(p.out + off) = pack_bf16(a0 * gs, a1 * gs);
          else
            *reinterpret_cast<float2*>(p.ws + off) = make_float2(a0, a1);
        }
      }
    }
  }

  if constexpr (PASS == STATS) {
    // the range's partials of the thread's rows, from the quad's first thread
    const long long ns = gridDim.y;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float z = quad_sum(zy[h]);
      const int t = m0 + 64 * wg + r0 + 8 * h;
      if (cq == 0 && t < p.N) {
        const long long o = (long long)blockIdx.y * p.N + t;
        p.ws[o] = m_run[h];
        p.ws[ns * p.N + o] = l_run[h];
        p.ws[2 * ns * p.N + o] = z;
      }
    }
  }
}

template <int PASS>
cudaError_t launch_pass(const CUtensorMap& ta, const CUtensorMap& tb, const Params& p,
                        dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_ce_kernel<PASS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  fused_ce_kernel<PASS><<<grid, THREADS, SMEM, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

bool bad_shape(int N, int V, int D) { return N < 1 || V < 1 || D < 8 || D % 8 != 0; }

int tiles(int n, int t) { return (n + t - 1) / t; }

}  // namespace hop

}  // namespace

// Columns of the vocab per forward block: the workspace holds
// ceil(V / tdx_fused_ce_fwd_cols()) partials per token.
extern "C" int tdx_fused_ce_fwd_cols() { return hop::FWD_TILES * hop::TN; }

// Each returns cudaGetLastError() after its launches (0 on success); the
// Python wrappers raise on anything else.  part: 3 x n_split x N f32
// workspace (max, sum-exp, label logit per vocab range).
extern "C" int tdx_fused_ce_fwd_bf16(const void* x, const void* w, const void* labels,
                                     void* part, void* loss, void* lse, int N, int V, int D,
                                     void* stream) {
  using namespace hop;
  if (bad_shape(N, V, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap xa, wb;
  if (!map_2d(&xa, x, N, D, TM) || !map_2d(&wb, w, V, D, TN))
    return (int)cudaErrorInvalidValue;
  const int ns = tiles(V, FWD_TILES * TN);
  float* m_part = static_cast<float*>(part);
  Params p{};  // lse, g, out: unused by STATS
  p.labels = static_cast<const int*>(labels);
  p.ws = m_part;  // the (3, ns, N) partials
  p.N = N;
  p.D = D;
  p.v0 = 0;
  p.cw = V;  // the whole vocabulary is one chunk
  p.nk = tiles(D, TK);
  cudaError_t err = launch_pass<STATS>(xa, wb, p, dim3(tiles(N, TM), ns), st);
  if (err != cudaSuccess) return (int)err;
  fused_ce_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      m_part, m_part + (long long)ns * N, m_part + 2LL * ns * N, static_cast<float*>(loss),
      static_cast<float*>(lse), N, ns);
  return (int)cudaGetLastError();
}

// The backward: dx (N, D) and dw (V, D) bf16 = (softmax - onehot) W and
// its transpose times X, times g[0] / N (g: one f32 on the device).  panel:
// bf16 (N, chunk) scratch, chunk a multiple of 256; ws: f32 (N, D) scratch
// when chunk < V, else unused.
extern "C" int tdx_fused_ce_bwd_bf16(const void* x, const void* w, const void* labels,
                                     const void* lse, const void* g, void* panel, void* ws,
                                     void* dx, void* dw, int N, int V, int D, int chunk,
                                     void* stream) {
  using namespace hop;
  if (bad_shape(N, V, D) || chunk < TN || chunk % TN != 0 || (chunk < V && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap xa, wb, x64, w64, p64, p128;
  if (!map_2d(&xa, x, N, D, TM) || !map_2d(&wb, w, V, D, TN) ||
      !map_2d(&x64, x, N, D, 64) || !map_2d(&w64, w, V, D, 64) ||
      !map_2d(&p64, panel, N, chunk, 64) || !map_2d(&p128, panel, N, chunk, TM))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(lse), static_cast<const int*>(labels),
           static_cast<const float*>(g), nullptr, static_cast<float*>(ws), N, D, 0, 0, chunk,
           0, 0, 0, 1.0f / (float)N};
  for (int v0 = 0; v0 < V; v0 += chunk) {
    p.v0 = v0;
    p.cw = V - v0 < chunk ? V - v0 : chunk;
    p.first = v0 == 0;
    p.last = v0 + chunk >= V;
    p.out = static_cast<bf16*>(panel);
    p.nk = tiles(D, TK);
    cudaError_t err =
        launch_pass<LOGITS>(xa, wb, p, dim3(tiles(N, TM), tiles(p.cw, TN)), st);
    if (err == cudaSuccess) {
      p.out = static_cast<bf16*>(dw) + (long long)v0 * D;
      p.nk = tiles(N, TK);
      err = launch_pass<DW>(p64, x64, p, dim3(tiles(D, TN), tiles(p.cw, TM)), st);
    }
    if (err == cudaSuccess) {
      p.out = static_cast<bf16*>(dx);
      p.nk = tiles(p.cw, TK);
      err = launch_pass<DX>(p128, w64, p, dim3(tiles(D, TN), tiles(N, TM)), st);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
