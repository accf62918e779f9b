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
// Forward: the (N, V) logits never reach device memory.  Every 128 x 128
// logits tile lives in shared memory only, built through warp-level WMMA
// 16x16x16 bf16 fragments with fp32 accumulators fed by a three-stage
// cp.async pipeline of 64-wide K chunks; a block takes 128 tokens and a
// range of 16 vocab tiles (2048 columns) and folds each tile into per-row
// running (max, sum-exp) and the label logit in registers.  Partial (max,
// sum-exp, z_y) per vocab range go to a small workspace, and a second
// kernel combines them per token (an exact log-sum-exp merge).  Shared
// memory: the three stages of X and W chunks (3 x 2 x 18,432 bytes) and,
// aliased once they are consumed, the f32 logits tile (128 x 132 x 4); two
// blocks per SM.
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
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// ---- the forward ---------------------------------------------------------------

constexpr int BM = 128;          // rows of a logits tile (tokens)
constexpr int BN = 128;          // columns of a logits tile (vocab entries)
constexpr int BK = 64;           // depth of one staged chunk (hidden dim)
constexpr int STAGES = 3;        // cp.async pipeline depth of the logits tiles
constexpr int LDK = BK + 8;      // bf16 row stride of a staged chunk
constexpr int LDS = BN + 4;      // f32 row stride of the logits tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int FWD_TILES = 16;    // vocab tiles per forward block

constexpr size_t CHUNK_BYTES = size_t(BM) * LDK * 2;
constexpr size_t STAGE_BYTES = 2 * CHUNK_BYTES;  // an X chunk and a W chunk
constexpr size_t REGION_BYTES = STAGES * STAGE_BYTES;
constexpr size_t FWD_SMEM = REGION_BYTES;
static_assert(size_t(BM) * LDS * 4 <= REGION_BYTES, "the logits tile exceeds the region");
static_assert(BM == BN, "one loader for both operands");

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// Stage rows [0, ROWS) x columns [k0, k0 + BK) of a row-major (*, D) bf16
// matrix whose row 0 is `src` into dst (row stride LDK); rows >= valid and
// columns >= D are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int valid, int D, int k0) {
  constexpr int CPR = BK / 8;
  // not unrolled: under the forward's two-block register cap the unrolled
  // loop's addresses spill
#pragma unroll 1
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < valid && k0 + c < D;
    // a 32-bit offset: r < 128 rows of at most 2^24 columns
    cp_async16(dst + r * LDK + c, src + (ok ? r * D + k0 + c : 0), ok);
  }
}

// The f32 logits tile S (BM x BN, row stride LDS, at `region`) = X[0:BM] .
// W[0:BN]^T over the full depth D, through a STAGES-deep cp.async pipeline
// of BK-wide chunks.  Rows of x past x_rows and of w past w_rows read as
// zeros.  On return S is complete and visible to the block.
__device__ void logits_tile(unsigned char* region, const bf16* x, int x_rows,
                            const bf16* w, int w_rows, int D) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps, each 32 x 64
  Acc acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  __syncthreads();  // the region (the previous tile's S) is free
  const int nk = (D + BK - 1) / BK;
  auto stage_a = [&](int s) { return reinterpret_cast<bf16*>(region + s * STAGE_BYTES); };
  auto stage_b = [&](int s) {
    return reinterpret_cast<bf16*>(region + s * STAGE_BYTES + CHUNK_BYTES);
  };
  // one commit group per chunk, empty past the end, so that waiting for
  // all but STAGES - 2 groups always means "chunk kt has landed"
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_chunk<BM>(stage_a(s), x, x_rows, D, s * BK);
      load_chunk<BN>(stage_b(s), w, w_rows, D, s * BK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_stages();
    __syncthreads();  // chunk kt is visible; chunk kt - 1 is consumed
    const int next = kt + STAGES - 1;
    if (next < nk) {
      load_chunk<BM>(stage_a(next % STAGES), x, x_rows, D, next * BK);
      load_chunk<BN>(stage_b(next % STAGES), w, w_rows, D, next * BK);
    }
    cp_async_commit();
    const bf16* A = stage_a(kt % STAGES);
    const bf16* B = stage_b(kt % STAGES);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], A + (wm * 32 + i * 16) * LDK + kk * 16, LDK);
      // one B fragment live at a time (fewer registers)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, B + (wn * 64 + j * 16) * LDK + kk * 16, LDK);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every stage is consumed before S overwrites them
  float* S = reinterpret_cast<float*>(region);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(S + (wm * 32 + i * 16) * LDS + wn * 64 + j * 16, acc[i][j],
                              LDS, wmma::mem_row_major);
  __syncthreads();
}


// Grid (ceil(N / BM), ceil(V / (FWD_TILES * BN))).  Two threads per token
// row, each over half the tile's columns.  Two blocks per SM (ptxas caps
// the kernel at 128 registers): more latency hidden than by one block of
// 180 registers.
__global__ void __launch_bounds__(NTHREADS, 2)
fused_ce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ m_part,
                    float* __restrict__ l_part, float* __restrict__ zy_part, int N, int V,
                    int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int rows = min(BM, N - t0);
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  const int label = r < rows ? labels[t0 + r] : -1;
  float m_run = -1e30f, l_run = 0.f, zy = 0.f;
  const int v_end = min((split + 1) * FWD_TILES * BN, V);
  for (int v0 = split * FWD_TILES * BN; v0 < v_end; v0 += BN) {
    const int cols = min(BN, V - v0);
    logits_tile(smem, x + (long long)t0 * D, rows, w + (long long)v0 * D, cols, D);
    const float* S = reinterpret_cast<const float*>(smem) + r * LDS + half * 64;
    const int c_end = min(64, cols - half * 64);  // <= 0: nothing in this half
    float mx = -1e30f;
    for (int c = 0; c < c_end; ++c) mx = fmaxf(mx, S[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    float sum = 0.f;
    for (int c = 0; c < c_end; ++c) sum += expf(S[c] - mx);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float m_new = fmaxf(m_run, mx);
    l_run = l_run * expf(m_run - m_new) + sum * expf(mx - m_new);
    m_run = m_new;
    const int lc = label - v0 - half * 64;
    if (lc >= 0 && lc < c_end) zy += S[lc];
  }
  zy += __shfl_xor_sync(0xffffffffu, zy, 1);
  if (half == 0 && r < rows) {
    const long long o = (long long)split * N + t0 + r;
    m_part[o] = m_run;
    l_part[o] = l_run;
    zy_part[o] = zy;
  }
}

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

// ---- the backward ----------------------------------------------------------------

namespace bwd {

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

enum Pass { LOGITS = 0, DW = 1, DX = 2 };

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
  float* ws;   // DX: the f32 (N, D) sum over the chunks so far
  int N, D;
  int v0, cw;  // the chunk's first vocab row and its width (<= ld)
  int ld;      // the panel's row stride
  int nk;      // k-blocks of the pass
  int first, last;
  float inv_n;
};

// LOGITS: rows are tokens, columns the chunk's vocab, grid (row tiles,
// column tiles): the blocks in flight share W's tiles and read X, which L2
// holds (21 MB at GPT-2-large's N 8192), where llama_1b's W (131 MB) would
// be read from memory once per row tile.  DW: rows the chunk's vocab,
// columns D; DX: rows tokens, columns D; grid (column tiles, row tiles).
template <int PASS>
__global__ void __launch_bounds__(THREADS, 1)
fused_ce_bwd_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int n0 = (PASS == LOGITS ? blockIdx.y : blockIdx.x) * TN;
  const int m0 = (PASS == LOGITS ? blockIdx.x : blockIdx.y) * TM;

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
    // ---- producer: one thread keeps the ring full ----------------------------
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      for (int kb = 0; kb < p.nk; ++kb) {
        const int st = kb % STAGES;
        const int k0 = kb * TK;
        unsigned char* a = smem + st * STAGE_BYTES;
        unsigned char* b = a + A_BYTES;
        bar_wait(empty + st, ((kb / STAGES) & 1) ^ 1);
        bar_expect_tx(full + st, STAGE_BYTES);
        if (PASS == LOGITS) {
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
    return;
  }

  // ---- consumers: 64 output rows each ------------------------------------------
  reg_alloc<240>();
  const int tid = threadIdx.x % 128;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // the thread's rows: r0 and r0 + 8
  const int cq = 2 * (tid % 4);                      // its columns in each 8-column chunk
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < p.nk; ++kb) {
    const int st = kb % STAGES;
    const unsigned char* a = smem + st * STAGE_BYTES;
    const unsigned char* b = a + A_BYTES;
    // K-major: the warpgroup's 64 rows (A) or all 256 (B), a 16-deep step
    // +32 bytes; MN-major: the warpgroup's 64-column panel (A) or all four
    // (B), a 16-deep step +2048 bytes
    const uint64_t da = PASS == DW ? desc_sw128(a + wg * PANEL, PANEL, 1024)
                                   : desc_sw128(a + wg * 64 * 128, 16, 1024);
    const uint64_t db = PASS == LOGITS ? desc_sw128(b, 16, 1024) : desc_sw128(b, PANEL, 1024);
    constexpr uint32_t STEP_A = PASS == DW ? 2048 : 32;
    constexpr uint32_t STEP_B = PASS == LOGITS ? 32 : 2048;
    bar_wait(full + st, (kb / STAGES) & 1);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      mma<PASS == DW, PASS != LOGITS>(acc, desc_add(da, kk * STEP_A), desc_add(db, kk * STEP_B));
    wg_commit();
    wg_wait<1>();
    fence_regs(acc);
    // the previous k-block's products are done: its stage is free
    if (kb > 0) bar_arrive(empty + (kb - 1) % STAGES);
  }
  wg_wait<0>();
  fence_regs(acc);

  // acc[4 j + 2 h + e]: row r0 + 8 h, column 8 j + cq + e of the warpgroup's tile
  if constexpr (PASS == LOGITS) {
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

template <int PASS>
cudaError_t launch_pass(const CUtensorMap& ta, const CUtensorMap& tb, const Params& p,
                        dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_ce_bwd_kernel<PASS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  fused_ce_bwd_kernel<PASS><<<grid, THREADS, SMEM, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

}  // namespace bwd

bool bad_shape(int N, int V, int D) { return N < 1 || V < 1 || D < 8 || D % 8 != 0; }

int n_split(int V) { return (V + FWD_TILES * BN - 1) / (FWD_TILES * BN); }

}  // namespace

// Columns of the vocab per forward block: the workspace holds
// ceil(V / tdx_fused_ce_fwd_cols()) partials per token.
extern "C" int tdx_fused_ce_fwd_cols() { return FWD_TILES * BN; }

// Each returns cudaGetLastError() after its launches (0 on success); the
// Python wrappers raise on anything else.  part: 3 x n_split x N f32
// workspace (max, sum-exp, label logit per vocab range).
extern "C" int tdx_fused_ce_fwd_bf16(const void* x, const void* w, const void* labels,
                                     void* part, void* loss, void* lse, int N, int V, int D,
                                     void* stream) {
  if (bad_shape(N, V, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int ns = n_split(V);
  float* m_part = static_cast<float*>(part);
  float* l_part = m_part + (long long)ns * N;
  float* zy_part = l_part + (long long)ns * N;
  dim3 grid((N + BM - 1) / BM, ns);
  fused_ce_fwd_kernel<<<grid, NTHREADS, FWD_SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(labels),
      m_part, l_part, zy_part, N, V, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      m_part, l_part, zy_part, static_cast<float*>(loss), static_cast<float*>(lse), N, ns);
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
  using namespace bwd;
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
  auto tiles = [](int n, int t) { return (n + t - 1) / t; };
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
