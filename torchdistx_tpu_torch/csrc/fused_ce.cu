// Fused LM-head cross-entropy for Hopper (sm_90a): three kernels, bf16
// operands, fp32 logits, softmax statistics and accumulation.
//
// Replaces the Pallas kernels of torchdistx_tpu/ops/fused_ce.py:
//   fused_ce_fwd  <- _fwd_kernel: per token, the online max / sum-exp over
//                    the vocab and the label logit; emits loss_i = lse_i -
//                    z_{y_i} and lse_i (f32);
//   fused_ce_dx   <- _dx_kernel: recomputes each logits tile from (X, W,
//                    lse), forms dP = softmax - onehot and accumulates
//                    dX = dP W;
//   fused_ce_dw   <- _dw_kernel: the same recompute, dW = dP^T X.
// The mean over the N true tokens (1/N) and the cotangent g are applied in
// the last pass, which reads g from device memory (no host sync).
//
// What bounds them on an H100: operations.  Logits are an N x V x D
// product (2NVD flops; 4NVD for each backward kernel, recompute included)
// against inputs read once (X and W, ~140 MB at the llama_1b and GPT-2
// shapes), far right of the card's ridge point.  The design keeps the
// (N, V) logits out of device memory: every logits tile lives in shared
// memory only, and every product runs on the tensor cores through
// warp-level WMMA 16x16x16 bf16 fragments with fp32 accumulators, fed by
// a three-stage cp.async pipeline of 64-wide K chunks.  It is the simple
// first version: no TMA, no wgmma.
//
// The TPU kernels keep a (256, D) f32 dX or a (512, D) f32 dW accumulator
// in VMEM for a whole pass over the other dimension; at D = 2048 that is
// 2-4 MB, and an SM has 227 KB of shared memory.  So the passes are split
// differently here:
//
// - forward: a block takes 128 tokens and a range of 16 vocab tiles
//   (2048 columns); each 128 x 128 logits tile is built by streaming D in
//   64-wide chunks, then folded into per-row running (max, sum-exp) and
//   the label logit in registers.  Partial (max, sum-exp, z_y) per vocab
//   range go to a small workspace, and a second kernel combines them per
//   token (an exact log-sum-exp merge).
// - dX: a block takes 128 tokens x 256 vocab columns: it builds the two
//   128 x 128 logits tiles, turns them into a bf16 dP panel (128 x 256) in
//   shared memory, then walks D in 64-wide chunks: out = dP . W[range,
//   chunk], added into an f32 (N, D) workspace with 16-byte atomics.  No token
//   tile holds a D-long accumulator; the price is one f32 atomic add per
//   (token, d) for each 256-column vocab range: N * D * V / 256 adds.
// - dW: the mirror image: 128 vocab rows x 256 tokens, dP^T panel, out =
//   dP^T . X[range, chunk] into an f32 (V, D) workspace: V * D * N / 256
//   adds.
// - scale: ws * (g / N) -> bf16 output.
// The recompute is what the JAX design pays (2NVD in each backward
// kernel); the atomics and the f32 workspaces are this design's extra
// work.  dP is fed to the tensor cores as bf16 (p - onehot in [-1, 1],
// relative rounding 2^-9); the 1/N is applied in f32 at the end.
//
// Shared memory (bytes): a 110,592 region holds the three stages of X and
// W chunks (3 x 2 x 18,432) and, aliased once they are consumed, the f32
// logits tile (128 x 132 x 4 = 67,584) or, in the gradient kernels' second
// phase, two Y chunks (2 x 36,864) and the f32 output staging (34,816);
// the gradient kernels add the bf16 dP panel (128 x 264 x 2 = 67,584) and
// the range's lse and labels (2,048): 180,224, one block of 8 warps per
// SM.  The forward takes 110,592, two blocks per SM.
//
// Padding: nothing is padded in memory.  Rows past N and vocab columns past
// V are zero-filled in the staged chunks and masked out of the softmax
// (columns) and of dP (both); GPT-2's V = 50257 needs no copy of W.
// Requirements: x (N, D), w (V, D) bf16 contiguous, 16-byte aligned,
// D % 8 == 0; labels (N,) int32; lse (N,) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;          // rows of a logits tile (tokens)
constexpr int BN = 128;          // columns of a logits tile (vocab entries)
constexpr int BK = 64;           // depth of one staged chunk (hidden dim)
constexpr int STAGES = 3;        // cp.async pipeline depth of the logits tiles
constexpr int LDK = BK + 8;      // bf16 row stride of a staged chunk
constexpr int LDS = BN + 4;      // f32 row stride of the logits tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int FWD_TILES = 16;    // vocab tiles per forward block
constexpr int RANGE = 256;       // vocab columns (dX) or tokens (dW) per block
constexpr int SUB = RANGE / BN;  // logits tiles per gradient block
constexpr int LDP = RANGE + 8;   // bf16 row stride of the dP panel
constexpr int LDO = BK + 4;      // f32 row stride of the output staging

constexpr size_t CHUNK_BYTES = size_t(BM) * LDK * 2;
constexpr size_t STAGE_BYTES = 2 * CHUNK_BYTES;  // an X chunk and a W chunk
constexpr size_t REGION_BYTES = STAGES * STAGE_BYTES;
constexpr size_t YCHUNK_BYTES = size_t(RANGE) * LDK * 2;
constexpr size_t OSTAGE_OFF = 2 * YCHUNK_BYTES;
constexpr size_t P_OFF = REGION_BYTES;
constexpr size_t ROWS_OFF = P_OFF + size_t(BM) * LDP * 2;
constexpr size_t GRAD_SMEM = ROWS_OFF + size_t(RANGE) * 8;
constexpr size_t FWD_SMEM = REGION_BYTES;
static_assert(size_t(BM) * LDS * 4 <= REGION_BYTES, "the logits tile exceeds the region");
static_assert(OSTAGE_OFF + size_t(BM) * LDO * 4 <= REGION_BYTES, "phase B exceeds the region");
static_assert(BM == BN, "one loader for both operands");
static_assert(BM == 4 * 32 && BK == 2 * 32, "phase B: 4 x 2 warps of 32 x 32 outputs");

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// Stage rows [0, ROWS) x columns [k0, k0 + BK) of a row-major (*, D) bf16
// matrix whose row 0 is `src` into dst (row stride LDK); rows >= valid and
// columns >= D are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int valid, int D, int k0) {
  constexpr int CPR = BK / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < valid && k0 + c < D;
    cp_async16(dst + r * LDK + c, ok ? src + (long long)r * D + k0 + c : src, ok);
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
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], A + (wm * 32 + i * 16) * LDK + kk * 16, LDK);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], B + (wn * 64 + j * 16) * LDK + kk * 16, LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
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
// the kernel at 128 registers and spills 8 bytes): more latency hidden
// than by one block of 180 registers.
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

// DW = false: dX.  Block (token tile s0, vocab range r0): panel P[token]
//   [vocab] = p - onehot; out (tokens x chunk) = P . W[r0:, chunk].
// DW = true: dW.  Block (vocab tile s0, token range r0): panel P[vocab]
//   [token]; out (vocab x chunk) = P . X[r0:, chunk].
// Both add out into the f32 workspace ws (stationary rows x D).
template <bool DW>
__global__ void __launch_bounds__(NTHREADS)
fused_ce_grad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const int* __restrict__ labels, const float* __restrict__ lse,
                     float* __restrict__ ws, int N, int V, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* P = reinterpret_cast<bf16*>(smem + P_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + ROWS_OFF);
  int* lab_s = reinterpret_cast<int*>(smem + ROWS_OFF + RANGE * 4);
  const int s0 = blockIdx.x * BM;
  const int r0 = blockIdx.y * RANGE;
  const int warp = threadIdx.x / 32;

  // the lse and labels of this block's tokens (DX: its BM tokens, DW: its range)
  const int tok_base = DW ? r0 : s0;
  for (int i = threadIdx.x; i < RANGE; i += NTHREADS) {
    const int t = tok_base + i;
    const bool ok = (DW || i < BM) && t < N;
    lse_s[i] = ok ? lse[t] : 0.f;
    lab_s[i] = ok ? labels[t] : -1;
  }
  // (made visible by the barrier at the top of logits_tile, or below)
  __syncthreads();

  // phase A: the dP panel, one 128 x 128 logits tile at a time
  for (int j = 0; j < SUB; ++j) {
    const int t0 = DW ? r0 + j * BM : s0;
    const int v0 = DW ? s0 : r0 + j * BN;
    const int rows = min(BM, N - t0);
    const int cols = min(BN, V - v0);
    if (rows > 0 && cols > 0) {
      logits_tile(smem, x + (long long)t0 * D, rows, w + (long long)v0 * D, cols, D);
      const float* S = reinterpret_cast<const float*>(smem);
      for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
        const int r = i / BN, c = i % BN;  // token r, vocab column c of the tile
        const int ti = DW ? j * BM + r : r;
        float p = 0.f;
        if (r < rows && c < cols) {
          p = expf(S[r * LDS + c] - lse_s[ti]);
          if (v0 + c == lab_s[ti]) p -= 1.f;
        }
        if (DW)
          P[c * LDP + j * BM + r] = __float2bfloat16(p);
        else
          P[r * LDP + j * BN + c] = __float2bfloat16(p);
      }
    } else {
      for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
        const int r = i / BN, c = i % BN;
        P[r * LDP + j * BN + c] = __float2bfloat16(0.f);  // a square block: either layout
      }
    }
  }
  __syncthreads();  // the panel is complete; the region is free

  // phase B: out (BM x BK per chunk) = P (BM x RANGE) . Y[r0 : r0 + RANGE, chunk],
  // 4 x 2 warps of 32 x 32 outputs each, Y chunks double-buffered
  const bf16* y = DW ? x : w;
  const int y_valid = min(RANGE, (DW ? N : V) - r0);
  const int out_valid = min(BM, (DW ? V : N) - s0);
  bf16* y_buf[2] = {reinterpret_cast<bf16*>(smem),
                    reinterpret_cast<bf16*>(smem + YCHUNK_BYTES)};
  float* O = reinterpret_cast<float*>(smem + OSTAGE_OFF);
  const bf16* y0 = y + (long long)r0 * D;
  const int wm = warp / 2, wn = warp % 2;
  const int nk = (D + BK - 1) / BK;
  load_chunk<RANGE>(y_buf[0], y0, y_valid, D, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_chunk<RANGE>(y_buf[(kt + 1) & 1], y0, y_valid, D, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // chunk kt is visible; the last chunk's atomics read O
    const bf16* Y = y_buf[kt & 1];
    Acc acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll 4
    for (int kk = 0; kk < RANGE / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], P + (wm * 32 + i * 16) * LDP + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Y + (kk * 16) * LDK + wn * 32 + j * 16, LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(O + (wm * 32 + i * 16) * LDO + wn * 32 + j * 16, acc[i][j],
                                LDO, wmma::mem_row_major);
    __syncthreads();  // O is complete; chunk kt is consumed
    // 16-byte vector atomics (sm_90): D % 8 == 0 keeps every group of four
    // columns inside the row and 16-byte aligned
    const int k0 = kt * BK;
    for (int i = threadIdx.x; i < BM * BK / 4; i += NTHREADS) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      if (r < out_valid && k0 + c < D)
        atomicAdd(reinterpret_cast<float4*>(ws + (long long)(s0 + r) * D + k0 + c),
                  *reinterpret_cast<const float4*>(O + r * LDO + c));
    }
  }
}

// out = bf16(ws * g[0] * inv_n), g read on the device.
__global__ void fused_ce_scale_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                                      long long n, const float* __restrict__ g, float inv_n) {
  const float s = g[0] * inv_n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16(ws[i] * s);
}

bool bad_shape(int N, int V, int D) { return N < 1 || V < 1 || D < 8 || D % 8 != 0; }

int n_split(int V) { return (V + FWD_TILES * BN - 1) / (FWD_TILES * BN); }

cudaError_t scale_out(const float* ws, void* out, long long n, const float* g, float inv_n,
                      cudaStream_t stream) {
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  fused_ce_scale_kernel<<<blocks, 256, 0, stream>>>(ws, static_cast<bf16*>(out), n, g, inv_n);
  return cudaGetLastError();
}

template <bool DW>
cudaError_t launch_grad(const void* x, const void* w, const void* labels, const void* lse,
                        const void* g, void* ws, void* out, int N, int V, int D,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_grad_kernel<DW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GRAD_SMEM);
  if (err != cudaSuccess) return err;
  const int stat = DW ? V : N, range = DW ? N : V;
  dim3 grid((stat + BM - 1) / BM, (range + RANGE - 1) / RANGE);
  fused_ce_grad_kernel<DW><<<grid, NTHREADS, GRAD_SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<float*>(ws), N, V, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return scale_out(static_cast<const float*>(ws), out, (long long)stat * D,
                   static_cast<const float*>(g), 1.0f / (float)N, stream);
}

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

// ws: zeroed f32 (N, D) workspace; dx: bf16 (N, D); g: one f32 on the device.
extern "C" int tdx_fused_ce_dx_bf16(const void* x, const void* w, const void* labels,
                                    const void* lse, const void* g, void* ws, void* dx, int N,
                                    int V, int D, void* stream) {
  if (bad_shape(N, V, D)) return (int)cudaErrorInvalidValue;
  return (int)launch_grad<false>(x, w, labels, lse, g, ws, dx, N, V, D,
                                 static_cast<cudaStream_t>(stream));
}

// ws: zeroed f32 (V, D) workspace; dw: bf16 (V, D); g: one f32 on the device.
extern "C" int tdx_fused_ce_dw_bf16(const void* x, const void* w, const void* labels,
                                    const void* lse, const void* g, void* ws, void* dw, int N,
                                    int V, int D, void* stream) {
  if (bad_shape(N, V, D)) return (int)cudaErrorInvalidValue;
  return (int)launch_grad<true>(x, w, labels, lse, g, ws, dw, N, V, D,
                                static_cast<cudaStream_t>(stream));
}
