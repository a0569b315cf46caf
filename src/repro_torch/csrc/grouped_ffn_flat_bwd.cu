// K1b on Hopper: the backward of K1, the ragged grouped gated FFN over the
// dispatcher's flat buffer.
//
// K1 (csrc/grouped_ffn_flat.cu) replaces the Pallas TPU kernel
// `grouped_ffn_flat_pallas` (src/repro/kernels/grouped_matmul.py:118).  The
// reference has no backward kernel: it trains through `jax.grad` of its plain
// `grouped_ffn_flat_ref` (src/repro/kernels/ref.py:47).  K1b computes that same
// gradient.  For the rows R = [start_g, end_g) of every group g, with
// g_r = x_r·Wg, u_r = x_r·Wu and dout the gradient of K1's output:
//
//     dh = dout·Wdᵀ,   du = dh ⊙ act(g),   dg = dh ⊙ u ⊙ act'(g),  h = act(g) ⊙ u
//     dx = dg·Wgᵀ + du·Wuᵀ
//     dWg = xᵀ·dg,  dWu = xᵀ·du,  dWd = hᵀ·dout      (summed over R only)
//
// Rows outside every group get dx = 0 (the wrapper hands in a zeroed dx) and add
// nothing; an empty group's weight gradients are written as zeros.  act is
// swiglu, geglu (tanh approximation, as jax.nn.gelu) or relu_sq.  f32 only:
// the reference trains in f32.
//
// What bounds it: ~6·rows·H·F f32 operations for dh, dx and the three weight
// gradients (412 GFLOP at olmoe-1b-7b's training geometry, 16 384 routed rows,
// H 2048, F 1024: 6.15 ms at 67 TFLOP/s), far above the bytes; recomputing g and
// u adds 4·rows·H·F that the bound does not count.
//
// Design: a simple tiled shared-memory FFMA GEMM, three launches on one stream.
// Every block computes a 64 × 64 output tile with 256 threads, 4 × 4 outputs a
// thread, stepping through the reduction in slices of 16 staged in shared memory
// (zero-filled past every edge, so ragged H, F and group sizes are masked, never
// padded).
//   (a) hidden: grid (row blocks, F / 64).  A row block is up to 64 rows of one
//       group; blocks are numbered group by group, and a block past the last
//       one returns at once, so the work scales with the rows inside groups,
//       not with N.  It recomputes g and u (x·Wg, x·Wu) and forms dh (dout·Wdᵀ)
//       in one pass over H, then writes h, du and dg (f32) to a scratch buffer
//       [3, N, F].
//   (b) dx: grid (row blocks, H / 64): dg·Wgᵀ + du·Wuᵀ over F.
//   (c) weight gradients: grid (tiles, S, 3).  For group g and one 64 × 64 tile
//       of dWg, dWu or dWd, the sum over the group's rows in row order.
// No atomics: every output element is summed by one thread in a fixed order,
// so two calls agree bit for bit.  wgmma, TMA and a ring of stages are later
// work.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // output rows and columns of a block
constexpr int kK = 16;        // reduction slice staged per step
constexpr int kLd = kTile + 4;  // shared row length (float4-aligned, fewer conflicts)

enum Act : int { kSwiglu = 0, kGeglu = 1, kReluSq = 2 };

// act(g) and act'(g), the formulas of ref.grouped_ffn_flat_bwd_ref.
__device__ __forceinline__ void act_and_grad(int act, float g, float& a, float& da) {
  if (act == kSwiglu) {
    const float s = 1.0f / (1.0f + expf(-g));
    a = g * s;
    da = s * (1.0f + g * (1.0f - s));
  } else if (act == kGeglu) {
    const float c = 0.7978845608028654f, k = 0.044715f;
    const float t = tanhf(c * (g + k * g * g * g));
    a = 0.5f * g * (1.0f + t);
    da = 0.5f * (1.0f + t) + 0.5f * g * (1.0f - t * t) * c * (1.0f + 3.0f * k * g * g);
  } else {
    const float r = fmaxf(g, 0.0f);
    a = r * r;
    da = 2.0f * r;
  }
}

// Stage a kK × kTile slice: element (k, m) of the operand lies at
// base[m·sm + k·sk]; it goes to tile[k][m], zero where m >= m_valid or
// k >= k_valid.  `m_contig` says which index is contiguous in memory, so that
// neighbouring threads read neighbouring addresses.
__device__ __forceinline__ void stage(float (*tile)[kLd], const float* __restrict__ base,
                                      long long sm, long long sk, int m_valid, int k_valid,
                                      bool m_contig) {
#pragma unroll
  for (int i = 0; i < kK * kTile / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int m = m_contig ? idx % kTile : idx / kK;
    const int k = m_contig ? idx / kTile : idx % kK;
    tile[k][m] = (m < m_valid && k < k_valid) ? base[m * sm + k * sk] : 0.0f;
  }
}

// acc[i][j] += Σ_k a[k][4·ty + i] · b[k][4·tx + j] over one staged slice.
__device__ __forceinline__ void mma_slice(float (&acc)[4][4], const float (*a)[kLd],
                                          const float (*b)[kLd], int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&a[k][4 * ty]);
    const float4 bv = *reinterpret_cast<const float4*>(&b[k][4 * tx]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// The group and rows of row block `b`: blocks are numbered group by group, each
// group's rows cut into blocks of kTile.  Returns false past the last block.
__device__ __forceinline__ bool row_block(int b, const int* __restrict__ start,
                                          const int* __restrict__ end, int s_n, int& grp,
                                          int& r0, int& nr) {
  int first = 0;
  for (int s = 0; s < s_n; ++s) {
    const int count = end[s] - start[s];
    const int blocks = count > 0 ? (count + kTile - 1) / kTile : 0;
    if (b < first + blocks) {
      grp = s;
      r0 = start[s] + (b - first) * kTile;
      nr = min(kTile, end[s] - r0);
      return true;
    }
    first += blocks;
  }
  return false;
}

// (a) h, du, dg for one row block and 64 hidden columns.
__global__ void __launch_bounds__(kThreads)
    bwd_hidden(const float* __restrict__ x, const float* __restrict__ dout,
               const int* __restrict__ start, const int* __restrict__ end,
               const float* __restrict__ wg, const float* __restrict__ wu,
               const float* __restrict__ wd, float* __restrict__ hs, float* __restrict__ dus,
               float* __restrict__ dgs, int h, int f, int s_n, int act) {
  int grp, r0, nr;
  if (!row_block(blockIdx.x, start, end, s_n, grp, r0, nr)) return;
  const int f0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  __shared__ __align__(16) float xs[kK][kLd], os[kK][kLd];
  __shared__ __align__(16) float gs[kK][kLd], us[kK][kLd], ds[kK][kLd];
  const size_t hf = (size_t)h * f;
  const float* wg_g = wg + grp * hf + f0;
  const float* wu_g = wu + grp * hf + f0;
  const float* wd_g = wd + grp * hf + (size_t)f0 * h;
  float ag[4][4] = {}, au[4][4] = {}, ad[4][4] = {};
  for (int k0 = 0; k0 < h; k0 += kK) {
    const int kv = h - k0;
    stage(xs, x + (size_t)r0 * h + k0, h, 1, nr, kv, false);
    stage(os, dout + (size_t)r0 * h + k0, h, 1, nr, kv, false);
    stage(gs, wg_g + (size_t)k0 * f, 1, f, f - f0, kv, true);
    stage(us, wu_g + (size_t)k0 * f, 1, f, f - f0, kv, true);
    stage(ds, wd_g + k0, h, 1, f - f0, kv, false);      // Wd[f][c]: (k = c, n = f)
    __syncthreads();
    mma_slice(ag, xs, gs, ty, tx);
    mma_slice(au, xs, us, ty, tx);
    mma_slice(ad, os, ds, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = f0 + 4 * tx + j;
      if (c >= f) continue;
      float a, da;
      act_and_grad(act, ag[i][j], a, da);
      const float u = au[i][j], dh = ad[i][j];
      const size_t o = (size_t)(r0 + r) * f + c;
      hs[o] = a * u;
      dus[o] = dh * a;
      dgs[o] = dh * u * da;
    }
  }
}

// (b) dx = dg·Wgᵀ + du·Wuᵀ for one row block and 64 columns of H.
__global__ void __launch_bounds__(kThreads)
    bwd_dx(const float* __restrict__ dgs, const float* __restrict__ dus,
           const int* __restrict__ start, const int* __restrict__ end,
           const float* __restrict__ wg, const float* __restrict__ wu, float* __restrict__ dx,
           int h, int f, int s_n) {
  int grp, r0, nr;
  if (!row_block(blockIdx.x, start, end, s_n, grp, r0, nr)) return;
  const int c0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  __shared__ __align__(16) float gs[kK][kLd], us[kK][kLd];
  __shared__ __align__(16) float wgs[kK][kLd], wus[kK][kLd];
  const size_t hf = (size_t)h * f;
  const float* wg_g = wg + grp * hf + (size_t)c0 * f;   // Wg[c][f]: (k = f, n = c)
  const float* wu_g = wu + grp * hf + (size_t)c0 * f;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < f; k0 += kK) {
    const int kv = f - k0;
    stage(gs, dgs + (size_t)r0 * f + k0, f, 1, nr, kv, false);
    stage(us, dus + (size_t)r0 * f + k0, f, 1, nr, kv, false);
    stage(wgs, wg_g + k0, f, 1, h - c0, kv, false);
    stage(wus, wu_g + k0, f, 1, h - c0, kv, false);
    __syncthreads();
    mma_slice(acc, gs, wgs, ty, tx);
    mma_slice(acc, us, wus, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < h) dx[(size_t)(r0 + r) * h + c] = acc[i][j];
    }
  }
}

// (c) one 64 × 64 tile of dWg (z = 0), dWu (z = 1) or dWd (z = 2) of group
// blockIdx.y, summed over the group's rows in row order.
__global__ void __launch_bounds__(kThreads)
    bwd_weights(const float* __restrict__ x, const float* __restrict__ dout,
                const float* __restrict__ hs, const float* __restrict__ dus,
                const float* __restrict__ dgs, const int* __restrict__ start,
                const int* __restrict__ end, float* __restrict__ dwg, float* __restrict__ dwu,
                float* __restrict__ dwd, int h, int f) {
  const int grp = blockIdx.y, z = blockIdx.z;
  const int rows = z == 2 ? f : h, cols = z == 2 ? h : f;   // output [rows, cols]
  const int col_tiles = (cols + kTile - 1) / kTile;
  const int m0 = blockIdx.x / col_tiles * kTile, n0 = blockIdx.x % col_tiles * kTile;
  const int s0 = start[grp], count = max(end[grp] - s0, 0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // A (m, k = row r): x[r][m] or h[r][m]; B (n, k = r): dg/du[r][n] or dout[r][n]
  const float* a_src = z == 2 ? hs + (size_t)s0 * f : x + (size_t)s0 * h;
  const float* b_src = z == 2 ? dout + (size_t)s0 * h : (z == 0 ? dgs : dus) + (size_t)s0 * f;
  const long long lda = z == 2 ? f : h, ldb = z == 2 ? h : f;
  __shared__ __align__(16) float as[kK][kLd], bs[kK][kLd];
  float acc[4][4] = {};
  for (int k0 = 0; k0 < count; k0 += kK) {
    const int kv = count - k0;
    stage(as, a_src + (size_t)k0 * lda + m0, 1, lda, rows - m0, kv, true);
    stage(bs, b_src + (size_t)k0 * ldb + n0, 1, ldb, cols - n0, kv, true);
    __syncthreads();
    mma_slice(acc, as, bs, ty, tx);
    __syncthreads();
  }
  float* out = (z == 0 ? dwg : z == 1 ? dwu : dwd) + (size_t)grp * h * f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tx + j;
      if (c < cols) out[(size_t)r * cols + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// f32 elements of scratch a call needs: h, du and dg, each [N, F].
long long grouped_ffn_flat_bwd_scratch_floats(int n, int f) { return 3LL * n * f; }

// x, dout [N, H]; group_start, group_end int32[S]; wg, wu [S, H, F], wd [S, F, H];
// dx [N, H] zeroed by the caller; dwg, dwu [S, H, F], dwd [S, F, H] written whole.
// act: 0 = swiglu, 1 = geglu, 2 = relu_sq.  Launches the three kernels on
// `stream` without synchronising; returns the first launch error, 0 on success.
int grouped_ffn_flat_bwd(const float* x, const float* dout, const int* group_start,
                         const int* group_end, const float* wg, const float* wu,
                         const float* wd, float* dx, float* dwg, float* dwu, float* dwd,
                         float* scratch, int n, int h, int f, int s, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || h <= 0 || f <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  if (act < kSwiglu || act > kReluSq) return (int)cudaErrorInvalidValue;
  float* hs = scratch;
  float* dus = scratch + (size_t)n * f;
  float* dgs = scratch + 2 * (size_t)n * f;
  // row blocks: Σ_g ceil(count_g / 64) <= N / 64 + S; blocks past the last return
  const int row_blocks = (n + kTile - 1) / kTile + s;
  const int ft = (f + kTile - 1) / kTile, ht = (h + kTile - 1) / kTile;
  bwd_hidden<<<dim3(row_blocks, ft), kThreads, 0, st>>>(x, dout, group_start, group_end, wg,
                                                         wu, wd, hs, dus, dgs, h, f, s, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dx<<<dim3(row_blocks, ht), kThreads, 0, st>>>(dgs, dus, group_start, group_end, wg, wu,
                                                     dx, h, f, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_weights<<<dim3(ht * ft, s, 3), kThreads, 0, st>>>(x, dout, hs, dus, dgs, group_start,
                                                         group_end, dwg, dwu, dwd, h, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
