// K1 on Hopper: ragged grouped gated FFN over the dispatcher's flat buffer.
//
// Replaces the Pallas TPU kernel `grouped_ffn_flat_pallas` / `_ffn_flat_kernel`
// (src/repro/kernels/grouped_matmul.py).  For every row r of x[N, H] that lies
// in [start_g, end_g) of the group g owning its bm-row tile:
//
//     out[r] = (act(x[r] · Wg[g]) ⊙ (x[r] · Wu[g])) · Wd[g]
//
// and every other row is written as exact zeros.  K2, the slot-layout FFN that
// replaces `grouped_ffn_pallas`, launches this same device code on x[S, C, H]
// viewed flat, with group_end[s] = s·C + counts[s] and tile i in slot i / (C/bm)
// (src/repro_torch/kernels/grouped_matmul.py).  act is swiglu, geglu (tanh
// approximation, as jax.nn.gelu) or relu_sq.  Inputs are f32 or bf16; every
// product accumulates in f32; the output has x's type.
//
// What bounds it: at decode a tile holds a handful of rows, so the work is
// 2·3·rows·H·F operations against 3·H·F weight elements per active group —
// a few operations per byte, far below the card's ~20 f32 FLOP/byte ridge.
// The kernel is bound by the bytes of the active groups' weights, read from
// device memory once per row tile.
//
// Design (simple and right first; wgmma, TMA and multi-stage pipelines are
// later work):
//   * grid = (N / bm row tiles, ceil(F / kFChunk) F-chunks).  Splitting F over
//     blocks puts enough blocks on the card when only a few tiles are active.
//   * each block reads its own tile_gid / group_end (no scalar prefetch); a
//     tile wholly past its group's end returns at once and skips both products.
//   * rows are taken kRows at a time.  Phase 1: thread t owns hidden column
//     f0 + t and streams Wg/Wu[g][:, f] (coalesced over t) against x rows
//     staged in shared memory, giving h = act(x·Wg) ⊙ (x·Wu) for the chunk in
//     shared memory — h never reaches device memory.  Phase 2: thread t walks
//     output columns c ≡ t (mod kThreads) and accumulates h · Wd[g][f0:f1, c].
//   * each F-chunk writes its partial (rows × H) product to an f32 scratch
//     buffer; a second kernel sums the chunks in a fixed order (deterministic,
//     no atomics), writes zeros on rows at or past their group's end, and
//     casts to the output type.
//   * ragged H and F are masked in the kernel; nothing is padded per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kFChunk = 128;   // hidden columns per block (one per thread)
constexpr int kRows = 8;       // rows per register tile
constexpr int kChunkK = 256;   // x columns staged in shared memory per pass

static_assert(kFChunk == kThreads, "phase 1 maps one hidden column to a thread");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

enum Act : int { kSwiglu = 0, kGeglu = 1, kReluSq = 2 };

template <int ACT>
__device__ __forceinline__ float gated(float g, float u) {
  if (ACT == kSwiglu) {
    return g / (1.0f + expf(-g)) * u;
  } else if (ACT == kGeglu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
  } else {
    const float r = fmaxf(g, 0.0f);
    return r * r * u;
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
ffn_partial_kernel(const T* __restrict__ x, const int32_t* __restrict__ tile_gid,
                   const int32_t* __restrict__ group_end, const T* __restrict__ wg,
                   const T* __restrict__ wu, const T* __restrict__ wd,
                   float* __restrict__ partial, int n, int h, int f, int bm) {
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int gid = tile_gid[tile];
  const int row0 = tile * bm;
  const int end = group_end[gid];
  if (row0 >= end) return;  // tile wholly past its group: both products skipped
  const int rows = min(bm, end - row0);

  const int t = threadIdx.x;
  const int f0 = split * kFChunk;
  const int fcol = f0 + t;
  const bool f_ok = fcol < f;
  const int nf = min(kFChunk, f - f0);
  const size_t wbase = (size_t)gid * h * f;  // Wg/Wu [S,H,F] and Wd [S,F,H]

  __shared__ float xs[kRows][kChunkK];
  __shared__ float hs[kRows][kFChunk];

  for (int r0 = 0; r0 < rows; r0 += kRows) {
    const int nr = min(kRows, rows - r0);
    const T* xr = x + (size_t)(row0 + r0) * h;

    // ---- phase 1: h[r, f] = act(x[r]·Wg[:, f]) * (x[r]·Wu[:, f]) --------
    float ag[kRows], au[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ag[r] = au[r] = 0.0f;
    for (int k0 = 0; k0 < h; k0 += kChunkK) {
      const int nk = min(kChunkK, h - k0);
      __syncthreads();  // the previous pass is done reading xs
      for (int i = t; i < kRows * kChunkK; i += kThreads) {
        const int r = i / kChunkK, k = i % kChunkK;
        xs[r][k] = (r < nr && k < nk) ? to_f(xr[(size_t)r * h + k0 + k]) : 0.0f;
      }
      __syncthreads();
      if (f_ok) {
        const T* pg = wg + wbase + (size_t)k0 * f + fcol;
        const T* pu = wu + wbase + (size_t)k0 * f + fcol;
#pragma unroll 4
        for (int k = 0; k < nk; ++k) {
          const float g = to_f(pg[(size_t)k * f]);
          const float u = to_f(pu[(size_t)k * f]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            ag[r] = fmaf(xs[r][k], g, ag[r]);
            au[r] = fmaf(xs[r][k], u, au[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      hs[r][t] = (f_ok && r < nr) ? gated<ACT>(ag[r], au[r]) : 0.0f;
    __syncthreads();

    // ---- phase 2: partial[split, row, c] = h[row, f0:f0+nf] · Wd[f0:, c] --
    for (int c = t; c < h; c += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      const T* pd = wd + wbase + (size_t)f0 * h + c;
#pragma unroll 4
      for (int j = 0; j < nf; ++j) {
        const float w = to_f(pd[(size_t)j * h]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hs[r][j], w, acc[r]);
      }
      float* out = partial + ((size_t)split * n + row0 + r0) * h + c;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) out[(size_t)r * h] = acc[r];
    }
    __syncthreads();  // hs is rewritten by the next row group
  }
}

// Sum the F-chunk partials in chunk order; rows at or past their group's end
// (and rows of skipped tiles) are written as exact zeros.
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ partial,
                                  const int32_t* __restrict__ tile_gid,
                                  const int32_t* __restrict__ group_end,
                                  T* __restrict__ out, int n, int h, int bm, int nsplit) {
  const size_t total = (size_t)n * h;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int row = (int)(i / h);
    const int end = group_end[tile_gid[row / bm]];
    float v = 0.0f;
    if (row < end)
      for (int s = 0; s < nsplit; ++s) v += partial[(size_t)s * total + i];
    out[i] = from_f<T>(v);
  }
}

inline int num_splits(int f) { return (f + kFChunk - 1) / kFChunk; }

template <typename T, int ACT>
void launch(const void* x, const void* tile_gid, const void* group_end, const void* wg,
            const void* wu, const void* wd, void* out, void* partial, int n, int h, int f,
            int bm, cudaStream_t stream) {
  const int nsplit = num_splits(f);
  dim3 grid(n / bm, nsplit);
  ffn_partial_kernel<T, ACT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(tile_gid),
      static_cast<const int32_t*>(group_end), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd), static_cast<float*>(partial), n,
      h, f, bm);
  const size_t total = (size_t)n * h;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 8192 ? want : 8192);
  ffn_reduce_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const int32_t*>(tile_gid),
      static_cast<const int32_t*>(group_end), static_cast<T*>(out), n, h, bm, nsplit);
}

template <typename T>
void launch_act(int act, const void* x, const void* tile_gid, const void* group_end,
                const void* wg, const void* wu, const void* wd, void* out, void* partial,
                int n, int h, int f, int bm, cudaStream_t stream) {
  switch (act) {
    case kSwiglu:
      launch<T, kSwiglu>(x, tile_gid, group_end, wg, wu, wd, out, partial, n, h, f, bm, stream);
      break;
    case kGeglu:
      launch<T, kGeglu>(x, tile_gid, group_end, wg, wu, wd, out, partial, n, h, f, bm, stream);
      break;
    default:
      launch<T, kReluSq>(x, tile_gid, group_end, wg, wu, wd, out, partial, n, h, f, bm, stream);
  }
}

}  // namespace

extern "C" {

// f32 elements of scratch the launch needs: one (N × H) partial per F-chunk.
long long grouped_ffn_flat_scratch_floats(int n, int h, int f) {
  return (long long)num_splits(f) * n * h;
}

// dtype: 0 = float32, 1 = bfloat16.  act: 0 = swiglu, 1 = geglu, 2 = relu_sq.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int grouped_ffn_flat(const void* x, const void* tile_gid, const void* group_end,
                     const void* wg, const void* wu, const void* wd, void* out,
                     void* partial, int n, int h, int f, int bm, int dtype, int act,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || h <= 0 || f <= 0 || bm <= 0 || n % bm != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_act<float>(act, x, tile_gid, group_end, wg, wu, wd, out, partial, n, h, f, bm, st);
  else if (dtype == 1)
    launch_act<__nv_bfloat16>(act, x, tile_gid, group_end, wg, wu, wd, out, partial, n, h, f,
                              bm, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
