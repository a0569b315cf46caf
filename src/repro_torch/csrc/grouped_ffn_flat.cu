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
// What bounds it: at decode a tile holds a handful of rows, so the work is a
// batched GEMV: 2·3·rows·H·F operations against 3·H·F weight elements per
// active group, a few operations per byte, far below the card's ~20 f32
// FLOP/byte ridge.  The bound is the bytes of the active groups' weights, read
// once per row tile (olmoe-1b-7b decode: ~25 experts × 24 MB in f32, ~0.2 ms
// at 3.35 TB/s).  Reaching it takes ~2.3 MB in flight across the card (Little's
// law at ~0.7 µs), ~18 KB per SM, and enough blocks on all 132 SMs.
//
// Design: two kernels, both streaming weights through a ring of kStages = 4
// shared-memory stages filled by cp.async, with the arithmetic on FFMA.
//   * Work items: kRows = 8 rows of one bm-row tile (bm / 8 items a tile,
//     rounded up).  An item reads its own tile_gid / group_end; an item with
//     no row inside its group returns at once (the up kernel) or writes its
//     zeros without waiting for anything (the down kernel).  An item's work
//     is compiled for R = 1, 2, 4 and 8 rows and runs the smallest R that
//     holds its rows in the group, so a decode item of one or two rows
//     issues one or two FMAs per weight element, not eight.
//   * Up kernel: grid (items, F / 64).  A block owns 64 hidden columns and
//     the whole H reduction: each stage holds 32 rows of Wg and Wu (64
//     columns each) and the item's 32 matching x columns.  Thread t takes
//     columns 4·(t mod 16) .. +3 and stage rows 2·(t / 16), +1, for all R
//     rows.  The 16 partial sums of a column are reduced in a fixed order (a
//     shuffle pairs the two k-groups of a warp, then the 8 warps in order,
//     through shared memory), the activation is applied, and h[rows, 64]
//     (f32) goes to a scratch buffer h[N, F] in device memory.  Capped at
//     128 registers (2 blocks an SM; the R = 8 form spills).
//   * Down kernel: grid (items, H / 128).  A block owns 128 output columns and
//     the whole F reduction: each stage holds 16 rows of Wd (128 columns) and
//     the item's 16 matching h columns.  Thread t takes columns 4·(t mod 32)
//     .. +3 and stage rows 2·(t / 32), +1; the 8 warps' partials are summed
//     in order through shared memory and written in x's type, zeros on rows
//     outside the group.  Capped at 64 registers, so that 4 blocks an SM
//     hold every active item's blocks at decode in one wave.
//   * Overlap: the down kernel is launched with programmatic dependent launch.
//     Every up block signals at its start, so the down blocks are placed as
//     soon as the last up block has started; each issues its first three Wd
//     stages, then waits (griddepcontrol.wait) for the up kernel's h before
//     staging h.  So the Wd stream starts while the last Wg/Wu tiles are
//     consumed.
//   * Copies: 16-byte cp.async where every base address and row stride
//     allows, else 8- or 4-byte copies, else plain loads (a bf16 row of odd
//     length); pieces past H or F are zero-filled by the copy, so ragged
//     shapes are masked, never padded.  Bytes in flight: 3 stages ahead,
//     51 KB an up block and 25 KB a down block in f32, far above the ~18 KB
//     an SM needs.
//   * Deterministic: every sum has a fixed order and nothing is atomic, so
//     two calls agree bit for bit (ref.grouped_ffn_flat_blocked_ref repeats
//     the order in PyTorch).
//   * h stays in f32 between the kernels (N × F floats, rows padded to a
//     multiple of 4 so every h row is 16-byte aligned).  A bm-128 tile is 16
//     items, each of which streams the group's weights again (mostly from L2):
//     prefill-shaped calls are right, not fast.
//
// What is left between it and the bound: the up kernel holds 2 blocks an SM,
// so ~400 live blocks at decode run in 1.5 waves; the down kernel's Wd stream
// overlaps only the up kernel's last wave; every stage costs a block-wide
// barrier; bf16 moves half the bytes through as many stages, so its fixed
// costs weigh twice as much.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;       // rows per work item
constexpr int kStages = 4;     // cp.async ring depth

// up kernel: h[r, f] = act(x[r]·Wg[:, f]) · (x[r]·Wu[:, f])
constexpr int kUpCols = 64;                     // hidden columns per block
constexpr int kUpK = 32;                        // H rows per stage
constexpr int kUpQuads = kUpCols / 4;           // 16 column quads
constexpr int kUpBlocks = 2;                    // resident blocks an SM (register cap)
// down kernel: out[r, c] = h[r, :] · Wd[:, c]
constexpr int kDnCols = 128;                    // output columns per block
constexpr int kDnK = 16;                        // F rows per stage
constexpr int kDnQuads = kDnCols / 4;           // 32 column quads: one warp
constexpr int kDnBlocks = 4;                    // resident blocks an SM (register cap)

static_assert(kThreads / kUpQuads * 2 == kUpK, "an up thread takes 2 rows a stage");
static_assert(kUpQuads * 2 == 32, "a warp holds two k-groups of the up kernel");
static_assert(kThreads / kDnQuads * 2 == kDnK, "a down thread takes 2 rows a stage");

template <typename T>
struct Smem {
  static constexpr size_t kUpStage = (2 * kUpK * kUpCols + kRows * kUpK) * sizeof(T);
  static constexpr size_t kUpRed = (size_t)kWarps * 2 * kRows * kUpCols * sizeof(float);
  static constexpr size_t kUp = kStages * kUpStage > kUpRed ? kStages * kUpStage : kUpRed;
  static constexpr size_t kDnW = (size_t)kDnK * kDnCols * sizeof(T);
  static constexpr size_t kDnStage = kDnW + kRows * kDnK * sizeof(float);
  static constexpr size_t kDnRed = (size_t)kWarps * kRows * kDnCols * sizeof(float);
  static constexpr size_t kDn = kStages * kDnStage > kDnRed ? kStages * kDnStage : kDnRed;
  static_assert(kUpStage % 16 == 0 && kDnStage % 16 == 0 && kDnW % 16 == 0, "stages stay aligned");
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four (two) consecutive elements of shared memory, widened to f32 exactly.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

enum Act : int { kSwiglu = 0, kGeglu = 1, kReluSq = 2 };

__device__ __forceinline__ float gated(int act, float g, float u) {
  if (act == kSwiglu) {
    return g / (1.0f + expf(-g)) * u;
  } else if (act == kGeglu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
  } else {
    const float r = fmaxf(g, 0.0f);
    return r * r * u;
  }
}

// ---------------------------------------------------------------- copies

// One asynchronous copy of N bytes, of which the first `valid` are read from
// src and the rest written as zeros (valid = 0 reads nothing).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid));
  else if (N == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch (sm_90): let the next kernel of the stream be
// placed; wait for the previous kernel's completion and its memory.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <int VEC, int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage_tile_v(T* dst, const T* src, size_t ld, int nrow,
                                             int ncol) {
  constexpr int kE = VEC / (int)sizeof(T);  // elements per copy
  constexpr int kP = COLS / kE;             // copies per row
  for (int i = threadIdx.x; i < ROWS * kP; i += kThreads) {
    const int r = i / kP, c = (i % kP) * kE;
    const int valid = r < nrow ? max(0, min(kE, ncol - c)) : 0;
    cp_async<VEC>(dst + r * COLS + c, valid ? src + (size_t)r * ld + c : src,
                  valid * (int)sizeof(T));
  }
}

// Stage a ROWS × COLS tile of T from global memory (row stride ld elements,
// src its first element) into shared memory rows of COLS elements, issued by
// all threads of the block.  Rows at or past nrow and columns at or past ncol
// are zero-filled.  vec is the copy width in bytes (16, 8 or 4), or 0 for
// plain loads; the caller picks it so that every copy is aligned.
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, size_t ld, int nrow, int ncol,
                                           int vec) {
  if (vec == 16) {
    stage_tile_v<16, ROWS, COLS>(dst, src, ld, nrow, ncol);
  } else if (vec == 8) {
    stage_tile_v<8, ROWS, COLS>(dst, src, ld, nrow, ncol);
  } else if (vec == 4) {
    stage_tile_v<4, ROWS, COLS>(dst, src, ld, nrow, ncol);
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kThreads) {
      const int r = e / COLS, c = e % COLS;
      dst[e] = (r < nrow && c < ncol) ? src[(size_t)r * ld + c] : from_f<T>(0.0f);
    }
  }
}

// Rows [row0, row0 + rows) of work item `item`, and how many of them (nr)
// lie inside the tile's group.
struct Item {
  int row0, rows, nr, gid;
};
__device__ __forceinline__ Item item_rows(const int32_t* tile_gid, const int32_t* group_end,
                                          int bm, int nsub) {
  const int tile = blockIdx.x / nsub, sub = blockIdx.x % nsub;
  Item it;
  it.row0 = tile * bm + sub * kRows;
  it.rows = min(kRows, bm - sub * kRows);
  it.gid = tile_gid[tile];
  it.nr = max(0, min(it.rows, group_end[it.gid] - it.row0));
  return it;
}

// ------------------------------------------------------ up: h = act(xWg)·xWu

// The up kernel's work on an item of at most R rows (R = 1, 2, 4 or 8: the
// item's rows in its group, rounded up), so that a decode item of one or two
// rows issues one or two FMAs per weight element, not eight.
template <typename T, int R>
__device__ __forceinline__ void up_rows(const Item& it, const T* __restrict__ x,
                                        const T* __restrict__ wg, const T* __restrict__ wu,
                                        float* __restrict__ hbuf, int h, int f, int ldh,
                                        int act, int vec) {
  const int f0 = blockIdx.y * kUpCols;
  const int nf = min(kUpCols, f - f0);
  const int nk = (h + kUpK - 1) / kUpK;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  constexpr int kStageElems = (int)(Smem<T>::kUpStage / sizeof(T));
  const T* gsrc = wg + (size_t)it.gid * h * f + f0;
  const T* usrc = wu + (size_t)it.gid * h * f + f0;
  const T* xsrc = x + (size_t)it.row0 * h;

  auto issue = [&](int s) {
    T* st = ring + (s % kStages) * kStageElems;
    const int k0 = s * kUpK;
    stage_tile<kUpK, kUpCols>(st, gsrc + (size_t)k0 * f, f, h - k0, nf, vec);
    stage_tile<kUpK, kUpCols>(st + kUpK * kUpCols, usrc + (size_t)k0 * f, f, h - k0, nf, vec);
    stage_tile<R, kUpK>(st + 2 * kUpK * kUpCols, xsrc + k0, h, it.nr, h - k0, vec);
  };

  const int cq = threadIdx.x % kUpQuads;  // columns 4·cq .. 4·cq + 3
  const int kg = threadIdx.x / kUpQuads;  // stage rows 2·kg, 2·kg + 1
  float ag[R][4], au[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) ag[r][c] = au[r][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage i - 1 is free
    if (i + kStages - 1 < nk) issue(i + kStages - 1);
    cp_async_commit();
    const T* st = ring + (i % kStages) * kStageElems;
    const T* ws = st + 2 * kg * kUpCols + 4 * cq;
    const float4 g0 = load4(ws), g1 = load4(ws + kUpCols);
    const float4 u0 = load4(ws + kUpK * kUpCols), u1 = load4(ws + kUpK * kUpCols + kUpCols);
    const T* xs = st + 2 * kUpK * kUpCols + 2 * kg;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 xv = load2(xs + r * kUpK);
      ag[r][0] = fmaf(xv.y, g1.x, fmaf(xv.x, g0.x, ag[r][0]));
      ag[r][1] = fmaf(xv.y, g1.y, fmaf(xv.x, g0.y, ag[r][1]));
      ag[r][2] = fmaf(xv.y, g1.z, fmaf(xv.x, g0.z, ag[r][2]));
      ag[r][3] = fmaf(xv.y, g1.w, fmaf(xv.x, g0.w, ag[r][3]));
      au[r][0] = fmaf(xv.y, u1.x, fmaf(xv.x, u0.x, au[r][0]));
      au[r][1] = fmaf(xv.y, u1.y, fmaf(xv.x, u0.y, au[r][1]));
      au[r][2] = fmaf(xv.y, u1.z, fmaf(xv.x, u0.z, au[r][2]));
      au[r][3] = fmaf(xv.y, u1.w, fmaf(xv.x, u0.w, au[r][3]));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused for the reduction

  // k-groups 2w and 2w + 1 share warp w: pair them, then sum the warps in order
  float* red = reinterpret_cast<float*>(smem);  // [warp][gate, up][row][column]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float4 g, u;
    g.x = ag[r][0] + __shfl_xor_sync(0xffffffffu, ag[r][0], 16);
    g.y = ag[r][1] + __shfl_xor_sync(0xffffffffu, ag[r][1], 16);
    g.z = ag[r][2] + __shfl_xor_sync(0xffffffffu, ag[r][2], 16);
    g.w = ag[r][3] + __shfl_xor_sync(0xffffffffu, ag[r][3], 16);
    u.x = au[r][0] + __shfl_xor_sync(0xffffffffu, au[r][0], 16);
    u.y = au[r][1] + __shfl_xor_sync(0xffffffffu, au[r][1], 16);
    u.z = au[r][2] + __shfl_xor_sync(0xffffffffu, au[r][2], 16);
    u.w = au[r][3] + __shfl_xor_sync(0xffffffffu, au[r][3], 16);
    if (lane < 16) {
      *reinterpret_cast<float4*>(red + ((warp * 2) * R + r) * kUpCols + 4 * cq) = g;
      *reinterpret_cast<float4*>(red + ((warp * 2 + 1) * R + r) * kUpCols + 4 * cq) = u;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < R * kUpCols; o += kThreads) {
    const int r = o / kUpCols, c = o % kUpCols;
    if (r < it.nr && c < nf) {
      float g = red[r * kUpCols + c], u = red[(R + r) * kUpCols + c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        g += red[((w * 2) * R + r) * kUpCols + c];
        u += red[((w * 2 + 1) * R + r) * kUpCols + c];
      }
      hbuf[(size_t)(it.row0 + r) * ldh + f0 + c] = gated(act, g, u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kUpBlocks)
ffn_up_kernel(const T* __restrict__ x, const int32_t* __restrict__ tile_gid,
              const int32_t* __restrict__ group_end, const T* __restrict__ wg,
              const T* __restrict__ wu, float* __restrict__ hbuf, int h, int f, int bm,
              int nsub, int ldh, int act, int vec) {
  griddep_launch_dependents();  // the down kernel may be placed once every up block has started
  const Item it = item_rows(tile_gid, group_end, bm, nsub);
  if (it.nr == 0) return;       // no row in the group: both products skipped
  if (it.nr == 1)
    up_rows<T, 1>(it, x, wg, wu, hbuf, h, f, ldh, act, vec);
  else if (it.nr == 2)
    up_rows<T, 2>(it, x, wg, wu, hbuf, h, f, ldh, act, vec);
  else if (it.nr <= 4)
    up_rows<T, 4>(it, x, wg, wu, hbuf, h, f, ldh, act, vec);
  else
    up_rows<T, kRows>(it, x, wg, wu, hbuf, h, f, ldh, act, vec);
}

// ------------------------------------------------------------ down: out = hWd

// Zeros on an item's rows from `first` on, in this block's output columns.
template <typename T>
__device__ __forceinline__ void write_zeros(T* dst, int first, int rows, int h, int nc) {
  for (int o = first * kDnCols + threadIdx.x; o < rows * kDnCols; o += kThreads) {
    const int r = o / kDnCols, c = o % kDnCols;
    if (c < nc) dst[(size_t)r * h + c] = from_f<T>(0.0f);
  }
}

// The down kernel's work on an item of at most R rows in its group.
template <typename T, int R>
__device__ __forceinline__ void down_rows(const Item& it, const float* __restrict__ hbuf,
                                          const T* __restrict__ wd, T* __restrict__ dst, int h,
                                          int f, int ldh, int vec) {
  const int c0 = blockIdx.y * kDnCols;
  const int nc = min(kDnCols, h - c0);
  const int nk = (f + kDnK - 1) / kDnK;

  extern __shared__ __align__(16) unsigned char smem[];
  auto wstage = [&](int s) {
    return reinterpret_cast<T*>(smem + (s % kStages) * Smem<T>::kDnStage);
  };
  auto hstage = [&](int s) {
    return reinterpret_cast<float*>(smem + (s % kStages) * Smem<T>::kDnStage + Smem<T>::kDnW);
  };
  const T* dsrc = wd + (size_t)it.gid * f * h + c0;
  const float* hsrc = hbuf + (size_t)it.row0 * ldh;
  auto issue_w = [&](int s) {
    const int k0 = s * kDnK;
    stage_tile<kDnK, kDnCols>(wstage(s), dsrc + (size_t)k0 * h, h, f - k0, nc, vec);
  };
  auto issue_h = [&](int s) {  // h rows are 16-byte aligned (ldh ≡ 0 mod 4)
    const int k0 = s * kDnK;
    stage_tile<R, kDnK>(hstage(s), hsrc + k0, ldh, it.nr, f - k0, 16);
  };

  // The weights do not depend on the up kernel: start their stream before
  // waiting for it, then stage the matching h.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue_w(s);
    cp_async_commit();
  }
  griddep_wait();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < nk) issue_h(s);
  cp_async_commit();
  cp_async_wait<0>();

  const int cq = threadIdx.x % kDnQuads;  // columns 4·cq .. 4·cq + 3
  const int kg = threadIdx.x / kDnQuads;  // = the warp; stage rows 2·kg, 2·kg + 1
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < nk) {
      issue_w(i + kStages - 1);
      issue_h(i + kStages - 1);
    }
    cp_async_commit();
    const T* ws = wstage(i) + 2 * kg * kDnCols + 4 * cq;
    const float4 w0 = load4(ws), w1 = load4(ws + kDnCols);
    const float* hs = hstage(i) + 2 * kg;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 hv = load2(hs + r * kDnK);
      acc[r][0] = fmaf(hv.y, w1.x, fmaf(hv.x, w0.x, acc[r][0]));
      acc[r][1] = fmaf(hv.y, w1.y, fmaf(hv.x, w0.y, acc[r][1]));
      acc[r][2] = fmaf(hv.y, w1.z, fmaf(hv.x, w0.z, acc[r][2]));
      acc[r][3] = fmaf(hv.y, w1.w, fmaf(hv.x, w0.w, acc[r][3]));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused for the reduction

  float* red = reinterpret_cast<float*>(smem);  // [warp][row][column]
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(red + (kg * R + r) * kDnCols + 4 * cq) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int o = threadIdx.x; o < it.nr * kDnCols; o += kThreads) {
    const int r = o / kDnCols, c = o % kDnCols;
    if (c >= nc) continue;
    float v = red[r * kDnCols + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[(w * R + r) * kDnCols + c];
    dst[(size_t)r * h + c] = from_f<T>(v);
  }
  write_zeros(dst, it.nr, it.rows, h, nc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kDnBlocks)
ffn_down_kernel(const float* __restrict__ hbuf, const int32_t* __restrict__ tile_gid,
                const int32_t* __restrict__ group_end, const T* __restrict__ wd,
                T* __restrict__ out, int h, int f, int bm, int nsub, int ldh, int vec) {
  const Item it = item_rows(tile_gid, group_end, bm, nsub);
  const int c0 = blockIdx.y * kDnCols;
  T* dst = out + (size_t)it.row0 * h + c0;
  if (it.nr == 0) {  // no row in the group: zeros, which need nothing of the up kernel
    write_zeros(dst, 0, it.rows, h, min(kDnCols, h - c0));
  } else if (it.nr == 1) {
    down_rows<T, 1>(it, hbuf, wd, dst, h, f, ldh, vec);
  } else if (it.nr == 2) {
    down_rows<T, 2>(it, hbuf, wd, dst, h, f, ldh, vec);
  } else if (it.nr <= 4) {
    down_rows<T, 4>(it, hbuf, wd, dst, h, f, ldh, vec);
  } else {
    down_rows<T, kRows>(it, hbuf, wd, dst, h, f, ldh, vec);
  }
}

// ------------------------------------------------------------------ host

inline int ldh_of(int f) { return (f + 3) / 4 * 4; }

// The widest copy (16, 8 or 4 bytes; 0 for plain loads) that every base
// address and every row length in bytes allows.
inline int copy_width(const void* const* ptrs, int nptr, const long long* rows, int nrow) {
  for (int v = 16; v >= 4; v /= 2) {
    bool ok = true;
    for (int i = 0; i < nptr; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % v == 0;
    for (int i = 0; i < nrow; ++i) ok = ok && rows[i] % v == 0;
    if (ok) return v;
  }
  return 0;
}

template <typename T>
int launch(int act, const void* x, const void* tile_gid, const void* group_end, const void* wg,
           const void* wu, const void* wd, void* out, void* hbuf, int n, int h, int f, int bm,
           cudaStream_t stream) {
  const int nsub = (bm + kRows - 1) / kRows;
  const int items = n / bm * nsub;
  const int ldh = ldh_of(f);
  const void* up_ptrs[] = {x, wg, wu};
  const long long up_strides[] = {(long long)h * (long long)sizeof(T),
                               (long long)f * (long long)sizeof(T)};
  const int vec_up = copy_width(up_ptrs, 3, up_strides, 2);
  const long long dn_strides[] = {(long long)h * (long long)sizeof(T)};
  const int vec_dn = copy_width(&wd, 1, dn_strides, 1);

  auto up = ffn_up_kernel<T>;
  auto dn = ffn_down_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(up, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<T>::kUp);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<T>::kDn);
  if (err != cudaSuccess) return (int)err;

  dim3 grid_up(items, (f + kUpCols - 1) / kUpCols);
  ffn_up_kernel<T><<<grid_up, kThreads, Smem<T>::kUp, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(tile_gid),
      static_cast<const int32_t*>(group_end), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<float*>(hbuf), h, f, bm, nsub, ldh, act, vec_up);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items, (h + kDnCols - 1) / kDnCols);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Smem<T>::kDn;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dn, static_cast<const float*>(hbuf),
                           static_cast<const int32_t*>(tile_gid),
                           static_cast<const int32_t*>(group_end), static_cast<const T*>(wd),
                           static_cast<T*>(out), h, f, bm, nsub, ldh, vec_dn);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of scratch the launch needs: h[N, F], rows padded to a
// multiple of 4.
long long grouped_ffn_flat_scratch_floats(int n, int h, int f) {
  (void)h;
  return (long long)n * ldh_of(f);
}

// dtype: 0 = float32, 1 = bfloat16.  act: 0 = swiglu, 1 = geglu, 2 = relu_sq.
// Launches the up and the down kernel on `stream` without synchronising;
// returns the first error of the shared-memory opt-ins and the launches, 0 on
// success.
int grouped_ffn_flat(const void* x, const void* tile_gid, const void* group_end,
                     const void* wg, const void* wu, const void* wd, void* out,
                     void* scratch, int n, int h, int f, int bm, int dtype, int act,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || h <= 0 || f <= 0 || bm <= 0 || n % bm != 0) return (int)cudaErrorInvalidValue;
  if (act < kSwiglu || act > kReluSq) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(act, x, tile_gid, group_end, wg, wu, wd, out, scratch, n, h, f, bm, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(act, x, tile_gid, group_end, wg, wu, wd, out, scratch, n, h, f,
                                 bm, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
