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
// What bounds it: 12·rows·H·F f32 operations for dh, dx and the three weight
// gradients (412 GFLOP at olmoe-1b-7b's training geometry, 16 384 routed rows,
// H 2048, F 1024), far above the bytes (3.9 GB, 1.16 ms at 3.35 TB/s).  The
// products run on the tensor cores in 3xTF32, three TF32 products for each f32
// one: 3 × 412 GFLOP at 495 TFLOP/s is 2.50 ms (6.15 ms for the same work at
// the 67 TFLOP/s of f32 outside the tensor cores).  Recomputing g and u adds
// 4·rows·H·F that the bound does not count.
//
// Design: four launches of one warpgroup GEMM main loop on one stream, two
// warpgroups a block, one block an SM.
//   * Products: wgmma m64nNk8 TF32 with the 3xTF32 split (hi = rna(a),
//     lo = rna(a − hi); lo·hi + hi·lo first, then hi·hi), which keeps f32
//     accuracy, as K3 does (csrc/wkv6.cu).  wgmma, not mma.sync: a version
//     on mma.sync m16n8k8 (64 × 32 warp tiles, the same slices) took 11.4 ms
//     a call against this one's 9.7 (launch/time_k1b.py on an H100).  wgmma takes TF32 from shared memory
//     only K-major, so every product is arranged with a K-major B from shared
//     memory and its A from registers, which may come from a tile of either
//     layout:
//       dhᵀ = Wd·doutᵀ     A Wd (rows f),        B dout rows
//       gᵀ, uᵀ = Wgᵀ·xᵀ   A Wg, Wu ([c][f]),    B x rows
//       dx = dg·Wgᵀ        A dgᵀ ([f][r]),        B Wg rows ([c][f], k = f)
//       dWg = xᵀ·dg        A x ([r][c]),          B dgᵀ ([f][r], k = r)
//       dWdᵀ = doutᵀ·h     A dout ([r][c]),       B hᵀ ([f][r], k = r)
//     so the scratch h, du, dg is kept transposed, [F][N].  B is split into
//     TF32 parts once, in shared memory, by the threads that staged it (hi in
//     place, lo beside it), and A in registers by the warp that uses it.
//   * Accumulation: the tensor cores add each product into the accumulator
//     with truncation, which pulls a long sum toward zero.  So no reduction is
//     chained in the accumulator: every 32-deep slice of K is summed from zero
//     (the first wgmma of a slice does not read the accumulator) and added
//     into an f32 register total with round-to-nearest adds (reductions run
//     2048 deep over H, 2048 over F twice in dx, ~256 over a group's rows).
//   * Staging: a ring of 3-4 stages in dynamic shared memory (up to 196 KB a
//     block), filled with cp.async: 16-byte copies when the operands' base
//     addresses, row strides and tile offsets allow, else 4-byte copies;
//     zero-filled past every edge, so ragged H, F and group sizes are masked,
//     never padded.  B tiles are K-major with the 128-byte swizzle that wgmma
//     reads; A tiles keep their operand's layout, padded so that fragment
//     loads are free of bank conflicts.  While a slice's wgmma run, the
//     threads split the next stage's B.
//   (1) bwd_hidden_dh: dhᵀ for 256 columns of F × a row block of 64 rows of
//       one group, into scratch (dgᵀ's place).
//   (2) bwd_hidden_gu: gᵀ and uᵀ for 128 columns of F × a row block; the
//       epilogue reads dhᵀ and writes hᵀ, duᵀ and dgᵀ (over dhᵀ).
//   (3) bwd_dx: dx for a row block × 256 columns of H, K = F of dg then F of
//       du.
//       Row blocks are numbered group by group; a block past the last one
//       returns at once, so the work scales with the rows inside groups, not
//       with N.  Blocks are ordered in panels of 8 row blocks, the column
//       block changing every 8, so blocks in flight share their rows and
//       their group's weights in L2.
//   (4) bwd_weights: one 128 × 128 tile of dWg, dWu or dWdᵀ of one group, the
//       sum over the group's rows; a group's tiles run together, so its rows
//       stay in L2.
// No atomics: every output element is summed by one thread in a fixed order,
// so two calls agree bit for bit.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBK = 32;         // k per stage, and per partial sum
constexpr int kRowBM = 64;      // rows of a row block
constexpr int kPanel = 8;       // row blocks of a panel
constexpr int kSwRow = 32;      // floats of a swizzled B row (128 bytes)

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

// ------------------------------------------------------------ staging

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a ROWS × COLS tile, element (i, j) at src[i·ld + j], to dst[i·dld + j],
// zero where i >= rv or j >= cv.  `vec`: src and ld allow 16-byte copies.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(float* dst, int dld, const float* src, long long ld,
                                           int rv, int cv, bool vec) {
  if (vec) {
    constexpr int kCh = COLS / 4;
#pragma unroll
    for (int it = 0; it < ROWS * kCh / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int i = idx / kCh, j = idx % kCh * 4;
      const int bytes = i < rv ? 4 * min(max(cv - j, 0), 4) : 0;
      cp_async16(dst + i * dld + j, bytes ? src + i * ld + j : src, bytes);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < ROWS * COLS / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int i = idx / COLS, j = idx % COLS;
      const bool ok = i < rv && j < cv;
      cp_async4(dst + i * dld + j, ok ? src + i * ld + j : src, ok ? 4 : 0);
    }
  }
}

// Offset (floats) of element (row i, k) in a K-major tile of kSwRow-float rows
// with the 128-byte swizzle: the 16-byte chunk k / 4 of row i sits at chunk
// (k / 4) ^ (i % 8).
__device__ __forceinline__ int sw_off(int i, int k) {
  return i * kSwRow + ((((k >> 2) ^ i) & 7) << 2) + (k & 3);
}

// Stage a ROWS × kBK B tile (element (i, k) at src[i·ld + k]) in the swizzled
// layout, zero where i >= rv or k >= kv.
template <int ROWS>
__device__ __forceinline__ void stage_b(float* dst, const float* src, long long ld, int rv,
                                        int kv, bool vec) {
  if (vec) {
#pragma unroll
    for (int it = 0; it < ROWS * 8 / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int i = idx / 8, k = idx % 8 * 4;
      const int bytes = i < rv ? 4 * min(max(kv - k, 0), 4) : 0;
      cp_async16(dst + sw_off(i, k), bytes ? src + i * ld + k : src, bytes);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < ROWS * kBK / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int i = idx / kBK, k = idx % kBK;
      const bool ok = i < rv && k < kv;
      cp_async4(dst + sw_off(i, k), ok ? src + i * ld + k : src, ok ? 4 : 0);
    }
  }
}

// ------------------------------------------------------------ 3xTF32 split

// TF32 (10 mantissa bits) nearest to x, ties away from zero: the bits of
// cvt.rna.tf32.f32, with two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo with hi, lo TF32: the 3xTF32 split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Split the B tile that this thread staged with stage_b<ROWS> (the same
// elements: a thread's own cp.async copies are visible to it once waited for)
// into TF32 parts: hi in place, lo at the same offset of `lo`.
template <int ROWS>
__device__ __forceinline__ void split_b(float* t, float* lo, bool vec) {
  if (vec) {
#pragma unroll
    for (int it = 0; it < ROWS * 8 / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int o = sw_off(idx / 8, idx % 8 * 4);
      const float4 v = *reinterpret_cast<const float4*>(t + o);
      uint4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      *reinterpret_cast<uint4*>(t + o) = h;
      *reinterpret_cast<uint4*>(lo + o) = l;
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < ROWS * kBK / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int o = sw_off(idx / kBK, idx % kBK);
      uint32_t h, l;
      split_tf32(t[o], h, l);
      t[o] = __uint_as_float(h);
      lo[o] = __uint_as_float(l);
    }
  }
}

// ------------------------------------------------------------ wgmma

// Shared-memory descriptor of a K-major operand with the 128-byte swizzle:
// 8-row groups 1024 bytes apart, the tile 1024-byte aligned.
__device__ __forceinline__ uint64_t sw_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared memory written by this thread, then read by wgmma (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a·b for a 64 × N × 8 slice: A from registers (fragment of PTX's
// m64nNk8 .tf32 layout: warp w of the warpgroup holds rows 16w + gid and
// 16w + gid + 8, k tig and tig + 4), B from shared memory.  scale_d = 0
// ignores d's old value.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  if constexpr (N == 64) {
    wgmma_n64(d, a, b, scale_d);
  } else {
    wgmma_n128(d, a, b, scale_d);
  }
}

// A fragments (raw f32) of one warp for the four 8-deep k steps of a stage:
// rows r0 + (gid, gid + 8) of the warp's 16, k tig and tig + 4.  A K-contiguous
// tile ([m][ld], ld ≡ 4 mod 32) gives them with 4-byte loads; an
// MN-contiguous one ([k][ld], ld ≡ 8 mod 32) with 8-byte loads of rows
// 2·gid and 2·gid + 1, which stand for rows gid and gid + 8 (undone in the
// epilogue by a_row).
template <bool KC, int LD>
__device__ __forceinline__ void load_a(const float* s, int r0, float (&a)[4][4]) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const int k = 8 * kb + tig;
    if (KC) {
      a[kb][0] = s[(r0 + gid) * LD + k];
      a[kb][1] = s[(r0 + gid + 8) * LD + k];
      a[kb][2] = s[(r0 + gid) * LD + k + 4];
      a[kb][3] = s[(r0 + gid + 8) * LD + k + 4];
    } else {
      const float2 p = *reinterpret_cast<const float2*>(s + k * LD + r0 + 2 * gid);
      const float2 q = *reinterpret_cast<const float2*>(s + (k + 4) * LD + r0 + 2 * gid);
      a[kb][0] = p.x; a[kb][1] = p.y; a[kb][2] = q.x; a[kb][3] = q.y;
    }
  }
}

// Tile row of accumulator element e (0-3 of each 8-column group) of a warp
// whose 16 rows start at r0.
template <bool KC>
__device__ __forceinline__ int a_row(int r0, int e) {
  const int gid = threadIdx.x % 32 / 4;
  return KC ? r0 + gid + (e >= 2 ? 8 : 0) : r0 + 2 * gid + (e >= 2 ? 1 : 0);
}
// Column of accumulator element e of 8-column group j.
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x % 4) + (e & 1);
}

// The main loop of every launch.  Each warpgroup accumulates NA products of
// 64 × N over `ktiles` stages of kBK: total[j] += A_j·B.  A stage holds
// A_FLOATS of A (for the whole block) then B_ROWS rows of swizzled B; the
// warpgroup's B starts at row b_row.  `stage(kt, a_dst, b_dst)` issues stage
// kt's copies (B through stage_b<B_ROWS>, 16-byte copies where `vec`);
// `frags(a_src, a)` reads the warpgroup's A fragments of a stage, a[j][kb][4].
template <int NA, int N, int STAGES, int A_FLOATS, int B_ROWS, class Stage, class Frags>
__device__ __forceinline__ void wg_gemm(float* smem, int ktiles, bool vec, int b_row,
                                        const Stage& stage, const Frags& frags,
                                        float (&total)[NA][N / 2]) {
  constexpr int kB = B_ROWS * kSwRow;
  constexpr int kStage = A_FLOATS + kB;
  static_assert(A_FLOATS % 256 == 0 && kB % 256 == 0, "1024-byte aligned B tiles");
  float* lo_base = smem + STAGES * kStage;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) stage(s, smem + s * kStage, smem + s * kStage + A_FLOATS);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  if (ktiles > 0) split_b<B_ROWS>(smem + A_FLOATS, lo_base, vec);
  fence_async_shared();
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int nxt = kt + STAGES - 1;
    if (nxt < ktiles) {
      float* st = smem + (nxt % STAGES) * kStage;
      stage(nxt, st, st + A_FLOATS);
    }
    cp_async_commit();
    const float* as = smem + (kt % STAGES) * kStage;
    const float* bh = as + A_FLOATS + b_row * kSwRow;
    const float* bl = lo_base + (kt & 1) * kB + b_row * kSwRow;
    float raw[NA][4][4];
    frags(as, raw);
    uint32_t ah[NA][4][4], al[NA][4][4];
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(raw[j][kb][e], ah[j][kb][e], al[j][kb][e]);
    float part[NA][N / 2];
#pragma unroll
    for (int j = 0; j < NA; ++j) fence_regs(part[j]);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint64_t dh = sw_desc(bh + 8 * kb), dl = sw_desc(bl + 8 * kb);
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        wgmma<N>(part[j], al[j][kb], dh, kb > 0);
        wgmma<N>(part[j], ah[j][kb], dl, 1);
        wgmma<N>(part[j], ah[j][kb], dh, 1);
      }
    }
    wgmma_commit();
    // split the next stage's B while the tensor cores work
    if (kt + 1 < ktiles) {
      cp_async_wait<STAGES - 2>();
      split_b<B_ROWS>(smem + ((kt + 1) % STAGES) * kStage + A_FLOATS,
                      lo_base + ((kt + 1) & 1) * kB, vec);
      fence_async_shared();
    }
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      fence_regs(part[j]);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) total[j][e] = __fadd_rn(total[j][e], part[j][e]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

// Shared-memory bytes of a wg_gemm: the ring, two lo buffers of B and 1 KB
// to align the ring to 1024 bytes.
constexpr int gemm_bytes(int stages, int a_floats, int b_rows) {
  return (stages * (a_floats + b_rows * kSwRow) + 2 * b_rows * kSwRow) * 4 + 1024;
}

__device__ __forceinline__ float* aligned_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uintptr_t p = reinterpret_cast<uintptr_t>(smem_raw);
  return reinterpret_cast<float*>((p + 1023) & ~uintptr_t(1023));
}

// Store (v0, v1) at p[0], p[1] (columns col, col + 1 of a row of n), within n.
__device__ __forceinline__ void store2(float* p, int col, int n, float v0, float v1, bool pair) {
  if (pair && col + 1 < n) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < n) p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

// The group and rows of row block `b`: blocks are numbered group by group, each
// group's rows cut into blocks of kRowBM.  Returns false past the last block.
__device__ __forceinline__ bool row_block(int b, const int* __restrict__ start,
                                          const int* __restrict__ end, int s_n, int& grp,
                                          int& r0, int& nr) {
  int first = 0;
  for (int s = 0; s < s_n; ++s) {
    const int count = end[s] - start[s];
    const int blocks = count > 0 ? (count + kRowBM - 1) / kRowBM : 0;
    if (b < first + blocks) {
      grp = s;
      r0 = start[s] + (b - first) * kRowBM;
      nr = min(kRowBM, end[s] - r0);
      return true;
    }
    first += blocks;
  }
  return false;
}

// Row block and column block of a row-block launch: panels of kPanel row
// blocks, the column block changing every kPanel blocks.
__device__ __forceinline__ void panel_order(int col_blocks, int& rb, int& cb) {
  const int per_panel = kPanel * col_blocks;
  const int in = blockIdx.x % per_panel;
  rb = blockIdx.x / per_panel * kPanel + in % kPanel;
  cb = in / kPanel;
}

// A tiles of each launch (floats), with row strides ≡ 4 (K-contiguous) or 8
// (MN-contiguous) mod 32 words, and the ring depths.
constexpr int kLdDhA = kBK + 4;        // Wd rows [256][36]
constexpr int kDhA = 256 * kLdDhA;
constexpr int kLdGuA = 128 + 8;        // Wg, Wu [32][136] each
constexpr int kGuA = 2 * kBK * kLdGuA;
constexpr int kLdDxA = kRowBM + 8;     // dgᵀ or duᵀ [32][72]
constexpr int kDxA = kBK * kLdDxA;
constexpr int kLdWA = 128 + 8;         // x or dout [32][136]
constexpr int kWA = kBK * kLdWA;
constexpr int kStDh = 4, kStGu = 4, kStDx = 3, kStW = 4;
constexpr int kSmemDh = gemm_bytes(kStDh, kDhA, kRowBM);
constexpr int kSmemGu = gemm_bytes(kStGu, kGuA, kRowBM);
constexpr int kSmemDx = gemm_bytes(kStDx, kDxA, 256);
constexpr int kSmemW = gemm_bytes(kStW, kWA, 128);
static_assert(kSmemDh <= 232448 && kSmemGu <= 232448 && kSmemDx <= 232448 &&
                  kSmemW <= 232448,
              "shared memory of a block");

// (1) dhᵀ = Wd·doutᵀ for 256 columns of F (warpgroup w: 128, as two m64) and
// one row block, into dhts ([F][N]).
__global__ void __launch_bounds__(kThreads, 1)
    bwd_hidden_dh(const float* __restrict__ dout, const int* __restrict__ start,
                  const int* __restrict__ end, const float* __restrict__ wd,
                  float* __restrict__ dhts, int n, int h, int f, int s_n, bool vec) {
  int rb, cb, grp, r0, nr;
  panel_order((f + 255) / 256, rb, cb);
  if (!row_block(rb, start, end, s_n, grp, r0, nr)) return;
  float* smem = aligned_smem();
  const int f0 = cb * 256, wgr = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const float* a_src = wd + (size_t)grp * h * f + (size_t)f0 * h;   // Wd[f][c]: m = f, k = c
  const float* b_src = dout + (size_t)r0 * h;                       // dout[r][c]: n = r, k = c
  auto stage = [&](int kt, float* as, float* bs) {
    const int k0 = kt * kBK;
    stage_tile<256, kBK>(as, kLdDhA, a_src + k0, h, f - f0, h - k0, vec);
    stage_b<kRowBM>(bs, b_src + k0, h, nr, h - k0, vec);
  };
  auto frags = [&](const float* as, float (&a)[2][4][4]) {
    load_a<true, kLdDhA>(as, 128 * wgr + 16 * warp, a[0]);
    load_a<true, kLdDhA>(as, 128 * wgr + 64 + 16 * warp, a[1]);
  };
  float acc[2][32] = {};
  wg_gemm<2, 64, kStDh, kDhA, kRowBM>(smem, (h + kBK - 1) / kBK, vec, 0, stage, frags, acc);
  const bool pair = n % 2 == 0 && r0 % 2 == 0;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int fr = f0 + a_row<true>(128 * wgr + 64 * j + 16 * warp, e % 4);
      const int c = acc_col(e / 4, e % 4);
      if (fr < f) store2(dhts + (size_t)fr * n + r0 + c, c, nr, acc[j][e], acc[j][e + 1], pair);
    }
}

// (2) gᵀ and uᵀ = [Wg | Wu]ᵀ·xᵀ for 128 columns of F (warpgroup w: 64) and one
// row block; with dhᵀ from dgts, writes hᵀ, duᵀ and dgᵀ (over dhᵀ), [F][N].
__global__ void __launch_bounds__(kThreads, 1)
    bwd_hidden_gu(const float* __restrict__ x, const int* __restrict__ start,
                  const int* __restrict__ end, const float* __restrict__ wg,
                  const float* __restrict__ wu, float* __restrict__ hts,
                  float* __restrict__ duts, float* __restrict__ dgts, int n, int h, int f,
                  int s_n, int act, bool vec) {
  int rb, cb, grp, r0, nr;
  panel_order((f + 127) / 128, rb, cb);
  if (!row_block(rb, start, end, s_n, grp, r0, nr)) return;
  float* smem = aligned_smem();
  const int f0 = cb * 128, wgr = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const float* g_src = wg + (size_t)grp * h * f + f0;   // Wg[c][f]: k = c, m = f
  const float* u_src = wu + (size_t)grp * h * f + f0;
  const float* b_src = x + (size_t)r0 * h;              // x[r][c]: n = r, k = c
  constexpr int kHalf = kBK * kLdGuA;
  auto stage = [&](int kt, float* as, float* bs) {
    const int k0 = kt * kBK;
    stage_tile<kBK, 128>(as, kLdGuA, g_src + (size_t)k0 * f, f, h - k0, f - f0, vec);
    stage_tile<kBK, 128>(as + kHalf, kLdGuA, u_src + (size_t)k0 * f, f, h - k0, f - f0, vec);
    stage_b<kRowBM>(bs, b_src + k0, h, nr, h - k0, vec);
  };
  auto frags = [&](const float* as, float (&a)[2][4][4]) {
    load_a<false, kLdGuA>(as, 64 * wgr + 16 * warp, a[0]);
    load_a<false, kLdGuA>(as + kHalf, 64 * wgr + 16 * warp, a[1]);
  };
  float acc[2][32] = {};
  wg_gemm<2, 64, kStGu, kGuA, kRowBM>(smem, (h + kBK - 1) / kBK, vec, 0, stage, frags, acc);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int fr = f0 + a_row<false>(64 * wgr + 16 * warp, e % 4);
    const int c = acc_col(e / 4, e % 4);
    if (fr >= f || c >= nr) continue;
    float a, da;
    act_and_grad(act, acc[0][e], a, da);
    const float u = acc[1][e];
    const size_t o = (size_t)fr * n + r0 + c;
    const float dh = dgts[o];
    hts[o] = a * u;
    duts[o] = dh * a;
    dgts[o] = dh * u * da;
  }
}

// (3) dx = dg·Wgᵀ + du·Wuᵀ for one row block (both warpgroups) and 256
// columns of H (warpgroup w: 128).
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dx(const float* __restrict__ dgts, const float* __restrict__ duts,
           const int* __restrict__ start, const int* __restrict__ end,
           const float* __restrict__ wg, const float* __restrict__ wu, float* __restrict__ dx,
           int n, int h, int f, int s_n, bool vec) {
  int rb, cb, grp, r0, nr;
  panel_order((h + 255) / 256, rb, cb);
  if (!row_block(rb, start, end, s_n, grp, r0, nr)) return;
  float* smem = aligned_smem();
  const int c0 = cb * 256, wgr = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const size_t woff = (size_t)grp * h * f + (size_t)c0 * f;   // Wg[c][f]: n = c, k = f
  const int kt_half = (f + kBK - 1) / kBK;                     // K: F of dg, then F of du
  const bool vec_a = vec && r0 % 4 == 0;
  auto stage = [&](int kt, float* as, float* bs) {
    const bool second = kt >= kt_half;
    const int k0 = (second ? kt - kt_half : kt) * kBK;
    // dgᵀ[f][r]: k = f, m = r
    stage_tile<kBK, kRowBM>(as, kLdDxA, (second ? duts : dgts) + (size_t)k0 * n + r0, n,
                            f - k0, nr, vec_a);
    stage_b<256>(bs, (second ? wu : wg) + woff + k0, f, h - c0, f - k0, vec);
  };
  auto frags = [&](const float* as, float (&a)[1][4][4]) {
    load_a<false, kLdDxA>(as, 16 * warp, a[0]);
  };
  float acc[1][64] = {};
  wg_gemm<1, 128, kStDx, kDxA, 256>(smem, 2 * kt_half, vec, 128 * wgr, stage, frags, acc);
  const bool pair = h % 2 == 0;
#pragma unroll
  for (int e = 0; e < 64; e += 2) {
    const int r = a_row<false>(16 * warp, e % 4);
    const int c = c0 + 128 * wgr + acc_col(e / 4, e % 4);
    if (r < nr) store2(dx + (size_t)(r0 + r) * h + c, c, h, acc[0][e], acc[0][e + 1], pair);
  }
}

// (4) one 128 × 128 tile of dWg (z = 0), dWu (z = 1) or dWdᵀ (z = 2) of group
// blockIdx.z: rows c of H (warpgroup w: 64), columns f of F, summed over the
// group's rows in row order.
__global__ void __launch_bounds__(kThreads, 1)
    bwd_weights(const float* __restrict__ x, const float* __restrict__ dout,
                const float* __restrict__ hts, const float* __restrict__ duts,
                const float* __restrict__ dgts, const int* __restrict__ start,
                const int* __restrict__ end, float* __restrict__ dwg, float* __restrict__ dwu,
                float* __restrict__ dwd, int n, int h, int f, bool vec) {
  const int grp = blockIdx.z, z = blockIdx.y;
  const int f_tiles = (f + 127) / 128;
  const int c0 = blockIdx.x / f_tiles * 128, f0 = blockIdx.x % f_tiles * 128;
  const int s0 = start[grp], count = max(end[grp] - s0, 0);
  float* smem = aligned_smem();
  const int wgr = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  // A (k = r, m = c): x[r][c] or dout[r][c]; B (n = f, k = r): dgᵀ, duᵀ or hᵀ
  const float* a_src = (z == 2 ? dout : x) + (size_t)s0 * h + c0;
  const float* b_src = (z == 2 ? hts : z == 0 ? dgts : duts) + (size_t)f0 * n + s0;
  const bool vec_b = vec && s0 % 4 == 0;
  auto stage = [&](int kt, float* as, float* bs) {
    const int k0 = kt * kBK;
    stage_tile<kBK, 128>(as, kLdWA, a_src + (size_t)k0 * h, h, count - k0, h - c0, vec);
    stage_b<128>(bs, b_src + k0, n, f - f0, count - k0, vec_b);
  };
  auto frags = [&](const float* as, float (&a)[1][4][4]) {
    load_a<false, kLdWA>(as, 64 * wgr + 16 * warp, a[0]);
  };
  float acc[1][64] = {};
  wg_gemm<1, 128, kStW, kWA, 128>(smem, (count + kBK - 1) / kBK, vec_b, 0, stage, frags, acc);
  if (z < 2) {
    float* out = (z == 0 ? dwg : dwu) + (size_t)grp * h * f;
    const bool pair = f % 2 == 0;
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int c = c0 + a_row<false>(64 * wgr + 16 * warp, e % 4);
      const int fc = f0 + acc_col(e / 4, e % 4);
      if (c < h) store2(out + (size_t)c * f + fc, fc, f, acc[0][e], acc[0][e + 1], pair);
    }
  } else {
    // dWd[f][c]: elements e and e + 2 are rows c and c + 1 of one column f
    float* out = dwd + (size_t)grp * h * f;
    const bool pair = h % 2 == 0;
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      if (e % 4 >= 2) continue;
      const int c = c0 + a_row<false>(64 * wgr + 16 * warp, e % 4);
      const int fc = f0 + acc_col(e / 4, e % 4);
      if (fc < f) store2(out + (size_t)fc * h + c, c, h, acc[0][e], acc[0][e + 2], pair);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// f32 elements of scratch a call needs: hᵀ, duᵀ and dgᵀ, each [F, N] (dhᵀ
// lives in dgᵀ's place until dgᵀ overwrites it).
long long grouped_ffn_flat_bwd_scratch_floats(int n, int f) { return 3LL * n * f; }

// x, dout [N, H]; group_start, group_end int32[S]; wg, wu [S, H, F], wd [S, F, H];
// dx [N, H] zeroed by the caller; dwg, dwu [S, H, F], dwd [S, F, H] written whole.
// act: 0 = swiglu, 1 = geglu, 2 = relu_sq.  Launches the four kernels on
// `stream` without synchronising; returns the first launch error, 0 on success.
int grouped_ffn_flat_bwd(const float* x, const float* dout, const int* group_start,
                         const int* group_end, const float* wg, const float* wu,
                         const float* wd, float* dx, float* dwg, float* dwu, float* dwd,
                         float* scratch, int n, int h, int f, int s, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || h <= 0 || f <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  if (act < kSwiglu || act > kReluSq) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const struct { const void* fn; int bytes; } attrs[] = {
        {(const void*)bwd_hidden_dh, kSmemDh}, {(const void*)bwd_hidden_gu, kSmemGu},
        {(const void*)bwd_dx, kSmemDx}, {(const void*)bwd_weights, kSmemW}};
    for (const auto& a : attrs) {
      const cudaError_t err =
          cudaFuncSetAttribute(a.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.bytes);
      if (err != cudaSuccess) return (int)err;
    }
    opted_in = true;
  }
  float* hts = scratch;
  float* duts = scratch + (size_t)n * f;
  float* dgts = scratch + 2 * (size_t)n * f;
  // 16-byte copies: every base address aligned and every row stride a
  // multiple of 4 floats (tiles that start at a row block or group start
  // check that start themselves)
  const bool vec = n % 4 == 0 && h % 4 == 0 && f % 4 == 0 && aligned16(x) && aligned16(dout) &&
                   aligned16(wg) && aligned16(wu) && aligned16(wd) && aligned16(scratch);
  // row blocks: Σ_g ceil(count_g / 64) <= N / 64 + S; blocks past the last return
  const int row_blocks = (n + kRowBM - 1) / kRowBM + s;
  const int panels = (row_blocks + kPanel - 1) / kPanel;
  const int f256 = (f + 255) / 256, f128 = (f + 127) / 128, h256 = (h + 255) / 256;
  bwd_hidden_dh<<<panels * kPanel * f256, kThreads, kSmemDh, st>>>(
      dout, group_start, group_end, wd, dgts, n, h, f, s, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_hidden_gu<<<panels * kPanel * f128, kThreads, kSmemGu, st>>>(
      x, group_start, group_end, wg, wu, hts, duts, dgts, n, h, f, s, act, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dx<<<panels * kPanel * h256, kThreads, kSmemDx, st>>>(
      dgts, duts, group_start, group_end, wg, wu, dx, n, h, f, s, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((h + 127) / 128) * f128;
  bwd_weights<<<dim3(tiles, 3, s), kThreads, kSmemW, st>>>(
      x, dout, hts, duts, dgts, group_start, group_end, dwg, dwu, dwd, n, h, f, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
