// K3b on Hopper: the gradient of K3, the RWKV-6 (Finch) recurrence over
// [BH, T, D] from a zero state (csrc/wkv6.cu).
//
// It replaces no Pallas kernel: the reference has no backward of
// `wkv6_pallas` and trains with `jax.grad` of its plain recurrence
// (`wkv6_chunk_ref`, src/repro/kernels/ref.py, a lax.scan over T, reached
// through `ops.wkv6(..., impl="ref")`).  The port trains on the card, where
// K3 is a ctypes launch autograd cannot see through, so its gradient is this
// kernel.  For every (batch·head) row, with w_t = exp(lw_t), the forward
//
//     o_t = q_t (S_{t-1} + u ⊙ k_t v_tᵀ),   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,   S_0 = 0,
//
// and the output's gradient dO, it computes, in f32:
//
//   forward scan (re-forms S; nothing of the forward is saved but its inputs):
//     dq_t = S_{t-1}·dO_t + u ⊙ k_t (v_t·dO_t)
//     p_t  = q_t ⊙ (S_{t-1}·dO_t)                     (kept in dlw for now)
//     du   = Σ_t q_t ⊙ k_t (v_t·dO_t)
//   reverse scan (G_t = ∂L/∂S_t, G_{T-1} = 0):
//     dk_t = G_t·v_t + u ⊙ q_t (v_t·dO_t)
//     dv_t = G_tᵀ·k_t + dO_t (Σ_i u_i q_ti k_ti)
//     r_t  = k_t ⊙ (G_t·v_t)
//     dlw_t = (dlw_{t+1} + p_{t+1}) − r_t             (p_T = 0, dlw_T = 0)
//     G_{t-1} = diag(w_t) G_t + q_t dO_tᵀ
//
// dlw needs no second state: with c_t = Σ_{i≤t} lw_i, ∂L/∂c_m = p_{m+1} − r_m,
// and dlw_t = Σ_{m≥t} ∂L/∂c_m is kept as one running sum from the end, so the
// running value is dlw itself and no large partial sums cancel.
//
// What bounds it: the function reads q, k, v, lw, dO (and u) once and writes
// dq, dk, dv, dlw (and du) once, 9·BH·T·D f32 elements, against 12·D² + 24·D
// operations a step and row.  At rwkv6-7b's training geometry (BH 256, T 512,
// D 64) that is 302 MB and 6.64 GFLOP: 0.090 ms of bytes at 3.35 TB/s, and
// 0.040 ms of operations as 3xTF32 on the tensor cores (three TF32 products
// for each f32 one, 495 TFLOP/s), so the bound is bytes (in f32 FMAs the
// operations alone would take 0.099 ms).  A step-by-step form is bound by the
// latency of 2·T dependent steps a row with only BH rows in flight.  This
// kernel walks 2·T/16 dependent sub-chunks a row and is bound by what each
// SM issues: the mma.sync products and their operands' reads from shared
// memory take the largest part, then the decay factors' ex2, the dot
// products of a and the score, the copies in and the stores out.  It also
// moves ~1.8× the bytes of the bound: the reverse scan reads the inputs
// again, and p goes out and back through dlw.
//
// Design: K3's sub-chunk algebra, carried backward.  A row is walked in
// sub-chunks of kTau = 16 steps, with c the cumulative log-decays in log2
// units local to the sub-chunk (c_{t-1} before step t, c_τ after its last),
// every exponent ≤ 0.  With S_0 the state at a sub-chunk's start, G the
// state's gradient at its end and a[t][s] = dO_t·v_s (s ≤ t):
//
//   dq  = 2^c_{t-1} ⊙ (dO·S_0ᵀ) + Σ_{s<t} a[t,s] k_s ⊙ 2^(c_{t-1} − c_s) + u ⊙ k_t a[t,t]
//   S  ← diag(2^c_τ) S_0 + k̂ᵀ·v,          k̂_s = k_s ⊙ 2^(c_τ − c_s)
//   dk  = 2^(c_τ − c_s) ⊙ (v·Gᵀ) + Σ_{t>s} a[t,s] q_t ⊙ 2^(c_{t-1} − c_s) + u ⊙ q_s a[s,s]
//   dv  = k̂·G + scoreᵀ·dO                  (K3's score, its bonus on the diagonal)
//   G  ← diag(2^c_τ) G + q̂ᵀ·dO,            q̂_t = q_t ⊙ 2^c_{t-1}
//
// The intra terms carry per-channel decays that do not factor into one
// product with bounded exponents; each is split at a step m between s and
// t − 1 into two factors ≤ 1, as K3 splits its score: m at the end of s's
// 4-step block when t lies in a later block, else at the block's second step;
// s = t − 1 takes no decay.  ref.wkv6_bwd_subchunk_ref repeats this
// arithmetic in PyTorch.
//
//   * One block of 8 warps a row, a forward scan then a reverse scan.  The
//     reverse scan needs p at every step for dlw; a block that hands p to
//     itself through dlw needs no scratch and no second launch, and at BH
//     256 the rows already fill the card's 132 SMs, two blocks each, in one
//     wave.  Forward and reverse scans as separate blocks would need p and
//     r both kept until a second pass, in memory the C entry does not have.
//   * A sub-chunk, forward: (1) the stage is in; the next sub-chunk's
//     copies are issued into the other of two stage buffers; a = dO·vᵀ and
//     the decays' scan (one thread a channel, in step order) run side by
//     side; (2) each warp forms the decay factors of its own 8 channels
//     and computes dq for them, then updates its own rows of S.  Reverse:
//     (1) as forward, with p read back from dlw; (2) q̂, k̂ and the factors;
//     (3) K3's score, and dk with r; (4) dv, then each warp updates its own
//     columns of G, and one thread a channel carries dlw.  __syncthreads
//     separates the stages: 2 a sub-chunk forward, 4 reverse.
//   * Staging: cp.async copies q, k, v, dO straight into padded rows (16
//     bytes a copy, zeros past T), lw as it lies; where D is not a multiple
//     of 4 or an input is not 16-byte aligned, they are loaded plainly.
//   * Products on the tensor cores: mma.sync m16n8k8 TF32 with the 3xTF32
//     split (hi = rna(x), lo = rna(x − hi); lo·hi + hi·lo + hi·hi, f32
//     accumulation), which keeps f32 accuracy where one TF32 pass would not:
//     dO·S_0ᵀ and v·Gᵀ (M = 16 steps, a warp an 8-channel tile of the
//     output), k̂·G and scoreᵀ·dO, and the two state updates (M = 16
//     channels).  Products over D rotate four accumulators by k tile.
//   * S and G live in shared memory ([i][j], rows ≡ 8 (mod 32) words apart,
//     so the fragment reads and updates are free of bank conflicts) and
//     never in an mma accumulator across sub-chunks: the tensor cores add
//     with truncation, which would pull a long-lived sum toward zero.  Each
//     sub-chunk's update is accumulated from zero and added to the decayed
//     state with one fmaf.
//   * a and the score: each entry a dot product of 4 channels a lane,
//     reduced over 16 lanes in a fixed order.  The intra terms, the decays
//     and the bonus run on the FP32 cores in the threads that hold the
//     entries of dq (or dk) in their accumulators; dlw and du take one
//     thread a channel, in step order.
//   * T need not be a multiple of 16 and may be below it: one kernel for
//     every T, steps past T are zeros with lw = 0, channels past D likewise,
//     so they add nothing to any sum.
//   * Every sum has a fixed order (no atomics): results repeat bit for bit.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kTau = 16;           // steps per sub-chunk
constexpr int kBlocks = 10;        // 4 × 4 blocks of a sub-chunk's lower triangle
constexpr int kOff = 6;            // of which strictly below the diagonal
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kAS = 20;            // row stride of a = dO·vᵀ
constexpr int kSS = 24;            // row stride of the score
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Layout {
  static constexpr int W = DP + 8;               // padded row stride, ≡ 8 (mod 32) words
  static constexpr int kIn = 4 * kTau * W;       // a stage buffer: q, k, v, dO rows
  static constexpr int kLw = kTau * DP;          // and lw as copied, kTau·d floats
  // padded rows: c, q̂, k̂, kk (16 each), k2 (8), qq (24), q2 (8), r (16)
  static constexpr int kRows = 4 * kTau + kTau / 2 + 4 * kOff + kTau / 2 + kTau;
  static constexpr int kState = DP * W;
  static constexpr size_t kFloats = 2 * (kIn + kLw) + (size_t)kRows * W + kState +
                                    kTau * kAS + kTau * kSS + 2 * DP;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// 2^x for x ≤ 0 (the MUFU unit; about 2 ulp, subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// 16 bytes, or zeros where src_bytes is 0 (nothing is read then)
__device__ __forceinline__ void cp_async16z(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copy n contiguous floats of global memory into shared memory with the
// widest copies that the source address allows.  Issued by every thread.
__device__ __forceinline__ void stage_copy(float* dst, const float* src, int n, int tid) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  int done = 0;
  if ((addr & 15) == 0) {
    done = n & ~3;
    for (int e = 4 * tid; e < done; e += 4 * kThreads) cp_async16(dst + e, src + e);
  }
  for (int e = done + tid; e < n; e += kThreads) cp_async4(dst + e, src + e);
}

// TF32 nearest to x, ties away from zero: the bits of cvt.rna.tf32.f32.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], h[e], l[e]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32: the small terms first, then hi·hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// d += a·b in 3xTF32 with b already split.
__device__ __forceinline__ void mma3s(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                      const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 ex2(float4 a, float4 b) {  // 2^(a − b)
  return make_float4(ex2(a.x - b.x), ex2(a.y - b.y), ex2(a.z - b.z), ex2(a.w - b.w));
}
__device__ __forceinline__ float dot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 fma2(float a, float2 b, float2 c) {
  return make_float2(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y));
}
__device__ __forceinline__ float2 fma2(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y));
}
__device__ __forceinline__ float2 ex2(float2 a, float2 b) {  // 2^(a − b)
  return make_float2(ex2(a.x - b.x), ex2(a.y - b.y));
}

// Channels ic and ic + 1 of an output row (those below d), at out[off] on.
__device__ __forceinline__ void store2(float* out, size_t off, int ic, int d, float2 x) {
  float* p = out + off;
  if (ic + 1 < d && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = x;
  } else {
    if (ic < d) p[0] = x.x;
    if (ic + 1 < d) p[1] = x.y;
  }
}

// One step of a reduce-scatter over 16 lanes: lane l keeps the half of its
// M-wide entries whose bit M matches its own, adding lane l ^ M's copy.
template <int M>
__device__ __forceinline__ void reduce_scatter(float (&pr)[16], bool up) {
#pragma unroll
  for (int e = 0; e < M; ++e) {
    const float send = up ? pr[e] : pr[e + M];
    const float keep = up ? pr[e + M] : pr[e];
    pr[e] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Fragment coordinates (PTX m16n8k8, lane = 4·gid + tig): A a0 (gid, tig),
// a1 (gid+8, tig), a2 (gid, tig+4), a3 (gid+8, tig+4); B b0 (k tig, n gid),
// b1 (k tig+4, n gid); C c0 (gid, 2tig), c1 (gid, 2tig+1), c2 (gid+8, 2tig),
// c3 (gid+8, 2tig+1).
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
wkv6_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ dout,
                float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                float* dlw, float* __restrict__ du, int t_len, int d) {
  using L = Layout<DP>;
  constexpr int W = L::W;
  constexpr int NG = DP / 4;                            // 4-channel groups
  constexpr int NN = DP / 8;                            // 8-wide channel tiles
  constexpr int NPW = NN / kWarps;                      // of them a warp owns (1 or 2)
  constexpr int NM = DP / 16;                           // 16-wide channel tiles

  extern __shared__ __align__(16) float sm[];
  float* in = sm;                      // two stage buffers of q, k, v, dO rows
  float* lwb = in + 2 * L::kIn;        // two of lw, kTau·d floats as copied
  float* cc = lwb + 2 * L::kLw;        // c_t, log2 units
  float* qh = cc + kTau * W;           // q̂ = q ⊙ 2^c_{t-1} (reverse scan)
  float* kh = qh + kTau * W;           // k̂ = k ⊙ 2^(c_τ − c)
  // the intra terms' decay factors, every exponent ≤ 0: with r the last step
  // of s's 4-step block, kk_s = k_s ⊙ 2^(c_r − c_s) and, for each block sb
  // below t's, qq_t = q_t ⊙ 2^(c_{t-1} − c_r); within a block of 4 and m its
  // second step, k2_s = k_s ⊙ 2^(c_m − c_s) for s ≤ m, q2_t = q_t ⊙
  // 2^(c_{t-1} − c_m) for t ≥ m + 1
  float* kk = kh + kTau * W;
  float* k2 = kk + kTau * W;           // [4-step block][2]
  float* qq = k2 + kTau / 2 * W;       // [block pair][4] (reverse scan)
  float* q2 = qq + 4 * kOff * W;       // [4-step block][2] (reverse scan)
  float* xr = q2 + kTau / 2 * W;       // r = k ⊙ dk's part without the bonus
  float* st = xr + kTau * W;           // S (forward scan), then G (reverse), [i][j]
  float* am = st + L::kState;          // a[t][s] = dO_t·v_s, s ≤ t
  float* sc = am + kTau * kAS;         // the score [t][s], zero above the diagonal
  float* ect = sc + kTau * kSS;        // 2^c_τ
  float* uf = ect + DP;                // u

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row = blockIdx.x;
  const size_t base = (size_t)row * t_len * d;
  const int nsub = (t_len + kTau - 1) / kTau;
  // rows of q, k, v, dO start 16-byte aligned: they are copied into padded
  // rows with cp.async; else they are loaded plainly
  const uintptr_t any_addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                             reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  const bool fast = d % 4 == 0 && (any_addr & 15) == 0;

  for (int i = tid; i < DP; i += kThreads) uf[i] = i < d ? u[(size_t)row * d + i] : 0.0f;
  for (int e = tid; e < kTau * kSS; e += kThreads) sc[e] = 0.0f;
  for (int e = tid; e < L::kState; e += kThreads) st[e] = 0.0f;
  for (int e = tid; e < 2 * L::kIn; e += kThreads) in[e] = 0.0f;   // channels past d stay 0
  __syncthreads();

  // Copy sub-chunk ci into stage buffer b: q, k, v, dO into padded rows
  // (zeros past T), lw as it lies.  Then commit the copies as one group.
  auto issue = [&](int ci, int b) {
    const size_t off = base + (size_t)ci * kTau * d;
    const int n = min(kTau, t_len - ci * kTau);
    float* dst = in + b * L::kIn;
    auto src = [&](int a) { return a == 0 ? q : a == 1 ? k : a == 2 ? v : dout; };
    if (fast) {
      for (int e = tid; e < 4 * kTau * NG; e += kThreads) {   // 16-byte pieces
        const int a = e / (kTau * NG), t = e / NG % kTau, c = 4 * (e % NG);
        if (c < d)
          cp_async16z(dst + a * kTau * W + t * W + c, src(a) + off + (t < n ? t * d + c : 0),
                      t < n ? 16 : 0);
      }
    } else {
      for (int e = tid; e < 4 * kTau * DP; e += kThreads) {
        const int a = e / (kTau * DP), t = e / DP % kTau, c = e % DP;
        dst[a * kTau * W + t * W + c] = t < n && c < d ? src(a)[off + (size_t)t * d + c] : 0.0f;
      }
    }
    stage_copy(lwb + b * L::kLw, lw + off, n * d, tid);
    cp_async_commit();
  };
  float *sq, *sk, *sv, *sd;   // q, k, v, dO of the sub-chunk in hand, [t][i]
  auto use = [&](int b) {
    sq = in + b * L::kIn;
    sk = sq + kTau * W;
    sv = sk + kTau * W;
    sd = sv + kTau * W;
  };
  auto row4 = [&](const float* a, int r, int c0) {
    return *reinterpret_cast<const float4*>(a + r * W + c0);
  };
  auto put4 = [&](float* a, int r, int c0, float4 x) {
    *reinterpret_cast<float4*>(a + r * W + c0) = x;
  };
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // The decays of the sub-chunk in buffer b, one thread a channel, summed
  // in step order (lw = 0 past n steps and d channels).
  auto scan = [&](int n, int b) {
    if (tid >= kThreads - DP) {
      const int ch = tid - (kThreads - DP);
      const float* sl = lwb + b * L::kLw;
      float l2[kTau];   // loaded before the stores to cc, which might alias them
#pragma unroll
      for (int t = 0; t < kTau; ++t) l2[t] = ch < d && t < n ? __fmul_rn(sl[t * d + ch], kLog2e) : 0.0f;
      float run = 0.0f;
#pragma unroll
      for (int t = 0; t < kTau; ++t) {
        run = __fadd_rn(run, l2[t]);
        cc[t * W + ch] = run;
      }
    }
  };

  // a = dO·vᵀ (mode 0) or K3's score (mode 1) over the 4 × 4 blocks of the
  // lower triangle: each entry a dot product spread over NG lanes of 4
  // channels, reduced in a fixed order so that lane g of 16 ends with entry g.
  auto lower_blocks = [&](int mode) {
    for (int item = tid; item < kBlocks * NG; item += kThreads) {
      const int blk = item / NG, g = item % NG, c0 = 4 * g;
      float pr[16];
      int tb, sb;
      if (blk < kOff) {
        tb = 1 + (blk >= 1) + (blk >= 3);
        sb = blk - tb * (tb - 1) / 2;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 x = mode ? row4(qq, 4 * blk + a, c0) : row4(sd, 4 * tb + a, c0);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            pr[4 * a + b] = dot(x, mode ? row4(kk, 4 * sb + b, c0) : row4(sv, 4 * sb + b, c0));
        }
      } else {
        tb = sb = blk - kOff;
#pragma unroll
        for (int e = 0; e < 16; ++e) pr[e] = 0.0f;
        if (mode) {
          const float4 w = row4(uf, 0, c0);
          float4 x[4], y[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            x[a] = row4(sq, 4 * tb + a, c0);
            y[a] = row4(sk, 4 * tb + a, c0);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) pr[5 * a] = dot(x[a] * w, y[a]);
          pr[4] = dot(x[1], y[0]);
          pr[14] = dot(x[3], y[2]);
#pragma unroll
          for (int a = 2; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
              pr[4 * a + b] = dot(row4(q2, 2 * tb + a - 2, c0), row4(k2, 2 * tb + b, c0));
        } else {
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b <= a; ++b)
              pr[4 * a + b] = dot(row4(sd, 4 * tb + a, c0), row4(sv, 4 * tb + b, c0));
        }
      }
      // lanes g and g ^ 16 (NG = 32) hold the same entries' other channels
      if constexpr (NG == 32) {
#pragma unroll
        for (int e = 0; e < 16; ++e) pr[e] += __shfl_xor_sync(0xffffffffu, pr[e], 16);
      }
      reduce_scatter<8>(pr, g & 8);
      reduce_scatter<4>(pr, g & 4);
      reduce_scatter<2>(pr, g & 2);
      reduce_scatter<1>(pr, g & 1);
      if (g < 16) {
        const int t = 4 * tb + g / 4, s = 4 * sb + g % 4;
        if (mode) sc[t * kSS + s] = pr[0];
        else am[t * kAS + s] = pr[0];
      }
    }
  };

  // acc (+)= rows(16 × DP)·stᵀ: out[t][i] = Σ_j rows[t][j]·st[i][j] for the
  // warp's i tiles, the k index permuted within each 8-wide block (tig ↔
  // j = 2·tig, tig + 4 ↔ 2·tig + 1) in both operands, so each reads a float2
  auto rows_by_state = [&](const float* rows, float (&acc)[NPW][4][4]) {
#pragma unroll
    for (int kb = 0; kb < NN; ++kb) {
      const float2 r0 = ld2(rows + gid * W + 8 * kb + 2 * tig);
      const float2 r1 = ld2(rows + (gid + 8) * W + 8 * kb + 2 * tig);
      const float a[4] = {r0.x, r1.x, r0.y, r1.y};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
#pragma unroll
      for (int n = 0; n < NPW; ++n) {
        const float2 b = ld2(st + (8 * (warp * NPW + n) + gid) * W + 8 * kb + 2 * tig);
        mma3(acc[n][kb & 3], ah, al, b.x, b.y);
      }
    }
  };
  // the sum of a tile's four accumulators, entries h and h + 1
  auto total2 = [](const float (&acc)[4][4], int h) {
    return make_float2((acc[0][h] + acc[1][h]) + (acc[2][h] + acc[3][h]),
                       (acc[0][h + 1] + acc[1][h + 1]) + (acc[2][h + 1] + acc[3][h + 1]));
  };

  // st[i][j] ← fmaf(st[i][j], 2^c_τ,i, U[i][j]) for the warp's own tiles of
  // one channel axis, the update accumulated from zero: U = Σ_s a[s]ᵀ b[s]
  // with M = 16 channels of a (all of them), N = 8 channels of b (the
  // warp's own tiles).  rows_b: b's channels are the state's rows i (the
  // forward scan, whose warps own the rows of S they read in dO·Sᵀ), else
  // its columns j (the reverse scan, whose warps own the columns of G they
  // read in k̂·G).
  auto update_state = [&](const float* a, const float* b, bool rows_b) {
    float upd[NM][NPW][4] = {};
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      uint32_t bh[NPW][2], bl[NPW][2];
#pragma unroll
      for (int n = 0; n < NPW; ++n) {
        const float* c = b + (8 * kb + tig) * W + 8 * (warp * NPW + n) + gid;
        split_tf32(c[0], bh[n][0], bl[n][0]);
        split_tf32(c[4 * W], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int mt = 0; mt < NM; ++mt) {
        const float* r0 = a + (8 * kb + tig) * W + 16 * mt + gid;
        const float* r1 = r0 + 4 * W;
        const float x[4] = {r0[0], r0[8], r1[0], r1[8]};
        uint32_t ah[4], al[4];
        split4(x, ah, al);
#pragma unroll
        for (int n = 0; n < NPW; ++n) mma3s(upd[mt][n], ah, al, bh[n], bl[n]);
      }
    }
    __syncwarp();   // every lane has read the warp's part of the state
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int n = 0; n < NPW; ++n) {
        const int m = 16 * mt + gid, c = 8 * (warp * NPW + n) + 2 * tig;
        if (rows_b) {   // U[m][c] is Sᵀ's: S[c][m]
          const float e0 = ect[c], e1 = ect[c + 1];
          float* s0 = st + c * W + m;
          s0[0] = fmaf(s0[0], e0, upd[mt][n][0]);
          s0[W] = fmaf(s0[W], e1, upd[mt][n][1]);
          s0[8] = fmaf(s0[8], e0, upd[mt][n][2]);
          s0[W + 8] = fmaf(s0[W + 8], e1, upd[mt][n][3]);
        } else {        // U[m][c] is G's
          const float e0 = ect[m], e1 = ect[m + 8];
          float2* s0 = reinterpret_cast<float2*>(st + m * W + c);
          float2* s1 = reinterpret_cast<float2*>(st + (m + 8) * W + c);
          const float2 x0 = *s0, x1 = *s1;
          *s0 = make_float2(fmaf(x0.x, e0, upd[mt][n][0]), fmaf(x0.y, e0, upd[mt][n][1]));
          *s1 = make_float2(fmaf(x1.x, e1, upd[mt][n][2]), fmaf(x1.y, e1, upd[mt][n][3]));
        }
      }
  };

  // ================= forward scan: dq, p (into dlw), du =================
  float dus = 0.0f;   // du of channel tid (tid < DP)
  int buf = 0;        // the stage buffer of the sub-chunk in hand
  issue(0, 0);
  for (int ci = 0; ci < nsub; ++ci, buf ^= 1) {
    const int n = min(kTau, t_len - ci * kTau);
    cp_async_wait_all();
    __syncthreads();   // buffer buf holds ci; the other one and the rest are free
    use(buf);
    issue(ci + 1 < nsub ? ci + 1 : nsub - 1, buf ^ 1);   // the reverse scan starts with the last
    lower_blocks(0);   // a = dO·vᵀ
    scan(n, buf);
    __syncthreads();

    // k̂, kk, k2 and 2^c_τ of the warp's own columns, a lane a (step, 4
    // channels): the warp alone reads them
#pragma unroll
    for (int nt = 0; nt < NPW; ++nt) {
      const int t = lane / 2, c0 = 8 * (warp * NPW + nt) + 4 * (lane % 2), tb = t / 4;
      const float4 y = row4(sk, t, c0), f = row4(cc, t, c0), last = row4(cc, kTau - 1, c0);
      put4(kh, t, c0, y * ex2(last, f));
      put4(kk, t, c0, y * ex2(row4(cc, t | 3, c0), f));
      if (t % 4 < 2) put4(k2, 2 * tb + t % 4, c0, y * ex2(row4(cc, 4 * tb + 1, c0), f));
      if (t == 0) put4(ect, 0, c0, ex2(last, zero4));
    }
    __syncwarp();

    // dq = 2^c_{t-1} ⊙ (dO·Sᵀ) + intra + bonus, and p, from the accumulators;
    // then the warp's rows of S ← diag(2^c_τ) S + k̂ᵀ·v
    {
      float acc[NPW][4][4] = {};
      rows_by_state(sd, acc);
      const size_t off = base + (size_t)ci * kTau * d;
#pragma unroll
      for (int nt = 0; nt < NPW; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = gid + 8 * hr, ic = 8 * (warp * NPW + nt) + 2 * tig;
          const int tb = t >> 2, tm = t & 3;
          const float2 cp = t ? ld2(cc + (t - 1) * W + ic) : make_float2(0.0f, 0.0f);
          // Σ_{s<t} a[t,s] k_s ⊙ 2^(c_{t-1} − c_s), split at block ends, then at m
          float2 x = make_float2(0.0f, 0.0f);
#pragma unroll
          for (int sb = 0; sb < 3; ++sb) {
            if (sb < tb) {
              const float4 at = *reinterpret_cast<const float4*>(am + t * kAS + 4 * sb);
              float2 y = make_float2(0.0f, 0.0f);
              y = fma2(at.x, ld2(kk + (4 * sb) * W + ic), y);
              y = fma2(at.y, ld2(kk + (4 * sb + 1) * W + ic), y);
              y = fma2(at.z, ld2(kk + (4 * sb + 2) * W + ic), y);
              y = fma2(at.w, ld2(kk + (4 * sb + 3) * W + ic), y);
              x = fma2(ex2(cp, ld2(cc + (4 * sb + 3) * W + ic)), y, x);
            }
          }
          const int m = 4 * tb + 1;
          if (tm >= 2) {
            float2 y = make_float2(0.0f, 0.0f);
            y = fma2(am[t * kAS + m - 1], ld2(k2 + 2 * tb * W + ic), y);
            y = fma2(am[t * kAS + m], ld2(k2 + (2 * tb + 1) * W + ic), y);
            x = fma2(ex2(cp, ld2(cc + m * W + ic)), y, x);
          }
          if (tm & 1) x = fma2(am[t * kAS + t - 1], ld2(sk + (t - 1) * W + ic), x);
          const float2 a = fma2(total2(acc[nt], 2 * hr), ex2(cp, make_float2(0.0f, 0.0f)), x);
          if (t < n) {
            const float2 qv = ld2(sq + t * W + ic), kv = ld2(sk + t * W + ic);
            const float2 uv = ld2(uf + ic);
            const float vdo = am[t * kAS + t];
            store2(dq, off + (size_t)t * d + ic, ic, d,
                   make_float2(fmaf(uv.x * kv.x, vdo, a.x), fmaf(uv.y * kv.y, vdo, a.y)));
            store2(dlw, off + (size_t)t * d + ic, ic, d, make_float2(qv.x * a.x, qv.y * a.y));
          }
        }
      if (tid < DP)
        for (int t = 0; t < n; ++t)
          dus = fmaf(sq[t * W + tid] * sk[t * W + tid], am[t * kAS + t], dus);
    }
    update_state(sv, kh, true);
  }
  if (tid < d) du[(size_t)row * d + tid] = dus;
  __syncthreads();
  for (int e = tid; e < L::kState; e += kThreads) st[e] = 0.0f;   // G at the end

  // ================= reverse scan: dk, dv, dlw =================
  float run = 0.0f, p_next = 0.0f;   // dlw's running sum and p_{t+1}, channel tid
  for (int ci = nsub - 1; ci >= 0; --ci, buf ^= 1) {
    const int n = min(kTau, t_len - ci * kTau);
    const size_t off = base + (size_t)ci * kTau * d;
    cp_async_wait_all();
    __syncthreads();
    use(buf);
    if (ci > 0) issue(ci - 1, buf ^ 1);
    float pv[kTau];   // p of channel tid, written by the forward scan
#pragma unroll
    for (int t = 0; t < kTau; ++t)
      pv[t] = tid < d && t < n ? __ldcg(dlw + off + (size_t)t * d + tid) : 0.0f;
    lower_blocks(0);
    scan(n, buf);
    __syncthreads();

    // q̂, k̂, the decay factors and 2^c_τ, one thread a (step, 4 channels)
    for (int task = tid; task < kTau * NG; task += kThreads) {
      const int t = task / NG, c0 = 4 * (task % NG), tb = t / 4, m = 4 * tb + 1;
      const float4 x = row4(sq, t, c0), y = row4(sk, t, c0);
      const float4 e = t ? row4(cc, t - 1, c0) : zero4, f = row4(cc, t, c0);
      const float4 last = row4(cc, kTau - 1, c0);
      put4(qh, t, c0, x * ex2(e, zero4));
      put4(kh, t, c0, y * ex2(last, f));
      put4(kk, t, c0, y * ex2(row4(cc, t | 3, c0), f));
      for (int sb = 0; sb < tb; ++sb)
        put4(qq, (tb * (tb - 1) / 2 + sb) * 4 + t % 4, c0, x * ex2(e, row4(cc, 4 * sb + 3, c0)));
      if (t % 4 >= 2)
        put4(q2, 2 * tb + t % 4 - 2, c0, x * ex2(e, row4(cc, m, c0)));
      else
        put4(k2, 2 * tb + t % 4, c0, y * ex2(row4(cc, m, c0), f));
      if (t == 0) put4(ect, 0, c0, ex2(last, zero4));
    }
    __syncthreads();

    // the score; dk = 2^(c_τ − c_s) ⊙ (v·Gᵀ) + intra + bonus, and r into xr
    lower_blocks(1);
    {
      float acc[NPW][4][4] = {};
      rows_by_state(sv, acc);
#pragma unroll
      for (int nt = 0; nt < NPW; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int s = gid + 8 * hr, ic = 8 * (warp * NPW + nt) + 2 * tig;
          const int sb = s >> 2, sm_ = s & 3;
          const float2 cs = ld2(cc + s * W + ic);
          // Σ_{t>s} a[t,s] q_t ⊙ 2^(c_{t-1} − c_s), split at block ends, then at m
          float2 y = make_float2(0.0f, 0.0f);
#pragma unroll
          for (int tb = 1; tb < 4; ++tb) {
            if (tb > sb) {
              const int blk = tb * (tb - 1) / 2 + sb;
#pragma unroll
              for (int b = 0; b < 4; ++b)
                y = fma2(am[(4 * tb + b) * kAS + s], ld2(qq + (4 * blk + b) * W + ic), y);
            }
          }
          const float2 f = ex2(ld2(cc + (4 * sb + 3) * W + ic), cs);
          float2 x = make_float2(f.x * y.x, f.y * y.y);
          const int m = 4 * sb + 1;
          if (sm_ < 2) {
            float2 y2 = make_float2(0.0f, 0.0f);
            y2 = fma2(am[(m + 1) * kAS + s], ld2(q2 + 2 * sb * W + ic), y2);
            y2 = fma2(am[(m + 2) * kAS + s], ld2(q2 + (2 * sb + 1) * W + ic), y2);
            x = fma2(ex2(ld2(cc + m * W + ic), cs), y2, x);
          }
          if (!(sm_ & 1)) x = fma2(am[(s + 1) * kAS + s], ld2(sq + (s + 1) * W + ic), x);
          const float2 a = fma2(total2(acc[nt], 2 * hr), ex2(ld2(cc + (kTau - 1) * W + ic), cs), x);
          const float2 kv = ld2(sk + s * W + ic);
          *reinterpret_cast<float2*>(xr + s * W + ic) = make_float2(kv.x * a.x, kv.y * a.y);
          if (s < n) {
            const float2 qv = ld2(sq + s * W + ic), uv = ld2(uf + ic);
            const float vdo = am[s * kAS + s];
            store2(dk, off + (size_t)s * d + ic, ic, d,
                   make_float2(fmaf(uv.x * qv.x, vdo, a.x), fmaf(uv.y * qv.y, vdo, a.y)));
          }
        }
    }

    __syncthreads();   // G is read by rows; the score and r are written

    // dv = k̂·G + scoreᵀ·dO (M = 16 steps s, the warp's j tiles); then the
    // warp's columns of G ← diag(2^c_τ) G + q̂ᵀ·dO
    {
      float acc[NPW][4][4] = {};
#pragma unroll
      for (int kb = 0; kb < NN; ++kb) {
        const float* r = kh + gid * W + 8 * kb + tig;
        const float a[4] = {r[0], r[8 * W], r[4], r[8 * W + 4]};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int nt = 0; nt < NPW; ++nt) {
          const float* b = st + (8 * kb + tig) * W + 8 * (warp * NPW + nt) + gid;
          mma3(acc[nt][kb & 3], ah, al, b[0], b[4 * W]);
        }
      }
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const float* r = sc + (8 * kb + tig) * kSS + gid;
        const float a[4] = {r[0], r[8], r[4 * kSS], r[4 * kSS + 8]};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int nt = 0; nt < NPW; ++nt) {
          const float* b = sd + (8 * kb + tig) * W + 8 * (warp * NPW + nt) + gid;
          mma3(acc[nt][(NN + kb) & 3], ah, al, b[0], b[4 * W]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NPW; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int s = gid + 8 * hr, jc = 8 * (warp * NPW + nt) + 2 * tig;
          if (s < n)
            store2(dv, off + (size_t)s * d + jc, jc, d, total2(acc[nt], 2 * hr));
        }
    }
    update_state(qh, sd, false);

    // dlw_t = (dlw_{t+1} + p_{t+1}) − r_t, from the end, one thread a channel
    if (tid < DP) {
#pragma unroll
      for (int t = kTau - 1; t >= 0; --t) {
        run = (run + p_next) - xr[t * W + tid];
        if (t < n && tid < d) dlw[off + (size_t)t * d + tid] = run;
        p_next = pv[t];
      }
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const float* lw, const float* u,
           const float* dout, float* dq, float* dk, float* dv, float* dlw, float* du, int bh,
           int t, int d, cudaStream_t stream) {
  const size_t smem = Layout<DP>::kBytes;
  auto kern = wkv6_bwd_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<bh, kThreads, smem, stream>>>(q, k, v, lw, u, dout, dq, dk, dv, dlw, du, t, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, lw, dout, dq, dk, dv, dlw: [bh, t, d] float32; u, du: [bh, d]
// float32; all contiguous, 4-byte aligned, the outputs disjoint from each
// other and from the inputs.  Launches on `stream` without synchronising;
// returns the error of the shared-memory opt-in or of the launch
// (cudaGetLastError()), 0 on success.
int wkv6_backward(const void* q, const void* k, const void* v, const void* lw,
                  const void* u, const void* dout, void* dq, void* dk, void* dv,
                  void* dlw, void* du, int bh, int t, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t <= 0 || d <= 0 || d > 128) return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* lp = static_cast<const float*>(lw);
  const float* up = static_cast<const float*>(u);
  const float* dp = static_cast<const float*>(dout);
  float* dqp = static_cast<float*>(dq);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  float* dlp = static_cast<float*>(dlw);
  float* dup = static_cast<float*>(du);
  if (d <= 64)
    return launch<64>(qp, kp, vp, lp, up, dp, dqp, dkp, dvp, dlp, dup, bh, t, d, st);
  return launch<128>(qp, kp, vp, lp, up, dp, dqp, dkp, dvp, dlp, dup, bh, t, d, st);
}

}  // extern "C"
