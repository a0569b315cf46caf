// K3 and K3s on Hopper: the RWKV-6 (Finch) recurrence over [BH, T, D].
//
// K3 replaces the Pallas TPU kernel `wkv6_pallas` / `_wkv6_kernel`
// (src/repro/kernels/wkv6_chunk.py), which starts every row from a zero
// state.  K3s is the same kernel with state in and state out: it replaces
// the reference's decode path `_wkv_with_state`
// (src/repro/models/layers/rwkv6.py), a vmap of the sequential oracle, which
// has no Pallas kernel.  For every (batch·head) row, from the f32 state
// S_0 = s0 (D × D; zero when s0 is null):
//
//     o_t = q_t (S_{t-1} + u ⊙ k_t v_tᵀ)      (u scales the rows of k_t v_tᵀ)
//     S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,      w_t = exp(lw_t)
//
// and, when s_out is not null, S_T written to s_out (never in place: the
// caller's state stays as it was).  S[i][j] has i the k/q channel (the one w
// scales) and j the v channel, rows contiguous: the layout of the
// reference's RWKVState.wkv reshaped to [B·H, D, D].  Inputs are f32 or bf16
// (widened to f32 as they leave shared memory); the state and every sum are
// f32; the output has q's type.  Any T ≥ 1, any D ≤ 128.
//
// Two kernels, chosen by T alone: below kShortT = 16 steps (the decode
// step's T = 1 among them) `wkv6_step_kernel`, step by step; from 16 steps
// on `wkv6_kernel`, sub-chunks on the tensor cores (described below).  A
// sub-chunk kernel would spend its 12 warps and two-stage ring on a single
// step.
//
// What bounds it: the function reads q, k, v, lw and writes o once, 5·BH·T·D
// elements, plus the state in and out (2·BH·D² f32 with a state), against
// about 5·D² operations per step and row; at D = 64 in f32 that is 16
// operations per byte, below the card's f32 ridge, so the bound is bytes
// (0.20 ms at rwkv6-7b's forward geometry, BH 256, T 2048; at its decode
// step, BH 256, T 1 with a state, 8.8 MB and 2.6 µs, most of it the state,
// where a launch's own latency is larger still).  A
// step-by-step form is bound instead by the latency of T dependent steps a
// row with only BH rows in flight.  This kernel takes T/16 dependent steps a
// row and is bound by the SM's throughput: its tensor work (3xTF32 on
// mma.sync) and its elementwise work (the decays, the score) share the SM's
// issue slots and shared-memory bandwidth.  wgmma reading B from shared
// memory and TMA staging are the next steps.
//
// Design: the TPU kernel's sub-chunk algebra, recast for the tensor cores.
// A row is walked in sub-chunks of kTau = 16 steps.  With cumulative
// log-decays c_t = Σ_{i≤t} lw_i local to the sub-chunk (per channel):
//
//     cross : o  += q̂ · S,                  q̂_t = q_t ⊙ exp(c_{t-1})
//     intra : o  += score · v,               score[t,s] = Σ_d q_td k_sd exp(c_{t-1,d} − c_sd), s < t,
//                                            score[t,t] = Σ_d q_td u_d k_td (the bonus)
//     state : S  ← diag(exp(c_τ)) S + k̂ᵀ v,  k̂_s = k_s ⊙ exp(c_τ − c_s)
//
// Every exponent is ≤ 0 (c is non-increasing), so nothing overflows and no
// rescaling pass is needed.  The per-channel decays of the score do not
// factor into one product with bounded exponents, but each entry does at a
// step m between s and t − 1: exp(c_{t-1} − c_s) = exp(c_{t-1} − c_m)·
// exp(c_m − c_s), both factors ≤ 1.  Taking m at the ends of 4-step blocks,
// then at the second step inside each block (s = t − 1 needs no decay), the
// score is a few small dot products of precomputed factor rows.
//
//   * Warp roles.  One block per (b·h) row.  Eight producer warps stage the
//     inputs and form, per sub-chunk, q̂, k̂, exp(c_τ), v widened to f32 and
//     the score; they hand them over in one of two buffers (named barriers
//     "ready" and "free"), so they work a sub-chunk ahead of the consumers.
//     One consumer warp per 16 value columns j keeps Sᵀ[j, :] (16 × D, f32)
//     in registers, in the mma accumulator layout, and computes o[:, j] with
//     no reduction across warps.  While the producers form the score, two
//     of them already scan the next sub-chunk's decays.
//   * Products on the tensor cores: mma.sync m16n8k8 TF32 with the 3xTF32
//     split (hi = rna(x), lo = rna(x − hi); lo·hi + hi·lo + hi·hi, f32
//     accumulation), which keeps f32 accuracy; one TF32 pass would not (its
//     error at rwkv6-7b's decays is ~100× the 1e-4 check).  The tensor
//     cores add each mma into its accumulator with truncation, not rounding
//     to nearest, which pulls a long-lived accumulator toward zero.  So S is
//     never an mma accumulator across sub-chunks: each sub-chunk's update
//     k̂ᵀv is accumulated from zero and added to the decayed state with one
//     fmaf, and o's products go to two accumulators in turn.  A state
//     carried in from s0 is loaded into that fragment before the first
//     sub-chunk, and the last fragment is stored to s_out, both undoing the
//     permutation below (a state lives across hundreds of decode steps, so
//     the same rule holds for it).  The state's
//     fragment is read directly as the A operand of the next cross term:
//     within each 8-wide k-block the k index is permuted (position tig ↔
//     i = 2·tig, tig + 4 ↔ 2·tig + 1), and q̂ is read with the same
//     permutation, so S never leaves registers.
//   * Staging: q, k, v, lw of the next two sub-chunks are copied into a ring
//     of kStages buffers in dynamic shared memory with cp.async (16-byte
//     copies where the address allows, 4-byte where it does not, plain loads
//     for 2-byte alignment).  A sub-chunk of a row is one contiguous range of
//     [BH, T, D].  Steps past T and channels past D are masked to zero (lw =
//     0) when the stage is widened: a zero q and k keep them out of every sum.
//   * Output: each consumer writes its o columns in q's type straight from
//     its accumulators, 8 consecutive columns of 4 rows per store (whole
//     32-byte sectors in f32).  Every sum has a fixed order (no atomics):
//     results repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kTau = 16;           // steps per sub-chunk
constexpr int kBlocks = 10;        // 4 × 4 blocks of the score's lower triangle
constexpr int kOff = 6;            // of which strictly below the diagonal
constexpr int kScanWarp = 6;       // producer warps from this one on scan the next decays
constexpr int kProducers = 8;      // producer warps
constexpr float kLog2e = 1.4426950408889634f;

// Named barriers (0 is __syncthreads)
constexpr int kBarProd = 1, kBarReady = 2, kBarFree = 4;  // ready, free: + buffer

template <typename T, int DP>
struct Geometry {
  static constexpr int kStages = 3;       // cp.async ring depth
  static constexpr int kWS = DP + 8;      // row stride of the handed-over arrays: ≡ 8 (mod 32) words
  static constexpr int kSS = kTau + 4;    // score row stride
  static constexpr int kStage = 4 * kTau * DP;      // elements of one stage
  static constexpr size_t kStageBytes = (size_t)kStages * kStage * sizeof(T);
  // one buffer of what the producers hand to the consumers (Hand), in floats
  static constexpr int kHand = 3 * kTau * kWS + kTau * kSS + DP;
  // the producers' own rows: q, k, c_{t-1}, c_t, kk (16 each), qq (24), q2, k2 (8 each)
  static constexpr int kOwnRows = 5 * kTau + 4 * kOff + kTau;
  static constexpr size_t kFloats = kOwnRows * DP + 2 * kHand + DP;
  static constexpr size_t kSmem = kStageBytes + kFloats * sizeof(float);
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 2^x for x ≤ 0 (the MUFU unit; about 2 ulp, subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy n contiguous elements of global memory into shared memory, with the
// widest copies that the source address allows; the tail that does not fill
// a copy is loaded plainly.  Issued by all nt threads of the block.
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, int n, int tid, int nt) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const int nbytes = n * (int)sizeof(T);
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  int done = 0;  // bytes copied asynchronously
  if ((addr & 15) == 0) {
    done = nbytes & ~15;
    for (int b = tid * 16; b < done; b += nt * 16) cp_async16(d + b, s + b);
  } else if ((addr & 3) == 0) {
    done = nbytes & ~3;
    for (int b = tid * 4; b < done; b += nt * 4) cp_async4(d + b, s + b);
  }
  for (int e = done / (int)sizeof(T) + tid; e < n; e += nt) dst[e] = src[e];
}

// TF32 (10 mantissa bits) nearest to x, ties away from zero: the bits of
// cvt.rna.tf32.f32, made with two integer operations, which issue at a
// higher rate than the conversion.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo with hi, lo TF32: the 3xTF32 split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
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

// One buffer of what the producers hand to the consumers for a sub-chunk.
template <typename T, int DP>
struct Hand {
  float* qh;   // q̂ [t][i] = q ⊙ exp(c_{t-1})
  float* kh;   // k̂ [s][i] = k ⊙ exp(c_τ − c_s)
  float* vf;   // v [s][j]
  float* sc;   // score [t][s], zero above the diagonal
  float* ect;  // exp(c_τ) [i]
  __device__ Hand(float* h, int b) {
    using G = Geometry<T, DP>;
    qh = h + b * G::kHand;
    kh = qh + kTau * G::kWS;
    vf = kh + kTau * G::kWS;
    sc = vf + kTau * G::kWS;
    ect = sc + kTau * G::kSS;
  }
};

template <int DP>
struct Roles {
  static constexpr int kNJ = DP / 16;               // 16-column tiles, one consumer warp each
  static constexpr int kConsumers = 32 * kNJ;       // consumer threads
  static constexpr int kThreads = kConsumers + 32 * kProducers;
};

__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 ex2(float4 a, float4 b) {  // 2^(a − b)
  return make_float4(ex2(a.x - b.x), ex2(a.y - b.y), ex2(a.z - b.z), ex2(a.w - b.w));
}
__device__ __forceinline__ float dot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
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
template <typename T, int DP>
__global__ void __launch_bounds__(Roles<DP>::kThreads, DP <= 64 ? 2 : 1)
wkv6_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ lw, const T* __restrict__ u, T* __restrict__ o,
            const float* __restrict__ s0, float* __restrict__ s_out, int t_len, int d) {
  using G = Geometry<T, DP>;
  using R = Roles<DP>;
  constexpr int NCT = R::kConsumers, NT = R::kThreads;
  constexpr int NPT = 32 * kProducers;
  constexpr int NI = DP / 8;            // 8-wide tiles of the key index
  constexpr int NG = DP / 4;            // 4-channel groups
  constexpr int WS = G::kWS, SS = G::kSS;

  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  // the producers' own arrays, [row][channel], rows of DP.  The score's
  // decay factors, every exponent ≤ 0: with r the last step of s's 4-step
  // block, kk_s = k_s ⊙ exp(c_r − c_s) and, for each such block below t's,
  // qq_t = q_t ⊙ exp(c_{t-1} − c_r); within a block of 4 and m its second
  // step, k2_s = k_s ⊙ exp(c_m − c_s) for s ≤ m, q2_t = q_t ⊙ exp(c_{t-1} − c_m)
  // for t ≥ m + 2
  float* qf = reinterpret_cast<float*>(smem + G::kStageBytes);  // q
  float* kf = qf + kTau * DP;    // k
  float* cp = kf + kTau * DP;    // c_{t-1}, in log2 units
  float* cc = cp + kTau * DP;    // c_t, in log2 units
  float* kk = cc + kTau * DP;
  float* qq = kk + kTau * DP;    // [block below the diagonal][4]
  float* q2 = qq + 4 * kOff * DP;      // [4-step block][2]
  float* k2 = q2 + kTau / 2 * DP;      // [4-step block][2]
  float* hand = k2 + kTau / 2 * DP;    // two Hand buffers
  float* uf = hand + 2 * G::kHand;            // u

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  const size_t base = (size_t)row * t_len * d;
  const int nsub = (t_len + kTau - 1) / kTau;

  for (int i = tid; i < DP; i += NT) uf[i] = i < d ? to_f(u[(size_t)row * d + i]) : 0.0f;
  for (int i = tid; i < 2 * G::kHand; i += NT) hand[i] = 0.0f;  // the score's upper part stays 0
  __syncthreads();

  if (tid >= NCT) {
    // ---------------- producers: stage, widen, decays, score -----------------
    const int pt = tid - NCT;
    auto issue = [&](int ci) {  // stage sub-chunk ci of q, k, v, lw
      T* dst = stage + (ci % G::kStages) * G::kStage;
      const size_t off = base + (size_t)ci * kTau * d;
      const int n = min(kTau, t_len - ci * kTau) * d;
      stage_copy(dst, q + off, n, pt, NPT);
      stage_copy(dst + kTau * DP, k + off, n, pt, NPT);
      stage_copy(dst + 2 * kTau * DP, v + off, n, pt, NPT);
      stage_copy(dst + 3 * kTau * DP, lw + off, n, pt, NPT);
    };
    // f32 rows of 4-channel multiples are 16-byte aligned in the stage
    const bool vec = sizeof(T) == 4 && d % 4 == 0;
    // cumulative log-decays of sub-chunk ci, one thread per channel (steps
    // past T and channels past D decay by 0); by the threads from pt0 on
    auto scan = [&](int ci, int pt0) {
      const T* sl = stage + (ci % G::kStages) * G::kStage + 3 * kTau * DP;
      const int n = min(kTau, t_len - ci * kTau);
      for (int ch = pt - pt0; ch < DP; ch += NPT - pt0) {
        float run = 0.0f;
#pragma unroll
        for (int t = 0; t < kTau; ++t) {
          cp[t * DP + ch] = run;
          if (ch < d && t < n) run = __fadd_rn(run, __fmul_rn(to_f(sl[t * d + ch]), kLog2e));
          cc[t * DP + ch] = run;
        }
      }
    };
    issue(0);
    cp_async_commit();
    if (nsub > 1) issue(1);
    cp_async_commit();
    cp_async_wait<1>();
    bar_sync(kBarProd, NPT);
    scan(0, 0);
    for (int ci = 0; ci < nsub; ++ci) {
      const int b = ci & 1;
      const Hand<T, DP> hb(hand, b);
      // stage ci + 2 goes where ci − 1 was, widened before the last barrier
      if (ci + 2 < nsub) issue(ci + 2);
      cp_async_commit();
      cp_async_wait<1>();                       // ci + 1 staged (this thread's copies)
      bar_sync(kBarProd, NPT);                  // ... and everyone's; the decays of ci ready
      if (ci >= 2) bar_sync(kBarFree + b, NT);  // the consumers are done with buffer b

      // 1. widen and mask q, k, v; q̂, k̂, exp(c_τ), and the score's decay
      //    factors; one thread per (step, 4 channels)
      {
        const T* sq = stage + (ci % G::kStages) * G::kStage;
        const T* sk = sq + kTau * DP;
        const T* sv = sk + kTau * DP;
        const int n = min(kTau, t_len - ci * kTau);
        for (int task = pt; task < kTau * NG; task += NPT) {
          const int t = task / NG, c0 = 4 * (task % NG);
          auto load = [&](const T* a) {
            if (vec)
              return t < n && c0 < d ? *reinterpret_cast<const float4*>(a + t * d + c0)
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            float r[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) r[c] = t < n && c0 + c < d ? to_f(a[t * d + c0 + c]) : 0.0f;
            return make_float4(r[0], r[1], r[2], r[3]);
          };
          auto own = [&](float* a, int r) -> float4& {
            return *reinterpret_cast<float4*>(a + r * DP + c0);
          };
          auto handed = [&](float* a, int r) -> float4& {
            return *reinterpret_cast<float4*>(a + r * WS + c0);
          };
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 x = load(sq), y = load(sk);
          const float4 e = own(cp, t), f = own(cc, t), last = own(cc, kTau - 1);
          const int tb = t / 4, m = 4 * tb + 1;
          own(qf, t) = x;
          own(kf, t) = y;
          handed(hb.vf, t) = load(sv);
          handed(hb.qh, t) = x * ex2(e, zero);
          handed(hb.kh, t) = y * ex2(last, f);
          if (t == 0) handed(hb.ect, 0) = ex2(last, zero);
          own(kk, t) = y * ex2(own(cc, t | 3), f);
          for (int sb = 0; sb < tb; ++sb)
            own(qq, (tb * (tb - 1) / 2 + sb) * 4 + t % 4) = x * ex2(e, own(cc, 4 * sb + 3));
          if (t % 4 >= 2)
            own(q2, 2 * tb + t % 4 - 2) = x * ex2(e, own(cc, m));
          else
            own(k2, 2 * tb + t % 4) = y * ex2(own(cc, m), f);
        }
      }
      bar_sync(kBarProd, NPT);

      // 2. score, in 4 × 4 blocks of (t, s), each spread over NG lanes of 4
      //    channels: every entry a dot product of the factors above (s = t − 1:
      //    of q and k; s = t: the bonus, q ⊙ u and k).  The lanes' sums are
      //    reduced in a fixed order, each of 16 lanes ending with one entry.
      //    Meanwhile the warps from kScanWarp on scan sub-chunk ci + 1's decays.
      if (pt >= 32 * kScanWarp) {
        if (ci + 1 < nsub) scan(ci + 1, 32 * kScanWarp);
      } else {
        for (int item = pt; item < kBlocks * NG; item += 32 * kScanWarp) {
          const int blk = item / NG, g = item % NG;
          auto row = [&](const float* a, int r) {
            return *reinterpret_cast<const float4*>(a + r * DP + 4 * g);
          };
          float pr[16];
          int tb, sb;
          if (blk < kOff) {
            tb = 1 + (blk >= 1) + (blk >= 3);
            sb = blk - tb * (tb - 1) / 2;
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float4 x = row(qq, 4 * blk + a);
#pragma unroll
              for (int bb = 0; bb < 4; ++bb) pr[4 * a + bb] = dot(x, row(kk, 4 * sb + bb));
            }
          } else {
            tb = sb = blk - kOff;
            const float4 w = row(uf, 0);
            float4 x[4], y[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              x[a] = row(qf, 4 * tb + a);
              y[a] = row(kf, 4 * tb + a);
            }
#pragma unroll
            for (int e = 0; e < 16; ++e) pr[e] = 0.0f;
#pragma unroll
            for (int a = 0; a < 4; ++a) pr[5 * a] = dot(x[a] * w, y[a]);
            pr[4] = dot(x[1], y[0]);
            pr[14] = dot(x[3], y[2]);
#pragma unroll
            for (int a = 2; a < 4; ++a)
#pragma unroll
              for (int bb = 0; bb < 2; ++bb)
                pr[4 * a + bb] = dot(row(q2, 2 * tb + a - 2), row(k2, 2 * tb + bb));
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
          if (g < 16) hb.sc[(4 * tb + g / 4) * SS + 4 * sb + g % 4] = pr[0];
        }
      }
      bar_arrive(kBarReady + b, NT);  // buffer b holds sub-chunk ci
    }
    for (int ci = max(nsub - 2, 0); ci < nsub; ++ci) bar_sync(kBarFree + (ci & 1), NT);
    return;
  }

  // ---------------- consumers: the state, on the tensor cores ----------------
  const int gid = lane >> 2, tig = lane & 3;
  const int jw = 16 * warp;   // first value column of the warp
  float S[NI][4];   // Sᵀ: rows j = jw + gid (c0, c1), jw + gid + 8 (c2, c3); cols i = 8·it + 2·tig (+1)
  // S[it][h] holds S[i][j] (s0's layout) at i = 8·it + 2·tig + (h & 1),
  // j = jw + gid + 8·(h >> 1); channels past D stay zero
  auto state_at = [&](int it, int h, int& i, int& j) {
    i = 8 * it + 2 * tig + (h & 1);
    j = jw + gid + 8 * (h >> 1);
    return i < d && j < d;
  };
  const size_t sbase = (size_t)row * d * d;
#pragma unroll
  for (int it = 0; it < NI; ++it)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      int i, j;
      S[it][h] = s0 != nullptr && state_at(it, h, i, j) ? s0[sbase + (size_t)i * d + j] : 0.0f;
    }

  for (int ci = 0; ci < nsub; ++ci) {
    const int b = ci & 1;
    const Hand<T, DP> hb(hand, b);
    bar_sync(kBarReady + b, NT);

    // 4. cross term: oᵀ (16 j × 16 t) = Sᵀ · q̂ᵀ, into two accumulators in
    //    turn (even and odd k tiles), summed after the intra term
    float acc[2][4] = {}, alt[2][4] = {};
#pragma unroll
    for (int it = 0; it < NI; ++it) {
      uint32_t ah[4], al[4];
      split_tf32(S[it][0], ah[0], al[0]);   // a0 ↔ (j gid,     i 8it + 2tig)
      split_tf32(S[it][2], ah[1], al[1]);   // a1 ↔ (j gid + 8, i 8it + 2tig)
      split_tf32(S[it][1], ah[2], al[2]);   // a2 ↔ (j gid,     i 8it + 2tig + 1)
      split_tf32(S[it][3], ah[3], al[3]);   // a3 ↔ (j gid + 8, i 8it + 2tig + 1)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(hb.qh + (8 * nt + gid) * WS + 8 * it + 2 * tig);
        mma3(it & 1 ? alt[nt] : acc[nt], ah, al, bv.x, bv.y);
      }
    }

    // 5. intra term and bonus: oᵀ += vᵀ · scoreᵀ
    uint32_t vh[2][4], vl[2][4];   // A = vᵀ (j × s), one fragment per 8 steps
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* r0 = hb.vf + (8 * ks + tig) * WS + jw + gid;
      const float* r1 = r0 + 4 * WS;
      split_tf32(r0[0], vh[ks][0], vl[ks][0]);
      split_tf32(r0[8], vh[ks][1], vl[ks][1]);
      split_tf32(r1[0], vh[ks][2], vl[ks][2]);
      split_tf32(r1[8], vh[ks][3], vl[ks][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* r = hb.sc + (8 * nt + gid) * SS + 8 * ks + tig;
        mma3(ks ? alt[nt] : acc[nt], vh[ks], vl[ks], r[0], r[4]);
      }

#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[nt][h] += alt[nt][h];

    // 6. state: Sᵀ ← Sᵀ diag(exp(c_τ)) + vᵀ · k̂, the update accumulated
    //    from zero and added to the decayed state rounded to nearest
#pragma unroll
    for (int it = 0; it < NI; ++it) {
      const float e0 = hb.ect[8 * it + 2 * tig], e1 = hb.ect[8 * it + 2 * tig + 1];
      float upd[4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* r = hb.kh + (8 * ks + tig) * WS + 8 * it + gid;
        mma3(upd, vh[ks], vl[ks], r[0], r[4 * WS]);
      }
      S[it][0] = fmaf(S[it][0], e0, upd[0]);
      S[it][1] = fmaf(S[it][1], e1, upd[1]);
      S[it][2] = fmaf(S[it][2], e0, upd[2]);
      S[it][3] = fmaf(S[it][3], e1, upd[3]);
    }
    bar_arrive(kBarFree + b, NT);  // buffer b may be refilled

    // 7. output, from the accumulators: each store instruction writes 8
    //    consecutive columns of 4 rows (whole 32-byte sectors in f32)
    const size_t off = base + (size_t)ci * kTau * d;
    const int n = min(kTau, t_len - ci * kTau);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int t = 8 * nt + 2 * tig + (h & 1), j = jw + gid + 8 * (h >> 1);
        if (t < n && j < d) o[off + (size_t)t * d + j] = from_f<T>(acc[nt][h]);
      }
  }

  // 8. the state after the last step, in s0's layout
  if (s_out != nullptr) {
#pragma unroll
    for (int it = 0; it < NI; ++it)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        int i, j;
        if (state_at(it, h, i, j)) s_out[sbase + (size_t)i * d + j] = S[it][h];
      }
  }
}

// ---------------------------------------------------------------------------
// The step-by-step kernel for short T (below kShortT; the decode step's T = 1).
// One block per (b·h) row, kSlices × DP threads: thread (slice sl, column j)
// keeps S[i][j] for the DP / kSlices rows i of its slice in registers, so the
// state is read once and written once.  The inputs of up to kStepTile steps
// are staged in shared memory (w = exp(lw) formed there, accurately); each
// step, every thread adds q_i (S_ij + u_i k_i v_j) over its rows in order and
// leaves the partial sum in shared memory, then updates its rows, S_ij ←
// fmaf(w_i, S_ij, k_i v_j).  The update does not wait for o, so a tile's
// partial sums are reduced after its last step, slice 0 + 1 + 2 + 3 in that
// order.  Every sum has a fixed order (ref.wkv6_step_ref repeats it): the
// results repeat bit for bit.
constexpr int kShortT = 16;   // T below this takes the step-by-step kernel
constexpr int kSlices = 4;    // slices of the state's rows i a column j is split into
constexpr int kStepTile = 8;  // steps staged at a time

template <typename T, int DP>
__global__ void __launch_bounds__(kSlices * DP)
wkv6_step_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ lw, const T* __restrict__ u, T* __restrict__ o,
                 const float* __restrict__ s0, float* __restrict__ s_out, int t_len, int d) {
  constexpr int NR = DP / kSlices;   // rows i a thread keeps
  constexpr int NT = kSlices * DP;
  __shared__ float sq[kStepTile][DP], sk[kStepTile][DP], sv[kStepTile][DP], sw[kStepTile][DP];
  __shared__ float su[DP];
  __shared__ float part[kStepTile][kSlices][DP];

  const int tid = threadIdx.x, j = tid % DP, i0 = (tid / DP) * NR;
  const int row = blockIdx.x;
  const size_t base = (size_t)row * t_len * d;
  const size_t sbase = (size_t)row * d * d;

  float S[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = i0 + r;
    S[r] = s0 != nullptr && i < d && j < d ? s0[sbase + (size_t)i * d + j] : 0.0f;
  }
  for (int c = tid; c < DP; c += NT) su[c] = c < d ? to_f(u[(size_t)row * d + c]) : 0.0f;

  for (int t0 = 0; t0 < t_len; t0 += kStepTile) {
    const int n = min(kStepTile, t_len - t0);
    __syncthreads();   // the previous tile's inputs and partial sums are read
    for (int e = tid; e < kStepTile * DP; e += NT) {
      const int t = e / DP, c = e % DP;
      const bool in = t < n && c < d;   // masked: q = k = v = 0, w = 1
      const size_t off = base + (size_t)(t0 + t) * d + c;
      sq[t][c] = in ? to_f(q[off]) : 0.0f;
      sk[t][c] = in ? to_f(k[off]) : 0.0f;
      sv[t][c] = in ? to_f(v[off]) : 0.0f;
      sw[t][c] = in ? expf(to_f(lw[off])) : 1.0f;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = sv[t][j];
      float p = 0.0f;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int i = i0 + r;
        const float kv = sk[t][i] * vj;
        p = fmaf(sq[t][i], fmaf(su[i], kv, S[r]), p);
        S[r] = fmaf(sw[t][i], S[r], kv);
      }
      part[t][tid / DP][j] = p;
    }
    __syncthreads();
    for (int e = tid; e < n * DP; e += NT) {
      const int t = e / DP, c = e % DP;
      float acc = part[t][0][c];
#pragma unroll
      for (int sl = 1; sl < kSlices; ++sl) acc += part[t][sl][c];
      if (c < d) o[base + (size_t)(t0 + t) * d + c] = from_f<T>(acc);
    }
  }

  if (s_out != nullptr) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int i = i0 + r;
      if (i < d && j < d) s_out[sbase + (size_t)i * d + j] = S[r];
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* lw, const void* u,
           void* o, const float* s0, float* s_out, int bh, int t, int d,
           cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* lp = static_cast<const T*>(lw);
  const T* up = static_cast<const T*>(u);
  T* op = static_cast<T*>(o);
  if (t < kShortT) {
    wkv6_step_kernel<T, DP><<<bh, kSlices * DP, 0, stream>>>(qp, kp, vp, lp, up, op, s0,
                                                            s_out, t, d);
    return (int)cudaGetLastError();
  }
  const size_t smem = Geometry<T, DP>::kSmem;
  auto kern = wkv6_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<bh, Roles<DP>::kThreads, smem, stream>>>(qp, kp, vp, lp, up, op, s0, s_out, t, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* q, const void* k, const void* v, const void* lw,
                 const void* u, void* o, const float* s0, float* s_out, int bh, int t,
                 int d, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, lw, u, o, s0, s_out, bh, t, d, stream);
  return launch<T, 128>(q, k, v, lw, u, o, s0, s_out, bh, t, d, stream);
}

}  // namespace

extern "C" {

// q, k, v, lw, o: [bh, t, d]; u: [bh, d]; contiguous, any alignment of the
// element type.  dtype: 0 = float32, 1 = bfloat16.  s0, s_out: [bh, d, d]
// float32, contiguous, or null: a null s0 starts from a zero state (K3), a
// null s_out writes no state; s_out must not overlap s0 or the inputs.  The
// two are last so that a K3 library built before they existed takes the
// same call and ignores them.  Launches on `stream` without synchronising;
// returns the error of the shared-memory opt-in or of the launch
// (cudaGetLastError()), 0 on success.
int wkv6_forward(const void* q, const void* k, const void* v, const void* lw, const void* u,
                 void* o, int bh, int t, int d, int dtype, void* stream, const void* s0,
                 void* s_out) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* si = static_cast<const float*>(s0);
  float* so = static_cast<float*>(s_out);
  if (bh <= 0 || t <= 0 || d <= 0 || d > 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_width<float>(q, k, v, lw, u, o, si, so, bh, t, d, st);
  if (dtype == 1) return launch_width<__nv_bfloat16>(q, k, v, lw, u, o, si, so, bh, t, d, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
