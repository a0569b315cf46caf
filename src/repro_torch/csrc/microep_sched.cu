// K4: the MicroEP scheduler of one MoE layer call, one block an instance on
// an H100 (sm_90a), with a plain C interface bound by kernels/sched.py.
//
// What it replaces.  No Pallas kernel: the reference computes the schedule
// inside its compiled step (src/repro/core/scheduler.py:197-253): the LPP-1
// solve by Gauss-Seidel water-filling (src/repro/core/solver_jax.py:231,
// solve_replica_loads, a lax.scan of E x sweeps water-fills) or by damped
// Jacobi (:386, solve_replica_loads_batched, one vectorized water-fill of
// every expert a sweep), each with optional per-device weights (the
// weighted water-fill, :103-121) and MemFine memory caps (project_mem_caps
// :131, _cap_effective_weights :180, used at :291-297 and :442-449); then
// largest-remainder rounding (core/rounding.py) and Algorithm 1 routing
// with or without its local phase (core/routing.py); or, in vanilla mode
// (Megatron EP), each token to the replicas on its own row.  Eager PyTorch
// runs that as tens of thousands of small dependent launches a decode step;
// this kernel is one launch.  Its plain version is kernels/ref.py::
// schedule_ref, and it repeats that version's arithmetic operation for
// operation: every f32 sum is added in the same order (left to right over
// sorted or replica order, expert by expert over device loads, the
// reference's reduction tree for the caps' total), with no contracted
// multiply-adds except the two the reference's compiled program fuses,
// which both sides compute in double and round once; so x is equal bit for
// bit and the integer outputs are equal.
//
// What bounds it.  Not bytes or FLOPs (a few hundred KB and a few MFLOP at
// most) but dependent steps.  Gauss-Seidel is E x sweeps water-fills, yet
// step (sweep s, expert e) reads only the loads of e's own devices and e's
// own row of the iterate, so it depends only on the last earlier step that
// touched one of its devices: its critical path is a few hundred levels at
// the paper's groups (390 of 1536 steps at 64 devices x 256 experts).  The
// design runs that dataflow inside the block: every device g keeps its load
// and a count of the steps done on it in one 64-bit word of shared memory;
// warp w takes the steps of experts w, w + 16, ... in sequence order (so it
// alone writes their rows of x), and step (s, e) starts on device g once
// g's count reads s * (replicas on g) + (e's place in g's list), takes the
// load from the word, runs its fill, and stores the new load with the
// count + 1 in one store, so no fence is needed.  Every fill reads the
// values the sequential sweep reads, so no bit changes.  With one device
// (olmoe-1b-7b's and Mixtral's G = 1) the chain is serial: one warp runs
// it with the device's load in a register.  Each water-fill stays in
// registers on a segment of RP lanes (R rounded up to a power of two),
// with shuffles of width RP: at RP <= 8 every lane of the segment gathers
// the levels and computes the whole fill (the sorted levels, the prefix
// left to right, the level, the total) itself; at 16 and 32 the lanes
// share it, lane p standing for sorted position p.
// Damped Jacobi packs 32 / RP experts a warp, so a sweep at RP 2 is one
// round of fills.  Rounding packs the experts the same way, and Algorithm
// 1 runs a warp an expert, a segment a source and a lane a (source,
// replica) pair, its flow written coalesced.  Where they fit in shared
// memory (227 KB a block), the counts are staged there once by a bulk
// asynchronous copy (cp.async.bulk on an mbarrier) while the placement
// tables are built from a bitmask of each device's experts.  Waiting
// warps sleep 20 ns between polls (on an H100 a block of spinning warps
// slowed the working one), and a zero numerator skips its division (0 / b
// is 0; on an H100 that took ~15% off routing at 64 devices x 256
// experts).
//
// Phases of one launch (E <= 256 experts, G <= 64 devices, R <= 32
// replicas an expert, each device hosting at most one replica of an
// expert, an expert's tokens below 2^31):
//   0. set-up: counts staged, weights and caps, placement tables, the
//      experts' loads;
//   1. solve: Gauss-Seidel as a dataflow over the block (one warp at
//      G = 1), or damped Jacobi; with caps, project (4 passes), the caps'
//      effective weights, solve again, project;
//   2. round, a segment an expert; 3. route, a warp an expert (vanilla
//      mode: the same-row mask instead of 1 to 3);
//   4. device loads of x_int, their max and max (over weight) / mean.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;     // level of a padding replica
constexpr float kSlack = 1e-6f;   // the water-fill's interval slack
constexpr int kPasses = 4;        // project_mem_caps's passes
constexpr int kMaskWords = 256 / 32;   // a bitmask of E <= 256 experts
constexpr size_t kSmemLimit = 232448;   // the most shared memory a block takes
constexpr unsigned kCopyChunk = 16384;  // bytes a bulk copy instruction
constexpr unsigned kSpinNs = 20;  // a waiting warp's sleep between polls

struct Args {
  const long long* input;   // [B, E, G] tokens per (expert, source device)
  const long long* dev;     // [E, R] replica -> device, -1 padding
  const float* x_init;      // [B, E, R] warm start, or null
  const float* weights;     // [G] device compute weights, or null
  const float* caps;        // [G] memory token caps, or null
  float* x_out;             // [B, E, R] solver iterate
  long long* x_int;         // [B, E, R] integer replica loads
  long long* flow;          // [B, E, G, R] routed tokens
  float* stats;             // [B, 2] max device load, max / mean
  int E, G, R, sweeps, greedy, jacobi, vanilla, locality, cols;
  int stage;                // the counts staged into shared memory
};

// The block's shared memory.
struct Smem {
  long long* cnt;     // [E*G] the instance's counts, if staged
  long long* loadi;   // [E] tokens per expert
  unsigned long long* bar;   // the staging copy's mbarrier
  unsigned long long* tick;  // [G] Gauss-Seidel: device g's load (f32 bits,
                             // low half) and the steps done on it (high)
  float* x;           // [E*R] the iterate
  float* xc;          // [E*R] the projection's cut iterate
  float* loadf;       // [E] tokens per expert, f32
  float* rowsum;      // [E] the projection's row sums
  float* dl;          // [G] device loads
  float* dl2;         // [G] device loads of the cut iterate
  float* wts;         // [G] the solve's device weights
  float* cap;         // [G] memory caps
  float* fac;         // [G] the projection's scale factors; the breakpoints
  float* gt0;         // [G] sorted breakpoints
  float* gt1;         // [G] sorted weights
  float* gt2;         // [G] sorted caps
  float* scal;        // [4] damping, the caps' level
  int* xi;            // [E*R] integer replica loads
  unsigned* emask;    // [G*kMaskWords] the experts on device g, a bit each
  short* didx;        // [G*E] device g's replicas (e*R + r), e ascending
  short* pos;         // [E*R] replica (e, r)'s place in its device's list
  short* dcnt;        // [G] replicas on device g
  signed char* dev;   // [E*R]
  signed char* over;  // [G] device over its cap
};

__host__ __device__ size_t staged_bytes(int E, int G) {
  return sizeof(long long) * static_cast<size_t>(E) * G;
}

__device__ Smem carve(unsigned char* base, int E, int G, int R, bool stage) {
  Smem s;
  s.cnt = reinterpret_cast<long long*>(base);
  s.loadi = s.cnt + (stage ? E * G : 0);
  s.bar = reinterpret_cast<unsigned long long*>(s.loadi + E);
  s.tick = s.bar + 1;
  float* f = reinterpret_cast<float*>(s.tick + G);
  s.x = f;           f += E * R;
  s.xc = f;          f += E * R;
  s.loadf = f;       f += E;
  s.rowsum = f;      f += E;
  s.dl = f;          f += G;
  s.dl2 = f;         f += G;
  s.wts = f;         f += G;
  s.cap = f;         f += G;
  s.fac = f;         f += G;
  s.gt0 = f;         f += G;
  s.gt1 = f;         f += G;
  s.gt2 = f;         f += G;
  s.scal = f;        f += 4;
  s.xi = reinterpret_cast<int*>(f);
  s.emask = reinterpret_cast<unsigned*>(s.xi + E * R);
  s.didx = reinterpret_cast<short*>(s.emask + G * kMaskWords);
  s.pos = s.didx + G * E;
  s.dcnt = s.pos + E * R;
  s.dev = reinterpret_cast<signed char*>(s.dcnt + G);
  s.over = s.dev + E * R;
  return s;
}

size_t smem_bytes(int E, int G, int R, bool stage) {
  return (stage ? staged_bytes(E, G) : 0) + sizeof(long long) * (E + 1 + G) +
         sizeof(float) * (2 * E * R + 2 * E + 8 * G + 4) +
         sizeof(int) * static_cast<size_t>(E * R + G * kMaskWords) +
         sizeof(short) * (static_cast<size_t>(G) * E + E * R + G) +
         static_cast<size_t>(E) * R + G;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Thread 0: the instance's counts into s.cnt by bulk asynchronous copies,
// their completion counted on s.bar.  A block barrier must pass before any
// thread waits.
__device__ void stage_counts(const long long* input, const Smem& s, int E,
                             int G) {
  const unsigned bar = smem_addr(s.bar);
  const unsigned bytes = static_cast<unsigned>(staged_bytes(E, G));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
  const char* src = reinterpret_cast<const char*>(input);
  for (unsigned off = 0; off < bytes; off += kCopyChunk) {
    const unsigned n = bytes - off < kCopyChunk ? bytes - off : kCopyChunk;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s.cnt) + off),
        "l"(src + off), "r"(n), "r"(bar)
        : "memory");
  }
}

__device__ void wait_counts(const Smem& s) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(s.bar)),
      "r"(0u)
      : "memory");
}

// f32 a*b + c rounded once, computed in double as the plain version's
// _fma computes it (the product of two floats is exact in double).
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

// This lane's segment's bits of a warp ballot.
template <int RP>
__device__ __forceinline__ unsigned seg_bits(unsigned ballot) {
  if constexpr (RP == 32) {
    return ballot;
  } else {
    return (ballot >> ((threadIdx.x & 31) & ~(RP - 1))) & ((1u << RP) - 1u);
  }
}

// Sum over a segment's lanes (lanes at or past R carry 0), in each of them.
// Integers: the order does not matter.
template <int RP, typename T>
__device__ __forceinline__ T seg_sum(T v) {
#pragma unroll
  for (int off = 1; off < RP; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Position of this lane's value in a stable descending sort of its
// segment's lanes 0..R-1 (ties in lane order), as argsort(argsort(-v,
// stable)); `sl` is the lane's place in its segment.
template <int RP, typename T>
__device__ __forceinline__ int rank_desc(T v, int sl, int R) {
  int rank = 0;
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const T o = __shfl_sync(kFull, v, k, RP);
    if (k < R) rank += (o > v) || (o == v && k < sl);
  }
  return rank;
}

// a / b rounded once for b > 0; a zero a is a / b itself and skips the
// division
__device__ __forceinline__ float div_pos(float a, float b) {
  return a == 0.f ? a : __fdiv_rn(a, b);
}

// sum / n rounded once (n a constant once unrolled): a product where n is a
// power of two (the same rounding of the same value), else a division.
__device__ __forceinline__ float level_of(float sum, int n) {
  if (n == 1) return sum;
  if ((n & (n - 1)) == 0)
    return __fmul_rn(sum, __frcp_rn(static_cast<float>(n)));
  return __fdiv_rn(sum, static_cast<float>(n));
}

// a * (total > 0 ? budget / total : 0), the fill's rescale onto the exact
// budget; where total == budget the factor is 1 (or a is 0), so a itself.
__device__ __forceinline__ float rescale(float a, float budget, float total) {
  if (total == budget) return a;
  return __fmul_rn(a, total > 0.f ? __fdiv_rn(budget, total) : 0.f);
}

// One water-fill of `budget` onto the levels of one expert's replicas, on a
// segment of RP lanes: lane r of the segment holds replica r (`valid`
// false for padding and for lanes at or past R), `lv` its device's load
// without the expert, `w` its device's weight.  Uniform (!weighted): pour
// onto lv; weighted: onto t = lv / w with fill rate w.  The total that
// keeps the budget exact is added in sorted order (Gauss-Seidel's
// water_fill) or in replica order (the Jacobi sweep).  Returns this
// replica's allocation.
//
// RP <= 8: every lane of the segment gathers the levels and computes the
// whole fill itself, in registers.
template <int RP, bool weighted, bool sorted_total>
__device__ __forceinline__ float fill_small(float lv, bool valid, float w,
                                            float budget, int R) {
  const float wv = valid ? w : 1.f;
  const float t = valid ? (weighted ? div_pos(lv, wv) : lv) : kBig;
  const unsigned vm = seg_bits<RP>(__ballot_sync(kFull, valid));
  float tk[RP], wk[RP];
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    tk[k] = __shfl_sync(kFull, t, k, RP);
    wk[k] = 0.f;
    if constexpr (weighted) {
      const float o = __shfl_sync(kFull, wv, k, RP);
      wk[k] = (vm >> k) & 1u ? o : 0.f;
    }
  }
  // the levels in a stable ascending sort (ties in replica order)
  float srt[RP], wsr[RP];
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    srt[p] = kBig;
    wsr[p] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < RP; ++j)
      if (j < R) rank += (tk[j] < tk[k]) || (tk[j] == tk[k] && j < k);
#pragma unroll
    for (int p = 0; p < RP; ++p)
      if (k < R && rank == p) {
        srt[p] = tk[k];
        wsr[p] = wk[k];
      }
  }
  // with p+1 replicas filled the level is (budget + srt[0] + ... +
  // srt[p]) / (p+1), or (budget + Σ ws·ts) / Σ ws weighted; the first p
  // whose level lies in [srt[p], srt[p+1]] wins, else p = 0's
  float c = 0.f, cw = 0.f, level = 0.f;
#pragma unroll
  for (int p = 0; p < RP; ++p) {
    if (p >= R) break;
    float tau;
    if constexpr (weighted) {
      const float wt = __fmul_rn(wsr[p], srt[p]);
      c = p ? __fadd_rn(c, wt) : wt;
      cw = p ? __fadd_rn(cw, wsr[p]) : wsr[p];
      tau = __fdiv_rn(__fadd_rn(budget, c), fmaxf(cw, 1e-30f));
    } else {
      c = p ? __fadd_rn(c, srt[p]) : srt[p];
      tau = level_of(__fadd_rn(budget, c), p + 1);
    }
    if (p == 0) level = tau;
    const float nxt = (p + 1 < RP && p + 1 < R) ? srt[p + 1 < RP ? p + 1 : p]
                                                : kBig;
    if (tau >= __fsub_rn(srt[p], kSlack) && tau <= __fadd_rn(nxt, kSlack)) {
      level = tau;
      break;
    }
  }
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    if (k >= R) break;
    float a;
    if constexpr (sorted_total) {
      a = fmaxf(__fsub_rn(level, srt[k]), 0.f);
      if constexpr (weighted) a = __fmul_rn(a, wsr[k]);
    } else {
      a = fmaxf(__fsub_rn(level, tk[k]), 0.f);
      if constexpr (weighted) a = __fmul_rn(a, wk[k]);
      if (!((vm >> k) & 1u)) a = 0.f;
    }
    total = k ? __fadd_rn(total, a) : a;
  }
  float mine = fmaxf(__fsub_rn(level, t), 0.f);
  if constexpr (weighted) mine = __fmul_rn(mine, wv);
  return valid ? rescale(mine, budget, total) : 0.f;
}

// RP 16 and 32: the lanes share the fill; after the sort, lane p of the
// segment (`sl`) stands for sorted position p and adds its own prefix left
// to right.  `in`: sl < R on a live segment.
template <int RP, bool weighted, bool sorted_total>
__device__ __forceinline__ float fill_wide(float lv, bool valid, bool in,
                                           float w, float budget, int sl,
                                           int R) {
  const float wv = valid ? w : 1.f;
  const float t = valid ? (weighted ? div_pos(lv, wv) : lv) : kBig;
  const float wz = valid ? wv : 0.f;
  int rank = 0;   // stable ascending rank
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const float o = __shfl_sync(kFull, t, k, RP);
    if (k < R) rank += (o < t) || (o == t && k < sl);
  }
  int src = 0;    // the replica at sorted position sl
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const int rk = __shfl_sync(kFull, rank, k, RP);
    if (k < R && rk == sl) src = k;
  }
  const float sp = __shfl_sync(kFull, t, src, RP);
  const float ws = __shfl_sync(kFull, wz, src, RP);
  float c = 0.f, cw = 0.f;
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const float tk = __shfl_sync(kFull, sp, k, RP);
    if constexpr (weighted) {
      const float wk = __shfl_sync(kFull, ws, k, RP);
      if (k == 0) {
        c = __fmul_rn(wk, tk);
        cw = wk;
      } else if (k <= sl) {
        c = __fadd_rn(c, __fmul_rn(wk, tk));
        cw = __fadd_rn(cw, wk);
      }
    } else {
      if (k == 0) c = tk;
      else if (k <= sl) c = __fadd_rn(c, tk);
    }
  }
  const float tau =
      weighted ? __fdiv_rn(__fadd_rn(budget, c), fmaxf(cw, 1e-30f))
               : __fdiv_rn(__fadd_rn(budget, c), static_cast<float>(sl + 1));
  const float up = __shfl_sync(kFull, sp, sl + 1 < RP ? sl + 1 : sl, RP);
  const float nxt = sl + 1 < R ? up : kBig;
  const bool ok = in && tau >= __fsub_rn(sp, kSlack) &&
                  tau <= __fadd_rn(nxt, kSlack);
  const unsigned hit = seg_bits<RP>(__ballot_sync(kFull, ok));
  const float level = __shfl_sync(kFull, tau, hit ? __ffs(hit) - 1 : 0, RP);
  float al = fmaxf(__fsub_rn(level, sp), 0.f);
  if constexpr (weighted) al = __fmul_rn(al, ws);
  float alloc = __shfl_sync(kFull, al, rank, RP);   // back to replica order
  if (!valid) alloc = 0.f;
  const float part = sorted_total ? al : alloc;
  float total = __shfl_sync(kFull, part, 0, RP);   // left to right
#pragma unroll
  for (int k = 1; k < RP; ++k) {
    const float v = __shfl_sync(kFull, part, k, RP);
    if (k < R) total = __fadd_rn(total, v);
  }
  return valid ? rescale(alloc, budget, total) : 0.f;
}

template <int RP, bool weighted, bool sorted_total>
__device__ __forceinline__ float fill(float lv, bool valid, bool in, float w,
                                      float budget, int sl, int R) {
  if constexpr (RP <= 8)
    return fill_small<RP, weighted, sorted_total>(lv, valid, w, budget, R);
  else
    return fill_wide<RP, weighted, sorted_total>(lv, valid, in, w, budget,
                                                 sl, R);
}

// Device loads of a [E, R] iterate, a thread per device, expert by expert
// from 0 (solver.py::device_loads), over the device's own replicas only.
// Ends with a barrier.
__device__ void device_loads(const float* x, float* out, const Smem& s,
                             int E, int G) {
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const short* idx = s.didx + g * E;
    const int n = s.dcnt[g];
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) acc = __fadd_rn(acc, x[idx[k]]);
    out[g] = acc;
  }
  __syncthreads();
}

// The starting iterate of every expert (solver.py::_init_iterate): the
// proportional split, or `xi` rescaled onto the expert's tokens (xi may be
// s.x itself).  A thread per expert; ends with a barrier.
__device__ void init_iterate(const float* xi, const Smem& s, int E, int R) {
  for (int e = threadIdx.x; e < E; e += kThreads) {
    int n_valid = 0;
    for (int r = 0; r < R; ++r) n_valid += s.dev[e * R + r] >= 0;
    const float load = s.loadf[e];
    const float prop =
        __fdiv_rn(load, static_cast<float>(n_valid > 1 ? n_valid : 1));
    const float* row = xi ? xi + e * R : nullptr;
    float sum = 0.f;
    if (row) {
      sum = row[0];
      for (int r = 1; r < R; ++r) sum = __fadd_rn(sum, row[r]);
    }
    for (int r = 0; r < R; ++r) {
      float v = 0.f;
      if (s.dev[e * R + r] >= 0)
        v = (row && sum > 0.f)
                ? __fdiv_rn(__fmul_rn(row[r], load), fmaxf(sum, 1e-9f))
                : prop;
      s.x[e * R + r] = v;
    }
  }
  __syncthreads();
}

// Gauss-Seidel with one device (G = 1), on warp 0: every step depends on
// the one before, and the device's load stays in a register of every lane
// (at most one replica of an expert is valid).  The next expert's inputs
// are loaded before the step that precedes it.
template <int RP, bool weighted>
__device__ void gs_serial(const Smem& s, int E, int R, int sweeps) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < R;
  const float w = s.wts[0];
  float load = s.dl[0];
  int e = 0;
  int d = in ? s.dev[lane] : -1;
  float xe = in ? s.x[lane] : 0.f;
  float budget = s.loadf[0];
  for (int step = 0; step < sweeps * E; ++step) {
    const int en = e + 1 == E ? 0 : e + 1;
    const int d_next = in ? s.dev[en * R + lane] : -1;
    const float budget_next = s.loadf[en];
    float x_next = in ? s.x[en * R + lane] : 0.f;
    const bool valid = d >= 0;
    const float lv = __fsub_rn(load, xe);
    float alloc;
    if constexpr (RP == 1 && !weighted) {
      // one replica: the sorted levels, their prefix and the total are lv
      // and al themselves, and the level (budget + lv) / 1 is exact
      float al = fmaxf(__fsub_rn(__fadd_rn(budget, lv), lv), 0.f);
      if (al != budget)   // else budget / al is 1 (or al is 0)
        al = __fmul_rn(al, al > 0.f ? __fdiv_rn(budget, al) : 0.f);
      alloc = valid ? al : 0.f;
    } else {
      alloc = fill<RP, weighted, true>(lv, valid, in, w, budget,
                                       lane & (RP - 1), R);
    }
    const float moved = __fadd_rn(load, __fsub_rn(alloc, xe));
    if constexpr (RP == 1) {
      if (valid) load = moved;
    } else {
      const unsigned vm = seg_bits<RP>(__ballot_sync(kFull, valid));
      if (vm) load = __shfl_sync(kFull, moved, __ffs(vm) - 1);
    }
    if (in) s.x[e * R + lane] = alloc;
    if (en == e) x_next = in ? alloc : 0.f;   // E == 1: just written
    e = en;
    d = d_next;
    xe = x_next;
    budget = budget_next;
  }
}

// Gauss-Seidel on G > 1 devices as a dataflow over the block: warp w runs
// the steps of experts w, w + 16, ..., in sequence order, each on lanes
// 0..R-1.  Lane r polls its device's word in s.tick until it counts every
// earlier step that touches the device, takes the load from the same word,
// and after the fill stores the new load and the count + 1 in one 64-bit
// store: a load comes with its count, so no fence is needed.  Only this
// warp writes its experts' rows of x, so a row is read before the wait.
// Every dependency is an earlier step, and the lowest step not done has
// its warp and its inputs, so the block cannot deadlock.
template <int RP, bool weighted>
__device__ void gs_dataflow(const Smem& s, int E, int R, int sweeps) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < R;
  const int sl = lane & (RP - 1);
  for (int sweep = 0; sweep < sweeps; ++sweep)
  for (int e = threadIdx.x >> 5; e < E; e += kWarps) {
    const int d = in ? s.dev[e * R + lane] : -1;
    const bool valid = d >= 0;
    const int g = valid ? d : 0;
    const float budget = s.loadf[e];
    const float w = weighted ? s.wts[g] : 1.f;
    const float xe = in ? s.x[e * R + lane] : 0.f;
    const unsigned ticket =
        valid ? sweep * s.dcnt[g] + s.pos[e * R + lane] : 0u;
    float dl_g = 0.f;
    if (valid) {
      const volatile unsigned long long* word = s.tick + g;
      unsigned long long v = *word;
      while (static_cast<unsigned>(v >> 32) != ticket) {
        __nanosleep(kSpinNs);
        v = *word;
      }
      dl_g = __uint_as_float(static_cast<unsigned>(v));
    }
    __syncwarp();
    const float alloc = fill<RP, weighted, true>(__fsub_rn(dl_g, xe), valid,
                                                 in, w, budget, sl, R);
    if (valid)
      *reinterpret_cast<volatile unsigned long long*>(s.tick + g) =
          static_cast<unsigned long long>(ticket + 1) << 32 |
          __float_as_uint(__fadd_rn(dl_g, __fsub_rn(alloc, xe)));
    if (in) s.x[e * R + lane] = alloc;
  }
}

// Gauss-Seidel: sweeps x E water-fill steps from the iterate in s.x
// (solver.py::_gauss_seidel), with device weights s.wts if `weighted`.
template <int RP, bool weighted>
__device__ void gauss_seidel(const Smem& s, int E, int G, int R,
                             int sweeps) {
  device_loads(s.x, s.dl, s, E, G);
  if (G == 1) {
    if (threadIdx.x < 32) gs_serial<RP, weighted>(s, E, R, sweeps);
  } else {
    for (int g = threadIdx.x; g < G; g += kThreads)
      s.tick[g] = __float_as_uint(s.dl[g]);   // no step done yet
    __syncthreads();
    gs_dataflow<RP, weighted>(s, E, R, sweeps);
  }
  __syncthreads();
}

// Damped Jacobi (solver.py::_jacobi_solve_one): the starting iterate from
// `xi` (global warm start, s.x, or null), then per sweep the device loads,
// a barrier, every expert's water-fill against them (a segment an expert,
// 32 / RP a warp) and the damped step fma((1 - d), x, d * alloc); then the
// row sums pinned to the loads.
template <int RP, bool weighted>
__device__ void jacobi(const float* xi, const Smem& s, int E, int G, int R,
                       int sweeps) {
  init_iterate(xi, s, E, R);
  constexpr int kSeg = 32 / RP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane & (RP - 1), seg = lane / RP;
  const float damp = s.scal[0];
  const float keep = __fsub_rn(1.f, damp);
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    device_loads(s.x, s.dl, s, E, G);
    for (int e0 = warp * kSeg; e0 < E; e0 += kWarps * kSeg) {
      const int e = e0 + seg;
      const bool in = e < E && sl < R;
      const int d = in ? s.dev[e * R + sl] : -1;
      const bool valid = d >= 0;
      const int g = valid ? d : 0;
      const float xv = in ? s.x[e * R + sl] : 0.f;
      const float lv = __fsub_rn(s.dl[g], xv);
      const float alloc = fill<RP, weighted, false>(
          lv, valid, in, weighted ? s.wts[g] : 1.f, e < E ? s.loadf[e] : 0.f,
          sl, R);
      if (in) s.x[e * R + sl] = fma_once(keep, xv, __fmul_rn(damp, alloc));
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float* row = s.x + e * R;
    float sum = row[0];
    for (int r = 1; r < R; ++r) sum = __fadd_rn(sum, row[r]);
    for (int r = 0; r < R; ++r) {
      float v = row[r];
      if (sum > 0.f)
        v = __fdiv_rn(__fmul_rn(v, s.loadf[e]), fmaxf(sum, 1e-9f));
      row[r] = s.dev[e * R + r] >= 0 ? v : 0.f;
    }
  }
  __syncthreads();
}

// project_mem_caps: kPasses passes toward device loads <= caps, each
// expert's row sum kept.  Threads per device and per expert; ends with a
// barrier.
__device__ void project(const Smem& s, int E, int G, int R) {
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float sum = s.x[e * R];
    for (int r = 1; r < R; ++r) sum = __fadd_rn(sum, s.x[e * R + r]);
    s.rowsum[e] = sum;
  }
  for (int pass = 0; pass < kPasses; ++pass) {
    device_loads(s.x, s.dl, s, E, G);
    bool mine = false;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      const bool o = s.dl[g] > s.cap[g];
      s.over[g] = o;
      s.fac[g] = o ? __fdiv_rn(s.cap[g], fmaxf(s.dl[g], 1e-9f)) : 1.f;
      mine = mine || o;
    }
    const bool any = __syncthreads_or(mine);
    for (int i = threadIdx.x; i < E * R; i += kThreads) {
      const int d = s.dev[i];
      s.xc[i] = (d >= 0 && s.over[d]) ? __fmul_rn(s.x[i], s.fac[d]) : s.x[i];
    }
    __syncthreads();
    device_loads(s.xc, s.dl2, s, E, G);
    for (int e = threadIdx.x; e < E; e += kThreads) {
      const float* xc = s.xc + e * R;
      float* x = s.x + e * R;
      const signed char* dv = s.dev + e * R;
      float csum = xc[0], hsum = 0.f, bsum = 0.f;
      for (int r = 1; r < R; ++r) csum = __fadd_rn(csum, xc[r]);
      const float deficit = __fsub_rn(s.rowsum[e], csum);
      for (int r = 0; r < R; ++r) {
        const int d = dv[r];
        const float hr = (d >= 0 && !s.over[d])
                             ? fmaxf(__fsub_rn(s.cap[d], s.dl2[d]), 0.f)
                             : 0.f;
        const float b = d >= 0 ? x[r] : 0.f;
        hsum = r ? __fadd_rn(hsum, hr) : hr;
        bsum = r ? __fadd_rn(bsum, b) : b;
      }
      bsum = fmaxf(bsum, 1e-9f);
      if (any)
        for (int r = 0; r < R; ++r) {
          const int d = dv[r];
          const float hr = (d >= 0 && !s.over[d])
                               ? fmaxf(__fsub_rn(s.cap[d], s.dl2[d]), 0.f)
                               : 0.f;
          const float b = d >= 0 ? x[r] : 0.f;
          const float share = hsum > 0.f
                                  ? __fdiv_rn(hr, fmaxf(hsum, 1e-9f))
                                  : __fdiv_rn(b, bsum);
          x[r] = fma_once(deficit, share, xc[r]);
        }
    }
    __syncthreads();
  }
}

// The sum of all of x in the reference's reduction tree
// (solver.py::_full_sum): windows of 32 rows; in each, 8 lanes adding rows
// l, l + 8, ... from 0, halved l + 4, + 2, + 1, then the rows past the
// last full 8; windows added in order.  On warp 0, the result in lane 0.
__device__ float full_sum(const float* x, int E, int R) {
  const int lane = threadIdx.x & 31;
  float total = 0.f;
  for (int w0 = 0; w0 < E; w0 += 32) {
    const int n = E - w0 < 32 ? E - w0 : 32;
    const int nv = n / 8 * 8;
    float acc = 0.f;
    if (lane < 8)
      for (int b = 0; b < nv; b += 8)
        for (int c = 0; c < R; ++c)
          acc = __fadd_rn(acc, x[(w0 + b + lane) * R + c]);
    for (int h = 4; h >= 1; h >>= 1)
      acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, h));
    for (int r = nv; r < n; ++r)
      for (int c = 0; c < R; ++c) acc = __fadd_rn(acc, x[(w0 + r) * R + c]);
    total = __fadd_rn(total, acc);
  }
  return total;
}

// The caps' effective weights into s.wts (solver.py::
// _cap_effective_weights): min(w_g, cap_g / m*), m* from the sorted
// breakpoints cap_g / w_g.  `weights`: the device weights, or null.
// Ends with a barrier.
__device__ void cap_weights(const float* weights, const Smem& s, int E,
                            int G, int R) {
  const int tid = threadIdx.x;
  // the breakpoints and their stable ascending ranks
  for (int g = tid; g < G; g += kThreads) {
    const float wb = weights ? weights[g] : 1.f;
    s.fac[g] = __fdiv_rn(s.cap[g], fmaxf(wb, 1e-9f));
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    const float t = s.fac[g];
    int rank = 0;
    for (int j = 0; j < G; ++j)
      rank += (s.fac[j] < t) || (s.fac[j] == t && j < g);
    s.gt0[rank] = t;
    s.gt1[rank] = weights ? weights[g] : 1.f;
    s.gt2[rank] = s.cap[g];
  }
  __syncthreads();
  if (tid < 32) {
    const float total = full_sum(s.x, E, R);
    if (tid == 0) {
      // with the k cheapest-breakpoint devices capped:
      //   m_k = (total - Σ_{i<k} cap_i) / Σ_{i>=k} w_i on [t_{k-1}, t_k]
      float wrem = 0.f;
      for (int k = G - 1; k >= 0; --k) {
        wrem = k == G - 1 ? s.gt1[k] : __fadd_rn(wrem, s.gt1[k]);
        s.dl2[k] = wrem;
      }
      float ccap = 0.f, m_star = 0.f;
      bool found = false;
      for (int k = 0; k < G && !found; ++k) {
        const float m = __fdiv_rn(__fsub_rn(total, ccap), fmaxf(s.dl2[k],
                                                                 1e-9f));
        const float prev = k ? s.gt0[k - 1] : __int_as_float(0xff800000);
        if (m >= __fsub_rn(prev, kSlack) && m <= __fadd_rn(s.gt0[k], kSlack) &&
            m > 0.f) {
          m_star = m;
          found = true;
        }
        ccap = k ? __fadd_rn(ccap, s.gt2[k]) : s.gt2[0];
      }
      if (!found) m_star = __fmul_rn(2.f, s.gt0[G - 1]);
      s.scal[1] = m_star;
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    const float wb = weights ? weights[g] : 1.f;
    const float w = fminf(wb, __fdiv_rn(s.cap[g], fmaxf(s.scal[1], 1e-9f)));
    s.wts[g] = fmaxf(w, 1e-6f);
  }
  __syncthreads();
}

template <int RP>
__global__ void __launch_bounds__(kThreads, 1) microep_sched_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = a.E, G = a.G, R = a.R;
  const Smem s = carve(smem, E, G, R, a.stage);
  constexpr int kSeg = 32 / RP;   // segments a warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sl = lane & (RP - 1), seg = lane / RP;
  // this block's instance
  const long long b = blockIdx.x;
  const long long* input = a.input + b * E * G;
  const float* x_init = a.x_init ? a.x_init + b * E * R : nullptr;
  float* x_out = a.x_out + b * E * R;
  long long* x_int = a.x_int + b * E * R;
  long long* flow = a.flow + b * E * G * R;
  const bool weighted = a.weights != nullptr;

  // ---- 0. set-up
  if (a.stage && tid == 0) stage_counts(input, s, E, G);
  for (int i = tid; i < E * R; i += kThreads)
    s.dev[i] = static_cast<signed char>(a.dev[i] >= 0 ? a.dev[i] : -1);
  for (int g = tid; g < G; g += kThreads) {
    s.wts[g] = weighted ? a.weights[g] : 1.f;
    s.cap[g] = a.caps ? a.caps[g] : 0.f;
  }
  for (int i = tid; i < G * kMaskWords; i += kThreads) s.emask[i] = 0u;
  __syncthreads();
  for (int i = tid; i < E * R; i += kThreads) {
    const int d = s.dev[i], e = i / R;
    if (d >= 0) atomicOr(s.emask + d * kMaskWords + e / 32, 1u << (e % 32));
  }
  __syncthreads();
  // each device's replicas in expert order (its loads add in that order),
  // and each replica's place in its device's list: the experts below it
  // in the device's mask
  for (int i = tid; i < E * R; i += kThreads) {
    const int d = s.dev[i], e = i / R;
    if (d >= 0) {
      const unsigned* m = s.emask + d * kMaskWords;
      int p = __popc(m[e / 32] & ((1u << (e % 32)) - 1u));
      for (int w = 0; w < e / 32; ++w) p += __popc(m[w]);
      s.pos[i] = static_cast<short>(p);
      s.didx[d * E + p] = static_cast<short>(i);
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    int n = 0;
    for (int w = 0; w < kMaskWords; ++w)
      n += __popc(s.emask[g * kMaskWords + w]);
    s.dcnt[g] = static_cast<short>(n);
  }
  const long long* cnt = a.stage ? s.cnt : input;
  if (a.stage) wait_counts(s);
  // tokens per expert, four experts a warp at once (integer sums: any
  // order)
  for (int e0 = warp; e0 < E; e0 += 4 * kWarps) {
    long long sum[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kWarps;
      sum[u] = 0;
      if (e < E)
        for (int g = lane; g < G; g += 32) sum[u] += cnt[e * G + g];
    }
    int part[4];   // an expert's tokens are below 2^31 (s.xi)
#pragma unroll
    for (int u = 0; u < 4; ++u) part[u] = static_cast<int>(sum[u]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        part[u] += __shfl_xor_sync(kFull, part[u], off);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kWarps;
        if (e < E) {
          s.loadi[e] = part[u];
          s.loadf[e] = __int2float_rn(part[u]);
        }
      }
  }
  __syncthreads();
  // the Jacobi step: 1 / the most replicas a device hosts, weight-
  // normalized with weights (solver.py::_jacobi_damping)
  if (a.jacobi && !a.vanilla) {
    for (int g = tid; g < G; g += kThreads) {
      float o = static_cast<float>(s.dcnt[g]);
      if (weighted) {
        float mean = a.weights[0];
        for (int j = 1; j < G; ++j) mean = __fadd_rn(mean, a.weights[j]);
        mean = fmaxf(__fdiv_rn(mean, static_cast<float>(G)), 1e-30f);
        o = __fdiv_rn(__fmul_rn(o, a.weights[g]), mean);
      }
      s.gt0[g] = o;
    }
    __syncthreads();
    if (tid == 0) {
      float top = s.gt0[0];
      for (int g = 1; g < G; ++g) top = fmaxf(top, s.gt0[g]);
      s.scal[0] = __fdiv_rn(1.f, fmaxf(top, 1.f));
    }
    __syncthreads();
  }

  if (a.vanilla) {
    // ---- 2'. Megatron EP: each token to the replicas on its own row; a
    // warp an expert, a segment a source, a lane a (source, replica) pair
    for (int i = tid; i < E * R; i += kThreads)
      x_out[i] = x_init ? x_init[i] : 0.f;
    for (int e = warp; e < E; e += kWarps) {
      const bool in = sl < R;
      const int d = in ? s.dev[e * R + sl] : -1;
      const int row = d >= 0 ? d / a.cols : -1;
      long long xi = 0;
      for (int g0 = 0; g0 < G; g0 += kSeg) {
        const int g = g0 + seg;
        const bool live = g < G;
        const long long f = (live && row == g / a.cols) ? cnt[e * G + g] : 0LL;
        xi += f;
        if (in && live)
          flow[(static_cast<long long>(e) * G + g) * R + sl] = f;
      }
#pragma unroll
      for (int off = RP; off < 32; off <<= 1)
        xi += __shfl_xor_sync(kFull, xi, off);
      if (lane < R) {
        x_int[e * R + lane] = xi;
        s.xi[e * R + lane] = static_cast<int>(xi);
      }
    }
  } else {
    // ---- 1. solve
    if (a.jacobi) {
      if (weighted)
        jacobi<RP, true>(x_init, s, E, G, R, a.sweeps);
      else
        jacobi<RP, false>(x_init, s, E, G, R, a.sweeps);
    } else {
      init_iterate(x_init, s, E, R);
      if (weighted)
        gauss_seidel<RP, true>(s, E, G, R, a.sweeps);
      else
        gauss_seidel<RP, false>(s, E, G, R, a.sweeps);
    }
    if (a.caps) {   // the second solve runs on the caps' weights
      project(s, E, G, R);
      cap_weights(a.weights, s, E, G, R);
      if (a.jacobi)
        jacobi<RP, true>(s.x, s, E, G, R, a.sweeps);
      else
        gauss_seidel<RP, true>(s, E, G, R, a.sweeps);
      project(s, E, G, R);
    }

    // ---- 2. round (rounding.py), a segment an expert
    for (int e0 = warp * kSeg; e0 < E; e0 += kWarps * kSeg) {
      const int e = e0 + seg;
      const bool in = e < E && sl < R;
      const int d = in ? s.dev[e * R + sl] : -1;
      const bool valid = d >= 0;
      const float xv = valid ? s.x[e * R + sl] : 0.f;
      const long long load = e < E ? s.loadi[e] : 0LL;
      long long base = in ? static_cast<long long>(floorf(xv)) : 0;
      // take any overshoot off the largest entries
      const long long over = max(seg_sum<RP>(base) - load, 0LL);
      int rank = rank_desc<RP>(base, sl, R);
      base = max(base - (rank < over ? 1LL : 0LL), 0LL);
      const float frac = valid ? __fsub_rn(xv, __ll2float_rn(base)) : -1.f;
      const long long deficit =
          min(load - seg_sum<RP>(in ? base : 0LL),
              static_cast<long long>(
                  __popc(seg_bits<RP>(__ballot_sync(kFull, valid)))));
      rank = rank_desc<RP>(frac, sl, R);
      const long long xi = valid ? base + (rank < deficit ? 1LL : 0LL) : 0LL;
      if (in) {
        x_int[e * R + sl] = xi;
        s.xi[e * R + sl] = static_cast<int>(xi);
      }
    }
    __syncthreads();

    // ---- 3. route (routing.py, Algorithm 1): a warp an expert, a segment
    // a source, a lane a (source, replica) pair.  Every count here is at
    // most the expert's tokens (below 2^31, as s.xi holds them), so int
    // holds it; the share's product takes 64 bits.
    for (int e = warp; e < E; e += kWarps) {
      const bool in = sl < R;
      const int d = in ? s.dev[e * R + sl] : -1;
      const bool valid = d >= 0;
      const long long* __restrict__ ce = cnt + static_cast<long long>(e) * G;
      long long* __restrict__ fe = flow + static_cast<long long>(e) * G * R;
      const int xi = in ? s.xi[e * R + sl] : 0;
      // phase 1: tokens on the replica's own device stay there (none
      // without locality)
      const int local =
          (valid && a.locality) ? min(static_cast<int>(ce[d]), xi) : 0;
      const int rem_x = xi - local;
      // greedy: replica r fills the interval [b_prev, b_cum) of the tokens
      int b_cum = rem_x;
#pragma unroll
      for (int off = 1; off < RP; off <<= 1) {
        const int t = __shfl_up_sync(kFull, b_cum, off, RP);
        if (sl >= off) b_cum += t;
      }
      const int b_prev = b_cum - rem_x;
      const float tot = __int2float_rn(max(seg_sum<RP>(rem_x), 1));
      int a_before = 0;   // greedy: tokens of the earlier chunks
#pragma unroll 4
      for (int g0 = 0; g0 < G; g0 += kSeg) {
        const int g = g0 + seg;
        const bool live = g < G;
        // e's replica on g, if any, and the tokens of g it has not kept
        const unsigned m = seg_bits<RP>(__ballot_sync(kFull, valid && d == g));
        const int local_g = __shfl_sync(kFull, local, m ? __ffs(m) - 1 : 0, RP);
        const int rem_in =
            (live ? static_cast<int>(ce[g]) : 0) - (m ? local_g : 0);
        int remote;
        if (a.greedy) {
          // the sources' inclusive prefix over the chunk
          int a_cum = rem_in;
#pragma unroll
          for (int off = RP; off < 32; off <<= 1) {
            const int t = __shfl_up_sync(kFull, a_cum, off);
            if (lane >= off) a_cum += t;
          }
          const int chunk = __shfl_sync(kFull, a_cum, 31);
          a_cum += a_before;
          a_before += chunk;
          remote = max(min(a_cum, b_cum) - max(a_cum - rem_in, b_prev), 0);
        } else {
          // proportional, largest remainder per source device
          const float share = div_pos(
              __ll2float_rn(static_cast<long long>(rem_in) * rem_x), tot);
          const int sb = static_cast<int>(floorf(share));
          const float fr = valid ? __fsub_rn(share, __int2float_rn(sb)) : -1.f;
          const int def = rem_in - seg_sum<RP>(in ? sb : 0);
          const int rk = rank_desc<RP>(fr, sl, R);
          remote = valid ? sb + (rk < def ? 1 : 0) : 0;
        }
        if (in && live) fe[g * R + sl] = remote + (d == g ? local : 0);
      }
    }
    for (int i = tid; i < E * R; i += kThreads) x_out[i] = s.x[i];
  }
  // x_int written above is visible to the whole block past this barrier
  __syncthreads();

  // ---- 4. device loads of x_int, expert by expert, and the balance
  for (int g = tid; g < G; g += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < s.dcnt[g]; ++k)
      acc = __fadd_rn(acc, static_cast<float>(s.xi[s.didx[g * E + k]]));
    s.dl[g] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    float mx = s.dl[0], sum = s.dl[0];
    float mxn = weighted ? __fdiv_rn(s.dl[0], a.weights[0]) : s.dl[0];
    for (int g = 1; g < G; ++g) {
      mx = fmaxf(mx, s.dl[g]);
      sum = __fadd_rn(sum, s.dl[g]);
      mxn = fmaxf(mxn, weighted ? __fdiv_rn(s.dl[g], a.weights[g]) : s.dl[g]);
    }
    const float mean = fmaxf(__fdiv_rn(sum, static_cast<float>(G)), 1e-9f);
    a.stats[2 * b] = mx;
    a.stats[2 * b + 1] = __fdiv_rn(mxn, mean);
  }
}

template <int RP>
cudaError_t launch(const Args& a, int batch, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {   // above 48 KB only after the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        microep_sched_kernel<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  microep_sched_kernel<RP><<<batch, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// `batch` MicroEP schedules on `stream`, one block each; returns the CUDA
// error of the launch (0 on success).  Sizes past the limits give
// cudaErrorInvalidValue.  weights and caps may be null; jacobi, vanilla
// and locality are 0 or 1; cols is the placement's row width (vanilla).
extern "C" int microep_schedule(const void* input, const void* dev,
                                const void* x_init, const void* weights,
                                const void* caps, void* x_out, void* x_int,
                                void* flow, void* stats, int batch, int E,
                                int G, int R, int sweeps, int greedy,
                                int jacobi, int vanilla, int locality,
                                int cols, void* stream) {
  if (batch < 1 || E < 1 || E > 256 || G < 1 || G > 64 || R < 1 || R > 32 ||
      sweeps < 0 || cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the counts go through shared memory where they fit and the bulk copy
  // can take them (16-byte aligned, a multiple of 16 bytes an instance)
  const bool stage = reinterpret_cast<std::uintptr_t>(input) % 16 == 0 &&
                     (E * G) % 2 == 0 &&
                     smem_bytes(E, G, R, true) <= kSmemLimit;
  const Args a{static_cast<const long long*>(input),
               static_cast<const long long*>(dev),
               static_cast<const float*>(x_init),
               static_cast<const float*>(weights),
               static_cast<const float*>(caps), static_cast<float*>(x_out),
               static_cast<long long*>(x_int), static_cast<long long*>(flow),
               static_cast<float*>(stats), E, G, R, sweeps, greedy, jacobi,
               vanilla, locality, cols, stage ? 1 : 0};
  const size_t smem = smem_bytes(E, G, R, stage);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (R <= 1) err = launch<1>(a, batch, smem, s);
  else if (R <= 2) err = launch<2>(a, batch, smem, s);
  else if (R <= 4) err = launch<4>(a, batch, smem, s);
  else if (R <= 8) err = launch<8>(a, batch, smem, s);
  else if (R <= 16) err = launch<16>(a, batch, smem, s);
  else err = launch<32>(a, batch, smem, s);
  return static_cast<int>(err);
}
