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
// most) but a serial chain of dependent steps.  Gauss-Seidel: E x sweeps
// water-fills, each reading the device loads the previous one wrote; the
// design keeps that chain inside one warp, with the iterate, the placement
// and the device loads in shared memory and no block-wide barrier on it:
// lane r holds replica r of the current expert, ranks the levels by
// shuffles, and the sorted prefix sums run in parallel over the lanes,
// each lane adding its own prefix left to right.  The next expert's inputs
// are loaded before the step that precedes it, and with one replica an
// expert and uniform weights (olmoe-1b-7b's G = 1 group) the step stays in
// registers.  Damped Jacobi: sweeps block-wide steps (the scheduler runs 2
// x its sweeps), each a water-fill of every expert at once, a warp an
// expert over all sixteen warps, a barrier, and the device loads rebuilt a
// thread per device in expert order.  Rounding and routing are independent
// per expert and run a warp per expert; the projection onto the memory
// caps runs a thread per expert and a thread per device.
//
// Phases of one launch (E <= 256 experts, G <= 64 devices, R <= 32
// replicas an expert, each device hosting at most one replica of an
// expert):
//   0. budgets, placement tables, weights and caps, the starting iterate
//      (proportional split or the warm start rescaled);
//   1. solve: Gauss-Seidel on warp 0, or damped Jacobi on the block;
//      with caps, project (4 passes), the caps' effective weights, solve
//      again, project;
//   2. round and route, a warp per expert; flow and x_int written
//      directly (vanilla mode: the same-row mask instead of 1 and 2);
//   3. device loads of x_int, their max and max (over weight) / mean.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;     // level of a padding replica
constexpr float kSlack = 1e-6f;   // the water-fill's interval slack
constexpr int kPasses = 4;        // project_mem_caps's passes

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
};

// The block's shared memory.
struct Smem {
  long long* loadi;   // [E] tokens per expert
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
  float* srt;         // [kWarps*32] a warp's sorted levels
  float* wsr;         // [kWarps*32] a warp's sorted weights
  float* aux;         // [kWarps*32] a warp's allocations
  float* scal;        // [4] damping, the caps' level
  int* xi;            // [E*R] integer replica loads
  short* didx;        // [G*E] device g's replicas (e*R + r), e ascending
  short* dcnt;        // [G] replicas on device g
  signed char* dev;   // [E*R]
  signed char* slot;  // [E*G] the replica of e on g, or -1
  signed char* over;  // [G] device over its cap
};

__device__ Smem carve(unsigned char* base, int E, int G, int R) {
  Smem s;
  s.loadi = reinterpret_cast<long long*>(base);
  float* f = reinterpret_cast<float*>(s.loadi + E);
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
  s.srt = f;         f += kWarps * 32;
  s.wsr = f;         f += kWarps * 32;
  s.aux = f;         f += kWarps * 32;
  s.scal = f;        f += 4;
  s.xi = reinterpret_cast<int*>(f);
  s.didx = reinterpret_cast<short*>(s.xi + E * R);
  s.dcnt = s.didx + G * E;
  s.dev = reinterpret_cast<signed char*>(s.dcnt + G);
  s.slot = s.dev + E * R;
  s.over = s.slot + E * G;
  return s;
}

size_t smem_bytes(int E, int G, int R) {
  return sizeof(long long) * E +
         sizeof(float) * (2 * E * R + 2 * E + 8 * G + 3 * kWarps * 32 + 4) +
         sizeof(int) * static_cast<size_t>(E) * R +
         sizeof(short) * (static_cast<size_t>(G) * E + G) +
         static_cast<size_t>(E) * R + static_cast<size_t>(E) * G + G;
}

// f32 a*b + c rounded once, computed in double as the plain version's
// _fma computes it (the product of two floats is exact in double).
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

// One expert's counts over G <= 64 sources, held two a lane: lane l has
// sources l and l + 32; `at(g)` hands any lane source g's count.
struct CountsRow {
  long long lo, hi;
  __device__ CountsRow(const long long* row, int G, int lane)
      : lo(lane < G ? row[lane] : 0LL),
        hi(lane + 32 < G ? row[lane + 32] : 0LL) {}
  // g the same in every lane
  __device__ long long at(int g) const {
    return __shfl_sync(kFull, g < 32 ? lo : hi, g & 31);
  }
  // g per lane
  __device__ long long at_lane(int g) const {
    const long long l = __shfl_sync(kFull, lo, g & 31);
    const long long h = __shfl_sync(kFull, hi, g & 31);
    return g < 32 ? l : h;
  }
};

// Sum over lanes 0..RP-1 (lanes at or past R carry 0), in every such lane.
// Integers: the order does not matter.
template <int RP>
__device__ __forceinline__ long long group_sum(long long v) {
#pragma unroll
  for (int off = 1; off < RP; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Position of this lane's value in a stable descending sort of lanes
// 0..R-1 (ties in lane order), as argsort(argsort(-v, stable)).
template <int RP, typename T>
__device__ __forceinline__ int rank_desc(T v, int lane, int R) {
  int rank = 0;
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const T o = __shfl_sync(kFull, v, k);
    if (k < R) rank += (o > v) || (o == v && k < lane);
  }
  return rank;
}

// One water-fill of `budget` onto the levels of one expert's replicas, on
// one warp: lane r holds replica r (lanes at or past R are `in` = false),
// `lv` its device's load without the expert, `w` its device's weight.
// Uniform (!weighted): pour onto lv; weighted: onto t = lv / w with fill
// rate w.  The total that keeps the budget exact is added in sorted order
// (Gauss-Seidel's water_fill) or in replica order (the Jacobi sweep).
// Returns lane r's allocation; srt, wsr and aux are the warp's scratch.
template <int RP, bool weighted, bool sorted_total>
__device__ float warp_fill(float lv, bool valid, bool in, float w,
                           float budget, int lane, int R, float* srt,
                           float* wsr, float* aux) {
  const float wv = valid ? w : 1.f;
  const float t = valid ? (weighted ? __fdiv_rn(lv, wv) : lv) : kBig;
  int rank = 0;   // stable ascending rank
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const float o = __shfl_sync(kFull, t, k);
    if (k < R) rank += (o < t) || (o == t && k < lane);
  }
  if (in) {
    srt[rank] = t;
    wsr[rank] = valid ? wv : 0.f;
  }
  __syncwarp();
  // from here lane p stands for sorted position p: with p+1 replicas
  // filled the level is (budget + srt[0] + ... + srt[p]) / (p+1), or
  // (budget + Σ ws·ts) / Σ ws weighted
  float tau = 0.f, sp = kBig, ws = 0.f;
  bool ok = false;
  if (in) {
    sp = srt[lane];
    ws = wsr[lane];
    if constexpr (weighted) {
      float cw = wsr[0], cwt = __fmul_rn(wsr[0], srt[0]);
#pragma unroll
      for (int i = 1; i < RP; ++i)
        if (i <= lane) {
          cw = __fadd_rn(cw, wsr[i]);
          cwt = __fadd_rn(cwt, __fmul_rn(wsr[i], srt[i]));
        }
      tau = __fdiv_rn(__fadd_rn(budget, cwt), fmaxf(cw, 1e-30f));
    } else {
      float c = srt[0];
#pragma unroll
      for (int i = 1; i < RP; ++i)
        if (i <= lane) c = __fadd_rn(c, srt[i]);
      tau = __fdiv_rn(__fadd_rn(budget, c), static_cast<float>(lane + 1));
    }
    const float nxt = lane + 1 < R ? srt[lane + 1] : kBig;
    ok = tau >= __fsub_rn(sp, kSlack) && tau <= __fadd_rn(nxt, kSlack);
  }
  const unsigned hit = __ballot_sync(kFull, ok);   // first such p
  const float level = __shfl_sync(kFull, tau, hit ? __ffs(hit) - 1 : 0);
  float al = fmaxf(__fsub_rn(level, sp), 0.f);
  if constexpr (weighted) al = __fmul_rn(al, ws);
  // back to replica order: lane r takes sorted position rank
  float alloc = __shfl_sync(kFull, al, rank);
  if (!valid) alloc = 0.f;
  __syncwarp();
  if (in) aux[lane] = sorted_total ? al : alloc;
  __syncwarp();
  float total = aux[0];   // left to right
#pragma unroll
  for (int i = 1; i < RP; ++i)
    if (i < R) total = __fadd_rn(total, aux[i]);
  __syncwarp();
  const float scale = total > 0.f ? __fdiv_rn(budget, total) : 0.f;
  return valid ? __fmul_rn(alloc, scale) : 0.f;
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

// The chain of gauss_seidel, on warp 0.
template <int RP, bool weighted>
__device__ void gs_chain(const Smem& s, int E, int R, int sweeps) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < R;
  int e = 0;
  int d = in ? s.dev[lane] : -1;
  float xe = in ? s.x[lane] : 0.f;
  float budget = s.loadf[0];
  for (int step = 0; step < sweeps * E; ++step) {
    // the next expert's placement, budget and iterate do not depend on
    // this step (lane r alone writes column r of x): load them first
    const int en = e + 1 == E ? 0 : e + 1;
    const int d_next = in ? s.dev[en * R + lane] : -1;
    const float budget_next = s.loadf[en];
    float x_next = in ? s.x[en * R + lane] : 0.f;
    const bool valid = d >= 0;
    const int g = valid ? d : 0;
    // level of this replica's device without e; padding goes last.  No
    // other lane writes dl[g] in this step (one replica of e a device)
    const float dl_g = s.dl[g];
    const float lv = __fsub_rn(dl_g, xe);
    float alloc;
    if constexpr (RP == 1 && !weighted) {
      // one replica: the sorted levels, their prefix and the total are
      // lv and al themselves, and the level (budget + lv) / 1 is exact
      float al = fmaxf(__fsub_rn(__fadd_rn(budget, lv), lv), 0.f);
      al = __fmul_rn(al, al > 0.f ? __fdiv_rn(budget, al) : 0.f);
      alloc = valid ? al : 0.f;
    } else {
      alloc = warp_fill<RP, weighted, true>(
          lv, valid, in, weighted ? s.wts[g] : 1.f, budget, lane, R, s.srt,
          s.wsr, s.aux);
    }
    if (valid) s.dl[g] = __fadd_rn(dl_g, __fsub_rn(alloc, xe));
    if (in) s.x[e * R + lane] = alloc;
    __syncwarp();
    if (en == e) x_next = in ? alloc : 0.f;   // E == 1: just written
    e = en;
    d = d_next;
    xe = x_next;
    budget = budget_next;
  }
}

// Gauss-Seidel: sweeps x E water-fill steps on warp 0 from the iterate in
// s.x (solver.py::_gauss_seidel), with device weights s.wts if `weighted`.
template <int RP, bool weighted>
__device__ void gauss_seidel(const Smem& s, int E, int G, int R,
                             int sweeps) {
  device_loads(s.x, s.dl, s, E, G);
  if (threadIdx.x < 32) gs_chain<RP, weighted>(s, E, R, sweeps);
  __syncthreads();
}

// Damped Jacobi (solver.py::_jacobi_solve_one): the starting iterate from
// `xi` (global warm start, s.x, or null), then per sweep the device loads,
// a barrier, every expert's water-fill against them (a warp an expert)
// and the damped step fma((1 - d), x, d * alloc); then the row sums
// pinned to the loads.
template <int RP, bool weighted>
__device__ void jacobi(const float* xi, const Smem& s, int E, int G, int R,
                       int sweeps) {
  init_iterate(xi, s, E, R);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in = lane < R;
  const float damp = s.scal[0];
  const float keep = __fsub_rn(1.f, damp);
  float* srt = s.srt + warp * 32;
  float* wsr = s.wsr + warp * 32;
  float* aux = s.aux + warp * 32;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    device_loads(s.x, s.dl, s, E, G);
    for (int e = warp; e < E; e += kWarps) {
      const int d = in ? s.dev[e * R + lane] : -1;
      const bool valid = d >= 0;
      const int g = valid ? d : 0;
      const float xv = in ? s.x[e * R + lane] : 0.f;
      const float lv = __fsub_rn(s.dl[g], xv);
      const float alloc = warp_fill<RP, weighted, false>(
          lv, valid, in, weighted ? s.wts[g] : 1.f, s.loadf[e], lane, R, srt,
          wsr, aux);
      if (in)
        s.x[e * R + lane] = fma_once(keep, xv, __fmul_rn(damp, alloc));
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
  const Smem s = carve(smem, E, G, R);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's instance
  const long long b = blockIdx.x;
  const long long* input = a.input + b * E * G;
  const float* x_init = a.x_init ? a.x_init + b * E * R : nullptr;
  float* x_out = a.x_out + b * E * R;
  long long* x_int = a.x_int + b * E * R;
  long long* flow = a.flow + b * E * G * R;
  const bool weighted = a.weights != nullptr;

  // ---- 0. set-up
  for (int e = warp; e < E; e += kWarps) {   // integer sums: any order
    const CountsRow c(input + e * G, G, lane);
    long long sum = c.lo + c.hi;
    for (int off = 16; off >= 1; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) {
      s.loadi[e] = sum;
      s.loadf[e] = __ll2float_rn(sum);
    }
  }
  for (int i = tid; i < E * R; i += kThreads)
    s.dev[i] = static_cast<signed char>(a.dev[i] >= 0 ? a.dev[i] : -1);
  for (int i = tid; i < E * G; i += kThreads) s.slot[i] = -1;
  for (int g = tid; g < G; g += kThreads) {
    s.wts[g] = weighted ? a.weights[g] : 1.f;
    s.cap[g] = a.caps ? a.caps[g] : 0.f;
  }
  __syncthreads();
  // slot[e][g]: the replica of e on device g, or -1
  for (int i = tid; i < E * R; i += kThreads)
    if (s.dev[i] >= 0)
      s.slot[(i / R) * G + s.dev[i]] = static_cast<signed char>(i % R);
  __syncthreads();
  // each device's replicas in expert order, for its loads
  for (int g = tid; g < G; g += kThreads) {
    int n = 0;
    for (int e = 0; e < E; ++e) {
      const int r = s.slot[e * G + g];
      if (r >= 0) s.didx[g * E + n++] = static_cast<short>(e * R + r);
    }
    s.dcnt[g] = static_cast<short>(n);
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
    // ---- 2'. Megatron EP: each token to the replicas on its own row
    for (int i = tid; i < E * R; i += kThreads)
      x_out[i] = x_init ? x_init[i] : 0.f;
    for (int e = warp; e < E; e += kWarps) {
      const bool in = lane < R;
      const int d = in ? s.dev[e * R + lane] : -1;
      const int row = d >= 0 ? d / a.cols : -1;
      const CountsRow c(input + e * G, G, lane);
      long long xi = 0;
      for (int g = 0; g < G; ++g) {
        const long long cg = c.at(g);
        const long long f = row == g / a.cols ? cg : 0LL;
        xi += f;
        if (in) flow[(static_cast<long long>(e) * G + g) * R + lane] = f;
      }
      if (in) {
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

    // ---- 2. round (rounding.py) and route (routing.py), a warp per expert
    for (int e = warp; e < E; e += kWarps) {
      const bool in = lane < R;
      const int d = in ? s.dev[e * R + lane] : -1;
      const bool valid = d >= 0;
      const float xv = valid ? s.x[e * R + lane] : 0.f;
      const long long load = s.loadi[e];
      long long base = in ? static_cast<long long>(floorf(xv)) : 0;
      // take any overshoot off the largest entries
      const long long over = max(group_sum<RP>(base) - load, 0LL);
      int rank = rank_desc<RP>(base, lane, R);
      base = max(base - (rank < over ? 1LL : 0LL), 0LL);
      const float frac = valid ? __fsub_rn(xv, __ll2float_rn(base)) : -1.f;
      const long long deficit =
          min(load - group_sum<RP>(in ? base : 0LL),
              static_cast<long long>(__popc(__ballot_sync(kFull, valid))));
      rank = rank_desc<RP>(frac, lane, R);
      const long long xi = valid ? base + (rank < deficit ? 1LL : 0LL) : 0LL;
      if (in) {
        x_int[e * R + lane] = xi;
        s.xi[e * R + lane] = static_cast<int>(xi);
      }

      // Algorithm 1, phase 1: tokens on the replica's own device stay
      // there (none without locality)
      const CountsRow c(input + e * G, G, lane);
      const long long at_d = c.at_lane(valid ? d : 0);
      const long long local = (valid && a.locality) ? min(at_d, xi) : 0LL;
      const long long rem_x = xi - local;
      // greedy: replica r fills the interval [b_prev, b_cum) of the tokens
      long long b_cum = rem_x;
#pragma unroll
      for (int off = 1; off < RP; off <<= 1) {
        const long long t = __shfl_up_sync(kFull, b_cum, off);
        if (lane >= off) b_cum += t;
      }
      const long long b_prev = b_cum - rem_x;
      const float tot = __ll2float_rn(max(group_sum<RP>(rem_x), 1LL));
      long long a_cum = 0;
      for (int g = 0; g < G; ++g) {
        const int rs = s.slot[e * G + g];   // e's replica on g, or -1
        const long long local_g = __shfl_sync(kFull, local, rs >= 0 ? rs : 0);
        const long long rem_in = c.at(g) - (rs >= 0 ? local_g : 0LL);
        long long remote;
        if (a.greedy) {
          a_cum += rem_in;
          remote = max(min(a_cum, b_cum) - max(a_cum - rem_in, b_prev), 0LL);
        } else {
          // proportional, largest remainder per source device
          const float share = __fdiv_rn(__ll2float_rn(rem_in * rem_x), tot);
          const long long sb = static_cast<long long>(floorf(share));
          const float fr = valid ? __fsub_rn(share, __ll2float_rn(sb)) : -1.f;
          const long long def = rem_in - group_sum<RP>(in ? sb : 0LL);
          const int rk = rank_desc<RP>(fr, lane, R);
          remote = valid ? sb + (rk < def ? 1LL : 0LL) : 0LL;
        }
        if (in)
          flow[(static_cast<long long>(e) * G + g) * R + lane] =
              remote + (d == g ? local : 0LL);
      }
    }
    for (int i = tid; i < E * R; i += kThreads) x_out[i] = s.x[i];
  }
  // x_int written above is visible to the whole block past this barrier
  __syncthreads();

  // ---- 3. device loads of x_int, expert by expert, and the balance
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
  const Args a{static_cast<const long long*>(input),
               static_cast<const long long*>(dev),
               static_cast<const float*>(x_init),
               static_cast<const float*>(weights),
               static_cast<const float*>(caps), static_cast<float*>(x_out),
               static_cast<long long*>(x_int), static_cast<long long*>(flow),
               static_cast<float*>(stats), E, G, R, sweeps, greedy, jacobi,
               vanilla, locality, cols};
  const size_t smem = smem_bytes(E, G, R);
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
