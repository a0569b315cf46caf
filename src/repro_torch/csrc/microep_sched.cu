// K4: the MicroEP scheduler of one MoE layer call, one block on an H100
// (sm_90a), with a plain C interface bound by kernels/sched.py.
//
// What it replaces.  No Pallas kernel: the reference computes the schedule
// inside its compiled step, as the Gauss-Seidel LPP-1 solver's lax.scan of
// E x sweeps water-fills (src/repro/core/solver_jax.py:231,
// solve_replica_loads, uniform weights, no memory caps), then
// largest-remainder rounding (src/repro/core/rounding.py) and Algorithm 1
// routing (src/repro/core/routing.py).  Eager PyTorch runs that scan as
// tens of thousands of small dependent launches a decode step; this kernel
// is one launch.  Its plain version is kernels/ref.py::schedule_ref, and it
// repeats that version's arithmetic operation for operation: every f32 sum
// is added in the same order (left to right over sorted replicas, expert by
// expert over device loads), with no contracted multiply-adds, so the
// iterate is equal bit for bit and the integer outputs are equal.
//
// What bounds it.  Not bytes or FLOPs (a few hundred KB and a few MFLOP at
// most) but a serial chain of E x sweeps dependent water-fill steps: each
// step reads the device loads the previous one wrote.  The design keeps
// that chain inside one warp, with the iterate, the placement and the
// device loads in shared memory and no block-wide barrier on it: lane r
// holds replica r of the current expert, ranks the levels by shuffles, and
// the sorted prefix sums run in parallel over the lanes, each lane adding
// its own prefix left to right.  The next expert's inputs are loaded
// before the step that precedes it, and with one replica an expert
// (olmoe-1b-7b's G = 1 group) the step stays in registers.  Rounding and
// routing are independent per expert and run a warp per expert on all
// sixteen warps; the device loads of the result run a thread per device.
//
// Phases of one launch (E <= 256 experts, G <= 64 devices, R <= 32
// replicas an expert, each device hosting at most one replica of an
// expert):
//   0. budgets, placement tables, the starting iterate (proportional split
//      or the warm start rescaled), device loads;
//   1. solve: sweeps x E water-fill steps on warp 0;
//   2. round and route, a warp per expert; flow and x_int written directly;
//   3. device loads of x_int, their max and max / mean.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;     // level of a padding replica
constexpr float kSlack = 1e-6f;   // the water-fill's interval slack

struct Args {
  const long long* input;   // [E, G] tokens per (expert, source device)
  const long long* dev;     // [E, R] replica -> device, -1 padding
  const float* x_init;    // [E, R] warm start, or null
  float* x_out;           // [E, R] solver iterate
  long long* x_int;       // [E, R] integer replica loads
  long long* flow;        // [E, G, R] routed tokens
  float* stats;           // [2] max device load, max / mean
  int E, G, R, sweeps, greedy;
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

template <int RP>
__global__ void __launch_bounds__(kThreads, 1) microep_sched_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = a.E, G = a.G, R = a.R;
  long long* loadi = reinterpret_cast<long long*>(smem);       // [E]
  float* x = reinterpret_cast<float*>(loadi + E);                // [E*R]
  float* loadf = x + E * R;                                      // [E]
  float* dl = loadf + E;                                         // [G]
  float* srt = dl + G;                                           // [32]
  float* alc = srt + 32;                                         // [32]
  signed char* dev = reinterpret_cast<signed char*>(alc + 32);   // [E*R]
  signed char* slot = dev + E * R;                               // [E*G]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- 0. set-up
  for (int e = tid; e < E; e += kThreads) {
    long long s = 0;
    for (int g = 0; g < G; ++g) s += a.input[e * G + g];
    loadi[e] = s;
    loadf[e] = __ll2float_rn(s);
  }
  for (int i = tid; i < E * R; i += kThreads)
    dev[i] = static_cast<signed char>(a.dev[i] >= 0 ? a.dev[i] : -1);
  for (int i = tid; i < E * G; i += kThreads) slot[i] = -1;
  __syncthreads();
  // slot[e][g]: the replica of e on device g, or -1
  for (int i = tid; i < E * R; i += kThreads)
    if (dev[i] >= 0)
      slot[(i / R) * G + dev[i]] = static_cast<signed char>(i % R);
  // the starting iterate (solver.py::_init_iterate)
  for (int e = tid; e < E; e += kThreads) {
    int n_valid = 0;
    for (int r = 0; r < R; ++r) n_valid += dev[e * R + r] >= 0;
    const float prop =
        __fdiv_rn(loadf[e], static_cast<float>(n_valid > 1 ? n_valid : 1));
    const float* xi = a.x_init ? a.x_init + e * R : nullptr;
    float s = 0.f;
    if (xi) {
      s = xi[0];
      for (int r = 1; r < R; ++r) s = __fadd_rn(s, xi[r]);
    }
    for (int r = 0; r < R; ++r) {
      float v = 0.f;
      if (dev[e * R + r] >= 0)
        v = (xi && s > 0.f)
                ? __fdiv_rn(__fmul_rn(xi[r], loadf[e]), fmaxf(s, 1e-9f))
                : prop;
      x[e * R + r] = v;
    }
  }
  __syncthreads();
  // device loads, expert by expert from 0 (solver.py::device_loads)
  for (int g = tid; g < G; g += kThreads) {
    float acc = 0.f;
    for (int e = 0; e < E; ++e) {
      const int r = slot[e * G + g];
      if (r >= 0) acc = __fadd_rn(acc, x[e * R + r]);
    }
    dl[g] = acc;
  }
  __syncthreads();

  // ---- 1. solve: the Gauss-Seidel chain on warp 0 (solver.py::water_fill)
  if (warp == 0) {
    const bool in = lane < R;
    int e = 0;
    int d = in ? dev[lane] : -1;
    float xe = in ? x[lane] : 0.f;
    float budget = loadf[0];
    for (int step = 0; step < a.sweeps * E; ++step) {
      // the next expert's placement, budget and iterate do not depend on
      // this step (lane r alone writes column r of x): load them first
      const int en = e + 1 == E ? 0 : e + 1;
      const int d_next = in ? dev[en * R + lane] : -1;
      const float budget_next = loadf[en];
      float x_next = in ? x[en * R + lane] : 0.f;
      const bool valid = d >= 0;
      const int g = valid ? d : 0;
      // level of this replica's device without e; padding goes last.  No
      // other lane writes dl[g] in this step (one replica of e a device)
      const float dl_g = dl[g];
      const float lv = valid ? __fsub_rn(dl_g, xe) : kBig;
      float alloc;
      if constexpr (RP == 1) {
        // one replica: the sorted levels, their prefix and the total are
        // lv and al themselves, and the level (budget + lv) / 1 is exact
        float al = fmaxf(__fsub_rn(__fadd_rn(budget, lv), lv), 0.f);
        al = __fmul_rn(al, al > 0.f ? __fdiv_rn(budget, al) : 0.f);
        alloc = valid ? al : 0.f;
      } else {
        int rank = 0;   // stable ascending rank
#pragma unroll
        for (int k = 0; k < RP; ++k) {
          const float o = __shfl_sync(kFull, lv, k);
          if (k < R) rank += (o < lv) || (o == lv && k < lane);
        }
        if (in) srt[rank] = lv;
        __syncwarp();
        // from here lane p stands for sorted position p: with p+1 replicas
        // filled the level is (budget + srt[0] + ... + srt[p]) / (p+1)
        float tau = 0.f, sp = kBig;
        bool ok = false;
        if (in) {
          sp = srt[lane];
          float c = srt[0];
#pragma unroll
          for (int i = 1; i < RP; ++i)
            if (i <= lane) c = __fadd_rn(c, srt[i]);
          tau = __fdiv_rn(__fadd_rn(budget, c), static_cast<float>(lane + 1));
          const float nxt = lane + 1 < R ? srt[lane + 1] : kBig;
          ok = tau >= __fsub_rn(sp, kSlack) && tau <= __fadd_rn(nxt, kSlack);
        }
        const unsigned hit = __ballot_sync(kFull, ok);   // first such p
        const float level = __shfl_sync(kFull, tau, hit ? __ffs(hit) - 1 : 0);
        float al = fmaxf(__fsub_rn(level, sp), 0.f);
        if (in) alc[lane] = al;
        __syncwarp();
        float total = alc[0];   // left to right, as the plain version
#pragma unroll
        for (int i = 1; i < RP; ++i)
          if (i < R) total = __fadd_rn(total, alc[i]);
        al = __fmul_rn(al, total > 0.f ? __fdiv_rn(budget, total) : 0.f);
        // back to replica order: lane r takes sorted position rank
        alloc = __shfl_sync(kFull, al, rank);
        if (!valid) alloc = 0.f;
      }
      if (valid) dl[g] = __fadd_rn(dl_g, __fsub_rn(alloc, xe));
      if (in) x[e * R + lane] = alloc;
      __syncwarp();
      if (en == e) x_next = in ? alloc : 0.f;   // E == 1: just written
      e = en;
      d = d_next;
      xe = x_next;
      budget = budget_next;
    }
  }
  __syncthreads();

  // ---- 2. round (rounding.py) and route (routing.py), a warp per expert
  for (int e = warp; e < E; e += kWarps) {
    const bool in = lane < R;
    const int d = in ? dev[e * R + lane] : -1;
    const bool valid = d >= 0;
    const float xv = valid ? x[e * R + lane] : 0.f;
    const long long load = loadi[e];
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
    if (in) a.x_int[e * R + lane] = xi;

    // Algorithm 1, phase 1: tokens on the replica's own device stay there
    const long long local = valid ? min(a.input[e * G + d], xi) : 0LL;
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
      const int rs = slot[e * G + g];   // e's replica on g, or -1
      const long long local_g = __shfl_sync(kFull, local, rs >= 0 ? rs : 0);
      const long long rem_in = a.input[e * G + g] - (rs >= 0 ? local_g : 0LL);
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
        a.flow[(static_cast<long long>(e) * G + g) * R + lane] =
            remote + (d == g ? local : 0LL);
    }
  }
  // x_int written above is visible to the whole block past this barrier
  __syncthreads();

  // ---- 3. device loads of x_int, expert by expert, and the balance
  for (int g = tid; g < G; g += kThreads) {
    float acc = 0.f;
    for (int e = 0; e < E; ++e) {
      const int r = slot[e * G + g];
      if (r >= 0) acc = __fadd_rn(acc, __ll2float_rn(a.x_int[e * R + r]));
    }
    dl[g] = acc;
  }
  for (int i = tid; i < E * R; i += kThreads) a.x_out[i] = x[i];
  __syncthreads();
  if (tid == 0) {
    float mx = dl[0], sum = dl[0];
    for (int g = 1; g < G; ++g) {
      mx = fmaxf(mx, dl[g]);
      sum = __fadd_rn(sum, dl[g]);
    }
    const float mean = fmaxf(__fdiv_rn(sum, static_cast<float>(G)), 1e-9f);
    a.stats[0] = mx;
    a.stats[1] = __fdiv_rn(mx, mean);
  }
}

template <int RP>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {   // above 48 KB only after the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        microep_sched_kernel<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  microep_sched_kernel<RP><<<1, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One MicroEP schedule on `stream`; returns the CUDA error of the launch
// (0 on success).  Sizes past the limits give cudaErrorInvalidValue.
extern "C" int microep_schedule(const void* input, const void* dev,
                                const void* x_init, void* x_out, void* x_int,
                                void* flow, void* stats, int E, int G, int R,
                                int sweeps, int greedy, void* stream) {
  if (E < 1 || E > 256 || G < 1 || G > 64 || R < 1 || R > 32 || sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const long long*>(input),
               static_cast<const long long*>(dev),
               static_cast<const float*>(x_init), static_cast<float*>(x_out),
               static_cast<long long*>(x_int), static_cast<long long*>(flow),
               static_cast<float*>(stats), E, G, R, sweeps, greedy};
  const size_t smem = sizeof(long long) * E +
                      sizeof(float) * (E * R + E + G + 64) +
                      static_cast<size_t>(E) * R + static_cast<size_t>(E) * G;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (R <= 1) err = launch<1>(a, smem, s);
  else if (R <= 2) err = launch<2>(a, smem, s);
  else if (R <= 4) err = launch<4>(a, smem, s);
  else if (R <= 8) err = launch<8>(a, smem, s);
  else if (R <= 16) err = launch<16>(a, smem, s);
  else err = launch<32>(a, smem, s);
  return static_cast<int>(err);
}
