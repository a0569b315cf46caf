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
//   forward scan (re-forms S_{t-1}; nothing of the forward is saved but its
//   inputs):
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
// What bounds it: the function reads q, k, v, lw, dO (and u) once and
// writes dq, dk, dv, dlw (and du) once, 9·BH·T·D f32 elements, against
// 12·D² + ~20·D operations a step and row (5·D² in the forward scan: S·dO
// and the state update; 7·D² in the reverse one: G·v, Gᵀ·k and G's update).
// At D = 64 that is 21 operations a byte, just above the card's f32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20): at rwkv6-7b's training geometry (BH 256,
// T 512, D 64) 6.4 GFLOP and 302 MB, a bound of ~0.1 ms.  This kernel is
// the simple form: each row is a block that walks its T steps one after the
// other, in f32 FMAs, so it is bound by the latency of the steps with only BH
// blocks in flight.  The sub-chunk algebra of K3 on the tensor cores is the
// way to the bound, and later work.
//
// Design: one block per row, 4·DP threads (DP = 64 for D ≤ 64, else 128).
//   * Forward scan: 4 threads a row i of S (tid = 4i + s), thread s holding
//     the columns j = 4c + s in registers.  S·dO_t is each thread's partial
//     sum in c order, then (s0 + s1) + (s2 + s3) by two warp shuffles; every
//     thread of the row then holds the same sum, so no shared memory or
//     barrier is needed within a step.
//   * Reverse scan: G is kept twice, bit for bit the same: 2 threads a row i
//     (threads 0 … 2·DP−1, columns j = 2c + h) for G·v, dk, r and dlw, and 2
//     threads a column j (threads 2·DP … 4·DP−1, rows i = 2c + h) for Gᵀ·k
//     and dv.  Each copy updates its entries with the same fmaf(w_i, G_ij,
//     q_i·dO_j), so the two never drift, and neither layout needs a
//     reduction across warps.
//   * Staging: the inputs of 1024/DP steps at a time (16 at D ≤ 64) are
//     copied to shared memory, w = exp(lw) formed once, and v_t·dO_t and
//     Σ_i u_i q_ti k_ti summed by one thread a step, in channel order.  The
//     reverse scan also stages p_t from dlw before it overwrites that tile.
//   * Every sum has a fixed order (no atomics): results repeat bit for bit.
//     ref.wkv6_bwd_ref repeats the order; it rounds each fmaf twice.
//   * Channels past D are zeros (lw = 0): they add nothing to any sum.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

template <int DP>
struct Bwd {
  static constexpr int kThreads = 4 * DP;
  static constexpr int kTile = 1024 / DP;   // steps staged at a time
  static constexpr int kNC = DP / 4;        // forward scan: S entries a thread
  static constexpr int kNG = DP / 2;        // reverse scan: G entries a thread
};

constexpr unsigned kFull = 0xffffffffu;

template <int DP>
struct Stage {
  float q[Bwd<DP>::kTile][DP], k[Bwd<DP>::kTile][DP], v[Bwd<DP>::kTile][DP];
  float w[Bwd<DP>::kTile][DP], dout[Bwd<DP>::kTile][DP], p[Bwd<DP>::kTile][DP];
  float u[DP];
  float vdo[Bwd<DP>::kTile];   // v_t·dO_t
  float uqk[Bwd<DP>::kTile];   // Σ_i u_i q_ti k_ti
};

// Copy steps [t0, t0 + n) of the row into shared memory (masked past n and
// D: zeros, w = 1), with p from `p_src` when it is not null; then form each
// step's two dot products in channel order.
template <int DP>
__device__ __forceinline__ void stage_tile(Stage<DP>& st, const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ lw,
                                           const float* __restrict__ dout,
                                           const float* p_src, size_t base, int t0,
                                           int n, int d) {
  constexpr int kTile = Bwd<DP>::kTile;
  const int tid = threadIdx.x;
  __syncthreads();   // the previous tile is no longer read
  for (int e = tid; e < kTile * DP; e += Bwd<DP>::kThreads) {
    const int t = e / DP, c = e % DP;
    const bool in = t < n && c < d;
    const size_t off = base + (size_t)(t0 + t) * d + c;
    st.q[t][c] = in ? q[off] : 0.0f;
    st.k[t][c] = in ? k[off] : 0.0f;
    st.v[t][c] = in ? v[off] : 0.0f;
    st.w[t][c] = in ? expf(lw[off]) : 1.0f;
    st.dout[t][c] = in ? dout[off] : 0.0f;
    if (p_src != nullptr) st.p[t][c] = in ? p_src[off] : 0.0f;
  }
  __syncthreads();
  if (tid < n) {
    float acc = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) acc = fmaf(st.v[tid][c], st.dout[tid][c], acc);
    st.vdo[tid] = acc;
  } else if (tid >= 32 && tid < 32 + n) {
    const int t = tid - 32;
    float acc = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) acc = fmaf(st.u[c] * st.q[t][c], st.k[t][c], acc);
    st.uqk[t] = acc;
  }
  __syncthreads();
}

template <int DP>
__global__ void __launch_bounds__(4 * DP)
wkv6_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ dout,
                float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                float* dlw, float* __restrict__ du, int t_len, int d) {
  using B = Bwd<DP>;
  __shared__ Stage<DP> st;
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const size_t base = (size_t)row * t_len * d;
  for (int c = tid; c < DP; c += B::kThreads) st.u[c] = c < d ? u[(size_t)row * d + c] : 0.0f;

  // ---- forward scan: dq, p (into dlw), du
  {
    const int i = tid >> 2, s = tid & 3;
    float S[B::kNC];
#pragma unroll
    for (int c = 0; c < B::kNC; ++c) S[c] = 0.0f;
    float dus = 0.0f;
    for (int t0 = 0; t0 < t_len; t0 += B::kTile) {
      const int n = min(B::kTile, t_len - t0);
      stage_tile<DP>(st, q, k, v, lw, dout, nullptr, base, t0, n, d);
      for (int t = 0; t < n; ++t) {
        float a = 0.0f;
#pragma unroll
        for (int c = 0; c < B::kNC; ++c) a = fmaf(S[c], st.dout[t][4 * c + s], a);
        a += __shfl_xor_sync(kFull, a, 1);
        a += __shfl_xor_sync(kFull, a, 2);   // (s0 + s1) + (s2 + s3) in every lane
        const float qi = st.q[t][i], ki = st.k[t][i], vd = st.vdo[t];
        const size_t off = base + (size_t)(t0 + t) * d + i;
        if (i < d) {
          if (s == 0) dq[off] = fmaf(st.u[i] * ki, vd, a);
          else if (s == 1) dlw[off] = qi * a;   // p_t
        }
        dus = fmaf(qi * ki, vd, dus);
        const float wi = st.w[t][i];
#pragma unroll
        for (int c = 0; c < B::kNC; ++c) S[c] = fmaf(wi, S[c], ki * st.v[t][4 * c + s]);
      }
    }
    if (s == 0 && i < d) du[(size_t)row * d + i] = dus;
  }

  // ---- reverse scan: dk, dlw (rows of G), dv (columns of G)
  const bool by_col = tid >= 2 * DP;
  const int lt = by_col ? tid - 2 * DP : tid;
  const int x = lt >> 1, h = lt & 1;   // x: row i (by_col false) or column j
  float G[B::kNG];
#pragma unroll
  for (int c = 0; c < B::kNG; ++c) G[c] = 0.0f;
  float run = 0.0f, p_next = 0.0f;
  for (int t0 = ((t_len - 1) / B::kTile) * B::kTile; t0 >= 0; t0 -= B::kTile) {
    const int n = min(B::kTile, t_len - t0);
    stage_tile<DP>(st, q, k, v, lw, dout, dlw, base, t0, n, d);
    for (int t = n - 1; t >= 0; --t) {
      const size_t off = base + (size_t)(t0 + t) * d + x;
      if (!by_col) {
        float a = 0.0f;
#pragma unroll
        for (int c = 0; c < B::kNG; ++c) a = fmaf(G[c], st.v[t][2 * c + h], a);
        a += __shfl_xor_sync(kFull, a, 1);   // (G·v)_i
        const float qi = st.q[t][x], ki = st.k[t][x];
        run = (run + p_next) - ki * a;
        p_next = st.p[t][x];
        if (x < d) {
          if (h == 0) dk[off] = fmaf(st.u[x] * qi, st.vdo[t], a);
          else dlw[off] = run;
        }
        const float wi = st.w[t][x];
#pragma unroll
        for (int c = 0; c < B::kNG; ++c) G[c] = fmaf(wi, G[c], qi * st.dout[t][2 * c + h]);
      } else {
        float a = 0.0f;
#pragma unroll
        for (int c = 0; c < B::kNG; ++c) a = fmaf(G[c], st.k[t][2 * c + h], a);
        a += __shfl_xor_sync(kFull, a, 1);   // (Gᵀ·k)_j
        const float dj = st.dout[t][x];
        if (h == 0 && x < d) dv[off] = fmaf(dj, st.uqk[t], a);
#pragma unroll
        for (int c = 0; c < B::kNG; ++c) {
          const int i = 2 * c + h;
          G[c] = fmaf(st.w[t][i], G[c], st.q[t][i] * dj);
        }
      }
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const float* lw, const float* u,
           const float* dout, float* dq, float* dk, float* dv, float* dlw, float* du, int bh,
           int t, int d, cudaStream_t stream) {
  wkv6_bwd_kernel<DP><<<bh, Bwd<DP>::kThreads, 0, stream>>>(q, k, v, lw, u, dout, dq, dk, dv,
                                                           dlw, du, t, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, lw, dout, dq, dk, dv, dlw: [bh, t, d] float32; u, du: [bh, d]
// float32; all contiguous, 4-byte aligned, the outputs disjoint from each
// other and from the inputs.  Launches on `stream` without synchronising;
// returns the launch's error (cudaGetLastError()), 0 on success.
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
