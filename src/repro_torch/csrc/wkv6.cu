// K3 on Hopper: the RWKV-6 (Finch) recurrence over [BH, T, D].
//
// Replaces the Pallas TPU kernel `wkv6_pallas` / `_wkv6_kernel`
// (src/repro/kernels/wkv6_chunk.py).  For every (batch·head) row, from a zero
// f32 state S (D × D):
//
//     o_t = q_t (S_{t-1} + u ⊙ k_t v_tᵀ)      (u scales the rows of k_t v_tᵀ)
//     S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,      w_t = exp(lw_t)
//
// Inputs are f32 or bf16 (read through __bfloat162float); the state and every
// sum are f32; the output has q's type.  Every w_t lies in (0, 1] since
// lw ≤ 0, so the state never grows past the sum of the k v products: this
// step-by-step form cannot overflow and needs none of the TPU kernel's
// rescaling.
//
// What bounds it: the function reads q, k, v, lw and writes o once, 5·BH·T·D
// elements, against about 5·D² operations per step and row (2·D² for q·S,
// 3·D² for w·S + k·vᵀ) — at D = 64 in f32
// that is 16 operations per byte, below the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so the bound is bytes.  This kernel does not reach it: a
// row's T steps are a chain of dependent updates, and the grid has only BH
// blocks (256 in rwkv6-7b's forward at batch 4), so it is bound by the latency
// of T sequential steps.  The chunked tensor-core form (the TPU kernel's
// sub-chunk algebra on wgmma) is later work.
//
// Design (simple and right first):
//   * one block per (b·h) row; DP·kGroups threads, DP = D rounded up to 64
//     or 128.  Thread (g, j) owns column j of S, rows [g·R, g·R + R) with
//     R = DP / kGroups, in registers: reading S_{t-1} and writing S_t are
//     the same thread's registers, so no barrier sits between them;
//   * kSteps steps at a time are staged in shared memory: q, k, v and
//     w = exp(lw) as coalesced rows, zero past D (a zero k row keeps the
//     padded rows of S at zero);
//   * each thread forms its share of o_t[j] = Σ_i q_i (S_ij + u_i k_i v_j)
//     over its R rows and then updates those rows; the kGroups shares are
//     summed in a fixed order after a barrier, and the chunk's outputs are
//     written as coalesced rows (deterministic, no atomics);
//   * shared memory: 4·kSteps·DP staged floats plus kSteps·kGroups·DP
//     shares = 32 KB at both widths, under the 48 KB static limit, so no
//     launch needs a dynamic shared-memory opt-in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kGroups = 4;  // row groups of S per column (threads = DP · kGroups)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int DP>
__global__ void __launch_bounds__(DP * kGroups)
wkv6_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ lw, const T* __restrict__ u, T* __restrict__ o,
            int t_len, int d) {
  constexpr int kThreads = DP * kGroups;
  constexpr int R = DP / kGroups;      // rows of S per thread
  constexpr int kSteps = 1024 / DP;    // steps staged per chunk

  __shared__ float qs[kSteps][DP];
  __shared__ float ks[kSteps][DP];
  __shared__ float vs[kSteps][DP];
  __shared__ float ws[kSteps][DP];
  __shared__ float part[kSteps][kGroups][DP];

  const int tid = threadIdx.x;
  const int j = tid % DP;   // column of S (value channel)
  const int g = tid / DP;   // row group: rows g*R .. g*R + R - 1
  const size_t base = (size_t)blockIdx.x * t_len * d;

  float s[R];   // S[g*R + r][j]
  float ur[R];  // u[g*R + r]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = g * R + r;
    s[r] = 0.0f;
    ur[r] = i < d ? to_f(u[(size_t)blockIdx.x * d + i]) : 0.0f;
  }

  for (int t0 = 0; t0 < t_len; t0 += kSteps) {
    const int nt = min(kSteps, t_len - t0);
    __syncthreads();  // the previous chunk is done reading the stage and the shares
    for (int idx = tid; idx < kSteps * DP; idx += kThreads) {
      const int tt = idx / DP, i = idx % DP;
      const bool ok = tt < nt && i < d;
      const size_t off = base + (size_t)(t0 + tt) * d + i;
      qs[tt][i] = ok ? to_f(q[off]) : 0.0f;
      ks[tt][i] = ok ? to_f(k[off]) : 0.0f;
      vs[tt][i] = ok ? to_f(v[off]) : 0.0f;
      ws[tt][i] = ok ? expf(to_f(lw[off])) : 0.0f;
    }
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float vj = vs[tt][j];
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g * R + r;
        const float kv = ks[tt][i] * vj;
        acc = fmaf(qs[tt][i], fmaf(ur[r], kv, s[r]), acc);  // q_i (S_ij + u_i k_i v_j)
        s[r] = fmaf(ws[tt][i], s[r], kv);                   // w_i S_ij + k_i v_j
      }
      part[tt][g][j] = acc;
    }
    __syncthreads();

    for (int idx = tid; idx < nt * DP; idx += kThreads) {
      const int tt = idx / DP, jj = idx % DP;
      if (jj < d) {
        float sum = 0.0f;
#pragma unroll
        for (int gg = 0; gg < kGroups; ++gg) sum += part[tt][gg][jj];
        o[base + (size_t)(t0 + tt) * d + jj] = from_f<T>(sum);
      }
    }
  }
}

template <typename T, int DP>
void launch(const void* q, const void* k, const void* v, const void* lw, const void* u,
            void* o, int bh, int t, int d, cudaStream_t stream) {
  wkv6_kernel<T, DP><<<bh, DP * kGroups, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), static_cast<const T*>(u), static_cast<T*>(o), t, d);
}

template <typename T>
void launch_width(const void* q, const void* k, const void* v, const void* lw,
                  const void* u, void* o, int bh, int t, int d, cudaStream_t stream) {
  if (d <= 64)
    launch<T, 64>(q, k, v, lw, u, o, bh, t, d, stream);
  else
    launch<T, 128>(q, k, v, lw, u, o, bh, t, d, stream);
}

}  // namespace

extern "C" {

// q, k, v, lw, o: [bh, t, d]; u: [bh, d]; contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
int wkv6_forward(const void* q, const void* k, const void* v, const void* lw, const void* u,
                 void* o, int bh, int t, int d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || t <= 0 || d <= 0 || d > 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_width<float>(q, k, v, lw, u, o, bh, t, d, st);
  else if (dtype == 1)
    launch_width<__nv_bfloat16>(q, k, v, lw, u, o, bh, t, d, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
