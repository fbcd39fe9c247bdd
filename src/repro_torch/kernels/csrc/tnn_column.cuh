// Device algebra shared by the TNN column kernels: RNL fire on the
// integer weight grid, k-WTA by min rounds, expected STDP.
//
// It is the CUDA counterpart of the three value-level helpers that every
// fused-column kernel of the JAX package is built from
// (src/repro/kernels/fused_column.py: _kernel_fire_counts, _kernel_wta,
// _kernel_stdp).  The TPU helpers put the fire on the matrix unit through
// one-hot weight planes; at the Table II widths (q <= 25) there is no
// matrix to fill, so the fire is the direct ramp sum below.
//
// Numerics (held bit for bit against the plain PyTorch versions):
//  * weights are rounded with rintf (half to even, as jnp.round and
//    torch.round), never roundf;
//  * with integer spike times every ramp term and every partial sum is a
//    small integer (<= p * w_max), exact in f32, so the order of the warp
//    reduction does not matter;
//  * the sources are built with --fmad=false and the STDP arithmetic uses
//    the _rn intrinsics, so w + mu * s is never contracted into an FMA;
//  * the stabilizer divides by w_max with IEEE division (__fdiv_rn), as the
//    JAX reference lowering and the plain PyTorch version do.  The TPU
//    kernel multiplied by the reciprocal instead, which can differ by an
//    ulp.
#pragma once

#include <cuda_runtime.h>

namespace tnn {

constexpr int kWarp = 32;

// Integer fire grid: rint(clamp(w, 0, w_max)).
__device__ __forceinline__ float fire_grid(float w, float w_max) {
  return rintf(fminf(fmaxf(w, 0.0f), w_max));
}

// Sum over the warp; every lane returns lane 0's total, so all lanes take
// the same branch on it.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Firing time of neuron j for one volley, computed by one whole warp:
// the first integer t < t_end with V(t) = sum_i min(relu(t - ti[i]),
// wi[i * q + j]) >= threshold, else t_end.  Lanes split the synapses.
// V is nondecreasing in t, so this equals the count of sub-threshold
// cycles in [0, t_end) that the TPU kernels accumulate.  Inputs at or
// past t_end contribute nothing inside the window.
__device__ __forceinline__ int warp_fire_time(
    const float* wi, int q, int j, const float* ti, int p,
    float threshold, int t_end) {
  const int lane = threadIdx.x % kWarp;
  for (int t = 0; t < t_end; ++t) {
    const float tf = static_cast<float>(t);
    float part = 0.0f;
    for (int i = lane; i < p; i += kWarp)
      part += fminf(fmaxf(tf - ti[i], 0.0f), wi[i * q + j]);
    if (warp_sum(part) >= threshold) return t;
  }
  return t_end;
}

// k-WTA on q firing times, run by one warp (lanes stride over neurons).
// Key t * q + j is unique, so k min rounds find the k-th smallest key;
// winners keep their time, everyone else and every silent neuron gets
// t_max (index tie-break, as _kernel_wta and kernels/ref.wta_ref).
__device__ __forceinline__ void warp_wta(
    const int* t_fire, int q, int t_max, int wta_k, float* y) {
  const int lane = threadIdx.x % kWarp;
  const int big = 0x7fffffff;
  int kth = 0;
  // round r takes the smallest key above the previous round's minimum
  // (the keys _kernel_wta has not yet replaced by `big`)
  for (int r = 0; r < wta_k; ++r) {
    int m = big;
    for (int j = lane; j < q; j += kWarp) {
      const int key = t_fire[j] * q + j;
      if (r == 0 || key > kth) m = min(m, key);
    }
    for (int off = kWarp / 2; off > 0; off >>= 1)
      m = min(m, __shfl_down_sync(0xffffffffu, m, off));
    m = __shfl_sync(0xffffffffu, m, 0);
    if (m == big) break;  // fewer than k neurons: every key already won
    kth = m;
  }
  for (int j = lane; j < q; j += kWarp) {
    const int key = t_fire[j] * q + j;
    const bool win = key <= kth && t_fire[j] < t_max;
    y[j] = win ? static_cast<float>(t_fire[j]) : static_cast<float>(t_max);
  }
}

// Expected STDP for one synapse (the algebra of kernels/ref.stdp_ref),
// clamped to [0, w_max].  eps = 1 / (2 w_max) arrives rounded to f32 by
// the host, as the JAX and PyTorch versions round their constant.
__device__ __forceinline__ float stdp_synapse(
    float w, float x, float y, float t_max, float mu_capture,
    float mu_backoff, float mu_search, float w_max, float eps,
    bool stabilize) {
  const bool xs = x < t_max;
  const bool ys = y < t_max;
  float s_plus = 1.0f, s_minus = 1.0f;
  if (stabilize) {
    const float frac = fminf(fmaxf(__fdiv_rn(w, w_max), 0.0f), 1.0f);
    s_plus = __fadd_rn(__fsub_rn(1.0f, frac), eps);
    s_minus = __fadd_rn(frac, eps);
  }
  float delta = 0.0f;
  if (xs && ys && x <= y) delta = __fmul_rn(mu_capture, s_plus);
  if ((xs && ys && x > y) || (!xs && ys))
    delta = __fmul_rn(-mu_backoff, s_minus);
  if (xs && !ys) delta = mu_search;
  return fminf(fmaxf(__fadd_rn(w, delta), 0.0f), w_max);
}

}  // namespace tnn
