// Device algebra shared by the TNN column kernels: RNL fire on the
// integer weight grid, k-WTA by min rounds, expected STDP.
//
// It is the CUDA counterpart of the three value-level helpers that every
// fused-column kernel of the JAX package is built from
// (src/repro/kernels/fused_column.py: _kernel_fire_counts, _kernel_wta,
// _kernel_stdp).  The TPU helpers put the fire on the matrix unit through
// one-hot weight planes; at the Table II widths (q <= 25) there is no
// matrix to fill, so the fire is the direct ramp sum below
// (warp_fire_time), or its slope-histogram form (scatter_ramp,
// warp_scan_fire_time), which needs no reduction per cycle.
//
// Numerics (held bit for bit against the plain PyTorch versions):
//  * weights are rounded with rintf (half to even, as jnp.round and
//    torch.round), never roundf;
//  * with integer spike times every ramp term and every partial sum is a
//    small integer (<= p * w_max), exact in f32, so the order of the warp
//    reduction does not matter;
//  * the sources are built with --fmad=false and the STDP arithmetic uses
//    the _rn intrinsics, so w + mu * s is never contracted into an FMA;
//  * the stabilizer is computed as XLA compiles the JAX package's fused
//    lowerings (its reference body and its interpreted TPU kernels):
//    frac = w * (1 / w_max) with the reciprocal rounded to f32, and
//    s_plus = (1 + eps) - frac with 1 + eps rounded to f32 (XLA's
//    simplifier folds the source's (1 - frac) + eps that way).  The plain
//    PyTorch versions (ref.stdp_ref with compiled=True) do the same, so card,
//    CPU and the JAX package agree bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace tnn {

constexpr int kWarp = 32;

// Integer fire grid: rint(clamp(w, 0, w_max)).
__device__ __forceinline__ float fire_grid(float w, float w_max) {
  return rintf(fminf(fmaxf(w, 0.0f), w_max));
}

// The device-memory layout of the fire kernels: rounds n weights once
// into the grid workspace that every thread block then reads through L2.
__global__ void fire_grid_kernel(const float* __restrict__ w,
                                 float* __restrict__ grid, size_t n,
                                 float w_max) {
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       k < n; k += static_cast<size_t>(gridDim.x) * blockDim.x)
    grid[k] = fire_grid(w[k], w_max);
}

// Launches fire_grid_kernel on `stream`; returns cudaGetLastError().
inline cudaError_t launch_fire_grid(const float* w, float* grid, size_t n,
                                    float w_max, cudaStream_t stream) {
  size_t blocks = (n + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  if (blocks == 0) return cudaSuccess;
  fire_grid_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      w, grid, n, w_max);
  return cudaGetLastError();
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
// past t_end contribute nothing inside the window.  Times are f32 or
// int32 (converted exactly: every time below 2^24 is); with kRound the
// weights are float and each is rounded to the grid as it is read
// (fire_grid), so no integer grid needs to be kept.
template <bool kRound = false, typename T>
__device__ __forceinline__ int warp_fire_time(
    const float* wi, int q, int j, const T* ti, int p,
    float threshold, int t_end, float w_max = 0.0f) {
  const int lane = threadIdx.x % kWarp;
  for (int t = 0; t < t_end; ++t) {
    const float tf = static_cast<float>(t);
    float part = 0.0f;
    for (int i = lane; i < p; i += kWarp) {
      const float g = kRound ? fire_grid(wi[i * q + j], w_max) : wi[i * q + j];
      part += fminf(fmaxf(tf - static_cast<float>(ti[i]), 0.0f), g);
    }
    if (warp_sum(part) >= threshold) return t;
  }
  return t_end;
}

// The slope-histogram form of the same fire, for integer spike times >= 0
// and integer grid weights g.  Synapse i adds min(relu(t - t_i), g) to
// V(t), which is the number of cycles s < t with t_i <= s < t_i + g; so
// V(t) = sum_{s < t} c(s), where the slope c(s) counts the synapses whose
// ramp is rising at s.  A neuron keeps c as a difference row (+1 at t_i,
// -1 at t_i + g) of at least t_end ints in shared memory; every term is an
// integer and every sum is at most p * w_max, so the result equals the
// f32 ramp sum of warp_fire_time bit for bit, and int atomics make the
// order of the scatter irrelevant.

// Scatters one synapse into its neuron's difference row: nothing for a
// time at or past t_end (silent inside the window), for g = 0, or for a
// negative time (outside the form's contract, and outside the row), and
// no -1 where the ramp tops out at or past t_end.
__device__ __forceinline__ void scatter_ramp(int* row, float ti, float g,
                                             int t_end) {
  if (ti >= 0.0f && ti < static_cast<float>(t_end) && g > 0.0f) {
    const int t0 = static_cast<int>(ti);
    atomicAdd(row + t0, 1);
    const int t1 = t0 + static_cast<int>(g);
    if (t1 < t_end) atomicAdd(row + t1, -1);
  }
}

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x % kWarp;
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Firing time of one neuron from its difference row, computed by one
// whole warp: the first integer t < t_end with V(t) >= threshold, else
// t_end (V(0) = 0, so a threshold <= 0 fires at 0).  32 cycles a step:
// one scan gives the slopes, a second the potentials V(s + 1), and a
// ballot the first crossing.  The warp leaves the row zeroed for the
// next volley's scatter.
__device__ __forceinline__ int warp_scan_fire_time(int* row, float threshold,
                                                   int t_end) {
  const int lane = threadIdx.x % kWarp;
  int fire = 0.0f >= threshold ? 0 : t_end;
  int slope = 0, v = 0;  // carried from the previous 32 cycles
  for (int s0 = 0; s0 < t_end; s0 += kWarp) {
    const int s = s0 + lane;
    int x = 0;
    if (s < t_end) {
      x = row[s];
      row[s] = 0;
    }
    if (fire < t_end) continue;  // found: only the zeroing is left
    x = warp_inclusive_scan(x) + slope;  // c(s)
    slope = __shfl_sync(0xffffffffu, x, kWarp - 1);
    x = warp_inclusive_scan(x) + v;  // V(s + 1)
    v = __shfl_sync(0xffffffffu, x, kWarp - 1);
    const unsigned hit = __ballot_sync(
        0xffffffffu, s + 1 < t_end && static_cast<float>(x) >= threshold);
    if (hit) fire = s0 + __ffs(static_cast<int>(hit));  // = s + 1 of the first
  }
  return fire;
}

// The slope-histogram fire of one (volley, neuron) pair by one whole
// warp, in a difference row of its own (at least t_end ints, zero on
// entry and left zeroed): the lanes scatter neuron j's p synapses
// (grid weights wi[i * q + j], times ti[i]), then warp_scan_fire_time.
// Exact for integer times >= 0 only (the form's domain); no block-wide
// barrier, so each warp of a block walks its own pairs.
template <typename T>
__device__ __forceinline__ int warp_slope_fire_time(
    int* row, const float* wi, int q, int j, const T* ti, int p,
    float threshold, int t_end) {
  for (int i = threadIdx.x % kWarp; i < p; i += kWarp)
    scatter_ramp(row, static_cast<float>(ti[i]), wi[i * q + j], t_end);
  __syncwarp();
  const int t = warp_scan_fire_time(row, threshold, t_end);
  __syncwarp();  // the row's zeros before the next pair's scatter
  return t;
}

// Stages `count` times from device memory into shared memory, every
// thread of the block a share, and returns to every thread whether the
// slope-histogram form is exact for all of them: int32 times, none
// negative.  A block-wide barrier (one __syncthreads_or for int32 times).
template <typename T>
__device__ __forceinline__ bool stage_times(T* dst, const T* src, int count) {
  if constexpr (std::is_same_v<T, int>) {
    bool neg = false;
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      const int x = src[k];
      dst[k] = x;
      neg |= x < 0;
    }
    return __syncthreads_or(neg) == 0;
  } else {
    for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
    __syncthreads();
    return false;
  }
}

// The number of thread blocks of `kernel` that the card holds at once at
// this block size and dynamic shared memory (at least 1), into *blocks.
template <typename K>
inline cudaError_t resident_blocks(K kernel, int threads, size_t smem,
                                   int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *blocks = sms * per_sm > 1 ? sms * per_sm : 1;
  return err;
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

// Expected STDP for one synapse (the algebra of ref.stdp_ref, compiled=True),
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
    const float inv = __fdiv_rn(1.0f, w_max);
    const float frac = fminf(fmaxf(__fmul_rn(w, inv), 0.0f), 1.0f);
    s_plus = __fsub_rn(__fadd_rn(1.0f, eps), frac);
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
