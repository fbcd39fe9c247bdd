// A whole online-STDP fit of a TNN column for D designs in one launch:
// epochs x N volleys folded in order, each an RNL fire on the integer
// weight grid, k-WTA and expected STDP.
//
// Replaces the TPU kernel _fused_kernel (src/repro/kernels/fused_column.py)
// behind fused_step_pallas_padded, and the scan around it that the JAX
// package compiles once per fit (_fused_fit_scan): the port's fit_fused
// launches this kernel once per fit (repro_torch/kernels/fused_column.py,
// fused_fit_padded), and fused_step_padded is its one-volley call.
//
// What bounds it on an H100: neither bytes nor arithmetic, but the chain.
// A WordSynonyms fit (270 x 25, 900 volleys, 8 epochs) moves ~1 MB and
// does ~6 x 10^8 operations in the slope form, microseconds of either,
// while volley v fires against the weights that volley v-1 wrote: 7,200
// steps, each a handful of block-wide barriers.  A launch and a host
// round trip per volley would each cost more than the volley's own work,
// so one launch carries the whole fit and every step stays on chip
// (about 4 us a volley on an H100 at that width).  One thread block per
// design holds the design's float weights in shared memory for the whole
// fit (read from device memory once, written once).  The volleys are
// read as they lie in device memory: while volley v fires, its successor
// (the first volley of the next epoch after the last of this one) is
// already in flight into the other half of a double buffer by per-thread
// cp.async (4-byte copies, so a row of any length and alignment), and
// the copy of volley v+2 starts as soon as volley v's STDP has read its
// buffer.
//
// The fire takes one of two forms, chosen by each block for its own
// design before the fit starts (one pass over the design's volleys and a
// __syncthreads_or, so no host sync and no launch argument; the pass
// reads the volleys once more, ~1 MB for a WordSynonyms fit):
//  * integer volleys whose times are all >= 0: the slope histogram of
//    tnn_column.cuh (scatter_ramp, warp_scan_fire_time), exact for those
//    only.  The STDP thread that writes a synapse's new weight rounds it
//    to the grid and scatters its ramp for the next volley's times, so no
//    integer grid is kept; the first volley scatters from the loaded
//    weights, and the last volley of the fit scatters nothing;
//  * float volleys, or integer volleys with a negative time: the direct
//    ramp sum (warp_fire_time), each weight rounded to the grid as it is
//    read.  Slower (a warp reduction per cycle), but it keeps the
//    contract of the JAX package's fit_fused, which takes float volleys.
// Both are the f32 ramp sum of the plain version bit for bit wherever
// that sum is exact (integer times; halves, as x + 0.5).
//
// A design too wide to keep its weights in shared memory (pq words +
// 2p volley words + 2q + q (t_window + 1) ints over 227 KB) takes the
// device-memory layout: the weights are updated in place in w_out, read
// through L2, while the volley buffers, the winner and firing times and
// the histogram stay in shared memory.  __syncthreads() orders the
// block's own global writes, and the fire, WTA and STDP code is shared.
//
// Layout: w, w_out [D, p, q] f32; xs [D, N, p] int32 or f32 (a time >= the
// design's t_max is silent); operands [D, 6] f32 in the column order of
// fused_column.OPERAND_COLS (threshold, t_max, q_active, mu_capture,
// mu_backoff, mu_search); y_last [D, q] f32 winner times of the last
// volley (t_max = none; may be NULL); trace [D, epochs, N, q] int32 winner
// times of every volley (may be NULL).
#include <cuda_runtime.h>

#include <type_traits>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 1024;

// One 4-byte asynchronous copy from device memory into shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Waits for every cp.async this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of volley v of the fit (volley v % n of the stream)
// into dst; each thread copies its own elements.
template <typename T>
__device__ __forceinline__ void prefetch_volley(T* dst, const T* xd,
                                                long long v, int n, int p) {
  const T* src = xd + (v % n) * static_cast<long long>(p);
  for (int i = threadIdx.x; i < p; i += blockDim.x) cp_async4(dst + i, src + i);
}

// The fit of design blockIdx.x in one fire form.
template <typename T, bool kResident, bool kSlope>
__device__ __forceinline__ void fused_fit(
    const float* __restrict__ w, const T* __restrict__ xs,
    const float* __restrict__ operands, float* __restrict__ w_out,
    float* __restrict__ y_last, int* __restrict__ trace, int n, int epochs,
    int p, int q, int t_window, float w_max, int wta_k, bool stabilize,
    float eps) {
  extern __shared__ float smem[];
  const int d = blockIdx.x;
  const int npq = p * q;
  // [p * q] weights: in shared memory when resident, else in w_out
  // (updated in place)
  float* sw = kResident ? smem : w_out + static_cast<size_t>(d) * npq;
  T* buf = reinterpret_cast<T*>(kResident ? smem + npq : smem);  // [2, p]
  float* sy = reinterpret_cast<float*>(buf + 2 * p);  // [q] winner times
  int* st_fire = reinterpret_cast<int*>(sy + q);      // [q] firing times
  int* hist = st_fire + q;  // [q, t_window + 1] difference rows
  const int row_len = t_window + 1;

  const float* op = operands + d * 6;
  const float threshold = op[0];
  const float t_max = op[1];
  const float q_live = op[2];
  const float mu_capture = op[3];
  const float mu_backoff = op[4];
  const float mu_search = op[5];
  const float* wd = w + static_cast<size_t>(d) * npq;
  const T* xd = xs + static_cast<size_t>(d) * n * p;
  const long long total = static_cast<long long>(epochs) * n;
  const int t_end = min(t_window, static_cast<int>(ceilf(t_max)));
  const int t_cap = static_cast<int>(t_max);

  if (total > 0) prefetch_volley(buf, xd, 0, n, p);
  if (total > 1) prefetch_volley(buf + p, xd, 1, n, p);
  if (kSlope)
    for (int k = threadIdx.x; k < q * row_len; k += blockDim.x) hist[k] = 0;
  for (int k = threadIdx.x; k < npq; k += blockDim.x) sw[k] = wd[k];
  cp_async_wait_all();
  __syncthreads();  // orders the block's own global writes as well

  // The synapse loops give each thread one column j (neuron) and every
  // rp-th row i of it, so a warp reads consecutive weights and one or two
  // input times, and scatters into distinct banks (rows t_window + 1 ints
  // apart).  Neurons at or past q_active keep their weights and scatter
  // nothing.
  const int rp = max(1, static_cast<int>(blockDim.x) / q);

  // the first volley's histogram, from the loaded weights
  if (kSlope && total > 0) {
    for (int c = threadIdx.x; c < rp * q; c += blockDim.x) {
      const int r = c / q;
      const int j = c - r * q;
      if (static_cast<float>(j) >= q_live) continue;
      for (int i = r; i < p; i += rp)
        tnn::scatter_ramp(hist + j * row_len, static_cast<float>(buf[i]),
                          tnn::fire_grid(sw[i * q + j], w_max), t_end);
    }
    __syncthreads();
  }

  const int warp = threadIdx.x / tnn::kWarp;
  const int lane = threadIdx.x % tnn::kWarp;
  const int n_warps = blockDim.x / tnn::kWarp;
  for (long long v = 0; v < total; ++v) {
    const T* ti = buf + (v & 1) * p;        // this volley
    const T* tn = buf + ((v + 1) & 1) * p;  // the next one, in flight
    // fire: one warp per neuron (the slope form scans the neuron's row
    // and leaves it zeroed)
    for (int j = warp; j < q; j += n_warps) {
      int t = t_cap;
      if (static_cast<float>(j) < q_live) {
        if (kSlope)
          t = tnn::warp_scan_fire_time(hist + j * row_len, threshold, t_end);
        else
          t = tnn::warp_fire_time<true>(sw, q, j, ti, p, threshold, t_end,
                                        w_max);
      }
      if (lane == 0) st_fire[j] = min(t, t_cap);
    }
    __syncthreads();

    if (warp == 0) {
      tnn::warp_wta(st_fire, q, t_cap, wta_k, sy);
      // each lane reads back the winner times it wrote
      if (trace != nullptr) {
        int* tr = trace + (static_cast<size_t>(d) * total + v) * q;
        for (int j = lane; j < q; j += tnn::kWarp)
          tr[j] = static_cast<int>(sy[j]);
      }
      if (y_last != nullptr && v == total - 1)
        for (int j = lane; j < q; j += tnn::kWarp)
          y_last[static_cast<size_t>(d) * q + j] = sy[j];
    }
    cp_async_wait_all();  // the next volley, for the scatter below
    __syncthreads();

    // STDP, then (slope form) the synapse's new grid weight scattered for
    // the next volley's fire
    const bool scatter = kSlope && v + 1 < total;
    for (int c = threadIdx.x; c < rp * q; c += blockDim.x) {
      const int r = c / q;
      const int j = c - r * q;
      if (static_cast<float>(j) >= q_live) continue;
      const float yj = sy[j];
      int* row = hist + j * row_len;
      for (int i = r; i < p; i += rp) {
        const int k = i * q + j;
        const float nw = tnn::stdp_synapse(
            sw[k], static_cast<float>(ti[i]), yj, t_max, mu_capture,
            mu_backoff, mu_search, w_max, eps, stabilize);
        sw[k] = nw;
        if (scatter)
          tnn::scatter_ramp(row, static_cast<float>(tn[i]),
                            tnn::fire_grid(nw, w_max), t_end);
      }
    }
    __syncthreads();
    // this volley's buffer is free: start the copy of volley v + 2
    if (v + 2 < total) prefetch_volley(buf + (v & 1) * p, xd, v + 2, n, p);
  }

  if (kResident) {
    float* wo = w_out + static_cast<size_t>(d) * npq;
    for (int k = threadIdx.x; k < npq; k += blockDim.x) wo[k] = sw[k];
  }
}

// The block's fire form: the slope histogram for integer volleys whose
// times are all >= 0 (the form's exact domain), else the ramp sum.  Every
// thread of the block reads a share of the design's volleys.
template <typename T>
__device__ __forceinline__ bool slope_exact(const T* xd, long long count) {
  if constexpr (std::is_same_v<T, int>) {
    bool neg = false;
    for (long long k = threadIdx.x; k < count; k += blockDim.x)
      neg |= xd[k] < 0;
    return __syncthreads_or(neg) == 0;
  } else {
    return false;
  }
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads) fused_fit_kernel(
    const float* __restrict__ w, const T* __restrict__ xs,
    const float* __restrict__ operands, float* __restrict__ w_out,
    float* __restrict__ y_last, int* __restrict__ trace, int n, int epochs,
    int p, int q, int t_window, float w_max, int wta_k, bool stabilize,
    float eps) {
  const long long count = static_cast<long long>(n) * p;
  if (slope_exact(xs + static_cast<size_t>(blockIdx.x) * count, count))
    fused_fit<T, kResident, true>(w, xs, operands, w_out, y_last, trace, n,
                                  epochs, p, q, t_window, w_max, wta_k,
                                  stabilize, eps);
  else
    fused_fit<T, kResident, false>(w, xs, operands, w_out, y_last, trace, n,
                                   epochs, p, q, t_window, w_max, wta_k,
                                   stabilize, eps);
}

template <typename T>
cudaError_t launch(bool resident, size_t smem, int d, cudaStream_t stream,
                   const void* w, const void* xs, const void* operands,
                   void* w_out, void* y_last, void* trace, int n, int epochs,
                   int p, int q, int t_window, float w_max, int wta_k,
                   bool stabilize, float eps) {
  auto kernel = resident ? fused_fit_kernel<T, true>
                         : fused_fit_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<d, kThreads, smem, stream>>>(
      static_cast<const float*>(w), static_cast<const T*>(xs),
      static_cast<const float*>(operands), static_cast<float*>(w_out),
      static_cast<float*>(y_last), static_cast<int*>(trace), n, epochs, p, q,
      t_window, w_max, wta_k, stabilize, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t tnn_fused_step_smem_bytes(int p, int q, int t_window,
                                            int resident) {
  const size_t w_words = resident ? static_cast<size_t>(p) * q : 0;
  return (w_words + 2 * static_cast<size_t>(p) + q) * sizeof(float) +
         (q + static_cast<size_t>(q) * (t_window + 1)) * sizeof(int);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `int_times`: xs is int32 (else f32).  y_last and trace may be NULL.
extern "C" int tnn_fused_step(const void* w, const void* xs,
                              const void* operands, void* w_out, void* y_last,
                              void* trace, int resident, int int_times, int d,
                              int n, int epochs, int p, int q, int t_window,
                              int w_max, int wta_k, int stabilize, float eps,
                              void* stream) {
  const size_t smem = tnn_fused_step_smem_bytes(p, q, t_window, resident);
  auto s = static_cast<cudaStream_t>(stream);
  const float wm = static_cast<float>(w_max);
  const bool stab = stabilize != 0;
  const cudaError_t err =
      int_times ? launch<int>(resident, smem, d, s, w, xs, operands, w_out,
                              y_last, trace, n, epochs, p, q, t_window, wm,
                              wta_k, stab, eps)
                : launch<float>(resident, smem, d, s, w, xs, operands, w_out,
                                y_last, trace, n, epochs, p, q, t_window, wm,
                                wta_k, stab, eps);
  return static_cast<int>(err);
}
