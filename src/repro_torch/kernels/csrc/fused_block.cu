// Volley-blocked online STDP for D designs: up to v_blk volleys folded in
// order in one launch, each an RNL fire on the integer weight grid, k-WTA
// and expected STDP, with the weights resident in shared memory.
//
// Replaces the TPU kernel _fused_block_kernel
// (src/repro/kernels/fused_column.py) behind fused_block_pallas_padded;
// the padded scan (repro_torch/kernels/fused_column.py, fit_scan_padded)
// launches it epochs x ceil(N / v_blk) times.
//
// What bounds it on an H100: neither bytes nor arithmetic.  A block of 32
// volleys at 270 x 50 moves ~140 KB per design and does a few million
// integer adds, about a microsecond of either, but the volleys are a
// sequential chain: volley i fires against the weights that volley i-1
// wrote.  So one thread block per design walks the block's volleys in
// order and keeps everything that chain touches on chip: the float
// weights, the block's volleys (staged once) and, per neuron, the slope
// histogram of the next fire.  The weights are read from device memory
// once per launch and written once.  Volleys at or past n_valid (the
// silent-padded tail of the last block) are not folded at all.
//
// The fire is the slope-histogram form (tnn_column.cuh): with integer
// spike times and grid weights, V_j(t) = sum_i min(relu(t - t_i), g_ij)
// has slope c_j(s) = #{i : t_i <= s < t_i + g_ij}, so each live synapse
// adds +1 at t_i and -1 at t_i + g_ij to its neuron's difference row of
// t_window + 1 shared-memory ints (int atomics: order-free), and one warp
// per neuron turns the row into V by two prefix scans and finds the first
// crossing with a ballot, 32 cycles a step.  There is no reduction per
// cycle.  The STDP thread that writes a synapse's new weight rounds it to
// the grid and scatters it for the next volley's times at once, so no
// integer grid is kept; the first volley scatters from the loaded
// weights.  Every sum is an integer <= p * w_max, so the result is the f32
// ramp sum's bit for bit.  The form needs integer spike times >= 0:
// fit_scan_padded refuses floating-point volleys on the 'cuda' lowering.
//
// A design too wide to keep its weights in shared memory beside even one
// volley (pq + p + 2q words + q (t_window + 1) ints over 227 KB) takes the
// device-memory layout: the weights are updated in place in w_out, read
// through L2, while the block's volleys, the winner and firing times and
// the histogram stay in shared memory.  __syncthreads() orders the
// block's own global writes before the next volley's scatter, and the
// fire, WTA and STDP code is shared.
//
// Layout: w, w_out [D, p, q] f32; t_in [D, v_blk, p] f32 integer times (a
// time >= the design's t_max is silent); operands [D, 6] f32 in the column
// order of fused_column.OPERAND_COLS (threshold, t_max, q_active,
// mu_capture, mu_backoff, mu_search).
#include <cuda_runtime.h>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 1024;

template <bool kResident>
__global__ void __launch_bounds__(kThreads) fused_block_kernel(
    const float* __restrict__ w, const float* __restrict__ t_in,
    const float* __restrict__ operands, float* __restrict__ w_out, int p,
    int q, int v_blk, int n_valid, int t_window, float w_max, int wta_k,
    bool stabilize, float eps) {
  extern __shared__ float smem[];
  const int d = blockIdx.x;
  const int n = p * q;
  // [p * q] weights: in shared memory when resident, else in w_out
  // (updated in place)
  float* sw = kResident ? smem : w_out + static_cast<size_t>(d) * n;
  float* sti = kResident ? smem + n : smem;       // [v_blk * p] volleys
  float* sy = sti + v_blk * p;                    // [q] winner times
  int* st_fire = reinterpret_cast<int*>(sy + q);  // [q] firing times
  int* hist = st_fire + q;  // [q, t_window + 1] difference rows
  const int row_len = t_window + 1;

  const float* op = operands + d * 6;
  const float threshold = op[0];
  const float t_max = op[1];
  const float q_live = op[2];
  const float mu_capture = op[3];
  const float mu_backoff = op[4];
  const float mu_search = op[5];
  const int n_fold = min(n_valid, v_blk);
  const float* wd = w + static_cast<size_t>(d) * n;
  const float* td = t_in + static_cast<size_t>(d) * v_blk * p;
  const int t_end = min(t_window, static_cast<int>(ceilf(t_max)));
  const int t_cap = static_cast<int>(t_max);

  for (int k = threadIdx.x; k < q * row_len; k += blockDim.x) hist[k] = 0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) sw[k] = wd[k];
  for (int i = threadIdx.x; i < n_fold * p; i += blockDim.x) sti[i] = td[i];
  __syncthreads();  // orders the block's own global writes as well

  // The synapse loops give each thread one column j (neuron) and every
  // rp-th row i of it, so a warp reads consecutive weights and one or two
  // input times, and scatters into distinct banks (rows t_window + 1 ints
  // apart).  Neurons at or past q_active keep their weights and scatter
  // nothing.
  const int rp = max(1, static_cast<int>(blockDim.x) / q);

  // the first volley's histogram, from the loaded weights
  if (n_fold > 0) {
    for (int c = threadIdx.x; c < rp * q; c += blockDim.x) {
      const int r = c / q;
      const int j = c - r * q;
      if (static_cast<float>(j) >= q_live) continue;
      for (int i = r; i < p; i += rp)
        tnn::scatter_ramp(hist + j * row_len, sti[i],
                          tnn::fire_grid(sw[i * q + j], w_max), t_end);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / tnn::kWarp;
  const int n_warps = blockDim.x / tnn::kWarp;
  for (int vi = 0; vi < n_fold; ++vi) {
    const float* ti = sti + vi * p;
    // fire: one warp per neuron scans its row and leaves it zeroed
    for (int j = warp; j < q; j += n_warps) {
      int t = t_cap;
      if (static_cast<float>(j) < q_live)
        t = tnn::warp_scan_fire_time(hist + j * row_len, threshold, t_end);
      if (threadIdx.x % tnn::kWarp == 0) st_fire[j] = min(t, t_cap);
    }
    __syncthreads();

    if (warp == 0) tnn::warp_wta(st_fire, q, t_cap, wta_k, sy);
    __syncthreads();

    // STDP, then the synapse's new grid weight scattered for the next
    // volley's fire
    const float* tn = vi + 1 < n_fold ? ti + p : nullptr;
    for (int c = threadIdx.x; c < rp * q; c += blockDim.x) {
      const int r = c / q;
      const int j = c - r * q;
      if (static_cast<float>(j) >= q_live) continue;
      const float yj = sy[j];
      int* row = hist + j * row_len;
      for (int i = r; i < p; i += rp) {
        const int k = i * q + j;
        const float v = tnn::stdp_synapse(sw[k], ti[i], yj, t_max, mu_capture,
                                          mu_backoff, mu_search, w_max, eps,
                                          stabilize);
        sw[k] = v;
        if (tn != nullptr)
          tnn::scatter_ramp(row, tn[i], tnn::fire_grid(v, w_max), t_end);
      }
    }
    __syncthreads();
  }

  if (kResident) {
    float* wo = w_out + static_cast<size_t>(d) * n;
    for (int k = threadIdx.x; k < n; k += blockDim.x) wo[k] = sw[k];
  }
}

}  // namespace

extern "C" size_t tnn_fused_block_smem_bytes(int p, int q, int v_blk,
                                             int t_window, int resident) {
  const size_t w_words = resident ? static_cast<size_t>(p) * q : 0;
  return (w_words + static_cast<size_t>(v_blk) * p + q) * sizeof(float) +
         (q + static_cast<size_t>(q) * (t_window + 1)) * sizeof(int);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tnn_fused_block(const void* w, const void* t_in,
                               const void* operands, void* w_out,
                               int resident, int d, int p, int q, int v_blk,
                               int n_valid, int t_window, int w_max,
                               int wta_k, int stabilize, float eps,
                               void* stream) {
  const size_t smem =
      tnn_fused_block_smem_bytes(p, q, v_blk, t_window, resident);
  auto kernel = resident ? fused_block_kernel<true> : fused_block_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<d, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(t_in),
      static_cast<const float*>(operands), static_cast<float*>(w_out), p, q,
      v_blk, n_valid, t_window, static_cast<float>(w_max), wta_k,
      stabilize != 0, eps);
  return static_cast<int>(cudaGetLastError());
}
