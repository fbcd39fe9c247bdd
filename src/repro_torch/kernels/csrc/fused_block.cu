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
// volleys at 270 x 50 moves ~140 KB per design and does ~28 M min+add
// operations, well under a microsecond of either, but the volleys are a
// sequential chain: volley i fires against the weights that volley i-1
// wrote.  So one thread block per design walks the block's volleys in
// order and keeps everything that chain touches on chip: the float
// weights, their integer fire grid (recomputed by each synapse's own
// thread right after its STDP write) and the block's volleys, staged
// once.  The weights are read from device memory once per launch and
// written once.  Within a volley the fire is one warp per neuron, the
// WTA one warp, the STDP one thread per synapse, as in fused_step.cu.
// Volleys at or past n_valid (the silent-padded tail of the last block)
// are not folded at all.
//
// A design too wide to keep its weights and grid in shared memory beside
// even one volley (2pq + p + 2q words over 227 KB) takes the device-memory
// layout: the weights are updated in place in w_out and their grid in a
// workspace the wrapper allocates, both read through L2, while the
// block's volleys, the winner times and the firing times stay in shared
// memory.  __syncthreads() orders the block's own global writes before
// the next volley's fire, and the fire, WTA and STDP code is shared.
//
// Layout: w, w_out [D, p, q] f32; t_in [D, v_blk, p] f32 (a time >= the
// design's t_max is silent); operands [D, 6] f32 in the column order of
// fused_column.OPERAND_COLS (threshold, t_max, q_active, mu_capture,
// mu_backoff, mu_search); grid [D, p, q] f32 workspace of the
// device-memory layout (unused when resident).
#include <cuda_runtime.h>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 512;

template <bool kResident>
__global__ void __launch_bounds__(kThreads) fused_block_kernel(
    const float* __restrict__ w, const float* __restrict__ t_in,
    const float* __restrict__ operands, float* __restrict__ w_out,
    float* __restrict__ grid, int p, int q, int v_blk, int n_valid,
    int t_window, float w_max, int wta_k, bool stabilize, float eps) {
  extern __shared__ float smem[];
  const int d = blockIdx.x;
  const int n = p * q;
  // [p * q] weights and [p * q] their integer fire grid: in shared memory
  // when resident, else in w_out (updated in place) and the workspace
  float* sw = kResident ? smem : w_out + static_cast<size_t>(d) * n;
  float* swi = kResident ? smem + n : grid + static_cast<size_t>(d) * n;
  float* sti = kResident ? smem + 2 * n : smem;  // [v_blk * p] volleys
  float* sy = sti + v_blk * p;                   // [q] winner times
  int* st_fire = reinterpret_cast<int*>(sy + q);  // [q] firing times

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

  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float v = wd[k];
    sw[k] = v;
    swi[k] = tnn::fire_grid(v, w_max);
  }
  for (int i = threadIdx.x; i < n_fold * p; i += blockDim.x) sti[i] = td[i];
  __syncthreads();  // orders the block's own global writes as well

  const int t_end = min(t_window, static_cast<int>(ceilf(t_max)));
  const int t_cap = static_cast<int>(t_max);
  const int warp = threadIdx.x / tnn::kWarp;
  const int n_warps = blockDim.x / tnn::kWarp;
  for (int vi = 0; vi < n_fold; ++vi) {
    const float* ti = sti + vi * p;
    // fire against the grid the previous volley left; neurons at or past
    // q_active are silent
    for (int j = warp; j < q; j += n_warps) {
      int t = tnn::warp_fire_time(swi, q, j, ti, p, threshold, t_end);
      if (static_cast<float>(j) >= q_live) t = t_cap;
      if (threadIdx.x % tnn::kWarp == 0) st_fire[j] = min(t, t_cap);
    }
    __syncthreads();

    if (warp == 0) tnn::warp_wta(st_fire, q, t_cap, wta_k, sy);
    __syncthreads();

    // STDP, then the synapse's grid entry for the next volley's fire;
    // neurons at or past q_active keep their weights
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int i = k / q;
      const int j = k - i * q;
      if (static_cast<float>(j) < q_live) {
        const float v = tnn::stdp_synapse(sw[k], ti[i], sy[j], t_max,
                                          mu_capture, mu_backoff, mu_search,
                                          w_max, eps, stabilize);
        sw[k] = v;
        swi[k] = tnn::fire_grid(v, w_max);
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
                                             int resident) {
  const size_t grid_words = resident ? 2 * static_cast<size_t>(p) * q : 0;
  return (grid_words + static_cast<size_t>(v_blk) * p + q) * sizeof(float) +
         q * sizeof(int);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `grid` is the device-memory layout's workspace, ignored when resident.
extern "C" int tnn_fused_block(const void* w, const void* t_in,
                               const void* operands, void* w_out, void* grid,
                               int resident, int d, int p, int q, int v_blk,
                               int n_valid, int t_window, int w_max,
                               int wta_k, int stabilize, float eps,
                               void* stream) {
  const size_t smem = tnn_fused_block_smem_bytes(p, q, v_blk, resident);
  auto kernel = resident ? fused_block_kernel<true> : fused_block_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<d, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(t_in),
      static_cast<const float*>(operands), static_cast<float*>(w_out),
      static_cast<float*>(grid), p, q, v_blk, n_valid, t_window,
      static_cast<float>(w_max), wta_k, stabilize != 0, eps);
  return static_cast<int>(cudaGetLastError());
}
