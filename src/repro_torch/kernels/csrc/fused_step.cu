// One online-STDP volley of a TNN column for D designs: RNL fire on the
// integer weight grid, k-WTA, expected STDP, weights written back.
//
// Replaces the TPU kernel _fused_kernel (src/repro/kernels/fused_column.py)
// behind fused_step_pallas_padded; the host loop over epochs x volleys
// launches it once per volley (repro_torch/kernels/fused_column.py).
//
// What bounds it on an H100: neither bytes nor arithmetic.  One volley at
// 270 x 25 moves ~55 KB and does ~0.9 M min+add operations, some tens of
// nanoseconds of either, while a launch costs microseconds; the work is
// also sequential from volley to volley.  The design keeps it simple and
// on chip: one thread block per design holds that design's weights, their
// rounded fire grid and the volley in shared memory for the whole step,
// so the weights are read from device memory once and written once.
// A design too wide for that (2pq + p + 2q words over 227 KB) takes the
// device-memory layout: the weights live in w_out and their grid in a
// workspace the wrapper allocates, both read through L2, while the volley,
// the winner times and the firing times stay in shared memory.  The fire,
// WTA and STDP code is the same in both layouts.
// Folding many volleys into one launch, which is what would remove the
// launch cost, is the port of _fused_block_kernel.
//
// Layout: w, w_out [D, p, q] f32; t_in [D, p] f32 (a time >= the design's
// t_max is silent); operands [D, 6] f32 in the column order of
// fused_column.OPERAND_COLS (threshold, t_max, q_active, mu_capture,
// mu_backoff, mu_search); y_out [D, q] f32 winner times (t_max = none);
// grid [D, p, q] f32 workspace of the device-memory layout (unused when
// resident).
#include <cuda_runtime.h>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kResident>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(
    const float* __restrict__ w, const float* __restrict__ t_in,
    const float* __restrict__ operands, float* __restrict__ w_out,
    float* __restrict__ y_out, float* __restrict__ grid, int p, int q,
    int t_window, float w_max, int wta_k, bool stabilize, float eps) {
  extern __shared__ float smem[];
  const int d = blockIdx.x;
  const int n = p * q;
  // [p * q] weights and [p * q] their integer fire grid: in shared memory
  // when resident, else in w_out and the workspace
  float* sw = kResident ? smem : w_out + static_cast<size_t>(d) * n;
  float* swi = kResident ? smem + n : grid + static_cast<size_t>(d) * n;
  float* sti = kResident ? smem + 2 * n : smem;  // [p] volley
  float* sy = sti + p;                           // [q] winner times
  int* st_fire = reinterpret_cast<int*>(sy + q);  // [q] firing times

  const float* op = operands + d * 6;
  const float threshold = op[0];
  const float t_max = op[1];
  const float q_live = op[2];
  const float mu_capture = op[3];
  const float mu_backoff = op[4];
  const float mu_search = op[5];
  const float* wd = w + static_cast<size_t>(d) * n;

  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float v = wd[k];
    sw[k] = v;
    swi[k] = tnn::fire_grid(v, w_max);
  }
  for (int i = threadIdx.x; i < p; i += blockDim.x)
    sti[i] = t_in[static_cast<size_t>(d) * p + i];
  __syncthreads();  // orders the block's own global writes as well

  // fire: one warp per neuron, cycles [0, min(t_max, t_window)) counted;
  // neurons at or past q_active are silent
  const int t_end = min(t_window, static_cast<int>(ceilf(t_max)));
  const int warp = threadIdx.x / tnn::kWarp;
  const int n_warps = blockDim.x / tnn::kWarp;
  for (int j = warp; j < q; j += n_warps) {
    int t = tnn::warp_fire_time(swi, q, j, sti, p, threshold, t_end);
    if (static_cast<float>(j) >= q_live) t = static_cast<int>(t_max);
    if (threadIdx.x % tnn::kWarp == 0)
      st_fire[j] = min(t, static_cast<int>(t_max));
  }
  __syncthreads();

  if (warp == 0)
    tnn::warp_wta(st_fire, q, static_cast<int>(t_max), wta_k, sy);
  __syncthreads();

  // STDP: one thread per synapse; neurons at or past q_active keep w.
  // Each thread reads and writes only its own synapses, so the in-place
  // update of the device-memory layout needs no further ordering.
  float* wo = w_out + static_cast<size_t>(d) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int i = k / q;
    const int j = k - i * q;
    const float v = sw[k];
    wo[k] = static_cast<float>(j) < q_live
        ? tnn::stdp_synapse(v, sti[i], sy[j], t_max, mu_capture, mu_backoff,
                            mu_search, w_max, eps, stabilize)
        : v;
  }
  for (int j = threadIdx.x; j < q; j += blockDim.x)
    y_out[static_cast<size_t>(d) * q + j] = sy[j];
}

}  // namespace

extern "C" size_t tnn_fused_step_smem_bytes(int p, int q, int resident) {
  const size_t grid_words = resident ? 2 * static_cast<size_t>(p) * q : 0;
  return (grid_words + p + q) * sizeof(float) + q * sizeof(int);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `grid` is the device-memory layout's workspace, ignored when resident.
extern "C" int tnn_fused_step(const void* w, const void* t_in,
                              const void* operands, void* w_out, void* y_out,
                              void* grid, int resident, int d, int p, int q,
                              int t_window, int w_max, int wta_k,
                              int stabilize, float eps, void* stream) {
  const size_t smem = tnn_fused_step_smem_bytes(p, q, resident);
  auto kernel = resident ? fused_step_kernel<true> : fused_step_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<d, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(t_in),
      static_cast<const float*>(operands), static_cast<float*>(w_out),
      static_cast<float*>(y_out), static_cast<float*>(grid), p, q, t_window,
      static_cast<float>(w_max), wta_k, stabilize != 0, eps);
  return static_cast<int>(cudaGetLastError());
}
