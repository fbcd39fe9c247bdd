// Batched RNL firing times of frozen integer-grid weights:
// t_in [B, p] x w [p, q] -> [B, q] int32, t_max where a neuron never fires.
//
// Replaces the TPU kernel _rnl_kernel (src/repro/kernels/rnl_response.py)
// behind rnl_fire_pallas; it is the assignment pass of mode='pallas'.
//
// What bounds it on an H100: arithmetic.  The work is B * q * p min+add
// pairs for every cycle up to each neuron's first crossing (0.78 G at
// B = 905, 270 x 25, t_max = 64) against a few hundred KB of input.  The
// TPU kernel put it on the matrix unit with one-hot weight planes; here
// the ramp sum is evaluated directly in f32 on the CUDA cores:
//  * one block per tile of kVolleys volleys keeps the rounded weight grid
//    and the tile's volleys in shared memory;
//  * one warp per (volley, neuron) pair, lanes split the synapses and a
//    warp sum gives V(t);
//  * the loop over t stops at the first crossing (V is nondecreasing), so
//    a neuron that fires early costs only the cycles before it.
// Times at or past t_max are silent by construction: their ramps never
// start inside the window.
#include <cuda_runtime.h>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVolleys = 8;

__global__ void __launch_bounds__(kThreads) rnl_fire_kernel(
    const float* __restrict__ t_in, const float* __restrict__ w,
    int* __restrict__ out, int b, int p, int q, float threshold, int t_max,
    float w_max) {
  extern __shared__ float smem[];
  float* swi = smem;          // [p * q] integer fire grid
  float* sti = swi + p * q;   // [kVolleys * p] this tile's volleys

  const int b0 = blockIdx.x * kVolleys;
  const int nb = min(kVolleys, b - b0);
  for (int k = threadIdx.x; k < p * q; k += blockDim.x)
    swi[k] = tnn::fire_grid(w[k], w_max);
  for (int k = threadIdx.x; k < nb * p; k += blockDim.x)
    sti[k] = t_in[static_cast<size_t>(b0) * p + k];
  __syncthreads();

  const int warp = threadIdx.x / tnn::kWarp;
  const int n_warps = blockDim.x / tnn::kWarp;
  for (int pair = warp; pair < nb * q; pair += n_warps) {
    const int v = pair / q;
    const int j = pair - v * q;
    const int t = tnn::warp_fire_time(swi, q, j, sti + v * p, p, threshold,
                                      t_max);
    if (threadIdx.x % tnn::kWarp == 0)
      out[static_cast<size_t>(b0 + v) * q + j] = t;
  }
}

}  // namespace

extern "C" size_t tnn_rnl_fire_smem_bytes(int p, int q) {
  return (static_cast<size_t>(p) * q + static_cast<size_t>(kVolleys) * p) *
         sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tnn_rnl_fire(const void* t_in, const void* w, void* out,
                            int b, int p, int q, float threshold, int t_max,
                            int w_max, void* stream) {
  const size_t smem = tnn_rnl_fire_smem_bytes(p, q);
  cudaError_t err = cudaFuncSetAttribute(
      rnl_fire_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (b + kVolleys - 1) / kVolleys;
  rnl_fire_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t_in), static_cast<const float*>(w),
      static_cast<int*>(out), b, p, q, threshold, t_max,
      static_cast<float>(w_max));
  return static_cast<int>(cudaGetLastError());
}
