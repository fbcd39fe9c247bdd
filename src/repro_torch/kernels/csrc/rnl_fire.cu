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
//
// A column whose grid and tile do not fit in shared memory (pq + 8p words
// over 227 KB) takes the device-memory layout: a first kernel rounds the
// weights once into a [p, q] workspace the wrapper allocates, and every
// block reads that grid through L2, keeping only its tile's volleys in
// shared memory.  The fire code is the same in both layouts.
#include <cuda_runtime.h>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVolleys = 8;

template <bool kResident>
__global__ void __launch_bounds__(kThreads) rnl_fire_kernel(
    const float* __restrict__ t_in, const float* __restrict__ w,
    const float* __restrict__ grid, int* __restrict__ out, int b, int p,
    int q, float threshold, int t_max, float w_max) {
  extern __shared__ float smem[];
  // [p * q] integer fire grid: in shared memory when resident, else the
  // workspace tnn::fire_grid_kernel filled
  float* swi = smem;
  float* sti = kResident ? smem + p * q : smem;  // [kVolleys * p] volleys

  const int b0 = blockIdx.x * kVolleys;
  const int nb = min(kVolleys, b - b0);
  if (kResident) {
    for (int k = threadIdx.x; k < p * q; k += blockDim.x)
      swi[k] = tnn::fire_grid(w[k], w_max);
  }
  const float* wi = kResident ? swi : grid;
  for (int k = threadIdx.x; k < nb * p; k += blockDim.x)
    sti[k] = t_in[static_cast<size_t>(b0) * p + k];
  __syncthreads();

  const int warp = threadIdx.x / tnn::kWarp;
  const int n_warps = blockDim.x / tnn::kWarp;
  for (int pair = warp; pair < nb * q; pair += n_warps) {
    const int v = pair / q;
    const int j = pair - v * q;
    const int t = tnn::warp_fire_time(wi, q, j, sti + v * p, p, threshold,
                                      t_max);
    if (threadIdx.x % tnn::kWarp == 0)
      out[static_cast<size_t>(b0 + v) * q + j] = t;
  }
}

}  // namespace

extern "C" size_t tnn_rnl_fire_smem_bytes(int p, int q, int resident) {
  const size_t grid_words = resident ? static_cast<size_t>(p) * q : 0;
  return (grid_words + static_cast<size_t>(kVolleys) * p) * sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `grid` is the device-memory layout's [p, q] workspace, ignored when
// resident.
extern "C" int tnn_rnl_fire(const void* t_in, const void* w, void* grid,
                            int resident, void* out, int b, int p, int q,
                            float threshold, int t_max, int w_max,
                            void* stream) {
  const size_t smem = tnn_rnl_fire_smem_bytes(p, q, resident);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = resident ? rnl_fire_kernel<true> : rnl_fire_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!resident) {
    err = tnn::launch_fire_grid(
        static_cast<const float*>(w), static_cast<float*>(grid),
        static_cast<size_t>(p) * q, static_cast<float>(w_max), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (b + kVolleys - 1) / kVolleys;
  kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const float*>(t_in), static_cast<const float*>(w),
      static_cast<const float*>(grid), static_cast<int*>(out), b, p, q,
      threshold, t_max, static_cast<float>(w_max));
  return static_cast<int>(cudaGetLastError());
}
