// Frozen-weight RNL fire of every volley of every design on the integer
// weight grid: the assignment pass of the padded design sweep.
//
// Replaces the TPU kernel _fire_block_kernel
// (src/repro/kernels/fused_column.py, inside assign_padded); the ids are
// taken from its times by _ids_from_times in
// repro_torch/kernels/fused_column.py, as the JAX package takes them
// outside its kernel.
//
// What bounds it on an H100: arithmetic, at the sweep's shapes.  At
// D = 12, N = 900, 270 x 50 it reads ~12 MB and writes ~2 MB (a few
// microseconds of bytes) but does ~10^10 min+add operations up to each
// neuron's first crossing.  Volleys have no order here, so the work is
// spread wide: one thread block per (design, tile of kTile volleys),
// ceil(N / kTile) x D blocks in all, each holding the design's integer
// grid and its tile's volleys in shared memory, with one warp per
// (volley, neuron) pair walking the cycles to the first crossing.
//
// An envelope whose grid and tile do not fit in shared memory (pq + 8p
// words over 227 KB) takes the device-memory layout: a first kernel rounds
// every design's weights once into a [D, p, q] workspace the wrapper
// allocates, and the blocks read that grid through L2, keeping only their
// tile's volleys in shared memory.  The fire code is the same in both
// layouts.
//
// Layout: operands [D, 6] f32 (threshold, t_max, q_active first);
// xs [D, N, p] f32 (a time >= the design's t_max is silent);
// w [D, p, q] f32; t_fire [D, N, q] f32, clamped to t_max, with neurons
// at or past q_active set to t_max; grid [D, p, q] f32 workspace of the
// device-memory layout (unused when resident).
#include <cuda_runtime.h>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;  // volleys per thread block

template <bool kResident>
__global__ void __launch_bounds__(kThreads) fire_block_kernel(
    const float* __restrict__ operands, const float* __restrict__ xs,
    const float* __restrict__ w, const float* __restrict__ grid,
    float* __restrict__ t_fire, int n, int p, int q, int t_window,
    float w_max) {
  extern __shared__ float smem[];
  // [p * q] integer fire grid: in shared memory when resident, else the
  // workspace tnn::fire_grid_kernel filled
  float* swi = smem;
  float* sx = kResident ? smem + p * q : smem;  // [kTile * p] volleys

  const int d = blockIdx.y;
  const int v0 = blockIdx.x * kTile;
  const int nv = min(kTile, n - v0);
  const float* op = operands + d * 6;
  const float threshold = op[0];
  const float t_max = op[1];
  const float q_live = op[2];

  if (kResident) {
    const float* wd = w + static_cast<size_t>(d) * p * q;
    for (int k = threadIdx.x; k < p * q; k += blockDim.x)
      swi[k] = tnn::fire_grid(wd[k], w_max);
  }
  const float* wi = kResident ? swi : grid + static_cast<size_t>(d) * p * q;
  const float* xd = xs + (static_cast<size_t>(d) * n + v0) * p;
  for (int i = threadIdx.x; i < nv * p; i += blockDim.x) sx[i] = xd[i];
  __syncthreads();

  const int t_end = min(t_window, static_cast<int>(ceilf(t_max)));
  const int t_cap = static_cast<int>(t_max);
  const int warp = threadIdx.x / tnn::kWarp;
  const int n_warps = blockDim.x / tnn::kWarp;
  float* out = t_fire + (static_cast<size_t>(d) * n + v0) * q;
  for (int pair = warp; pair < nv * q; pair += n_warps) {
    const int v = pair / q;
    const int j = pair - v * q;
    int t = t_cap;  // neurons at or past q_active stay silent
    if (static_cast<float>(j) < q_live)
      t = min(tnn::warp_fire_time(wi, q, j, sx + v * p, p, threshold, t_end),
              t_cap);
    if (threadIdx.x % tnn::kWarp == 0) out[v * q + j] = static_cast<float>(t);
  }
}

}  // namespace

extern "C" size_t tnn_fire_block_smem_bytes(int p, int q, int resident) {
  const size_t grid_words = resident ? static_cast<size_t>(p) * q : 0;
  return (grid_words + static_cast<size_t>(kTile) * p) * sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `grid` is the device-memory layout's [D, p, q] workspace, ignored when
// resident.
extern "C" int tnn_fire_block(const void* operands, const void* xs,
                              const void* w, void* grid, int resident,
                              void* t_fire, int d, int n, int p, int q,
                              int t_window, int w_max, void* stream) {
  const size_t smem = tnn_fire_block_smem_bytes(p, q, resident);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = resident ? fire_block_kernel<true> : fire_block_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!resident) {
    err = tnn::launch_fire_grid(
        static_cast<const float*>(w), static_cast<float*>(grid),
        static_cast<size_t>(d) * p * q, static_cast<float>(w_max), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 blocks((n + kTile - 1) / kTile, d);
  kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const float*>(operands), static_cast<const float*>(xs),
      static_cast<const float*>(w), static_cast<const float*>(grid),
      static_cast<float*>(t_fire), n, p, q, t_window,
      static_cast<float>(w_max));
  return static_cast<int>(cudaGetLastError());
}
