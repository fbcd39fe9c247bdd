// Batched RNL firing times of frozen integer-grid weights:
// t_in [B, p] x w [p, q] -> [B, q] int32, t_max where a neuron never fires.
//
// Replaces the TPU kernel _rnl_kernel (src/repro/kernels/rnl_response.py)
// behind rnl_fire_pallas; it is the assignment pass of mode='pallas' and
// the fire of ops.column_forward.
//
// What bounds it on an H100: the dependent chain of each (volley, neuron)
// pair, not bytes (a few hundred KB at B = 900, 270 x 25) and not the
// arithmetic.  The TPU kernel put the ramp sum on the matrix unit with
// one-hot weight planes; here one warp fires one pair, and the block's
// warps walk their pairs independently (no block-wide barrier per pair):
//  * int32 times, all >= 0: the slope histogram of tnn_column.cuh
//    (warp_slope_fire_time).  Each warp keeps ONE difference row of
//    t_max + 1 ints in shared memory; the lanes scatter the pair's p
//    synapses into it (+1 at t_i, -1 at t_i + g_ij, shared int atomics),
//    and two warp scans and a ballot find the first crossing 32 cycles a
//    step, leaving the row zeroed for the next pair.  A pair costs
//    ceil(p / 32) scatter steps and ceil(t_max / 32) scan steps;
//  * f32 times, or int32 times with a negative one: the ramp sum
//    (warp_fire_time), a warp reduction per cycle up to the crossing.
// Each thread block decides the form for each tile of volleys it stages
// (tnn::stage_times, one __syncthreads_or), with no host sync and no
// launch argument; both forms are the plain version's f32 ramp sum bit for
// bit (every partial sum is a small integer, or a half for x + 0.5 times).
//
// Filling the card: the launch is one wave of blocks (as many as fit on
// the card at once, tnn::resident_blocks, and at most one per tile of
// kTile volleys), each holding the f32 integer grid in shared memory and
// walking an even share of the batch a tile at a time, so the grid is
// read once per block.  At B = 900, 270 x 25 that is 450 blocks of 8
// warps, 31 KB each, over 132 SMs.  The grid stays f32 (any w_max).
//
// A column whose grid does not fit in shared memory beside a tile and the
// warps' rows (pq + kTile p words + 8 (t_max + 1) ints over 227 KB) takes
// the device-memory layout: a first kernel rounds the weights once into a
// [p, q] workspace the wrapper allocates, and every block reads that grid
// through L2.  The fire code is the same in both layouts.
#include <cuda_runtime.h>

#include <algorithm>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2;  // volleys staged at a time

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads) rnl_fire_kernel(
    const T* __restrict__ t_in, const float* __restrict__ w,
    const float* __restrict__ grid, int* __restrict__ out, int b, int p,
    int q, float threshold, int t_max, float w_max) {
  extern __shared__ float smem[];
  // [p * q] integer fire grid: in shared memory when resident, else the
  // workspace tnn::fire_grid_kernel filled
  float* swi = smem;
  T* sti = reinterpret_cast<T*>(kResident ? smem + p * q : smem);  // [kTile, p]
  int* rows = reinterpret_cast<int*>(sti + kTile * p);  // [warps, t_max + 1]
  const int row_len = t_max + 1;
  const int warp = threadIdx.x / tnn::kWarp;
  const int n_warps = blockDim.x / tnn::kWarp;
  int* row = rows + warp * row_len;

  if (kResident) {
    for (int k = threadIdx.x; k < p * q; k += blockDim.x)
      swi[k] = tnn::fire_grid(w[k], w_max);
  }
  for (int k = threadIdx.x; k < n_warps * row_len; k += blockDim.x)
    rows[k] = 0;
  const float* wi = kResident ? swi : grid;

  // this block's share of the batch, a tile at a time
  const int v_lo = static_cast<int>(static_cast<long long>(b) * blockIdx.x /
                                    gridDim.x);
  const int v_hi = static_cast<int>(
      static_cast<long long>(b) * (blockIdx.x + 1) / gridDim.x);
  for (int v0 = v_lo; v0 < v_hi; v0 += kTile) {
    const int nv = min(kTile, v_hi - v0);
    __syncthreads();  // the previous tile's pairs are done with sti
    const bool slope =
        tnn::stage_times(sti, t_in + static_cast<size_t>(v0) * p, nv * p);
    for (int pair = warp; pair < nv * q; pair += n_warps) {
      const int v = pair / q;
      const int j = pair - v * q;
      const T* ti = sti + v * p;
      const int t =
          slope ? tnn::warp_slope_fire_time(row, wi, q, j, ti, p, threshold,
                                            t_max)
                : tnn::warp_fire_time(wi, q, j, ti, p, threshold, t_max);
      if (threadIdx.x % tnn::kWarp == 0)
        out[static_cast<size_t>(v0 + v) * q + j] = t;
    }
  }
}

template <typename T>
cudaError_t launch(bool resident, size_t smem, cudaStream_t stream,
                   const void* t_in, const void* w, const void* grid,
                   void* out, int b, int p, int q, float threshold, int t_max,
                   float w_max) {
  auto kernel = resident ? rnl_fire_kernel<T, true>
                         : rnl_fire_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = tnn::resident_blocks(kernel, kThreads, smem, &blocks);
  if (err != cudaSuccess) return err;
  blocks = std::min(blocks, (b + kTile - 1) / kTile);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(t_in), static_cast<const float*>(w),
      static_cast<const float*>(grid), static_cast<int*>(out), b, p, q,
      threshold, t_max, w_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t tnn_rnl_fire_smem_bytes(int p, int q, int t_max,
                                          int resident) {
  const size_t grid_words = resident ? static_cast<size_t>(p) * q : 0;
  return (grid_words + static_cast<size_t>(kTile) * p) * sizeof(float) +
         static_cast<size_t>(kThreads / tnn::kWarp) * (t_max + 1) *
             sizeof(int);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `grid` is the device-memory layout's [p, q] workspace, ignored when
// resident.  `int_times`: t_in is int32 (else f32).
extern "C" int tnn_rnl_fire(const void* t_in, const void* w, void* grid,
                            int resident, int int_times, void* out, int b,
                            int p, int q, float threshold, int t_max,
                            int w_max, void* stream) {
  const size_t smem = tnn_rnl_fire_smem_bytes(p, q, t_max, resident);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float wm = static_cast<float>(w_max);
  if (!resident) {
    const cudaError_t err = tnn::launch_fire_grid(
        static_cast<const float*>(w), static_cast<float*>(grid),
        static_cast<size_t>(p) * q, wm, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err =
      int_times ? launch<int>(resident, smem, st, t_in, w, grid, out, b, p, q,
                              threshold, t_max, wm)
                : launch<float>(resident, smem, st, t_in, w, grid, out, b, p,
                                q, threshold, t_max, wm);
  return static_cast<int>(err);
}
