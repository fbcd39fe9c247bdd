// Frozen-weight RNL fire of every volley of every design on the integer
// weight grid: the assignment pass of the padded design sweep.
//
// Replaces the TPU kernel _fire_block_kernel
// (src/repro/kernels/fused_column.py, inside assign_padded); the ids are
// taken from its times by _ids_from_times in
// repro_torch/kernels/fused_column.py, as the JAX package takes them
// outside its kernel.
//
// What bounds it on an H100: the dependent chain of each (volley, neuron)
// pair, not bytes.  At D = 8, N = 900, 270 x 50 it reads ~8 MB and writes
// ~1.4 MB (microseconds of bytes), and volleys have no order here, so the
// work is spread wide: one warp fires one pair, and the warps of a block
// walk their pairs independently (no block-wide barrier per pair):
//  * int32 times, all >= 0: the slope histogram of tnn_column.cuh
//    (warp_slope_fire_time).  Each warp keeps ONE difference row of
//    t_window + 1 ints in shared memory; the lanes scatter the pair's p
//    synapses into it (+1 at t_i, -1 at t_i + g_ij, shared int atomics;
//    nothing for a time at or past t_end = min(t_window, ceil(t_max)) or
//    g = 0), and two warp scans and a ballot find the first crossing 32
//    cycles a step, leaving the row zeroed for the next pair;
//  * f32 times, or int32 times with a negative one: the ramp sum
//    (warp_fire_time), a warp reduction per cycle up to the crossing.
// Each thread block decides the form for each tile of volleys it stages
// (tnn::stage_times, one __syncthreads_or), with no host sync and no
// launch argument, so one launch may fire some designs and tiles by the
// slope form and others by the ramp sum.  Both are the plain version's
// f32 ramp sum bit for bit (every partial sum is a small integer, or a
// half for x + 0.5 times).
//
// Filling the card: blockIdx.y is the design, and each design gets an
// equal share of one wave of blocks (as many as fit on the card at once,
// tnn::resident_blocks, and at most one per tile of kTile volleys).  Each
// block holds its design's f32 integer grid in shared memory and walks an
// even share of the design's volleys a tile at a time, so the grid is read
// once per block.  At 270 x 50 a block of 16 warps takes 67 KB, three to
// an SM.  The grid stays f32 (any w_max).  Neurons at or past q_active
// are not fired (t_max), and times are clamped to int(t_max).
//
// An envelope whose grid does not fit in shared memory beside a tile and
// the warps' rows (pq + kTile p words + 16 (t_window + 1) ints over
// 227 KB) takes the device-memory layout: a first kernel rounds every
// design's weights once into a [D, p, q] workspace the wrapper allocates,
// and the blocks read that grid through L2.  The fire code is the same in
// both layouts.
//
// Layout: operands [D, 6] f32 (threshold, t_max, q_active first);
// xs [D, N, p] int32 or f32 (a time >= the design's t_max is silent);
// w [D, p, q] f32; t_fire [D, N, q] f32, clamped to t_max, with neurons
// at or past q_active set to t_max; grid [D, p, q] f32 workspace of the
// device-memory layout (unused when resident).
#include <cuda_runtime.h>

#include <algorithm>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 8;  // volleys staged at a time

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads) fire_block_kernel(
    const float* __restrict__ operands, const T* __restrict__ xs,
    const float* __restrict__ w, const float* __restrict__ grid,
    float* __restrict__ t_fire, int n, int p, int q, int t_window,
    float w_max) {
  extern __shared__ float smem[];
  // [p * q] integer fire grid: in shared memory when resident, else the
  // workspace tnn::fire_grid_kernel filled
  float* swi = smem;
  T* sx = reinterpret_cast<T*>(kResident ? smem + p * q : smem);  // [kTile, p]
  int* rows = reinterpret_cast<int*>(sx + kTile * p);  // [warps, t_window + 1]
  const int row_len = t_window + 1;
  const int warp = threadIdx.x / tnn::kWarp;
  const int n_warps = blockDim.x / tnn::kWarp;
  int* row = rows + warp * row_len;

  const int d = blockIdx.y;
  const float* op = operands + d * 6;
  const float threshold = op[0];
  const float t_max = op[1];
  const float q_live = op[2];

  if (kResident) {
    const float* wd = w + static_cast<size_t>(d) * p * q;
    for (int k = threadIdx.x; k < p * q; k += blockDim.x)
      swi[k] = tnn::fire_grid(wd[k], w_max);
  }
  for (int k = threadIdx.x; k < n_warps * row_len; k += blockDim.x)
    rows[k] = 0;
  const float* wi = kResident ? swi : grid + static_cast<size_t>(d) * p * q;
  const T* xd = xs + static_cast<size_t>(d) * n * p;
  float* out = t_fire + static_cast<size_t>(d) * n * q;

  const int t_end = min(t_window, static_cast<int>(ceilf(t_max)));
  const int t_cap = static_cast<int>(t_max);
  // this block's share of the design's volleys, a tile at a time
  const int v_lo = static_cast<int>(static_cast<long long>(n) * blockIdx.x /
                                    gridDim.x);
  const int v_hi = static_cast<int>(
      static_cast<long long>(n) * (blockIdx.x + 1) / gridDim.x);
  for (int v0 = v_lo; v0 < v_hi; v0 += kTile) {
    const int nv = min(kTile, v_hi - v0);
    __syncthreads();  // the previous tile's pairs are done with sx
    const bool slope =
        tnn::stage_times(sx, xd + static_cast<size_t>(v0) * p, nv * p);
    for (int pair = warp; pair < nv * q; pair += n_warps) {
      const int v = pair / q;
      const int j = pair - v * q;
      const T* ti = sx + v * p;
      int t = t_cap;  // neurons at or past q_active stay silent
      if (static_cast<float>(j) < q_live)
        t = min(slope ? tnn::warp_slope_fire_time(row, wi, q, j, ti, p,
                                                  threshold, t_end)
                      : tnn::warp_fire_time(wi, q, j, ti, p, threshold,
                                            t_end),
                t_cap);
      if (threadIdx.x % tnn::kWarp == 0)
        out[static_cast<size_t>(v0 + v) * q + j] = static_cast<float>(t);
    }
  }
}

template <typename T>
cudaError_t launch(bool resident, size_t smem, cudaStream_t stream,
                   const void* operands, const void* xs, const void* w,
                   const void* grid, void* t_fire, int d, int n, int p, int q,
                   int t_window, float w_max) {
  auto kernel = resident ? fire_block_kernel<T, true>
                         : fire_block_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int wave = 0;
  err = tnn::resident_blocks(kernel, kThreads, smem, &wave);
  if (err != cudaSuccess) return err;
  const dim3 blocks(std::max(1, std::min(wave / d, (n + kTile - 1) / kTile)),
                    d);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(operands), static_cast<const T*>(xs),
      static_cast<const float*>(w), static_cast<const float*>(grid),
      static_cast<float*>(t_fire), n, p, q, t_window, w_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t tnn_fire_block_smem_bytes(int p, int q, int t_window,
                                            int resident) {
  const size_t grid_words = resident ? static_cast<size_t>(p) * q : 0;
  return (grid_words + static_cast<size_t>(kTile) * p) * sizeof(float) +
         static_cast<size_t>(kThreads / tnn::kWarp) * (t_window + 1) *
             sizeof(int);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `grid` is the device-memory layout's [D, p, q] workspace, ignored when
// resident.  `int_times`: xs is int32 (else f32).
extern "C" int tnn_fire_block(const void* operands, const void* xs,
                              const void* w, void* grid, int resident,
                              int int_times, void* t_fire, int d, int n,
                              int p, int q, int t_window, int w_max,
                              void* stream) {
  const size_t smem = tnn_fire_block_smem_bytes(p, q, t_window, resident);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float wm = static_cast<float>(w_max);
  if (!resident) {
    const cudaError_t err = tnn::launch_fire_grid(
        static_cast<const float*>(w), static_cast<float*>(grid),
        static_cast<size_t>(d) * p * q, wm, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err =
      int_times ? launch<int>(resident, smem, st, operands, xs, w, grid,
                              t_fire, d, n, p, q, t_window, wm)
                : launch<float>(resident, smem, st, operands, xs, w, grid,
                                t_fire, d, n, p, q, t_window, wm);
  return static_cast<int>(err);
}
