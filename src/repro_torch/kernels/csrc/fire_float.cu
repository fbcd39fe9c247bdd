// Frozen-weight RNL fire of every volley of every design on the float
// weights as they are (no rounding to the integer grid): the assignment
// pass of the padded design sweep once online STDP has left the weights
// off the grid.
//
// Replaces the reference-lowering fire of the JAX package's assign_padded
// (src/repro/kernels/fused_column.py: fire_dense_ref, vmapped over blocks
// of volleys inside assign_padded), which has no TPU kernel: its TPU
// kernel (_fire_block_kernel, ported as fire_block.cu) fires the integer
// grid only.  The plain version is _fire_designs in
// repro_torch/kernels/fused_column.py, which materialises the dense
// [D, volleys, p, q, T] potential and sums it in float64; the ids are
// taken from these times by _ids_from_times there.
//
// What bounds it on an H100: as for fire_block.cu, the dependent chain of
// each (volley, neuron) pair, not bytes (D = 12, N = 900 at 540 x 50 reads
// ~24 MB and writes ~2 MB).  One warp fires one pair, the warps of a block
// walk their pairs independently, blockIdx.y is the design and each
// design gets an equal share of one wave of blocks (tnn::resident_blocks).
//
// The fire, exact on float weights.  Synapse i adds min(relu(t - x_i), w)
// to V(t) while its time x_i < t_max, and min(0, w) while it is silent.
//  * w > 0, integer x_i >= 0 (the slope form): with n = ceil(w) the term
//    rises by 1 on each of the cycles x_i + 1 .. x_i + n - 1 and then by a
//    final step of w - (n - 1), in (0, 1], at cycle x_i + n.  Each warp
//    keeps an int difference row for the rises (+1 at x_i, -1 at
//    x_i + n - 1, as tnn::scatter_ramp) and a float64 row for the final
//    steps (at x_i + n - 1); two int scans and one float64 scan give
//    V(s + 1) 32 cycles a step, and a ballot the first crossing.  Nothing
//    is scattered at or past the window's end t_end = min(t_window,
//    ceil(t_max)); a weight of +inf is a pure ramp.  The step is never
//    taken as w - ceil(w): for a tiny w that difference from -1 rounds in
//    float64, where the plain sum adds w exactly.
//  * w <= 0, or NaN: the term is the constant w (a silent synapse's
//    min(0, w) too), so each block sums it once per neuron into `base`;
//    a NaN weight makes the potential NaN at every cycle.
//  * f32 times, or int32 times with a negative one: the ramp sum, a
//    float64 warp reduction of the f32 terms per cycle up to the crossing.
// Each thread block decides the form for each tile of volleys it stages
// (tnn::stage_times), as fire_block does.
//
// Numerics.  Every term is an f32 value and every step a difference that
// is exact in f32, and V is summed in float64, as the plain version sums
// the same f32 terms; so the two agree bit for bit wherever that float64
// sum is exact (weights of the trained grid are: ~40 significant bits of
// a potential below 2^12), whatever order each adds in.  A pair's time is
// the number of cycles t < t_end with V(t) < threshold (the threshold f32
// widened to float64, as the plain version's v < thr promotes it): V is
// nondecreasing, so that is the first cycle where !(V < threshold), and
// a NaN potential fires at 0.  Times clamp to int(t_max); neurons at or
// past q_active report t_max as it is.
//
// Layout: the f32 weights of the design stay unrounded, in shared memory
// where they fit beside a tile of volleys and the warps' rows (pq + kTile
// p words + 12 bytes a cycle and warp + 8 q), else read through L2 from w
// (no workspace).  operands [D, 6] f32 (threshold, t_max, q_active first);
// xs [D, N, p] int32 or f32 (a time >= the design's t_max is silent);
// w [D, p, q] f32; t_fire [D, N, q] f32.
#include <cuda_runtime.h>

#include <algorithm>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / tnn::kWarp;
constexpr int kTile = 8;  // volleys staged at a time
constexpr unsigned kAll = 0xffffffffu;

// Inclusive prefix sum over the warp's lanes, in float64.
__device__ __forceinline__ double warp_inclusive_scan(double x) {
  const int lane = threadIdx.x % tnn::kWarp;
  for (int off = 1; off < tnn::kWarp; off <<= 1) {
    const double y = __shfl_up_sync(kAll, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Sum over the warp in float64; every lane returns lane 0's total.
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = tnn::kWarp / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(kAll, v, off);
  return __shfl_sync(kAll, v, 0);
}

// The slope form of one (volley, neuron) pair by one whole warp, in the
// warp's int row and float64 row (each at least t_end long, zero on entry
// and left zeroed): the lanes scatter neuron j's synapses with positive
// weight (w[i * q + j], integer times ti[i] >= 0), then scan.
template <typename T>
__device__ __forceinline__ int warp_slope_fire_time(
    int* row, double* frow, const float* w, int q, int j, const T* ti,
    int p, double threshold, double base, int t_end) {
  const int lane = threadIdx.x % tnn::kWarp;
  for (int i = lane; i < p; i += tnn::kWarp) {
    const float g = w[i * q + j];
    const int x = static_cast<int>(ti[i]);
    if (x >= t_end || !(g > 0.0f)) continue;  // x >= t_end: silent here
    if (g <= static_cast<float>(t_end - x)) {  // tops out inside the window
      const int n1 = static_cast<int>(ceilf(g)) - 1;
      if (n1 > 0) {
        atomicAdd(row + x, 1);
        atomicAdd(row + x + n1, -1);
      }
      atomicAdd(frow + x + n1,
                static_cast<double>(g) - static_cast<double>(n1));
    } else {
      atomicAdd(row + x, 1);
    }
  }
  __syncwarp();
  int fire = !(base < threshold) ? 0 : t_end;
  int slope = 0, vi = 0;  // carried from the previous 32 cycles
  double vf = 0.0;
  for (int s0 = 0; s0 < t_end; s0 += tnn::kWarp) {
    const int s = s0 + lane;
    int c = 0;
    double f = 0.0;
    if (s < t_end) {
      c = row[s];
      f = frow[s];
      row[s] = 0;
      frow[s] = 0.0;
    }
    if (fire < t_end) continue;  // found: only the zeroing is left
    c = tnn::warp_inclusive_scan(c) + slope;  // rising synapses at cycle s
    slope = __shfl_sync(kAll, c, tnn::kWarp - 1);
    c = tnn::warp_inclusive_scan(c) + vi;  // the rises' part of V(s + 1)
    vi = __shfl_sync(kAll, c, tnn::kWarp - 1);
    f = warp_inclusive_scan(f) + vf;  // the final steps' part of V(s + 1)
    vf = __shfl_sync(kAll, f, tnn::kWarp - 1);
    const double v = (static_cast<double>(c) + f) + base;
    const unsigned hit = __ballot_sync(kAll, s + 1 < t_end && !(v < threshold));
    if (hit) fire = s0 + __ffs(static_cast<int>(hit));  // = s + 1 of the first
  }
  __syncwarp();  // the rows' zeros before the next pair's scatter
  return fire;
}

// The ramp sum of one pair by one whole warp, for f32 times and negative
// int32 ones: V(t) = base + the float64 sum of the f32 terms
// min(relu(t - ti[i]), w) of live synapses with positive weight.
template <typename T>
__device__ __forceinline__ int warp_ramp_fire_time(
    const float* w, int q, int j, const T* ti, int p, float t_max,
    double threshold, double base, int t_end) {
  const int lane = threadIdx.x % tnn::kWarp;
  for (int t = 0; t < t_end; ++t) {
    const float tf = static_cast<float>(t);
    double part = 0.0;
    for (int i = lane; i < p; i += tnn::kWarp) {
      const float g = w[i * q + j];
      const float x = static_cast<float>(ti[i]);
      if (g > 0.0f && x < t_max)
        part += static_cast<double>(fminf(fmaxf(tf - x, 0.0f), g));
    }
    if (!(warp_sum(part) + base < threshold)) return t;
  }
  return t_end;
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads) fire_float_kernel(
    const float* __restrict__ operands, const T* __restrict__ xs,
    const float* __restrict__ w, float* __restrict__ t_fire, int n, int p,
    int q, int t_window) {
  extern __shared__ double smem[];
  const int row_len = t_window + 1;
  double* frows = smem;                   // [warps, t_window + 1]
  double* base = frows + kWarps * row_len;  // [q]
  float* sw = reinterpret_cast<float*>(base + q);  // [p * q] when resident
  T* sx = reinterpret_cast<T*>(kResident ? sw + p * q : sw);  // [kTile, p]
  int* rows = reinterpret_cast<int*>(sx + kTile * p);  // [warps, t_window + 1]
  const int warp = threadIdx.x / tnn::kWarp;
  int* row = rows + warp * row_len;
  double* frow = frows + warp * row_len;

  const int d = blockIdx.y;
  const float* op = operands + d * 6;
  const double threshold = static_cast<double>(op[0]);
  const float t_max = op[1];
  const float q_live = op[2];

  const float* wd = w + static_cast<size_t>(d) * p * q;
  if (kResident) {
    for (int k = threadIdx.x; k < p * q; k += blockDim.x) sw[k] = wd[k];
    __syncthreads();
  }
  const float* wj = kResident ? sw : wd;
  for (int k = threadIdx.x; k < kWarps * row_len; k += blockDim.x) {
    rows[k] = 0;
    frows[k] = 0.0;
  }
  // each neuron's constant: min(0, w) of every synapse with w <= 0 or NaN
  for (int j = threadIdx.x; j < q; j += blockDim.x) {
    double c = 0.0;
    for (int i = 0; i < p; ++i) {
      const float g = wj[i * q + j];
      if (!(g > 0.0f)) c += static_cast<double>(g);
    }
    base[j] = c;
  }
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
    for (int pair = warp; pair < nv * q; pair += kWarps) {
      const int v = pair / q;
      const int j = pair - v * q;
      const T* ti = sx + v * p;
      float t = t_max;  // neurons at or past q_active
      if (static_cast<float>(j) < q_live)
        t = static_cast<float>(min(
            slope ? warp_slope_fire_time(row, frow, wj, q, j, ti, p,
                                         threshold, base[j], t_end)
                  : warp_ramp_fire_time(wj, q, j, ti, p, t_max, threshold,
                                        base[j], t_end),
            t_cap));
      if (threadIdx.x % tnn::kWarp == 0)
        out[static_cast<size_t>(v0 + v) * q + j] = t;
    }
  }
}

template <typename T>
cudaError_t launch(bool resident, size_t smem, cudaStream_t stream,
                   const void* operands, const void* xs, const void* w,
                   void* t_fire, int d, int n, int p, int q, int t_window) {
  auto kernel = resident ? fire_float_kernel<T, true>
                         : fire_float_kernel<T, false>;
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
      static_cast<const float*>(w), static_cast<float*>(t_fire), n, p, q,
      t_window);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t tnn_fire_float_smem_bytes(int p, int q, int t_window,
                                            int resident) {
  const size_t row_len = static_cast<size_t>(t_window) + 1;
  const size_t w_words = resident ? static_cast<size_t>(p) * q : 0;
  return (kWarps * row_len + q) * sizeof(double) +
         (w_words + static_cast<size_t>(kTile) * p) * sizeof(float) +
         kWarps * row_len * sizeof(int);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `int_times`: xs is int32 (else f32).
extern "C" int tnn_fire_float(const void* operands, const void* xs,
                              const void* w, int resident, int int_times,
                              void* t_fire, int d, int n, int p, int q,
                              int t_window, void* stream) {
  const size_t smem = tnn_fire_float_smem_bytes(p, q, t_window, resident);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      int_times ? launch<int>(resident, smem, st, operands, xs, w, t_fire, d,
                              n, p, q, t_window)
                : launch<float>(resident, smem, st, operands, xs, w, t_fire,
                                d, n, p, q, t_window);
  return static_cast<int>(err);
}
