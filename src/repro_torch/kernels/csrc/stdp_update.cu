// Expected-mode STDP update of one volley: w[p, q] from the input spike
// times x[p] and the post-WTA output times y[q], clamped to [0, w_max].
//
// Replaces the TPU kernel _stdp_kernel (src/repro/kernels/stdp_update.py)
// behind stdp_update_pallas; ops.stdp_step launches it once per volley.
//
// What bounds it on an H100: bytes.  Each synapse reads its weight and
// two broadcast times and writes its weight, a few flops each: 8 B of
// weights per synapse against ~10 operations, far below the card's
// balance point.  At the paths' shapes (270 x 25 to 650 x 130) the whole
// update is 55 KB to 680 KB, tens to hundreds of nanoseconds of memory
// time, so the launch itself costs more than the work.  The design does
// nothing clever: one thread per synapse over the flat p * q grid,
// neighbouring threads on neighbouring weights (coalesced), x and y read
// through the read-only cache.  The TPU kernel tiled (p, q) to fill its
// 8 x 128 vector registers and padded with silent entries; a flat grid
// needs no padding.
//
// The arithmetic is tnn::stdp_synapse, shared with fused_step.cu and
// fused_block.cu: --fmad=false, the _rn intrinsics and XLA's compiled
// stabilizer form, so it equals ref.stdp_ref(..., compiled=True) and the
// JAX package's jitted kernel bit for bit.  Times arrive as f32 (the
// wrapper casts int32 times, as the TPU wrapper does).
#include <cuda_runtime.h>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) stdp_update_kernel(
    const float* __restrict__ w, const float* __restrict__ x,
    const float* __restrict__ y, float* __restrict__ w_out, int p, int q,
    float t_max, float mu_capture, float mu_backoff, float mu_search,
    float w_max, float eps, bool stabilize) {
  const long long n = static_cast<long long>(p) * q;
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = static_cast<int>(k / q);
  const int j = static_cast<int>(k - static_cast<long long>(i) * q);
  w_out[k] = tnn::stdp_synapse(w[k], __ldg(x + i), __ldg(y + j), t_max,
                               mu_capture, mu_backoff, mu_search, w_max, eps,
                               stabilize);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tnn_stdp_update(const void* w, const void* x, const void* y,
                               void* w_out, int p, int q, float t_max,
                               float mu_capture, float mu_backoff,
                               float mu_search, int w_max, int stabilize,
                               float eps, void* stream) {
  const long long n = static_cast<long long>(p) * q;
  const long long blocks = (n + kThreads - 1) / kThreads;
  stdp_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<float*>(w_out), p, q, t_max,
      mu_capture, mu_backoff, mu_search, static_cast<float>(w_max), eps,
      stabilize != 0);
  return static_cast<int>(cudaGetLastError());
}
