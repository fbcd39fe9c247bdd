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
// needs no padding.  The times are read as the path holds them, int32 or
// f32, x and y each its own type (a template per pair), and converted to
// f32 in the kernel: exact, since every time is below 2^24.  So the
// path's int32 times cost no cast launches before the update (they cost
// two a volley, three times the kernel's own time, when the wrapper cast
// them).
//
// The arithmetic is tnn::stdp_synapse, shared with fused_step.cu and
// fused_block.cu: --fmad=false, the _rn intrinsics and XLA's compiled
// stabilizer form, so it equals ref.stdp_ref(..., compiled=True) on f32
// times and the JAX package's jitted kernel bit for bit.
#include <cuda_runtime.h>

#include "tnn_column.cuh"

namespace {

constexpr int kThreads = 256;

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads) stdp_update_kernel(
    const float* __restrict__ w, const TX* __restrict__ x,
    const TY* __restrict__ y, float* __restrict__ w_out, int p, int q,
    float t_max, float mu_capture, float mu_backoff, float mu_search,
    float w_max, float eps, bool stabilize) {
  const long long n = static_cast<long long>(p) * q;
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = static_cast<int>(k / q);
  const int j = static_cast<int>(k - static_cast<long long>(i) * q);
  w_out[k] = tnn::stdp_synapse(w[k], static_cast<float>(__ldg(x + i)),
                               static_cast<float>(__ldg(y + j)), t_max,
                               mu_capture, mu_backoff, mu_search, w_max, eps,
                               stabilize);
}

template <typename TX, typename TY>
cudaError_t launch(unsigned blocks, cudaStream_t stream, const void* w,
                   const void* x, const void* y, void* w_out, int p, int q,
                   float t_max, float mu_capture, float mu_backoff,
                   float mu_search, float w_max, float eps, bool stabilize) {
  stdp_update_kernel<TX, TY><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(w), static_cast<const TX*>(x),
      static_cast<const TY*>(y), static_cast<float*>(w_out), p, q, t_max,
      mu_capture, mu_backoff, mu_search, w_max, eps, stabilize);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `x_int` / `y_int`: that time vector is int32 (else f32).
extern "C" int tnn_stdp_update(const void* w, const void* x, const void* y,
                               void* w_out, int p, int q, float t_max,
                               float mu_capture, float mu_backoff,
                               float mu_search, int w_max, int stabilize,
                               float eps, int x_int, int y_int,
                               void* stream) {
  const long long n = static_cast<long long>(p) * q;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  const float wm = static_cast<float>(w_max);
  const bool stab = stabilize != 0;
  cudaError_t err;
  if (x_int && y_int)
    err = launch<int, int>(blocks, s, w, x, y, w_out, p, q, t_max, mu_capture,
                           mu_backoff, mu_search, wm, eps, stab);
  else if (x_int)
    err = launch<int, float>(blocks, s, w, x, y, w_out, p, q, t_max,
                             mu_capture, mu_backoff, mu_search, wm, eps, stab);
  else if (y_int)
    err = launch<float, int>(blocks, s, w, x, y, w_out, p, q, t_max,
                             mu_capture, mu_backoff, mu_search, wm, eps, stab);
  else
    err = launch<float, float>(blocks, s, w, x, y, w_out, p, q, t_max,
                               mu_capture, mu_backoff, mu_search, wm, eps,
                               stab);
  return static_cast<int>(err);
}
