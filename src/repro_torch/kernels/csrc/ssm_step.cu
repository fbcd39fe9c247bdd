// The Mamba2 mixer's decode step (arXiv:2405.21060): one token of a layer
// from its in_proj output to the input of its out_proj, in two launches:
//   proj [B, 1, Di + C + H] (z | x B C | dt, C = Di + 2 G N, Di = H dh; any
//   batch stride, unit column stride), the layer's conv state [B, 3, C]
//   and SSM state S [B, H, N, dh] (f32), the conv's taps [4, C] and
//   optional bias [C], dt_bias, A_log and D [H] (f32), the norm's gamma [Di]
//   -> y [B, Di] (the gated norm's output, in the model's dtype), the new
//   conv state [B, 3, C] and the new S [B, H, N, dh],
// in bf16 or f32 (proj, the conv state, the taps, the bias, gamma and y
// of one dtype).  The states passed in are read and never written: the
// new ones go to the caller's fresh tensors.
//
// Replaces no TPU kernel: the JAX package runs a decode token as a jnp
// chunk of one token (src/repro/models/ssm.py), with no pallas_call.  It
// was added for the LM decode step (repro_torch/models/ssm.py,
// _one_token, once a mamba layer a step), whose plain version makes ~40
// launches a layer (the conv window's concatenation, casts, products and
// sum, the step sizes, the decay, the state's update, a permuted copy of
// S for the contraction, the skip, the gated norm's ~11 passes) and
// passes the f32 state through device memory ~7 times.
//
// Launch 1, ssm_step_kernel: one block a (head, batch entry).
//  * The conv step for the channels the head reads: its dh channels of x
//    and its group's N of B and N of C (every head of a group computes
//    the group's B and C itself, so no block waits for another), each
//    acc = ((((0 + p0) + p1) + p2) + p3) + bias in f32, p_k = window_k w_k,
//    each product and add rounded once (__fmul_rn, __fadd_rn: nothing is
//    contracted into an FMA), the order of the plain version's sum over
//    the window; then PyTorch's f32 SiLU (x / (1 + expf(-x)), compiled
//    under nvcc's default flags, as ATen is) and the rounding to the dtype.
//    The block writes the new conv state of its x channels; the group's
//    first head writes its B and C channels.
//  * The step size, as ATen computes softplus(dt + dt_bias) =
//    logaddexp(v, 0) = max(v, 0) + log1pf(expf(-|v|)), clamped below at
//    dt_min where that is set; A = -expf(A_log); decay = expf(dt A).
//  * S' = fma(B, x dt, S decay): S decay and x dt each rounded once, then
//    B (x dt) + S decay rounded once, as the plain version's mul and
//    addcmul (ATen's addcmul is one FMA on the card, as on the CPU); S'
//    written once.
//  * y = C . S' in f32 in the kernel's own order (each thread sums its
//    rows, then the row groups in order), + D x, rounded to the dtype;
//    then u = y silu(z) in f32 ('grouped' norm) or rounded to the dtype
//    with silu(z) rounded first ('rmsnorm' norm, the JAX package's), kept
//    in an f32 workspace, and the head's sum of the squares u^2 (each
//    square rounded, as the plain version's g * g).
// Launch 2, ssm_step_norm_kernel: one block a (head, batch entry).  It
// sums its norm group's head sums in a fixed order (every block of the
// group gets the same bits), mean = sum * (1 / n), r = rsqrtf(mean +
// eps), and writes y = dtype(dtype(u r) * gamma), the plain version's
// roundings.  The mean's order is the kernel's own.
//
// What bounds it on an H100: bytes.  S is read once and S' written once
// (at the zamba2-7b-instruct.docs4k cell's B 8, H 112, N 64, dh 64: 14.7
// MB each way, 8.8 us at 3.35 TB/s; at granite-4.0-h-small.rag2k's H 128,
// N 128: 33.5 MB each way, 20 us); the window, z, the weights and y are a
// few hundred KB.  A thread moves 16 bytes of S an access (four columns
// of a row), neighbouring threads on neighbouring columns, and walks the
// rows of its row group with the next loads in flight.
//
// It allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // ssm_step_kernel
constexpr int kNormThreads = 64;   // ssm_step_norm_kernel

// One call's operands.  proj's row stride is in elements; every other
// tensor is contiguous.
struct Args {
  const void* proj;
  const void* conv;      // [B, 3, C]
  const float* S;        // [B, H, N, dh]
  const void* conv_w;    // [4, C]
  const void* conv_b;    // [C], null: no bias
  const float* dt_bias;  // [H]
  const float* A_log;    // [H]
  const float* D;        // [H]
  const void* gamma;     // [Di]
  void* y;               // [B, Di]
  void* new_conv;        // [B, 3, C]
  float* new_S;          // [B, H, N, dh]
  float* u;              // [B, Di]: the norm's input, in f32
  float* ss;             // [B, H]: each head's sum of u^2
  long long proj_stride;
  int heads, groups, state, head_dim;
  int clamp;             // 1: softplus(dt) clamped below at dt_min
  float dt_min;
  int norm_groups;       // the norm's groups: G ('grouped') or 1 ('rmsnorm')
  int rms_form;          // 1: 'rmsnorm' (u rounded to the dtype)
  float eps;
};

// Storage types: bf16 as its 16 bits, f32 as itself.
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ uint16_t narrow(float v, uint16_t) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float narrow(float v, float) { return v; }
// v rounded to the storage type S, and back to f32
template <typename S>
__device__ __forceinline__ float round_to(float v) {
  return widen(narrow(v, S()));
}

// PyTorch's f32 silu, as ATen writes it (ActivationSiluKernel.cu).
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// PyTorch's logaddexp(v, 0) in f32 (BinaryMiscOpsKernels.cu): the
// infinite branch (a == b == inf) cannot be taken with b = 0.
__device__ __forceinline__ float softplus(float v) {
  const float m = fmaxf(v, 0.0f);
  return m + log1pf(expf(-fabsf(v - 0.0f)));
}

template <typename S>
__global__ void __launch_bounds__(kThreads) ssm_step_kernel(const Args a) {
  extern __shared__ float smem[];
  __shared__ float step[2];  // dt, decay
  __shared__ float warp_ss[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int H = a.heads, G = a.groups, N = a.state, dh = a.head_dim;
  const int hg = H / G, g = h / hg, di = H * dh, C = di + 2 * G * N;
  float* xs = smem;       // [dh]: x, rounded to the dtype
  float* bs = xs + dh;    // [N]: the group's B
  float* cs = bs + N;     // [N]: the group's C
  float* part = cs + N;   // [row groups][dh]: partial sums of C . S'

  const S* proj = static_cast<const S*>(a.proj) + b * a.proj_stride;
  const S* xbc = proj + di;
  const S* old = static_cast<const S*>(a.conv) + static_cast<long long>(b) * 3 * C;
  S* fresh = static_cast<S*>(a.new_conv) + static_cast<long long>(b) * 3 * C;
  const S* w = static_cast<const S*>(a.conv_w);
  const S* bias = static_cast<const S*>(a.conv_b);

  // the conv step over the head's channels
  for (int i = t; i < dh + 2 * N; i += kThreads) {
    int ch;
    float* dst;
    if (i < dh) {
      ch = h * dh + i;
      dst = xs + i;
    } else if (i < dh + N) {
      ch = di + g * N + (i - dh);
      dst = bs + (i - dh);
    } else {
      ch = di + G * N + g * N + (i - dh - N);
      dst = cs + (i - dh - N);
    }
    const S r0 = old[ch], r1 = old[C + ch], r2 = old[2 * C + ch], r3 = xbc[ch];
    float acc = __fadd_rn(0.0f, __fmul_rn(widen(r0), widen(w[ch])));
    acc = __fadd_rn(acc, __fmul_rn(widen(r1), widen(w[C + ch])));
    acc = __fadd_rn(acc, __fmul_rn(widen(r2), widen(w[2 * C + ch])));
    acc = __fadd_rn(acc, __fmul_rn(widen(r3), widen(w[3 * C + ch])));
    if (bias != nullptr) acc = __fadd_rn(acc, widen(bias[ch]));
    *dst = round_to<S>(silu(acc));
    if (i < dh || h % hg == 0) {
      fresh[ch] = r1;
      fresh[C + ch] = r2;
      fresh[2 * C + ch] = r3;
    }
  }
  if (t == 0) {
    float dt = softplus(__fadd_rn(widen(proj[di + C + h]), a.dt_bias[h]));
    if (a.clamp) dt = fmaxf(dt, a.dt_min);
    const float A = -expf(a.A_log[h]);
    step[0] = dt;
    step[1] = expf(__fmul_rn(dt, A));
  }
  __syncthreads();

  // S' = S decay + B (x dt); a thread: four columns of every rgs-th row
  const int c4 = dh / 4, rgs = kThreads / c4;
  const int col = t % c4, rg = t / c4;
  if (rg < rgs) {
    const float dt = step[0], decay = step[1];
    float xdt[4], acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) xdt[j] = __fmul_rn(xs[4 * col + j], dt);
    const long long head = (static_cast<long long>(b) * H + h) * N * dh;
    const float4* src = reinterpret_cast<const float4*>(a.S + head) + col;
    float4* dst = reinterpret_cast<float4*>(a.new_S + head) + col;
#pragma unroll 4
    for (int n = rg; n < N; n += rgs) {
      float4 s = src[n * c4];
      const float bn = bs[n], cn = cs[n];
      s.x = __fmaf_rn(bn, xdt[0], __fmul_rn(s.x, decay));
      s.y = __fmaf_rn(bn, xdt[1], __fmul_rn(s.y, decay));
      s.z = __fmaf_rn(bn, xdt[2], __fmul_rn(s.z, decay));
      s.w = __fmaf_rn(bn, xdt[3], __fmul_rn(s.w, decay));
      dst[n * c4] = s;
      acc[0] = __fadd_rn(acc[0], __fmul_rn(cn, s.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(cn, s.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(cn, s.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(cn, s.w));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) part[rg * dh + 4 * col + j] = acc[j];
  }
  __syncthreads();

  // y = the row groups' sums in order + D x, then the norm's input u
  float sq = 0.0f;
  for (int d = t; d < dh; d += kThreads) {
    float y = 0.0f;
    for (int r = 0; r < rgs; ++r) y = __fadd_rn(y, part[r * dh + d]);
    y = round_to<S>(__fadd_rn(y, __fmul_rn(a.D[h], xs[d])));
    const float gate = silu(widen(proj[h * dh + d]));
    const float u = a.rms_form ? round_to<S>(__fmul_rn(y, round_to<S>(gate)))
                               : __fmul_rn(y, gate);
    a.u[static_cast<long long>(b) * di + h * dh + d] = u;
    sq = __fadd_rn(sq, __fmul_rn(u, u));
  }
  // the head's sum of squares: each warp's, then the warps' in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, off));
  if ((t & 31) == 0) warp_ss[t >> 5] = sq;
  __syncthreads();
  if (t == 0) {
    float total = 0.0f;
    for (int k = 0; k < kThreads / 32; ++k) total = __fadd_rn(total, warp_ss[k]);
    a.ss[b * H + h] = total;
  }
}

template <typename S>
__global__ void __launch_bounds__(kNormThreads) ssm_step_norm_kernel(const Args a) {
  __shared__ float scale;
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int H = a.heads, dh = a.head_dim, di = H * dh;
  const int hn = H / a.norm_groups, first = (h / hn) * hn;
  if (t < 32) {  // the group's head sums: lane l takes l, l + 32, ..., then a tree
    float s = 0.0f;
    for (int k = t; k < hn; k += 32) s = __fadd_rn(s, a.ss[b * H + first + k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (t == 0) {
      const float mean = __fmul_rn(s, 1.0f / static_cast<float>(hn * dh));
      scale = rsqrtf(__fadd_rn(mean, a.eps));
    }
  }
  __syncthreads();
  const float r = scale;
  const S* gamma = static_cast<const S*>(a.gamma);
  S* y = static_cast<S*>(a.y) + static_cast<long long>(b) * di;
  for (int d = t; d < dh; d += kNormThreads) {
    const int i = h * dh + d;
    const float o = round_to<S>(__fmul_rn(a.u[static_cast<long long>(b) * di + i], r));
    y[i] = narrow(__fmul_rn(o, widen(gamma[i])), S());
  }
}

template <typename S>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int c4 = a.head_dim / 4;
  const size_t smem = sizeof(float) *
      (a.head_dim + 2 * static_cast<size_t>(a.state) + (kThreads / c4) * a.head_dim);
  const dim3 grid(a.heads, batch);
  ssm_step_kernel<S><<<grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_step_norm_kernel<S><<<grid, kNormThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (proj, conv, conv_w, conv_b, gamma, y,
// new_conv).  heads a multiple of groups and of norm_groups; head_dim a
// multiple of 4, at most 4 x kThreads; batch <= 65,535; S and new_S
// 16-byte aligned; conv_b may be null.  Launches on `stream`; returns
// the first non-zero cudaGetLastError() of the two launches
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int ssm_step(const void* proj, const void* conv, const float* S,
                        const void* conv_w, const void* conv_b, const float* dt_bias,
                        const float* A_log, const float* D, const void* gamma, void* y,
                        void* new_conv, float* new_S, float* u, float* ss, int batch,
                        long long proj_stride, int heads, int groups, int state,
                        int head_dim, int clamp, float dt_min, int norm_groups,
                        int rms_form, float eps, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || groups < 1 || heads % groups != 0 ||
      norm_groups < 1 || heads % norm_groups != 0 || state < 1 || head_dim < 4 ||
      head_dim % 4 != 0 || head_dim > 4 * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{proj, conv, S, conv_w, conv_b, dt_bias, A_log, D, gamma, y, new_conv,
                  new_S, u, ss, proj_stride, heads, groups, state, head_dim, clamp,
                  dt_min, norm_groups, rms_form, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<uint16_t>(args, batch, st);
  if (dtype == 0) return launch<float>(args, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
