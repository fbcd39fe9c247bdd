// The Mamba2 layer's depthwise causal conv of width 4 (arXiv:2405.21060),
// with its bias and SiLU, in one pass:
//   u [B, L, C] (any batch and time strides, unit channel stride), an
//   optional state [B, 3, C] (the rows before u; zeros without one), the
//   taps w [4, C] and an optional bias [C]
//   -> out [B, L, C] = silu(conv(u) + bias) and new_state [B, 3, C], the
//   last three rows of concat(state, u),
// in bf16 or f32 (every tensor of one dtype).
//
// Replaces no TPU kernel: the JAX package's _causal_conv
// (src/repro/models/ssm.py) is jnp, with no pallas_call.  It was added for
// the LM prefill (repro_torch/models/ssm.py, _causal_conv, once per mamba
// layer): the plain version there makes ~23 passes over [B, L, C] a layer,
// most of them in f32 (two concatenations, a zero fill, four casts,
// products and adds, the bias, the SiLU, the cast back), ~33 GB of
// traffic a layer at B 8 x 4,032, C 7,424.
//
// It computes what the plain version (_causal_conv_plain) computes, bit
// for bit:
//  * acc = (((0 + u[t-3] w0) + u[t-2] w1) + u[t-1] w2) + u[t] w3 in f32,
//    u[t-k] from the state's rows where t - k < 0, each product and each
//    add rounded once (__fmul_rn, __fadd_rn: nothing is contracted into an
//    FMA; a product of two bf16 values is exact in f32), then + bias;
//  * SiLU as PyTorch's f32 silu computes it, x / (1 + expf(-x)), written
//    as ATen writes it and compiled under nvcc's default flags, as ATen
//    is (the card tests hold it to torch's silu on every finite f32);
//  * the result rounded to nearest even into the dtype.
//
// What bounds it on an H100: bytes.  At the zamba2-7b-instruct.docs4k
// prefill's shape (B 8 x 4,032, C 7,424, bf16) it reads u once (0.479 GB)
// and writes out once (0.479 GB): 0.958 GB, 0.286 ms at 3.35 TB/s.  Its
// ~30 instructions an output (the taps, the exact expf and division of
// the SiLU, the conversions) take nearly as long to execute, so it needs
// many warps in flight as well as wide accesses.  The design:
//  * a thread owns 8 bytes of channels (4 bf16 or 2 f32), loaded and
//    stored as one 8-byte access, neighbouring threads on neighbouring
//    channels, so a warp reads 256 contiguous bytes of a row; u is read
//    where it lies (the in_proj output's x | B | C columns, through the
//    row strides).  16-byte accesses (8 bf16 a thread) took 114-132
//    registers and ran at 0.47-0.49 ms against 0.37 ms for these (77
//    registers) on the card;
//  * it walks a run of kRun positions with the last three input rows in
//    registers, so each row is read once, plus a halo of three rows a run
//    (from the state, or zeros, before position 0); rows come kGroup at a
//    time, the next group's loads started before this group's outputs are
//    computed;
//  * its taps and bias live in registers, read once a thread;
//  * the thread whose run ends the sequence holds, in its window, the
//    last three rows of concat(state, u): it writes them as new_state.
// Rows whose channels do not start 8-byte aligned run the same code with
// one element a thread.
//
// It allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 4;
constexpr int kRun = 64;     // positions a thread walks
constexpr int kGroup = 4;    // rows loaded at once
constexpr int kThreads = 64;

// One launch's operands.  u's strides are in elements, its channel stride
// 1; state, w, bias, out and new_state are contiguous.
struct Args {
  const void* u;
  const void* state;  // null: zeros
  const void* w;
  const void* bias;   // null: no bias
  void* out;
  void* new_state;
  int len, channels;
  long long sub, sut;
};

// Storage types: bf16 as its 16 bits, f32 as itself.
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ void narrow(float v, uint16_t& o) {
  o = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void narrow(float v, float& o) { o = v; }

// The integer type of one access of a given size.
template <int Bytes> struct Word;
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<2> { using T = uint16_t; };

// V elements of type S, moved in one access.
template <typename S, int V>
union Pack {
  typename Word<sizeof(S) * V>::T raw;
  S v[V];
};

template <typename S, int V>
__device__ __forceinline__ Pack<S, V> load(const S* p) {
  Pack<S, V> k;
  k.raw = *reinterpret_cast<const decltype(k.raw)*>(p);
  return k;
}

template <typename S, int V>
__device__ __forceinline__ Pack<S, V> zeros() {
  Pack<S, V> k;
  k.raw = {};
  return k;
}

// PyTorch's f32 silu, as ATen writes it (ActivationSiluKernel.cu).
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// One output row from the inputs at t-3, t-2, t-1 and t.
template <typename S, int V>
__device__ __forceinline__ void emit(S* dst, const Pack<S, V>& m3, const Pack<S, V>& m2,
                                     const Pack<S, V>& m1, const Pack<S, V>& x,
                                     const float (&w)[kTaps][V], const float (&bias)[V],
                                     bool has_bias) {
  Pack<S, V> o;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float acc = __fadd_rn(0.0f, __fmul_rn(widen(m3.v[j]), w[0][j]));
    acc = __fadd_rn(acc, __fmul_rn(widen(m2.v[j]), w[1][j]));
    acc = __fadd_rn(acc, __fmul_rn(widen(m1.v[j]), w[2][j]));
    acc = __fadd_rn(acc, __fmul_rn(widen(x.v[j]), w[3][j]));
    if (has_bias) acc = __fadd_rn(acc, bias[j]);
    narrow(silu(acc), o.v[j]);
  }
  *reinterpret_cast<decltype(o.raw)*>(dst) = o.raw;
}

// grid (channel blocks, runs, batch); a thread: V channels over one run.
template <typename S, int V>
__global__ void __launch_bounds__(kThreads) conv_kernel(const Args a) {
  using P = Pack<S, V>;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= a.channels) return;
  const long long C = a.channels;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kRun;
  const int t_end = min(t0 + kRun, a.len);
  const S* u = static_cast<const S*>(a.u) + b * a.sub + c0;
  S* out = static_cast<S*>(a.out) + static_cast<long long>(b) * a.len * C + c0;

  float w[kTaps][V], bias[V];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const P p = load<S, V>(static_cast<const S*>(a.w) + k * C + c0);
#pragma unroll
    for (int j = 0; j < V; ++j) w[k][j] = widen(p.v[j]);
  }
  const bool has_bias = a.bias != nullptr;
  {
    const P p = has_bias ? load<S, V>(static_cast<const S*>(a.bias) + c0) : zeros<S, V>();
#pragma unroll
    for (int j = 0; j < V; ++j) bias[j] = widen(p.v[j]);
  }

  // the window: the inputs at t-3, t-2, t-1 of the next output row t
  P win[kTaps - 1];
#pragma unroll
  for (int i = 0; i < kTaps - 1; ++i) {
    const int t = t0 - (kTaps - 1) + i;
    if (t >= 0) {
      win[i] = load<S, V>(u + t * a.sut);
    } else if (a.state != nullptr) {
      win[i] = load<S, V>(static_cast<const S*>(a.state) + (b * (kTaps - 1) + kTaps - 1 + t) * C + c0);
    } else {
      win[i] = zeros<S, V>();
    }
  }

  int t = t0;
  P next[kGroup];
  if (t + kGroup <= t_end) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) next[i] = load<S, V>(u + (t + i) * a.sut);
  }
  for (; t + kGroup <= t_end; t += kGroup) {
    P r[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) r[i] = next[i];
    if (t + 2 * kGroup <= t_end) {  // the next group's loads, in flight meanwhile
#pragma unroll
      for (int i = 0; i < kGroup; ++i) next[i] = load<S, V>(u + (t + kGroup + i) * a.sut);
    }
    emit<S, V>(out + t * C, win[0], win[1], win[2], r[0], w, bias, has_bias);
    emit<S, V>(out + (t + 1) * C, win[1], win[2], r[0], r[1], w, bias, has_bias);
    emit<S, V>(out + (t + 2) * C, win[2], r[0], r[1], r[2], w, bias, has_bias);
    emit<S, V>(out + (t + 3) * C, r[0], r[1], r[2], r[3], w, bias, has_bias);
    win[0] = r[1];
    win[1] = r[2];
    win[2] = r[3];
  }
  for (; t < t_end; ++t) {
    const P r = load<S, V>(u + t * a.sut);
    emit<S, V>(out + t * C, win[0], win[1], win[2], r, w, bias, has_bias);
    win[0] = win[1];
    win[1] = win[2];
    win[2] = r;
  }
  if (t_end == a.len) {
    S* ns = static_cast<S*>(a.new_state) + b * (kTaps - 1) * C + c0;
#pragma unroll
    for (int i = 0; i < kTaps - 1; ++i)
      *reinterpret_cast<decltype(win[i].raw)*>(ns + i * C) = win[i].raw;
  }
}

template <typename S, int V>
int launch(const Args& a, int batch, cudaStream_t stream) {
  if (a.channels % V != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vectors = a.channels / V;
  const dim3 grid((vectors + kThreads - 1) / kThreads, (a.len + kRun - 1) / kRun, batch);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  conv_kernel<S, V><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (every tensor).  vec 1: 8-byte accesses
// (u's data and row strides, state, w and bias 8-byte aligned, channels a
// multiple of 8 bytes), 0: one element a thread.  batch, len and channels
// >= 1; len <= 65,535 x 64 and batch <= 65,535.  state and bias may be
// null.  Launches on `stream`; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it does not take).
extern "C" int causal_conv(const void* u, const void* state, const void* w,
                           const void* bias, void* out, void* new_state,
                           int batch, int len, int channels, long long sub,
                           long long sut, int dtype, int vec, void* stream) {
  if (batch < 1 || len < 1 || channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{u, state, w, bias, out, new_state, len, channels, sub, sut};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return vec ? launch<uint16_t, 4>(args, batch, st) : launch<uint16_t, 1>(args, batch, st);
  }
  if (dtype == 0) {
    return vec ? launch<float, 2>(args, batch, st) : launch<float, 1>(args, batch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
