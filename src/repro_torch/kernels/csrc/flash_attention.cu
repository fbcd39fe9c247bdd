// Online-softmax (flash) attention with grouped KV heads:
// q [B, Sq, Hq, D], k, v [B, Skv, Hkv, D] -> out [B, Sq, Hq, D], in f32 or
// bf16, causal (kv index <= q index) or not.
//
// Replaces the TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention.py) behind flash_attention_pallas;
// the LM's attention (repro_torch/models/layers.py) launches it once per
// layer for every prefill and training-path forward on the card.
//
// It computes what the TPU kernel computes:
//  * q scaled by 1/sqrt(D) in f32 before the product;
//  * f32 scores, the causal mask, a running row max with the guard for
//    fully masked rows, f32 p and accumulator;
//  * out = acc / max(l, 1e-30), rounded to the input type.
// and differs in three places: q head h reads kv head h / (Hq / Hkv) (the
// grouping of layers._merge_gqa), so callers do not broadcast K and V; any
// Sq and Skv are taken, with rows past Sq not written and keys past Skv
// masked; and, causal, the key tiles past a query tile's last row are
// skipped.
//
// What bounds it on an H100: operations.  At the LM prefill shape
// (B 4, S 2048, Hq 32, D 128, causal) the two products are ~1.4e11
// operations against ~170 MB of Q, K, V and O.  This first kernel does
// them on the CUDA cores in f32, not on the tensor cores (wgmma and TMA
// are for a later PR), so it sits well above the bf16 bound.  Its design:
//  * one thread block per (64-row query tile, q head, batch); 256 threads
//    as a 16 x 16 grid, each owning 4 query rows (ty + 16 i) and, of the
//    score tile, 4 keys (tx + 16 j), of the output, D / 16 columns;
//  * the query tile, pre-scaled, stays in shared memory in f32; each
//    64-key tile of K and V is staged there in f32, and the probabilities
//    of the tile reuse K's space for the PV product;
//  * the row max and row sum are reduced over the 16 lanes that share a
//    row with warp shuffles; the running max, sum and the accumulator live
//    in registers;
//  * heavy (late, causal) query tiles are scheduled first.
// It allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = kBK + 4;   // row stride of the probability tile
static_assert(kBQ == kBK, "stage_tile stages kBQ rows of q, k and v");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [row0, row0 + 64) of one head of a [B, S, H, D] tensor into a
// shared f32 tile of row stride `ld`, times `scale`; rows at or past `rows`
// are zero.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, int b,
                                           int rows, int heads, int h,
                                           int row0, float scale, float* dst,
                                           int ld) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int k4 = (c - r * kChunks) * 4;
    const int row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) {
      v = load4(x + ((static_cast<size_t>(b) * rows + row) * heads + h) * D +
                k4);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * ld + k4) = v;
  }
}

// Reductions over the 16 lanes (tx) that share a query row.
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
__host__ __device__ constexpr int qk_stride() { return D + 4; }

template <int D>
__host__ __device__ constexpr int k_words() {
  return kBK * qk_stride<D>() > kBQ * kPS ? kBK * qk_stride<D>() : kBQ * kPS;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kBQ) * qk_stride<D>() + k_words<D>() +
          static_cast<size_t>(kBK) * D) * sizeof(float);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int sq, int skv, int hq,
    int hkv, bool causal, float scale) {
  constexpr int kLd = qk_stride<D>();
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];  // 16-byte aligned for float4 access
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ, kLd] scaled q
  float* ks = qs + kBQ * kLd;     // [kBK, kLd] key tile, then [kBQ, kPS] p
  float* vs = ks + k_words<D>();  // [kBK, D] value tile
  float* ps = ks;

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  stage_tile<D>(q, b, sq, hq, h, q0, scale, qs, kLd);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (skv + kBK - 1) / kBK;
  if (causal) {
    const int q_last = min(q0 + kBQ, sq) - 1;
    n_tiles = min(n_tiles, q_last / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's p and v are no longer read
    stage_tile<D>(k, b, skv, hkv, hk, k0, 1.f, ks, kLd);
    stage_tile<D>(v, b, skv, hkv, hk, k0, 1.f, vs, D);
    __syncthreads();

    // scores: s[i][j] = q[ty + 16 i] . k[tx + 16 j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLd + e);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + e);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update of each row
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < skv && (!causal || kj <= qi);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        sum += p[i][j];
      }
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * alpha + row_sum(sum);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();  // every score is read: p may take K's space
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPS + tx + 16 * j] = p[i][j];
    __syncthreads();

    // acc[i][c] += sum_j p[ty + 16 i][j] v[j][tx + 16 c]
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * D + tx;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float vv = vrow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = jj == 0 ? pa[i].x
                           : jj == 1 ? pa[i].y
                           : jj == 2 ? pa[i].z
                                     : pa[i].w;
            acc[i][c] = fmaf(pv, vv, acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * sq + qi) * hq + h) * D + tx;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(o + 16 * c, acc[i][c] * inv);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, bool causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, hq, hkv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int sq, int skv, int hq, int hkv, int d, bool causal,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<16, T>(q, k, v, out, b, sq, skv, hq, hkv, causal, scale,
                           stream);
    case 32:
      return launch<32, T>(q, k, v, out, b, sq, skv, hq, hkv, causal, scale,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, out, b, sq, skv, hq, hkv, causal, scale,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, out, b, sq, skv, hq, hkv, causal, scale,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  d in {16, 32, 64, 128}; hq a multiple of
// hkv; sq >= 1.  Launches on `stream`; returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported d or dtype).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int skv, int hq,
                               int hkv, int d, int causal, int dtype,
                               float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, sq, skv, hq, hkv, d, causal != 0,
                           scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, b, sq, skv, hq, hkv, d,
                                   causal != 0, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
