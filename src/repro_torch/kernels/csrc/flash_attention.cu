// Online-softmax (flash) attention with grouped KV heads:
// q [B, Sq, Hq, D], k, v [B, Skv, Hkv, D] -> out [B, Sq, Hq, D], in bf16
// or f32, causal (kv index <= q index) or not; and MLA's split head dims,
// q, k at 192 and v, out at 128.
//
// Replaces the TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention.py) behind flash_attention_pallas;
// the LM's attention (repro_torch/models/layers.py) launches it once per
// layer for every prefill and training-path forward on the card.
//
// It computes what the TPU kernel computes: f32 scores, the causal mask,
// a running row max with the guard for fully masked rows, f32
// probabilities and accumulator, out = acc / max(l, 1e-30) rounded to the
// input type; and differs in three places: q head h reads kv head
// h / (Hq / Hkv) (the grouping of layers._merge_gqa), so callers do not
// broadcast K and V; any Sq and Skv are taken, with rows past Sq not
// written and keys past Skv masked; and, causal, the key tiles past a
// query tile's last row are skipped, heavy (late) query tiles first.
//
// What bounds it on an H100: operations.  At the LM prefill shape (B 4,
// S 2048, Hq 32, D 128, causal, bf16) the two products are ~1.4e11
// operations against ~170 MB of Q, K, V and O, so the tensor cores'
// bf16 rate (989 TFLOP/s) is the ceiling.  Two kernels:
//
// bf16 (tc::flash_kernel): both products on the tensor cores.
//  * one block per (128 query rows, q head, batch): two consumer
//    warpgroups of 64 rows each, and one producer warp;
//  * the producer warp loads the query tile and a four-stage ring of
//    64-key K and V tiles by TMA, each stage guarded by a full and an
//    empty mbarrier (161 KB of shared memory a block at D 128, so one
//    block an SM).  The tensor maps are over [B, S, H, D] as it lies
//    (rows Hkv * D * 2 bytes apart; q head h reads kv head
//    h / (Hq / Hkv)), in swizzled rows of at most 64 columns; the
//    ragged tails of Sq and Skv arrive zero-filled;
//  * S = Q K^T by wgmma from shared memory (K in its stored [key][d]
//    order is the K-major B operand), f32 accumulate, scaled by 1/sqrt(D)
//    after the product in f32 (rounding q * scale to bf16 first would
//    move scores of ~10 by ~0.02);
//  * mask, running max, expf, running sum in f32 registers, as in the
//    f32 kernel;
//  * O += P V by wgmma with P from registers (the S accumulator's
//    fragment is the A fragment of a k16 step) and V as the transposed
//    (MN-major) B operand.  P is split into P_hi = bf16(P) and
//    P_lo = bf16(P - P_hi), two wgmmas into one accumulator: a single
//    bf16 P (~2^-9 relative per probability) moves rows whose values
//    cancel by more than the bf16 rounding of the output, which is the
//    per-element bound the card check holds the kernel to.  The split
//    costs 1.5x the operations of the two products;
//  * O is written once, in bf16, with rows past Sq masked.
// Later work (FA3's): pingpong between the two warpgroups, and the
// softmax of one tile overlapped with the next tile's products.
//
// Head dim 112 (kimi-k2's and zamba2's) runs the D = 128 instantiation on
// tensor maps whose inner extent is 112 (flash_kernel<128, 112>): TMA
// fills columns 112-127 of each row's second 64-column box with zeros, in
// Q, K and V alike, so Q K^T is the 112-column product and columns
// 112-127 of O stay 0; the epilogue stores 112 columns, and the caller's
// scale is 1/sqrt(112).  No padded copy is made anywhere.  The price is
// 128/112 of the products' operations.  (The other design, a D = 112
// layout of seven 16-column slabs under the 32-byte swizzle with n112
// wgmmas, would save that 14% at the cost of a second swizzle layout.)
// The f32 kernel takes D = 112 as it is (seven 16-lane column groups).
//
// MLA's expanded prefill (DeepSeek-V3: Q and K at 192 = 128 + 64 rope
// dims, V and O at 128) runs its own instantiation,
// tc::flash_mla_kernel<192, 128>, of the same body: Q and K tiles of
// three 64-column boxes, V tiles and the accumulator of two (an m64n128
// P·V as at D 128), four K/V stages (209 KB of shared memory); V is read
// as it lies, with no padded copy.  The f32 kernel takes it as
// simt::flash_kernel<192, 128, float>.
//
// f32 (simt::flash_kernel): the two products in f32 on the CUDA cores
// (the card check holds f32 to one f32 rounding, which TF32 cannot
// meet): one block per (64-row query tile, q head, batch), 256 threads
// as a 16 x 16 grid; q pre-scaled in shared memory, 64-key K and V tiles
// staged in f32, the probabilities reusing K's space; row max and sum
// reduced over 16 lanes by shuffles.
//
// It allocates nothing and launches on the caller's stream.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace simt {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = kBK + 4;   // row stride of the probability tile
static_assert(kBQ == kBK, "stage_tile stages kBQ rows of q, k and v");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// Rows [row0, row0 + 64) of one head of a [B, R, H, D] tensor (R = `stride`
// rows a batch entry) into a shared f32 tile of row stride `ld`, times
// `scale`; rows at or past `rows` are zero.
template <int D, typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, int b,
                                           int rows, int stride, int heads,
                                           int h, int row0, float scale,
                                           float* dst, int ld) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int k4 = (c - r * kChunks) * 4;
    const int row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) {
      v = load4(x + ((static_cast<size_t>(b) * stride + row) * heads + h) * D +
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

template <int D, int DV>
__host__ __device__ constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kBQ) * qk_stride<D>() + k_words<D>() +
          static_cast<size_t>(kBK) * DV) * sizeof(float);
}

// D: Q's and K's head dim; DV: V's and O's.
template <int D, int DV, typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
    const int* __restrict__ skv_dev, int kv_rows, int hq, int hkv, bool causal,
    float scale) {
  if (skv_dev != nullptr) skv = *skv_dev;
  constexpr int kLd = qk_stride<D>();
  constexpr int kCols = DV / 16;  // output columns per thread
  extern __shared__ float4 smem4[];  // 16-byte aligned for float4 access
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ, kLd] scaled q
  float* ks = qs + kBQ * kLd;     // [kBK, kLd] key tile, then [kBQ, kPS] p
  float* vs = ks + k_words<D>();  // [kBK, DV] value tile
  float* ps = ks;

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  stage_tile<D>(q, b, sq, sq, hq, h, q0, scale, qs, kLd);

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
    stage_tile<D>(k, b, skv, kv_rows, hkv, hk, k0, 1.f, ks, kLd);
    stage_tile<DV>(v, b, skv, kv_rows, hkv, hk, k0, 1.f, vs, DV);
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
        const float* vrow = vs + (j + jj) * DV + tx;
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
    T* o = out + ((static_cast<size_t>(b) * sq + qi) * hq + h) * DV + tx;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(o + 16 * c, acc[i][c] * inv);
  }
}

template <int D, int DV, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, const int* skv_dev, int kv_rows, int hq, int hkv,
           bool causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, DV, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<D, DV, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, skv_dev,
      kv_rows, hq, hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

namespace tc {

constexpr int kBQ = 128;         // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kConsumers = 256;  // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;  // and the producer warp

// D: the tiles' head dim of Q and K; DV: of V and the accumulator (D
// but in MLA's 192 / 128 instantiation).
template <int D, int DV = D>
struct Shape {
  static constexpr int kCol = D < 64 ? D : 64;  // columns of a swizzled row
  static constexpr int kRow = 2 * kCol;  // its bytes: 32, 64 or 128, the
                                         // swizzle span
  static constexpr int kChunks = D / kCol;    // of a Q or K row
  static constexpr int kVChunks = DV / kCol;  // of a V row
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;    // one K tile
  static constexpr int kVTileBytes = kBK * DV * 2;  // one V tile
  // the wgmma descriptor's layout type of that swizzle
  static constexpr int kLayout = kRow == 128 ? 1 : kRow == 64 ? 2 : 3;
  // 1024: the alignment slack of the swizzled tiles; then the mbarriers
  static constexpr size_t smem(int stages) {
    return 1024 + kQBytes + static_cast<size_t>(stages) * (kTileBytes + kVTileBytes) +
           (1 + 2 * stages) * 8;
  }
  // depth of the K/V ring: four stages where they fit, else two (at D 256
  // four would need 257 KB of shared memory, over the 227 KB a block may
  // use; at 192 / 128 four take 209 KB)
  static constexpr int kStages = smem(4) <= 232448 ? 4 : 2;
  static constexpr size_t kSmem = smem(kStages);
  static_assert(kSmem <= 232448, "a block may use 227 KB of shared memory");
  static_assert(DV % kCol == 0, "V's rows are whole swizzled rows");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.  A wait
// of ~2^35 cycles (well over ten seconds) means a load was lost: the
// launch faults instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 35)) __trap();
  }
}

// One TMA box of a 4-d tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle layout type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching accumulator registers across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, A and B K-major in shared
// memory (descriptors); the accumulator is zeroed first where !accumulate.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)));
}

// D[64 x 16] += A[64 x 16] B[16 x 16], A in registers (four bf16x2
// per thread, the accumulator's fragment order), B MN-major in shared
// memory (transposed: tnspB = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[8], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A in registers (four bf16x2
// per thread, the accumulator's fragment order), B MN-major in shared
// memory (transposed: tnspB = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (four bf16x2
// per thread, the accumulator's fragment order), B MN-major in shared
// memory (transposed: tnspB = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (four bf16x2
// per thread, the accumulator's fragment order), B MN-major in shared
// memory (transposed: tnspB = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A in registers (four bf16x2
// per thread, the accumulator's fragment order), B MN-major in shared
// memory (transposed: tnspB = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tile's head dim for a stored head dim DS: 112 runs in the D = 128
// tiles, 224 in the D = 256 ones (see the header).
template <int DS>
constexpr int tile_dim() { return DS == 112 ? 128 : DS == 224 ? 256 : DS; }

// Accumulator fragment of wgmma m64nN (f32), thread l of warp w of the
// warpgroup: element i sits at row 16 w + l / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (l % 4) + i % 2.  The A fragment of a k16 step in
// registers has the same order over that step's 16 columns.
// D is Q's and K's tile head dim, DS <= D the tensors' own (their row
// stride); TMA zero-fills the tiles' columns DS..D-1.  DV and DVS <= DV
// are V's and O's (D and DS but in MLA's instantiation).  The body of
// both kernels below.
template <int D, int DS, int DV, int DVS>
__device__ __forceinline__ void flash_body(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    __nv_bfloat16* __restrict__ out, int sq, int skv,
    const int* __restrict__ skv_dev, int hq, int hkv, bool causal,
    float scale) {
  if (skv_dev != nullptr) skv = *skv_dev;
  using S = Shape<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes of shared address: align to it
  uint8_t* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + S::kQBytes;              // [S::kStages] K tiles
  uint8_t* vs = ks + S::kStages * S::kTileBytes;  // [S::kStages] V tiles
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(vs + S::kStages * S::kVTileBytes);
  uint64_t* full = q_full + 1;     // [S::kStages] the stage has landed
  uint64_t* empty = full + S::kStages;  // [S::kStages] the stage is read

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  int n_tiles = (skv + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, sq) - 1) / kBK + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one lane loads
    if (lane == 0) {
      const int hk = h / (hq / hkv);
      mbar_expect_tx(q_full, S::kQBytes);
      for (int c = 0; c < S::kChunks; ++c)
        tma_load(qs + c * kBQ * S::kRow, tm_q, q_full, c * S::kCol, h, q0,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S::kStages;
        mbar_wait(&empty[s], ((t / S::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], S::kTileBytes + S::kVTileBytes);
        constexpr int kMost = S::kChunks > S::kVChunks ? S::kChunks : S::kVChunks;
        for (int c = 0; c < kMost; ++c) {
          if (c < S::kChunks)
            tma_load(ks + s * S::kTileBytes + c * kBK * S::kRow, tm_k,
                     &full[s], c * S::kCol, hk, t * kBK, b);
          if (c < S::kVChunks)
            tma_load(vs + s * S::kVTileBytes + c * kBK * S::kRow, tm_v,
                     &full[s], c * S::kCol, hk, t * kBK, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [first, first + 64) of the block
  const int wg = warp / 4;
  const int first = q0 + wg * 64;
  const int last = min(first + 63, sq - 1);  // < first: no rows to compute
  const int row0 = first + (warp % 4) * 16 + lane / 4;  // and row0 + 8
  const int col = 2 * (lane % 4);
  const uint32_t q_base = smem_addr(qs) + wg * 64 * S::kRow;
  const uint32_t k_base = smem_addr(ks);
  const uint32_t v_base = smem_addr(vs);

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S::kStages;
    const int k0 = t * kBK;
    // Every consumer waits for every tile, the ones it skips too: a
    // warpgroup that arrived on `empty` ahead of the loads would complete
    // a stage's next phase before the other warpgroup has read it.
    mbar_wait(&full[s], (t / S::kStages) & 1);
    // uniform over the warpgroup, as wgmma needs
    if (first <= last && (!causal || k0 <= last)) {
      // S = Q K^T over DS / 16 k16 steps (the columns past DS are zeros)
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk) {
        const int c = kk * 16 / S::kCol;
        const int off = (kk * 16 % S::kCol) * 2;
        wgmma_ss(sc,
                 desc(q_base + c * kBQ * S::kRow + off, 16, 8 * S::kRow,
                      S::kLayout),
                 desc(k_base + s * S::kTileBytes + c * kBK * S::kRow + off,
                      16, 8 * S::kRow, S::kLayout),
                 kk > 0);
      }
      wgmma_commit_wait();
      reg_fence(sc);

      // scale, mask, then the online-softmax update of the two rows
      const bool edge = (causal && k0 + kBK - 1 > first) || k0 + kBK > skv;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] *= scale;
        if (edge) {
          const int key = k0 + 8 * (i / 4) + col + i % 2;
          const int row = row0 + 8 * ((i / 2) % 2);
          if (key >= skv || (causal && key > row)) sc[i] = -INFINITY;
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * r + e];
            x = x == -INFINITY ? 0.f : expf(x - m_safe);
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        alpha[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe);
        l[r] = l[r] * alpha[r] + sum;
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // P = P_hi + P_lo in bf16, as A fragments: register 4 kk + r of a
      // k16 step kk holds p[8 kk + 2 r], p[8 kk + 2 r + 1]
      uint32_t p_hi[16], p_lo[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(sc[2 * r], sc[2 * r + 1]);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[r] = bits(hi);
        p_lo[r] = bits(__floats2bfloat162_rn(sc[2 * r] - hf.x,
                                             sc[2 * r + 1] - hf.y));
      }

      // O += P_hi V + P_lo V over the tile's four k16 steps
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t vd =
            desc(v_base + s * S::kVTileBytes + kk * 16 * S::kRow,
                 kBK * S::kRow, 8 * S::kRow, S::kLayout);
        wgmma_rs(o, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                 p_hi[4 * kk + 3], vd);
        wgmma_rs(o, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                 p_lo[4 * kk + 3], vd);
      }
      wgmma_commit_wait();
      reg_fence(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with s
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* o_row =
        out + ((static_cast<size_t>(b) * sq + row) * hq + h) * DVS + col;
#pragma unroll
    for (int j = 0; j < DVS / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
  }
}

// One head dim for Q, K and V: D the tiles', DS the tensors'.
template <int D, int DS>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    int sq, int skv, const int* __restrict__ skv_dev, int hq, int hkv,
    bool causal, float scale) {
  flash_body<D, DS, D, DS>(&tm_q, &tm_k, &tm_v, out, sq, skv, skv_dev, hq,
                           hkv, causal, scale);
}

// MLA's expanded prefill: Q and K at DQK, V and O at DV (192 and 128).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1) flash_mla_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    int sq, int skv, const int* __restrict__ skv_dev, int hq, int hkv,
    bool causal, float scale) {
  flash_body<DQK, DQK, DV, DV>(&tm_q, &tm_k, &tm_v, out, sq, skv, skv_dev, hq,
                               hkv, causal, scale);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query so that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one [batch, rows, heads, DS] bf16 tensor, as it lies,
// in boxes of box_rows rows of one head and Shape<D>::kCol columns (those
// at or past DS read as zeros).
template <int D, int DS>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch,
            int rows, int heads, int box_rows) {
  using S = Shape<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DS),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = 2ull * DS * heads;
  const cuuint64_t strides[3] = {2ull * DS, row_bytes, row_bytes * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(S::kCol), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      S::kRow == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : S::kRow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// DS: Q's and K's head dim, DVS V's and O's (DS, or MLA's 128 beside 192);
// the kernel runs in tiles of tile_dim<DS>() (and DVS for V).  K and V are
// the leading skv of kv_rows rows a batch entry.
template <int DS, int DVS = DS>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, const int* skv_dev, int kv_rows, int hq, int hkv,
           bool causal, float scale, cudaStream_t stream) {
  constexpr int D = tile_dim<DS>();
  constexpr int DV = DVS == DS ? D : DVS;
  if (skv == 0)  // no key: acc / max(l, 1e-30) is 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, 2ull * b * sq * hq * DVS, stream));
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode<D, DS>(fn, &tq, q, b, sq, hq, kBQ) ||
      !encode<D, DS>(fn, &tk, k, b, kv_rows, hkv, kBK) ||
      !encode<DV, DVS>(fn, &tv, v, b, kv_rows, hkv, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Shape<D, DV>::kSmem;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  cudaError_t err;
  if constexpr (DVS == DS) {
    err = cudaFuncSetAttribute(flash_kernel<D, DS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_kernel<D, DS><<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), sq, skv, skv_dev, hq,
        hkv, causal, scale);
  } else {
    err = cudaFuncSetAttribute(flash_mla_kernel<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_mla_kernel<D, DV><<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), sq, skv, skv_dev, hq,
        hkv, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

namespace {

// d in HEAD_DIMS; cudaErrorInvalidValue for another.
template <typename F>
int by_head_dim(int d, F&& f) {
  switch (d) {
    case 16:
      return f(std::integral_constant<int, 16>());
    case 32:
      return f(std::integral_constant<int, 32>());
    case 64:
      return f(std::integral_constant<int, 64>());
    case 112:
      return f(std::integral_constant<int, 112>());
    case 128:
      return f(std::integral_constant<int, 128>());
    case 224:
      return f(std::integral_constant<int, 224>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  d == dv in {16, 32, 64, 112, 128, 224},
// or d 192 and dv 128 (q and k at d, v and out at dv: MLA's expanded
// prefill, tc::flash_mla_kernel<192, 128>); hq a
// multiple of hkv; sq >= 1; q, k, v 16-byte aligned; K and V the leading
// skv of kv_rows >= skv rows a batch entry.  With `skv_dev` non-null the
// kernel reads skv from that device int instead (1 <= *skv_dev <= kv_rows;
// a decode step under a CUDA graph: the filled rows of its cache), and
// `skv` is only the host's bound.  Launches on `stream`; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported d or dtype, or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int skv,
                               const int* skv_dev, int kv_rows, int hq,
                               int hkv, int d, int dv, int causal, int dtype,
                               float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (d != dv) {
    if (d != 192 || dv != 128) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
      return simt::launch<192, 128, float>(q, k, v, out, b, sq, skv, skv_dev,
                                           kv_rows, hq, hkv, c, scale, st);
    if (dtype == 1)
      return tc::launch<192, 128>(q, k, v, out, b, sq, skv, skv_dev, kv_rows,
                                  hq, hkv, c, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0)
    return by_head_dim(d, [&](auto dim) {
      constexpr int kD = decltype(dim)::value;
      return simt::launch<kD, kD, float>(
          q, k, v, out, b, sq, skv, skv_dev, kv_rows, hq, hkv, c, scale, st);
    });
  if (dtype == 1)
    return by_head_dim(d, [&](auto dim) {
      return tc::launch<decltype(dim)::value>(q, k, v, out, b, sq, skv,
                                              skv_dev, kv_rows, hq, hkv, c,
                                              scale, st);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}
