// The Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060) of
// one layer in one launch:
//   x [B, L, H, DH], dt [B, L, H] f32, A [H] f32, B and C [B, L, G, N],
//   an optional initial state [B, H, N, DH] f32
//   -> y [B, L, H, DH] f32 and the final state [B, H, N, DH] f32,
// in bf16 or f32 (x, B and C of one dtype).  Head h reads group
// h / (H / G)'s B and C.
//
// Replaces no TPU kernel: the JAX package's ssd_chunked
// (src/repro/models/ssm.py) is jnp, with no pallas_call.  It was added for
// the LM prefill (repro_torch/models/ssm.py, ssd_chunked, once per mamba
// layer): the plain version there writes the [B, nc, H, q, q] decay mask
// to device memory in f32 (3.8 GB a layer at B 8 x 4,032, H 112, chunk
// 256) and passes over it and over [B, L, H, DH] copies a dozen times.
//
// It computes what the plain version (ssd_chunked_plain) computes, with
// every one of its roundings and no other; only the order of f32 sums
// differs:
//  * per chunk of q positions, cs = the cumulative sum of dt * A, left to
//    right from 0 with one f32 rounding per product and per add (the
//    sequential scan torch.cumsum runs along a non-innermost dimension
//    on CUDA), so the decays exp(cs_i - cs_j), exp(cs_last - cs_t),
//    exp(cs_last) and exp(cs_i) are the plain version's own;
//  * bf16: y_intra[i] = sum_{j <= i} (bf16(exp(cs_i - cs_j)) *
//    bf16(C_i . B_j)) * bf16(x_j dt_j), the score C_i . B_j summed in f32
//    and rounded to bf16 as the einsum's output is; the product of the two
//    bf16 values is exact in f32 and goes to the tensor cores as two bf16
//    parts, hi = bf16(p) and lo = p - hi (exact: p has 16 significant
//    bits), never as one;
//  * the state: S_c = S_{c-1} exp(cs_last) + sum_t B_t^T (x_t dt_t
//    exp(cs_last - cs_t)), in f32 (the weighted input is the f32 product,
//    not its bf16 rounding); y_inter[i] = (C_i . S_{c-1}) exp(cs_i); and
//    y = y_intra + y_inter.  The tensor cores take the f32 factors as
//    three bf16 parts, hi + mid + lo, which is exact (8 + 8 + 8 bits);
//  * f32: the same arithmetic with nothing rounded to bf16, in f32 FMAs on
//    the CUDA cores.
// Positions past L (the ragged last chunk) and the rows of a chunk tile
// past q are zeros, with dt 0, as the plain version's zero pad is: they
// leave the state unchanged.
//
// What bounds it on an H100: bytes.  At the cell's shape (B 8 x 4,032 ->
// 16 chunks of 256, H 112, G 2, N 64, DH 64) one launch reads x once
// (0.46 GB in bf16), B, C and dt, and writes y in f32 (0.92 GB) and the
// final state: ~1.45 GB, 0.43 ms at 3.35 TB/s, against ~1.8e11 operations
// with the causal half skipped (0.18 ms at the bf16 tensor-core rate).
// The design keeps everything of size [q, q] in registers:
//  * one block (8 warps) per (head, batch entry) walks the chunks in
//    order, the state carried in the registers of the warps that update
//    it and as three bf16 planes in shared memory for the next chunk's
//    y_inter; nothing but y and the final state is written;
//  * a chunk's x, B, C (in place, through their strides: the conv
//    output's split views) and dt are brought into shared memory by
//    cp.async, rows padded by 16 bytes so ldmatrix reads are free of bank
//    conflicts;
//  * each warp takes 16-row tiles of the chunk (tile k and its mirror, so
//    the causal work is even), the C fragments held in registers: the
//    scores of a 16 x 16 key tile by mma.sync m16n8k16, the mask and the
//    hi/lo split in registers, then the product with bf16(x dt) into the
//    tile's f32 accumulators; key tiles above the diagonal are skipped;
//  * then warp w updates the state's columns 8w..8w+7 over all N rows:
//    B^T (ldmatrix.trans) against the weighted input, which each lane
//    forms and splits in registers from x, dt and the decay.
// The bf16 kernel takes 179 KB of shared memory at chunk 256 (one block
// an SM) and 103 KB at chunk 128 (two).  Where that plan passes the 227 KB
// a block may have (N 128 at chunk 256: 266 KB), C stays out of shared
// memory: each warp reads its row tile's C fragments from device memory
// straight into registers (they are read nowhere else), and the tile
// takes 198 KB; the arithmetic is the same.  Later work: the next chunk's
// loads and cumulative sum overlapped with this chunk's products.
//
// It allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// the shared memory a block may opt in to on sm_90 (227 KB)
constexpr size_t kMaxSmem = 232448;

// One launch's operands.  Strides are in elements; x, B and C have unit
// innermost strides.
struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const float* s0;  // null: a zero initial state
  float* y;
  float* s_out;
  int len, heads, groups, q;
  long long sxb, sxl, sxh;
  long long sdb, sdl, sdh;
  long long sbb, sbl, sbg;
  long long scb, scl, scg;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// The chunk's prefix: a thread each of rows [0, Q) reads cs (written by
// thread 0 before the barrier that precedes this) and sets the decays.
template <int Q>
__device__ __forceinline__ void decays(const float* cs, float* dec,
                                       float* ecs) {
  const float last = cs[Q - 1];
  for (int r = threadIdx.x; r < Q; r += kThreads) {
    dec[r] = expf(__fsub_rn(last, cs[r]));
    ecs[r] = expf(cs[r]);
  }
}

// cs[r] = sum_{t <= r} dt_t * A, left to right from 0 (torch.cumsum's
// order on CUDA along a non-innermost dimension).
template <int Q>
__device__ __forceinline__ void cumulative_log_decay(const float* dts, float a,
                                                     float* cs) {
  float acc = 0.f;
  for (int r = 0; r < Q; ++r) {
    acc = __fadd_rn(acc, __fmul_rn(dts[r], a));
    cs[r] = acc;
  }
}

}  // namespace

namespace tc {

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 (round to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// v = hi + lo exactly, for v with at most 16 significant bits.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack(v0, v1);
  const float2 h = unpack(hi);
  lo = pack(__fsub_rn(v0, h.x), __fsub_rn(v1, h.y));
}

// v = hi + mid + lo exactly, for any finite f32 v.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack(v0, v1);
  const float2 h = unpack(hi);
  const float r0 = __fsub_rn(v0, h.x), r1 = __fsub_rn(v1, h.y);
  mid = pack(r0, r1);
  const float2 m = unpack(mid);
  lo = pack(__fsub_rn(r0, m.x), __fsub_rn(r1, m.y));
}

// bf16(exp(cs_i - cs_j)) * bf16(score) for j <= i (exact in f32), else 0.
__device__ __forceinline__ float masked(float score, float cs_i, float cs_j,
                                        bool keep) {
  if (!keep) return 0.f;
  const float m =
      __bfloat162float(__float2bfloat16_rn(expf(__fsub_rn(cs_i, cs_j))));
  return __fmul_rn(m, __bfloat162float(__float2bfloat16_rn(score)));
}

template <int N, int DH, int Q>
struct Shape {
  static constexpr int NP = N < 16 ? 16 : N;  // N zero-padded to the mma depth
  static constexpr int LN = NP + 8;  // row stride (elements) of B and C
  static constexpr int LD = DH + 8;  // of x, bf16(x dt) and the state planes
  // C in shared memory where the whole plan fits (else its fragments are
  // read from device memory): B, C, bf16(x dt), x, the 3 state planes and
  // 4 x [Q] f32
  static constexpr size_t kRest = size_t(Q) * LN * 2 + size_t(2) * Q * LD * 2 +
                                  size_t(3) * NP * LD * 2 + size_t(4) * Q * 4;
  static constexpr bool kCShared = kRest + size_t(Q) * LN * 2 <= kMaxSmem;
  static constexpr size_t kB = 0;
  static constexpr size_t kC = kB + size_t(Q) * LN * 2;
  static constexpr size_t kX = kC + (kCShared ? size_t(Q) * LN * 2 : 0);  // bf16(x dt)
  static constexpr size_t kXr = kX + size_t(Q) * LD * 2;  // x as read
  static constexpr size_t kS = kXr + size_t(Q) * LD * 2;  // 3 planes [NP][LD]
  static constexpr size_t kF = kS + size_t(3) * NP * LD * 2;  // 4 x [Q] f32
  static constexpr size_t kSmem = kF + size_t(4) * Q * 4;
  static_assert(N % 8 == 0 && DH % 16 == 0 && Q % 16 == 0, "tile shapes");
  static_assert(DH / 8 <= kWarps, "one column tile of the state a warp");
  static_assert(kCShared || N % 16 == 0, "C from device memory: no padded columns");
  static_assert(kSmem <= kMaxSmem, "the plan passes the shared memory of a block");
};

template <int N, int DH, int Q>
__global__ void __launch_bounds__(kThreads, 1) ssd_kernel(const Args a) {
  using S = Shape<N, DH, Q>;
  constexpr int NP = S::NP, LN = S::LN, LD = S::LD;
  constexpr int XV = DH / 8, NV = N / 8;  // 16-byte vectors a row
  constexpr int CV = S::kCShared ? NV : 0;  // of C brought to shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + S::kB);
  __nv_bfloat16* cs_ = reinterpret_cast<__nv_bfloat16*>(smem + S::kC);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + S::kX);
  __nv_bfloat16* xr = reinterpret_cast<__nv_bfloat16*>(smem + S::kXr);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + S::kS);
  float* dts = reinterpret_cast<float*>(smem + S::kF);
  float* cs = dts + Q;
  float* dec = cs + Q;
  float* ecs = dec + Q;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = h / (a.heads / a.groups);
  const float av = a.a[h];
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(a.x) +
                            b * a.sxb + h * a.sxh;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(a.bm) +
                            b * a.sbb + g * a.sbg;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(a.cm) +
                            b * a.scb + g * a.scg;
  const float* dtg = a.dt + b * a.sdb + h * a.sdh;
  float* yg = a.y + (static_cast<size_t>(b) * a.len * a.heads + h) * DH;
  const size_t y_row = static_cast<size_t>(a.heads) * DH;

  // B and C columns N..NP-1 stay zero (no load writes them)
  if (NP > N)
    for (int e = tid; e < Q * (NP - N); e += kThreads) {
      const int r = e / (NP - N), k = N + e % (NP - N);
      bs[r * LN + k] = __float2bfloat16_rn(0.f);
      if (S::kCShared) cs_[r * LN + k] = __float2bfloat16_rn(0.f);
    }

  // the carried state: warp w holds rows n of columns 8w..8w+7 (the
  // m16n8 accumulator layout), f32
  const bool owns = warp < DH / 8;
  float st[NP / 16][4];
  const int d_own = warp * 8 + 2 * tig;
  #pragma unroll
  for (int mt = 0; mt < NP / 16; ++mt)
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = mt * 16 + gid + (e >> 1) * 8;
      st[mt][e] = (owns && a.s0 != nullptr && n < N)
                      ? a.s0[((static_cast<size_t>(b) * a.heads + h) * N + n) *
                                 DH + d_own + (e & 1)]
                      : 0.f;
    }
  auto write_planes = [&]() {
    if (!owns) return;
    #pragma unroll
    for (int mt = 0; mt < NP / 16; ++mt)
      #pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = mt * 16 + gid + half * 8;
        uint32_t p[3];
        split3(st[mt][2 * half], st[mt][2 * half + 1], p[0], p[1], p[2]);
        #pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint32_t*>(sp + (k * NP + n) * LD + d_own) = p[k];
      }
  };
  write_planes();

  const int n_chunks = (a.len + a.q - 1) / a.q;
  for (int c = 0; c < n_chunks; ++c) {
    const int p0 = c * a.q;
    const int nv = min(a.q, a.len - p0);  // rows of this chunk
    __syncthreads();  // the previous chunk is done with the tiles
    for (int e = tid; e < Q * (XV + NV + CV); e += kThreads) {
      const int r = e / (XV + NV + CV), k = e % (XV + NV + CV);
      __nv_bfloat16* dst;
      const __nv_bfloat16* src;
      if (k < XV) {
        dst = xr + r * LD + k * 8;
        src = xg + (p0 + r) * a.sxl + k * 8;
      } else if (k < XV + NV) {
        dst = bs + r * LN + (k - XV) * 8;
        src = bg + (p0 + r) * a.sbl + (k - XV) * 8;
      } else {
        dst = cs_ + r * LN + (k - XV - NV) * 8;
        src = cg + (p0 + r) * a.scl + (k - XV - NV) * 8;
      }
      if (r < nv)
        cp16(dst, src);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int r = tid; r < Q; r += kThreads)
      dts[r] = r < nv ? dtg[(p0 + r) * a.sdl] : 0.f;
    cp_wait_all();
    __syncthreads();

    // thread 0: the cumulative log-decay; warps 1..: bf16(x dt)
    if (tid == 0) cumulative_log_decay<Q>(dts, av, cs);
    if (warp > 0)
      for (int e = tid - 32; e < Q * XV; e += kThreads - 32) {
        const int r = e / XV, k = (e % XV) * 8;
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + r * LD + k);
        const uint32_t* in = reinterpret_cast<const uint32_t*>(&raw);
        uint4 out;
        uint32_t* o = reinterpret_cast<uint32_t*>(&out);
        const float w = dts[r];
        #pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 v = unpack(in[u]);
          o[u] = pack(__fmul_rn(v.x, w), __fmul_rn(v.y, w));
        }
        *reinterpret_cast<uint4*>(xs + r * LD + k) = out;
      }
    __syncthreads();
    decays<Q>(cs, dec, ecs);
    const float chunk_decay = expf(cs[Q - 1]);
    __syncthreads();

    // y for 16-row tiles: tile k and its mirror k' = NT - 1 - k in turns
    constexpr int NT = Q / 16;
    for (int k = 0; k * kWarps < NT; ++k) {
      const int rt = k * kWarps + ((k & 1) ? kWarps - 1 - warp : warp);
      if (rt >= NT || rt * 16 >= nv) continue;
      const int i0 = rt * 16, ia = i0 + gid, ib = ia + 8;
      uint32_t cf[NP / 16][4];
      if (S::kCShared) {
        #pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk)
          ldsm_x4(cf[kk], cs_ + (i0 + (lane & 15)) * LN + kk * 16 + (lane >> 4) * 8);
      } else {
        // the A fragments of rows ia and ib (zeros past the chunk), as
        // ldmatrix would give them: columns 2 tig and 8 + 2 tig of each
        // 16-column step
        const __nv_bfloat16* ca = cg + (p0 + ia) * a.scl + 2 * tig;
        const __nv_bfloat16* cb = cg + (p0 + ib) * a.scl + 2 * tig;
        const bool va = ia < nv, vb = ib < nv;
        #pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          cf[kk][0] = va ? __ldg(reinterpret_cast<const unsigned*>(ca + kk * 16)) : 0u;
          cf[kk][1] = vb ? __ldg(reinterpret_cast<const unsigned*>(cb + kk * 16)) : 0u;
          cf[kk][2] = va ? __ldg(reinterpret_cast<const unsigned*>(ca + kk * 16 + 8)) : 0u;
          cf[kk][3] = vb ? __ldg(reinterpret_cast<const unsigned*>(cb + kk * 16 + 8)) : 0u;
        }
      }

      // y_inter = (C . S_prev) exp(cs_i), over the three planes of S_prev
      float yi[DH / 8][4] = {};
      #pragma unroll
      for (int p = 0; p < 3; ++p)
        #pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk)
          #pragma unroll
          for (int np = 0; np < DH / 16; ++np) {
            uint32_t bf[4];
            ldsm_x4_t(bf, sp + (p * NP + kk * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * LD +
                              np * 16 + (lane >> 4) * 8);
            mma(yi[2 * np], cf[kk], bf[0], bf[1]);
            mma(yi[2 * np + 1], cf[kk], bf[2], bf[3]);
          }
      const float ea = ecs[ia], eb = ecs[ib];
      #pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        yi[nt][0] = __fmul_rn(yi[nt][0], ea);
        yi[nt][1] = __fmul_rn(yi[nt][1], ea);
        yi[nt][2] = __fmul_rn(yi[nt][2], eb);
        yi[nt][3] = __fmul_rn(yi[nt][3], eb);
      }

      // y_intra over the key tiles at or below the diagonal
      float ya[DH / 8][4] = {};
      const float csa = cs[ia], csb = cs[ib];
      for (int kt = 0; kt <= rt; ++kt) {
        const int j0 = kt * 16;
        float sc[2][4] = {};
        #pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          uint32_t bf[4];
          ldsm_x4(bf, bs + (j0 + (lane & 7) + (lane >> 4) * 8) * LN + kk * 16 +
                          ((lane >> 3) & 1) * 8);
          mma(sc[0], cf[kk], bf[0], bf[1]);
          mma(sc[1], cf[kk], bf[2], bf[3]);
        }
        // the A fragments of mask * scores: key half t, row a (gid) or b
        uint32_t hi[4], lo[4];
        #pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = j0 + t * 8 + 2 * tig;
          const float c0 = cs[j], c1 = cs[j + 1];
          split2(masked(sc[t][0], csa, c0, j <= ia),
                 masked(sc[t][1], csa, c1, j + 1 <= ia), hi[2 * t], lo[2 * t]);
          split2(masked(sc[t][2], csb, c0, j <= ib),
                 masked(sc[t][3], csb, c1, j + 1 <= ib), hi[2 * t + 1],
                 lo[2 * t + 1]);
        }
        #pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, xs + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            np * 16 + (lane >> 4) * 8);
          mma(ya[2 * np], hi, bf[0], bf[1]);
          mma(ya[2 * np], lo, bf[0], bf[1]);
          mma(ya[2 * np + 1], hi, bf[2], bf[3]);
          mma(ya[2 * np + 1], lo, bf[2], bf[3]);
        }
      }
      #pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const int d = nt * 8 + 2 * tig;
        if (ia < nv)
          *reinterpret_cast<float2*>(yg + (p0 + ia) * y_row + d) = make_float2(
              __fadd_rn(ya[nt][0], yi[nt][0]), __fadd_rn(ya[nt][1], yi[nt][1]));
        if (ib < nv)
          *reinterpret_cast<float2*>(yg + (p0 + ib) * y_row + d) = make_float2(
              __fadd_rn(ya[nt][2], yi[nt][2]), __fadd_rn(ya[nt][3], yi[nt][3]));
      }
    }
    __syncthreads();  // the planes of S_prev are read; the tiles stay

    // S = S exp(cs_last) + B^T (x dt exp(cs_last - cs_t)), columns 8w..8w+7
    if (owns) {
      float sc[NP / 16][4] = {};
      for (int kt = 0; kt * 16 < nv; ++kt) {
        const int t0 = kt * 16;
        uint32_t xb[2];
        ldsm_x2_t(xb, xr + (t0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          warp * 8);
        uint32_t vh[2], vm[2], vl[2];
        #pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = t0 + u * 8 + 2 * tig;
          const float2 xv = unpack(xb[u]);
          split3(__fmul_rn(__fmul_rn(xv.x, dts[t]), dec[t]),
                 __fmul_rn(__fmul_rn(xv.y, dts[t + 1]), dec[t + 1]), vh[u],
                 vm[u], vl[u]);
        }
        #pragma unroll
        for (int mt = 0; mt < NP / 16; ++mt) {
          uint32_t af[4];
          ldsm_x4_t(af, bs + (t0 + (lane & 7) + (lane >> 4) * 8) * LN +
                            mt * 16 + ((lane >> 3) & 1) * 8);
          mma(sc[mt], af, vh[0], vh[1]);
          mma(sc[mt], af, vm[0], vm[1]);
          mma(sc[mt], af, vl[0], vl[1]);
        }
      }
      #pragma unroll
      for (int mt = 0; mt < NP / 16; ++mt)
        #pragma unroll
        for (int e = 0; e < 4; ++e)
          st[mt][e] = __fadd_rn(__fmul_rn(st[mt][e], chunk_decay), sc[mt][e]);
      write_planes();
    }
  }

  if (owns)
    #pragma unroll
    for (int mt = 0; mt < NP / 16; ++mt)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = mt * 16 + gid + (e >> 1) * 8;
        if (n < N)
          a.s_out[((static_cast<size_t>(b) * a.heads + h) * N + n) * DH +
                  d_own + (e & 1)] = st[mt][e];
      }
}

}  // namespace tc

namespace simt {

template <int N, int DH, int Q>
struct Shape {
  static constexpr int LB = N + 1;  // B's row stride: lanes read a column
  static constexpr size_t kC = 0;   // offsets in floats
  static constexpr size_t kB = kC + size_t(Q) * N;
  static constexpr size_t kX = kB + size_t(Q) * LB;  // x, then x dt
  static constexpr size_t kS = kX + size_t(Q) * DH;  // the state [N][DH]
  static constexpr size_t kM = kS + size_t(N) * DH;  // a row of mask * scores a warp
  static constexpr size_t kF = kM + size_t(kWarps) * Q;  // dt, cs, dec, ecs
  static constexpr size_t kSmem = (kF + size_t(4) * Q) * 4;
};

// f32: nothing rounded below f32; the products in f32 FMAs.
template <int N, int DH, int Q>
__global__ void __launch_bounds__(kThreads, 1) ssd_kernel(const Args a) {
  using S = Shape<N, DH, Q>;
  extern __shared__ __align__(16) float fsm[];
  float* cm = fsm + S::kC;
  float* bm = fsm + S::kB;
  float* xs = fsm + S::kX;
  float* sm = fsm + S::kS;
  float* dts = fsm + S::kF;
  float* cs = dts + Q;
  float* dec = cs + Q;
  float* ecs = dec + Q;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* mrow = fsm + S::kM + warp * Q;
  const int g = h / (a.heads / a.groups);
  const float av = a.a[h];
  const float* xg = static_cast<const float*>(a.x) + b * a.sxb + h * a.sxh;
  const float* bg = static_cast<const float*>(a.bm) + b * a.sbb + g * a.sbg;
  const float* cg = static_cast<const float*>(a.cm) + b * a.scb + g * a.scg;
  const float* dtg = a.dt + b * a.sdb + h * a.sdh;
  float* yg = a.y + (static_cast<size_t>(b) * a.len * a.heads + h) * DH;
  const size_t y_row = static_cast<size_t>(a.heads) * DH;
  const size_t s_base = (static_cast<size_t>(b) * a.heads + h) * N * DH;

  for (int e = tid; e < N * DH; e += kThreads)
    sm[e] = a.s0 != nullptr ? a.s0[s_base + e] : 0.f;

  const int n_chunks = (a.len + a.q - 1) / a.q;
  for (int c = 0; c < n_chunks; ++c) {
    const int p0 = c * a.q;
    const int nv = min(a.q, a.len - p0);
    __syncthreads();
    for (int e = tid; e < Q * N; e += kThreads) {
      const int r = e / N, k = e % N;
      cm[e] = r < nv ? cg[(p0 + r) * a.scl + k] : 0.f;
      bm[r * S::LB + k] = r < nv ? bg[(p0 + r) * a.sbl + k] : 0.f;
    }
    for (int e = tid; e < Q * DH; e += kThreads) {
      const int r = e / DH, k = e % DH;
      xs[e] = r < nv ? xg[(p0 + r) * a.sxl + k] : 0.f;
    }
    for (int r = tid; r < Q; r += kThreads)
      dts[r] = r < nv ? dtg[(p0 + r) * a.sdl] : 0.f;
    __syncthreads();
    if (tid == 0) cumulative_log_decay<Q>(dts, av, cs);
    if (warp > 0)
      for (int e = tid - 32; e < Q * DH; e += kThreads - 32)
        xs[e] = __fmul_rn(xs[e], dts[e / DH]);
    __syncthreads();
    decays<Q>(cs, dec, ecs);
    const float chunk_decay = expf(cs[Q - 1]);
    __syncthreads();

    for (int i = warp; i < nv; i += kWarps) {
      const float ci = cs[i];
      for (int j = lane; j <= i; j += 32) {
        float s = 0.f;
        for (int n = 0; n < N; ++n) s = fmaf(cm[i * N + n], bm[j * S::LB + n], s);
        mrow[j] = __fmul_rn(expf(__fsub_rn(ci, cs[j])), s);
      }
      __syncwarp();
      for (int d = lane; d < DH; d += 32) {
        float acc = 0.f;
        for (int j = 0; j <= i; ++j) acc = fmaf(mrow[j], xs[j * DH + d], acc);
        float in = 0.f;
        for (int n = 0; n < N; ++n) in = fmaf(cm[i * N + n], sm[n * DH + d], in);
        yg[(p0 + i) * y_row + d] = __fadd_rn(acc, __fmul_rn(in, ecs[i]));
      }
      __syncwarp();
    }
    __syncthreads();  // S_prev is read

    for (int e = tid; e < N * DH; e += kThreads) {
      const int n = e / DH, d = e % DH;
      float acc = 0.f;
      for (int t = 0; t < nv; ++t)
        acc = fmaf(bm[t * S::LB + n], __fmul_rn(xs[t * DH + d], dec[t]), acc);
      sm[e] = __fadd_rn(__fmul_rn(sm[e], chunk_decay), acc);
    }
  }
  __syncthreads();
  for (int e = tid; e < N * DH; e += kThreads) a.s_out[s_base + e] = sm[e];
}

}  // namespace simt

namespace {

template <int N, int DH, int Q>
int launch(int dtype, const Args& a, int batch, cudaStream_t stream) {
  void (*kernel)(const Args);
  size_t smem;
  if (dtype == 1) {
    kernel = tc::ssd_kernel<N, DH, Q>;
    smem = tc::Shape<N, DH, Q>::kSmem;
  } else if (dtype == 0) {
    // the f32 plan keeps C, B, x and the state in f32: no instantiation
    // where that passes a block's shared memory (N 128 at chunk 256)
    if constexpr (simt::Shape<N, DH, Q>::kSmem <= kMaxSmem) {
      kernel = simt::ssd_kernel<N, DH, Q>;
      smem = simt::Shape<N, DH, Q>::kSmem;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.q < 1 || a.q > Q) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.heads, batch), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B and C).  (n_state, head_dim,
// chunk_tile) one of the instantiations below (kernels/ssd_scan.py SHAPES;
// (128, 64, 256) in bfloat16 only, BF16_ONLY there),
// 1 <= chunk <= chunk_tile; heads a multiple of groups; len >= 1, batch >=
// 1.  x, B and C rows 16-byte aligned; s0 null or [batch, heads, n_state,
// head_dim] contiguous; y [batch, len, heads, head_dim] and s_out
// contiguous.  Launches on `stream`; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape or dtype with no
// instantiation).
extern "C" int ssd_scan(const void* x, const float* dt, const float* a,
                        const void* bm, const void* cm, const float* s0,
                        float* y, float* s_out, int batch, int len, int heads,
                        int groups, int n_state, int head_dim, int chunk_tile,
                        int chunk, long long sxb, long long sxl, long long sxh,
                        long long sdb, long long sdl, long long sdh,
                        long long sbb, long long sbl, long long sbg,
                        long long scb, long long scl, long long scg, int dtype,
                        void* stream) {
  if (batch < 1 || len < 1 || groups < 1 || heads % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x,     dt,  a,   bm,  cm,  s0,  y,   s_out, len, heads,
                  groups, chunk, sxb, sxl, sxh, sdb, sdl, sdh,   sbb, sbl,
                  sbg,   scb, scl, scg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = n_state, d = head_dim, q = chunk_tile;
  if (n == 64 && d == 64 && q == 256) return launch<64, 64, 256>(dtype, args, batch, st);
  if (n == 128 && d == 64 && q == 256) return launch<128, 64, 256>(dtype, args, batch, st);
  if (n == 64 && d == 64 && q == 128) return launch<64, 64, 128>(dtype, args, batch, st);
  if (n == 128 && d == 64 && q == 128) return launch<128, 64, 128>(dtype, args, batch, st);
  if (n == 16 && d == 16 && q == 16) return launch<16, 16, 16>(dtype, args, batch, st);
  if (n == 8 && d == 16 && q == 16) return launch<8, 16, 16>(dtype, args, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
