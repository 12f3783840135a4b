// f32 products on Hopper's tensor cores (sm_90a) as three TF32 products,
// and the attention backward pass built on them, shared by K2's f32 kernel
// (flash_bwd.cu), K5 (flash_blocked_bwd_fused.cu) and K4a, K4b
// (flash_blocked_bwd.cu); the forward built on them, for K3
// (flash_blocked_fwd.cu) and K1's f32 kernel (flash_fwd.cu), is in
// flash_tf32_fwd.cuh.
//
// Building blocks:
//   split_tf32   x = hi + lo: hi is x rounded to TF32 (10 mantissa bits,
//                to nearest, ties away from zero: the rounding of
//                `cvt.rna.tf32.f32`, done here with an integer add and
//                mask, which measured faster on the H100 than the
//                conversion, tools/tf32_variants.py), lo = x - hi, exact
//                in f32 with |lo| <= 2^-11 |x|. lo is passed as it is: the
//                tensor cores read the top 10 mantissa bits of a TF32
//                operand, so lo is truncated there, to within 2^-10 |lo|
//                <= 2^-21 |x|;
//   mma3         c += a . b as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b on
//                `mma.sync.m16n8k8` with TF32 operands and f32 sums, the
//                small products first. Each product is exact in f32; what
//                is left out (lo.lo and the truncation of lo) is about
//                2^-20 of |a.b|, far under the 1e-4 bar of the f32 kernels
//                and under what one-pass TF32 (2^-11 per operand) leaves;
//   FragA, FragB split m16n8k8 A (16 x 8) and B (8 x 8) fragments, loaded
//                with 32-bit shared loads from f32 tiles:
//                  lda_rows / ldb_rows: tile stored [m or n][k];
//                  lda_cols / ldb_cols: tile stored [k][m or n], k permuted;
//                  from_c: a 16 x 8 C fragment re-laid as the A fragment over
//                  k = its 8 columns, k permuted, with no data movement.
//                `ldmatrix` moves 16-bit elements and its `.trans` form
//                does not serve 32-bit ones, so the transposed operands are
//                read with 32-bit loads. "k permuted": a lane's k indices
//                t4 and t4 + 4 stand for the tile's rows 2*t4 and 2*t4 + 1,
//                in A and B alike (a sum over k does not see the order).
//                That is the order in which a C fragment holds its columns,
//                so from_c is free, and with tile rows DP + 4 floats apart
//                (4 times an odd number) both the [row][k] reads (lanes g,
//                t4 at g*LD + t4) and the permuted [k][col] reads (at
//                2*t4*LD + g) hit 32 distinct banks;
//   load_tile    a tile of rows of a [*, H, D] head into shared memory as
//                f32 times a factor, D zero-padded to DP, rows past the end
//                zero (so that 0 * pad is 0 in every product); TileRegs the
//                same in two steps, so that the next tile loads into
//                registers while the current one computes.
//
// The backward pass (`bwd_kv_kernel`, then `dq_reduce_kernel`): per (batch,
// head) and per chunk of `kt_per_block` key tiles of BK = 64 keys, one block
// of 4 warps, so that a head's key tiles spread over several blocks. Warp w
// owns keys 16w..16w+15 of the key tile (k, v in shared memory). For each
// query tile (q, do and the row statistics in shared memory) it computes
// S^T = k.q^T and dP^T = v.do^T for its keys, forms p and ds in registers,
// re-lays them as A fragments for dv += p^T.do and dk += ds^T.q, whose f32
// sums stay in registers over the whole query loop, and stages ds^T in
// shared memory; the warps then split this pair's ds.k (32 queries by D)
// into two strips of 16 queries by two halves of D, and each adds its part
// to the chunk's own dq part in an f32 scratch
// [chunks, B*H, Tq, DP] (written by the chunk's first key tile, added to by
// the others; no block touches another's part). Above DC = 64 columns the
// dk and dv sums would not fit in registers: the query loop then runs once
// per 64 columns of D, recomputing S^T and dP^T (dq in the first round
// only). The second kernel sums each dq element's parts in key order,
// scales it and rounds it once. So the result does not depend on the order
// of blocks, and there are no atomics. With causal, query tiles wholly
// above the diagonal are skipped, and a chunk's part holds rows from its
// first key on only (the sum leaves out the rest).
//
// Three semantics (template Sem):
//   kOneShot (K2): p = exp(s * scale - lse) / l, l and delta from K2's
//       first pass; dk = ds^T.q * scale; dq = (sum of ds.k) * scale.
//   kFused (K5): s = (q * scale).k^T, p = exp(s - lse), delta from the
//       wrapper; dk = ds^T.(q * scale); each key tile's ds.k is scaled
//       before it is added, as the TPU kernel does.
//   kDkv (K4b): K5's dk and dv alone: no ds staging, no ds.k, no dq parts
//       and no second kernel; the grid's key tiles fastest, so that the
//       blocks of one head run together and share its q and do in L2.
// All: masked p exactly 0 (causal: col <= row; segment: 0 < seg[j] <=
// seg[i]; rows and keys past the end), ds = p * (dp - delta), dv = p^T.do.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace bvt_tf32 {

constexpr int NT = 128;  // 4 warps
constexpr int BK = 64;   // keys of a key tile, 16 per warp
constexpr float LOG2E = 1.4426950408889634f;

// D zero-padded to a multiple of the k step (8): 32, 64, 128 or 256.
__host__ __device__ inline int dpad(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// ---- Building blocks ----

// Half of the 13 dropped bits added to the magnitude, then truncated: round
// to nearest, ties away from zero (an exponent carry is the right result).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

__device__ __forceinline__ FragA split_a(float x0, float x1, float x2,
                                         float x3) {
  FragA f;
  split_tf32(x0, f.hi[0], f.lo[0]);
  split_tf32(x1, f.hi[1], f.lo[1]);
  split_tf32(x2, f.hi[2], f.lo[2]);
  split_tf32(x3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float x0, float x1) {
  FragB f;
  split_tf32(x0, f.hi[0], f.lo[0]);
  split_tf32(x1, f.hi[1], f.lo[1]);
  return f;
}

// c += a . b on a 16 x 8 x 8 tile: TF32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b to f32 accuracy: three TF32 products, the small ones first.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// Lane coordinates of the m16n8k8 fragments: g = lane / 4, t4 = lane % 4.
struct Lane {
  int g, t4;
  __device__ explicit Lane(int lane) : g(lane >> 2), t4(lane & 3) {}
};

// A rows m0..m0+15, k columns k0..k0+7 of a tile stored [m][k].
__device__ __forceinline__ FragA lda_rows(const float* t, int ld, int m0,
                                          int k0, Lane l) {
  const float* p = t + (m0 + l.g) * ld + k0 + l.t4;
  return split_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// B k rows k0..k0+7 by n columns n0..n0+7 of a tile stored [n][k].
__device__ __forceinline__ FragB ldb_rows(const float* t, int ld, int n0,
                                          int k0, Lane l) {
  const float* p = t + (n0 + l.g) * ld + k0 + l.t4;
  return split_b(p[0], p[4]);
}

// A rows m0..m0+15, k rows k0..k0+7 (permuted) of a tile stored [k][m].
__device__ __forceinline__ FragA lda_cols(const float* t, int ld, int k0,
                                          int m0, Lane l) {
  const float* p = t + (k0 + 2 * l.t4) * ld + m0 + l.g;
  return split_a(p[0], p[8], p[ld], p[ld + 8]);
}

// B k rows k0..k0+7 (permuted) by n columns n0..n0+7 of a tile stored [k][n].
__device__ __forceinline__ FragB ldb_cols(const float* t, int ld, int k0,
                                          int n0, Lane l) {
  const float* p = t + (k0 + 2 * l.t4) * ld + n0 + l.g;
  return split_b(p[0], p[ld]);
}

// A 16 x 8 C fragment (columns 2*t4, 2*t4+1 in c[0..1], rows g and g+8) as
// the A fragment over k = those 8 columns, k permuted.
__device__ __forceinline__ FragA from_c(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// acc1[j] = a1[m0..m0+15] . b1[8j..8j+7]^T and acc2[j] likewise from a2,
// b2, over KD k steps of 8: two 16-row strips against NJ 8-row tiles, every
// tile stored [row][k] with row stride ld.
template <int KD, int NJ>
__device__ __forceinline__ void strip_products(
    const float* a1, const float* b1, const float* a2, const float* b2,
    int ld, int m0, float (&acc1)[NJ][4], float (&acc2)[NJ][4], Lane l) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[j][e] = acc2[j][e] = 0.f;
#pragma unroll 2
  for (int kd = 0; kd < KD; ++kd) {
    const FragA x = lda_rows(a1, ld, m0, 8 * kd, l);
    const FragA y = lda_rows(a2, ld, m0, 8 * kd, l);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mma3(acc1[j], x, ldb_rows(b1, ld, 8 * j, 8 * kd, l));
      mma3(acc2[j], y, ldb_rows(b2, ld, 8 * j, 8 * kd, l));
    }
  }
}

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements as f32 (`vec`: one 16-byte load for f32, one
// 8-byte load for bf16, which needs D % 4 == 0 and aligned rows).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Columns c..c+3 of the row at p - c as f32, zero past D; `vec` as above.
template <typename T>
__device__ __forceinline__ float4 load_cols(const T* p, int c, int D,
                                            bool vec) {
  if (vec) return load4(p);
  float4 x = make_float4(to_f(p[0]), 0.f, 0.f, 0.f);
  if (c + 1 < D) x.y = to_f(p[1]);
  if (c + 2 < D) x.z = to_f(p[2]);
  if (c + 3 < D) x.w = to_f(p[3]);
  return x;
}

__device__ __forceinline__ float4 scaled(float4 x, float mul) {
  return make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
}

// Rows r0..r0+ROWS-1 of a head (row i at head + i * row elements) into a
// ROWS x DP f32 tile with row stride DP + 4, times mul; rows past nrows and
// columns past D are zero. `vec`: D % 4 == 0 and 16-byte aligned rows.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* head,
                                          long long row, int r0, int nrows,
                                          int D, float mul, bool vec,
                                          int tid) {
  constexpr int LD = DP + 4, C4 = DP / 4;  // 4-column chunks per row
  const int n = min(ROWS, nrows - r0);
#pragma unroll 4
  for (int i = tid; i < ROWS * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    const float4 x = r < n && c < D
        ? load_cols(head + (long long)(r0 + r) * row + c, c, D, vec)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * LD + c) = scaled(x, mul);
  }
}

// The same tile in two steps, so that it loads while the previous one
// computes: `fetch` issues this thread's loads into registers (ROWS * DP /
// 4 / NT float4, 4 for 32 x 64), `store` scales them into shared memory
// once the previous tile's readers are done. (bf16 is converted as it
// arrives, so only f32 loads overlap.)
template <typename T, int ROWS, int DP>
struct TileRegs {
  static constexpr int C4 = DP / 4, N = ROWS * C4 / NT;
  static_assert(ROWS * C4 % NT == 0, "whole float4 per thread");
  float4 x[N];
  __device__ __forceinline__ void fetch(const T* head, long long row, int r0,
                                        int nrows, int D, bool vec, int tid) {
    const int n = min(ROWS, nrows - r0);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = tid + u * NT, r = i / C4, c = (i % C4) * 4;
      x[u] = r < n && c < D
          ? load_cols(head + (long long)(r0 + r) * row + c, c, D, vec)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float* dst, float mul, int tid) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = tid + u * NT;
      *reinterpret_cast<float4*>(dst + (i / C4) * (DP + 4) + (i % C4) * 4) =
          scaled(x[u], mul);
    }
  }
};

// ---- The backward pass ----

struct BwdArgs {
  const void *q, *k, *v, *dout;  // [B, Tq or Tkv, H, D], contiguous
  const float *lse, *delta, *l;  // per query row, [B*H, Tq]; l null for K5
  const int32_t* seg;            // [B, T] or null
  void *dq, *dk, *dv;
  float* dq_parts;               // [chunks, B*H, Tq, DP]
  int B, Tq, Tkv, H, D, causal, kt_per_block, vec;
  float scale;
};

enum class Sem { kOneShot, kFused, kDkv };

template <int DP> struct Tiles {
  // Queries of a query tile: 32 keeps the S^T and dP^T fragments, and
  // shared memory, small enough for three blocks per SM at D <= 64, which
  // measured faster than 64 on the H100 (tools/tf32_variants.py).
  static constexpr int BQ = 32;
  static constexpr int DC = DP < 64 ? DP : 64;    // dk, dv columns per round
  static constexpr int LD = DP + 4;               // row stride of q, do, k, v
  static constexpr int LDS = BQ + 4;              // row stride of ds^T
  // Floats: k, v [BK][LD]; q, do [BQ][LD]; ds^T [BK][LDS] where dq is
  // computed; per query row lse * log2(e), 1 / l and delta [3][BQ]; then
  // ints: seg of the query and key rows.
  static constexpr size_t bytes(bool dq) {
    return (2 * BK * LD + 2 * BQ * LD + (dq ? BK * LDS : 0) + 3 * BQ + BQ +
            BK) * 4;
  }
};

template <typename T, int DP, Sem SEM>
__global__ void __launch_bounds__(NT) bwd_kv_kernel(const BwdArgs a) {
  using Tl = Tiles<DP>;
  constexpr bool ONE_SHOT = SEM == Sem::kOneShot, DQ = SEM != Sem::kDkv;
  constexpr int BQ = Tl::BQ, DC = Tl::DC, LD = Tl::LD, LDS = Tl::LDS;
  constexpr int NQ = BQ / 8;             // 8-query tiles of S^T
  constexpr int KD = DP / 8;             // k steps over D
  constexpr int NC = DC / 8;             // 8-column tiles of a dk, dv round
  constexpr int STRIPS = BQ / 16;        // 16-query strips of a tile (dq)
  constexpr int ND = KD * STRIPS / 4;    // 8-column dq tiles per warp
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sdS = sdO + BQ * LD;  // ds^T of the current pair, [key][query]
  float* sStat = sdS + (DQ ? BK * LDS : 0);
  int* sSegQ = reinterpret_cast<int*>(sStat + 3 * BQ);
  int* sSegK = sSegQ + BQ;

  const int tid = threadIdx.x, w = tid >> 5;
  const Lane l(tid & 31);
  const int bh = DQ ? blockIdx.x : blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int chunk = DQ ? blockIdx.y : blockIdx.x;
  const long long row = (long long)a.H * a.D;
  const T* qb = static_cast<const T*>(a.q) + ((long long)b * a.Tq * a.H + h) * a.D;
  const T* dob = static_cast<const T*>(a.dout) + ((long long)b * a.Tq * a.H + h) * a.D;
  const long long koff = ((long long)b * a.Tkv * a.H + h) * a.D;
  const T* kb = static_cast<const T*>(a.k) + koff;
  const T* vb = static_cast<const T*>(a.v) + koff;
  const int32_t* segq = a.seg ? a.seg + (long long)b * a.Tq : nullptr;
  const int32_t* segk = a.seg ? a.seg + (long long)b * a.Tkv : nullptr;
  const float* lse = a.lse + (long long)bh * a.Tq;
  const float* delta = a.delta + (long long)bh * a.Tq;
  float* part =
      DQ ? a.dq_parts + ((long long)chunk * gridDim.x + bh) * a.Tq * DP
         : nullptr;
  // K2: s = q.k^T unscaled; K5, K4b: q scaled as it is loaded.
  const float s_mul = ONE_SHOT ? a.scale * LOG2E : LOG2E;
  const float q_mul = ONE_SHOT ? 1.f : a.scale;
  const float dk_mul = ONE_SHOT ? a.scale : 1.f;
  const float dq_mul = ONE_SHOT ? 1.f : a.scale;
  const int nq = (a.Tq + BQ - 1) / BQ, nk = (a.Tkv + BK - 1) / BK;
  const int kt0 = chunk * a.kt_per_block;
  const int kt1 = min(nk, kt0 + a.kt_per_block);
  const bool vec = a.vec;
  // Up to D = 64 the next query tile loads while this one computes (32
  // registers a thread); above, each loads in turn.
  constexpr bool PREFETCH = DP <= 64;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int kv0 = kt * BK;
    __syncthreads();  // the previous key tile's readers are done
    load_tile<T, BK, DP>(sK, kb, row, kv0, a.Tkv, a.D, 1.f, vec, tid);
    load_tile<T, BK, DP>(sV, vb, row, kv0, a.Tkv, a.D, 1.f, vec, tid);
    if (segk && tid < BK) sSegK[tid] = kv0 + tid < a.Tkv ? segk[kv0 + tid] : 0;
    // With causal, query tiles wholly above the diagonal see none of these
    // keys (kv0 is a multiple of BQ).
    const int qt0 = a.causal ? kv0 / BQ : 0;
    for (int c0 = 0; c0 < DP; c0 += DC) {
      float dk_acc[NC][4], dv_acc[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

      TileRegs<T, BQ, DP> fq, fo;
      if (PREFETCH && qt0 < nq) {
        fq.fetch(qb, row, qt0 * BQ, a.Tq, a.D, vec, tid);
        fo.fetch(dob, row, qt0 * BQ, a.Tq, a.D, vec, tid);
      }
      for (int qt = qt0; qt < nq; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();  // the previous query tile's readers are done
        if (PREFETCH) {
          fq.store(sQ, q_mul, tid);
          fo.store(sdO, 1.f, tid);
        } else {
          load_tile<T, BQ, DP>(sQ, qb, row, q0, a.Tq, a.D, q_mul, vec, tid);
          load_tile<T, BQ, DP>(sdO, dob, row, q0, a.Tq, a.D, 1.f, vec, tid);
        }
        if (tid < BQ) {
          const int r = q0 + tid;
          const bool in = r < a.Tq;
          sStat[tid] = in ? lse[r] * LOG2E : 0.f;
          sStat[BQ + tid] = in && ONE_SHOT ? 1.f / a.l[(long long)bh * a.Tq + r] : 1.f;
          sStat[2 * BQ + tid] = in ? delta[r] : 0.f;
          if (segq) sSegQ[tid] = in ? segq[r] : 0;
        }
        __syncthreads();
        if (PREFETCH && qt + 1 < nq) {
          fq.fetch(qb, row, q0 + BQ, a.Tq, a.D, vec, tid);
          fo.fetch(dob, row, q0 + BQ, a.Tq, a.D, vec, tid);
        }

        // S^T and dP^T for keys 16w..16w+15 against the tile's queries.
        float s[NQ][4], dp[NQ][4];
        strip_products<KD, NQ>(sK, sQ, sV, sdO, LD, 16 * w, s, dp, l);
        // p (0 where masked) into s, ds into dp.
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = 8 * j + 2 * l.t4 + (e & 1);
            const int kl = 16 * w + l.g + 8 * (e >> 1);
            const int qi = q0 + ql, ki = kv0 + kl;
            bool vis = qi < a.Tq && ki < a.Tkv;
            if (a.causal) vis = vis && ki <= qi;
            if (segk) vis = vis && sSegK[kl] > 0 && sSegK[kl] <= sSegQ[ql];
            float p = 0.f, ds = 0.f;
            if (vis) {
              p = exp2f(s[j][e] * s_mul - sStat[ql]) * sStat[BQ + ql];
              ds = p * (dp[j][e] - sStat[2 * BQ + ql]);
            }
            s[j][e] = p;
            dp[j][e] = ds;
          }
        // dv += p^T . do and dk += ds^T . q over columns c0..c0+DC-1, k
        // over the tile's queries.
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const FragA pa = from_c(s[j]), da = from_c(dp[j]);
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            mma3(dv_acc[n], pa, ldb_cols(sdO, LD, 8 * j, c0 + 8 * n, l));
            mma3(dk_acc[n], da, ldb_cols(sQ, LD, 8 * j, c0 + 8 * n, l));
          }
        }
        if (!DQ || c0 != 0) continue;

        // ds^T to shared memory, then this pair's ds . k for query rows
        // 16*strip.. and dq columns 8*ND*grp.. of the tile.
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          float* d0 = sdS + (16 * w + l.g) * LDS + 8 * j + 2 * l.t4;
          d0[0] = dp[j][0], d0[1] = dp[j][1];
          d0[8 * LDS] = dp[j][2], d0[8 * LDS + 1] = dp[j][3];
        }
        __syncthreads();
        const int strip = w % STRIPS, n0 = (w / STRIPS) * ND;
        float acc[ND][4];
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < BK / 8; ++ks) {
          const FragA sa = lda_cols(sdS, LDS, 8 * ks, 16 * strip, l);
#pragma unroll
          for (int n = 0; n < ND; ++n)
            mma3(acc[n], sa, ldb_cols(sK, LD, 8 * ks, 8 * (n0 + n), l));
        }
#pragma unroll
        for (int n = 0; n < ND; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int qi = q0 + 16 * strip + l.g + 8 * hf;
            if (qi >= a.Tq) continue;
            float2* dst = reinterpret_cast<float2*>(
                part + (long long)qi * DP + 8 * (n0 + n) + 2 * l.t4);
            float2 x = make_float2(acc[n][2 * hf] * dq_mul,
                                   acc[n][2 * hf + 1] * dq_mul);
            if (kt != kt0) {
              const float2 old = *dst;
              x.x = old.x + x.x, x.y = old.y + x.y;
            }
            *dst = x;
          }
      }

      // dk and dv of keys 16w+g and 16w+g+8, columns of the round.
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = kv0 + 16 * w + l.g + 8 * (e >> 1);
          const int d = c0 + 8 * n + 2 * l.t4 + (e & 1);
          if (kr < a.Tkv && d < a.D) {
            const long long o = koff + kr * row + d;
            static_cast<T*>(a.dk)[o] = from_f<T>(dk_acc[n][e] * dk_mul);
            static_cast<T*>(a.dv)[o] = from_f<T>(dv_acc[n][e]);
          }
        }
    }
  }
}

// dq[b, r, h, d] = mul * (sum over chunks c, in key order, of
// parts[c, b*H+h, r, d]); with causal, chunk c holds rows from its first
// key (c * chunk_keys) on only.
template <typename T>
__global__ void __launch_bounds__(256) dq_reduce_kernel(
    const float* __restrict__ parts, T* __restrict__ dq, int BH, int H,
    int Tq, int D, int DP, int chunks, int chunk_keys, int causal,
    float mul) {
  const long long total = (long long)BH * Tq * D;
  const long long stride = (long long)BH * Tq * DP;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int d = i % D, r = (i / D) % Tq, bh = i / ((long long)D * Tq);
    const float* p = parts + ((long long)bh * Tq + r) * DP + d;
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (causal && r < c * chunk_keys) break;
      acc += p[c * stride];
    }
    const int b = bh / H, h = bh % H;
    dq[(((long long)b * Tq + r) * H + h) * D + d] = from_f<T>(acc * mul);
  }
}

// Launches the kernels of the pass on `stream` (kDkv: the first alone);
// returns the first error.
template <typename T, int DP, Sem SEM>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr bool ONE_SHOT = SEM == Sem::kOneShot;
  auto kern = bwd_kv_kernel<T, DP, SEM>;
  const int smem = (int)Tiles<DP>::bytes(SEM != Sem::kDkv);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nk = (a.Tkv + BK - 1) / BK;
  const int chunks = (nk + a.kt_per_block - 1) / a.kt_per_block;
  const dim3 grid = SEM == Sem::kDkv ? dim3(chunks, a.B * a.H)
                                     : dim3(a.B * a.H, chunks);
  kern<<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || SEM == Sem::kDkv) return err;
  const long long total = (long long)a.B * a.H * a.Tq * a.D;
  const long long need = (total + 255) / 256;
  const int blocks = need < 132 * 16 ? (int)need : 132 * 16;
  dq_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      a.dq_parts, static_cast<T*>(a.dq), a.B * a.H, a.H, a.Tq, a.D, DP,
      chunks, a.kt_per_block * BK, a.causal, ONE_SHOT ? a.scale : 1.f);
  return cudaGetLastError();
}

// By D padded (32, 64, 128 or 256).
template <typename T, Sem SEM>
cudaError_t dispatch_bwd(const BwdArgs& a, cudaStream_t stream) {
  switch (dpad(a.D)) {
    case 32: return launch_bwd<T, 32, SEM>(a, stream);
    case 64: return launch_bwd<T, 64, SEM>(a, stream);
    case 128: return launch_bwd<T, 128, SEM>(a, stream);
    default: return launch_bwd<T, 256, SEM>(a, stream);
  }
}

// Whether every row of D elements at these base pointers can be read in
// 16-byte vectors (f32) or 8-byte vectors (bf16): D % 4 == 0 and aligned
// base pointers.
template <typename T>
inline int vec_ok(int D, std::initializer_list<const void*> bases) {
  uintptr_t bits = 0;
  for (const void* p : bases) bits |= reinterpret_cast<uintptr_t>(p);
  return D % 4 == 0 && bits % (4 * sizeof(T)) == 0;
}

// The same for every row of q, k, v and do.
template <typename T>
inline int vec_ok(const BwdArgs& a) {
  return vec_ok<T>(a.D, {a.q, a.k, a.v, a.dout});
}

}  // namespace bvt_tf32
