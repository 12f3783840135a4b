// Blocked attention forward for Hopper (sm_90a): the port of the TPU kernel
// `_fwd_kernel` in big_vision_tpu/ops/flash_attention.py (launched by `_fwd`),
// the forward of the JAX package's blocked path (long T).
//
// What it computes, per (batch, head), all in f32 as the TPU body does after
// its casts: q, k, v read in their storage dtype (bf16 or f32) and widened;
// q multiplied by scale before s = q . k^T; the causal (col <= row) and
// segment (0 < seg[j] <= seg[i]) masks and the ragged edge of the last tile;
// an online softmax with a running row max m and row sum l; masked entries
// excluded from the sums explicitly; o = acc / l rounded once to q's dtype;
// the row log-sum-exp m + log(l) (f32). A row with no visible key gets
// o = 0 and lse = -1e30. Unlike the one-shot kernel K1 (csrc/flash_fwd.cu),
// p is not rounded to v's dtype before p . v.
//
// Layout: q, o [B, Tq, H, D] and k, v [B, Tkv, H, D], contiguous, read in
// place; seg [B, T] int32 or null; lse [B*H, Tq] f32.
//
// Design. The TPU kernel walks 128-row q blocks over 128-row kv blocks of a
// T padded to the block, with whole K/V rows of one head in VMEM. Here each
// block owns one (batch*head, 64-row query tile) and stages the scaled q
// tile once; it loops over 64-row K/V tiles in shared memory, keeping m and
// l in shared memory and the f32 output accumulator in registers (a 4 x 4
// register tile per thread for the scores, 4 rows x D/16 columns for the
// accumulator). The ragged edge is masked in the kernel, so nothing is
// padded. No atomics: each block writes only its own rows. At the
// FlexiViT-B shape (B=32, H=12, T=1601) the grid is 384 x 26 blocks.
//
// Bound at that shape in f32: q, k, v read and o written once are 0.63 GB,
// 0.19 ms at 3.35 TB/s; its two products are 4*T^2*D*BH = 2.52e11 FLOP,
// 0.25 ms at the bf16 tensor-core rate (989 TFLOP/s), 3.8 ms at the f32
// rate outside the tensor cores (67 TFLOP/s). The semantics are f32 and
// this version runs scalar f32 FMAs with shared-memory operands, so the
// f32 arithmetic, not the bytes, is its limit; tensor-core MMAs (TF32 or
// split bf16) and a prefetch of the next tile are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // key/value rows per shared-memory tile
constexpr int NT = 256;   // threads: a 16 x 16 grid of 4 x 4 register tiles
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory, in floats: sQ [BQ][DS], sK [BKV][DS], sV [BKV][D],
// sP [BQ][BKV + 1], sM/sL/sAlpha [BQ], then ints sSegQ [BQ], sSegK [BKV].
// DS = D | 1 is odd so that 16 threads reading 16 rows of sK at one column
// hit 16 different banks.
__host__ __device__ inline int row_stride(int d) { return d | 1; }

inline size_t smem_bytes(int d) {
  const int ds = row_stride(d);
  size_t floats = size_t(BQ) * ds + size_t(BKV) * ds + size_t(BKV) * d +
                  size_t(BQ) * (BKV + 1) + 3 * BQ;
  return floats * sizeof(float) + (BQ + BKV) * sizeof(int);
}

// Fills dst[r * stride + d] (r < 64, d < D) with rows r of src (row r at
// src + r * row_elems) as floats times `mul`; rows r >= nrows read as
// zeros. With VEC (D a multiple of the 16-byte vector and 16-byte aligned
// rows), each thread issues up to 4 vector loads before it stores any.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          long long row_elems, int nrows,
                                          int D, int tid, float mul) {
  if (VEC) {
    constexpr int W = 16 / sizeof(T);  // elements per vector
    const int vpr = D / W, total = 64 * vpr;
    for (int base = 0; base < total; base += 4 * NT) {
      uint4 buf[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * NT + tid, r = i / vpr;
        buf[u] = (i < total && r < nrows)
            ? *reinterpret_cast<const uint4*>(src + r * row_elems + (i % vpr) * W)
            : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * NT + tid;
        if (i >= total) break;
        const T* x = reinterpret_cast<const T*>(&buf[u]);
        float* out = dst + (i / vpr) * stride + (i % vpr) * W;
#pragma unroll
        for (int e = 0; e < W; ++e) out[e] = to_f(x[e]) * mul;
      }
    }
  } else {
    for (int i = tid; i < 64 * D; i += NT) {
      const int r = i / D, d = i % D;
      dst[r * stride + d] = r < nrows ? to_f(src[r * row_elems + d]) * mul : 0.f;
    }
  }
}

// MAXC: column groups of 16 per thread in the output accumulator (D <= 16*MAXC).
template <typename T, int MAXC, bool VEC>
__global__ void __launch_bounds__(NT)
flash_blocked_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         const int32_t* __restrict__ seg, float* __restrict__ lse,
                         int Tq, int Tkv, int H, int D, int causal, float scale) {
  extern __shared__ float smem[];
  const int ds = row_stride(D);
  float* sQ = smem;
  float* sK = sQ + BQ * ds;
  float* sV = sK + BKV * ds;
  float* sP = sV + BKV * D;
  float* sM = sP + BQ * (BKV + 1);
  float* sL = sM + BQ;
  float* sAlpha = sL + BQ;
  int* sSegQ = reinterpret_cast<int*>(sAlpha + BQ);
  int* sSegK = sSegQ + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int qn = min(BQ, Tq - q0);
  const long long row_q = (long long)H * D;  // elements between rows of q/o
  const T* qb = q + ((long long)b * Tq * H + h) * D;
  const T* kb = k + ((long long)b * Tkv * H + h) * D;
  const T* vb = v + ((long long)b * Tkv * H + h) * D;
  T* ob = o + ((long long)b * Tq * H + h) * D;

  // q * scale in f32, as the TPU kernel scales q before its product.
  load_tile<T, VEC>(sQ, ds, qb + q0 * row_q, row_q, qn, D, tid, scale);
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
    if (seg) sSegQ[tid] = tid < qn ? seg[(long long)b * Tq + q0 + tid] : 0;
  }

  float acc[4][MAXC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.f;

  int kv_end = Tkv;
  if (causal) kv_end = min(Tkv, q0 + BQ);  // later tiles are fully masked
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    const int kvn = min(BKV, Tkv - kv0);
    __syncthreads();  // previous tile's readers are done with sK/sV/sP
    load_tile<T, VEC>(sK, ds, kb + kv0 * row_q, row_q, kvn, D, tid, 1.f);
    load_tile<T, VEC>(sV, D, vb + kv0 * row_q, row_q, kvn, D, tid, 1.f);
    if (seg && tid < BKV)
      sSegK[tid] = tid < kvn ? seg[(long long)b * Tkv + kv0 + tid] : 0;
    __syncthreads();

    // Scores for rows ty*4+i, columns tx+16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * ds + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * ds + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bool vis = r < qn && c < kvn;
        if (causal) vis = vis && kv0 + c <= q0 + r;
        if (seg) vis = vis && sSegK[c] > 0 && sSegK[c] <= sSegQ[r];
        // -inf marks a masked entry: exp(-inf - m) is exactly 0 below.
        sP[r * (BKV + 1) + c] = vis ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: 4 neighbouring threads per row, 16 columns each.
    {
      const int r = tid / 4, part = tid % 4;
      float* prow = sP + r * (BKV + 1) + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);  // finite: m starts at NEG_INF
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        prow[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v for rows ty*4+i, columns tx+16*c.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) acc[i][c] *= a;
    }
    for (int j = 0; j < kvn; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * (BKV + 1) + j];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          const float vv = sV[j * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }
  __syncthreads();

  if (tid < qn) {
    const float l = sL[tid];
    lse[(long long)bh * Tq + q0 + tid] = sM[tid] + logf(l == 0.f ? 1.f : l);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= qn) continue;
    const float l = sL[r];
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[(q0 + r) * row_q + d] = from_f<T>(acc[i][c] / l_safe);
    }
  }
}

template <typename T, int MAXC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int32_t* seg, float* lse, int B, int Tq, int Tkv,
                   int H, int D, int causal, float scale, cudaStream_t stream) {
  const bool vec = D % (16 / sizeof(T)) == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  auto kern = vec ? flash_blocked_fwd_kernel<T, MAXC, true>
                  : flash_blocked_fwd_kernel<T, MAXC, false>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seg, lse, Tq, Tkv, H, D,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       const int32_t* seg, float* lse, int B, int Tq, int Tkv,
                       int H, int D, int causal, float scale,
                       cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, seg, lse, B, Tq, Tkv, H, D, causal, scale, stream);
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, seg, lse, B, Tq, Tkv, H, D, causal, scale, stream);
  return launch<T, 16>(q, k, v, o, seg, lse, B, Tq, Tkv, H, D, causal, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. seg may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bvt_flash_blocked_fwd(const void* q, const void* k,
                                     const void* v, void* o, const void* seg,
                                     void* lse, int dtype, int B, int Tq,
                                     int Tkv, int H, int D, int causal,
                                     float scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  const int32_t* s = static_cast<const int32_t*>(seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch_d<float>(q, k, v, o, s, l, B, Tq, Tkv, H, D, causal, scale, st); break;
    case 1: err = dispatch_d<__nv_bfloat16>(q, k, v, o, s, l, B, Tq, Tkv, H, D, causal, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
