// One-shot attention forward in f32 for Hopper (sm_90a): kernel K1 for f32
// inputs, the port of the TPU kernel `_oneshot_fwd_kernel` /
// `_oneshot_softmax` in big_vision_tpu/ops/flash_attention.py (reached from
// `_oneshot_fwd`). This file holds only the f32 instantiation; bf16 inputs
// take the tensor-core kernel of csrc/flash_fwd_tc.cu, which keeps the same
// contract with p rounded to bf16 before p . v.
//
// What it computes, per (batch, head): s = (q . k^T) * scale in f32, the
// optional causal (col <= row) and segment (0 < seg[j] <= seg[i]) masks,
// softmax in f32, o = (p . v) / l in f32.
// A row with no visible key emits exact zeros (masked entries are excluded
// from the sum explicitly, so a fully masked row never becomes mean(V)).
// Tq may differ from Tkv; D is a runtime value up to 256. It also writes
// each row's log-sum-exp m + log(l) (f32; -1e30 for a row with no visible
// key), which the backward (csrc/flash_bwd.cu) takes.
//
// Layout: q, o [B, Tq, H, D] and k, v [B, Tkv, H, D], f32, contiguous, read in
// place (no transposes around the kernel); seg [B, T] int32 or null; lse
// [B*H, Tq] f32.
//
// Design. The TPU kernel holds whole [T, T] f32 matrices in 16 MB of VMEM;
// at T=256 one such matrix is 256 KB, more than a Hopper block's 227 KB of
// shared memory. So each block owns one (batch*head, 64-row query tile),
// streams 64-row K/V tiles through shared memory, and keeps an online
// softmax: a running f32 row max m and row sum l (in shared memory, sM/sL)
// rescale the f32 output accumulator held in registers; m + log l is the
// log-sum-exp the backward takes. Products are scalar f32 FMAs on a 4x4
// register tile per thread; tile loads are 16-byte vectors when D allows.
// f32 semantics on the tensor cores would need TF32-split or 3xTF32
// products held to the f32 bar, which is later work.
//
// Bound at FlexiViT-B's seqhw 15 (B*H = 384, T = 226, D = 64, f32): q, k, v
// read and o written once are 89 MB, 0.027 ms at 3.35 TB/s; its two
// products are 5.0 GFLOP, 0.075 ms at the f32 rate outside the tensor
// cores (67 TFLOP/s), which bounds it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // key/value rows per shared-memory tile
constexpr int NT = 256;   // threads: a 16 x 16 grid of 4 x 4 register tiles
constexpr float NEG_INF = -1e30f;

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
// src + r * row_elems); rows r >= nrows read as zeros. With VEC (D a
// multiple of the 16-byte vector and 16-byte aligned rows), each thread
// issues up to 4 vector loads before it stores any, so a tile costs few
// memory round trips.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* src,
                                          long long row_elems, int nrows,
                                          int D, int tid) {
  if (VEC) {
    constexpr int W = 4;  // floats per vector
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
        const float* x = reinterpret_cast<const float*>(&buf[u]);
        float* out = dst + (i / vpr) * stride + (i % vpr) * W;
#pragma unroll
        for (int e = 0; e < W; ++e) out[e] = x[e];
      }
    }
  } else {
    for (int i = tid; i < 64 * D; i += NT) {
      const int r = i / D, d = i % D;
      dst[r * stride + d] = r < nrows ? src[r * row_elems + d] : 0.f;
    }
  }
}

// MAXC: column groups of 16 per thread in the output accumulator (D <= 16*MAXC).
template <int MAXC, bool VEC>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const long long row_q = (long long)H * D;  // elements between rows of q/o
  const float* qb = q + ((long long)b * Tq * H + h) * D;
  const float* kb = k + ((long long)b * Tkv * H + h) * D;
  const float* vb = v + ((long long)b * Tkv * H + h) * D;
  float* ob = o + ((long long)b * Tq * H + h) * D;

  load_tile<VEC>(sQ, ds, qb + q0 * row_q, row_q, Tq - q0, D, tid);
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
    if (seg) sSegQ[tid] = (q0 + tid < Tq) ? seg[(long long)b * Tq + q0 + tid] : 0;
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
    load_tile<VEC>(sK, ds, kb + kv0 * row_q, row_q, kvn, D, tid);
    load_tile<VEC>(sV, D, vb + kv0 * row_q, row_q, kvn, D, tid);
    if (seg && tid < BKV)
      sSegK[tid] = (tid < kvn) ? seg[(long long)b * Tkv + kv0 + tid] : 0;
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
      const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = kv0 + c;
        bool vis = c < kvn;
        if (causal) vis = vis && col <= row;
        if (seg) vis = vis && sSegK[c] > 0 && sSegK[c] <= sSegQ[r];
        // -inf marks a masked entry: exp(-inf - m) is exactly 0 below.
        sP[r * (BKV + 1) + c] = vis ? s[i][j] * scale : -INFINITY;
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
        const float p = __expf(prow[c] - m_new);
        sum += p;
        prow[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = __expf(m_old - m_new);
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

  if (tid < BQ && q0 + tid < Tq) {
    const float l = sL[tid];
    lse[(long long)bh * Tq + q0 + tid] = sM[tid] + logf(l == 0.f ? 1.f : l);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Tq) continue;
    const float l = sL[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[(q0 + r) * row_q + d] = acc[i][c] * inv;
    }
  }
}

template <int MAXC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int32_t* seg, float* lse, int B, int Tq, int Tkv,
                   int H, int D, int causal, float scale, cudaStream_t stream) {
  const bool vec = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  auto kern = vec ? flash_fwd_kernel<MAXC, true> : flash_fwd_kernel<MAXC, false>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), seg, lse, Tq, Tkv,
      H, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// f32 only. seg may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bvt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, const void* seg, void* lse, int B,
                             int Tq, int Tkv, int H, int D, int causal,
                             float scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  const int32_t* s = static_cast<const int32_t*>(seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 64)
    err = launch<4>(q, k, v, o, s, l, B, Tq, Tkv, H, D, causal, scale, st);
  else if (D <= 128)
    err = launch<8>(q, k, v, o, s, l, B, Tq, Tkv, H, D, causal, scale, st);
  else
    err = launch<16>(q, k, v, o, s, l, B, Tq, Tkv, H, D, causal, scale, st);
  return (int)err;
}
