// The tiles and the per-tile arithmetic shared by the blocked attention
// backward kernels K4a and K4b (csrc/flash_blocked_bwd.cu). See that file
// for what each kernel computes and how it is laid out on the card.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace bvt_blocked_bwd {

constexpr int NT = 256;  // threads: a 16 x 16 grid

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

// Shared memory, in floats: sQ, sdO, sK, sV [BR][DS] each; sP, sdS
// [BR][BR + 1]; sLse, sDelta [BR]; then ints sSegQ, sSegK [BR]. DS = D | 1
// is odd so that 16 threads reading 16 rows at one column hit 16 banks.
// K4a leaves sP unused.
__host__ __device__ inline int row_stride(int d) { return d | 1; }

inline size_t smem_bytes(int br, int d) {
  const int ds = row_stride(d);
  size_t floats = 4 * size_t(br) * ds + 2 * size_t(br) * (br + 1) + 2 * br;
  return floats * sizeof(float) + 2 * br * sizeof(int);
}

// Fills dst[r * stride + d] (r < ROWS, d < D) with rows r of src (row r at
// src + r * row_elems) as floats times `mul`; rows r >= nrows read as
// zeros. With VEC (D a multiple of the 16-byte vector and 16-byte aligned
// rows) each thread issues up to 4 vector loads before it stores any.
template <typename T, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          long long row_elems, int nrows,
                                          int D, int tid, float mul) {
  if (VEC) {
    constexpr int W = 16 / sizeof(T);  // elements per vector
    const int vpr = D / W, total = ROWS * vpr;
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
    for (int i = tid; i < ROWS * D; i += NT) {
      const int r = i / D, d = i % D;
      dst[r * stride + d] = r < nrows ? to_f(src[r * row_elems + d]) * mul : 0.f;
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int32_t* seg;
  void *out_a, *out_b;  // K4a: dq; K4b: dk, dv
  int B, Tq, Tkv, H, D, causal;
  float scale;
};

// The shared memory carve-up and the per-tile arithmetic of both kernels.
template <typename T, int BR, bool VEC>
struct Tiles {
  static constexpr int RI = BR / 16;  // rows (and score columns) per thread
  static constexpr int PS = BR + 1;   // row stride of sP and sdS
  Args a;
  int bh, b, ds, tid, ty, tx;
  float *sQ, *sdO, *sK, *sV, *sP, *sdS, *sLse, *sDelta;
  int *sSegQ, *sSegK;
  const T *qb, *dob, *kb, *vb;
  long long row;

  __device__ Tiles(float* smem, const Args& args, int bh_)
      : a(args), bh(bh_) {
    ds = row_stride(a.D);
    sQ = smem;
    sdO = sQ + BR * ds;
    sK = sdO + BR * ds;
    sV = sK + BR * ds;
    sP = sV + BR * ds;
    sdS = sP + BR * PS;
    sLse = sdS + BR * PS;
    sDelta = sLse + BR;
    sSegQ = reinterpret_cast<int*>(sDelta + BR);
    sSegK = sSegQ + BR;
    tid = threadIdx.x;
    ty = tid / 16;
    tx = tid % 16;
    b = bh / a.H;
    const int h = bh % a.H;
    row = (long long)a.H * a.D;
    qb = static_cast<const T*>(a.q) + ((long long)b * a.Tq * a.H + h) * a.D;
    dob = static_cast<const T*>(a.dout) + ((long long)b * a.Tq * a.H + h) * a.D;
    kb = static_cast<const T*>(a.k) + ((long long)b * a.Tkv * a.H + h) * a.D;
    vb = static_cast<const T*>(a.v) + ((long long)b * a.Tkv * a.H + h) * a.D;
  }

  // Query tile q0: q * scale, do, lse, delta and seg into shared memory.
  __device__ void load_q(int q0, int qn) {
    load_tile<T, BR, VEC>(sQ, ds, qb + q0 * row, row, qn, a.D, tid, a.scale);
    load_tile<T, BR, VEC>(sdO, ds, dob + q0 * row, row, qn, a.D, tid, 1.f);
    if (tid < BR) {
      const bool in = tid < qn;
      const long long i = (long long)bh * a.Tq + q0 + tid;
      sLse[tid] = in ? a.lse[i] : 0.f;
      sDelta[tid] = in ? a.delta[i] : 0.f;
      if (a.seg) sSegQ[tid] = in ? a.seg[(long long)b * a.Tq + q0 + tid] : 0;
    }
  }

  // Key tile kv0: k, v and seg into shared memory.
  __device__ void load_kv(int kv0, int kvn) {
    load_tile<T, BR, VEC>(sK, ds, kb + kv0 * row, row, kvn, a.D, tid, 1.f);
    load_tile<T, BR, VEC>(sV, ds, vb + kv0 * row, row, kvn, a.D, tid, 1.f);
    if (a.seg && tid < BR)
      sSegK[tid] = tid < kvn ? a.seg[(long long)b * a.Tkv + kv0 + tid] : 0;
  }

  // p and ds of the loaded tiles for rows ty*RI+i and columns tx+16*j.
  __device__ void probs(int q0, int qn, int kv0, int kvn, float (&p)[RI][RI],
                        float (&dsv)[RI][RI]) {
    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < a.D; ++d) {
      float qv[RI], gv[RI], kv[RI], vv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = sQ[(ty * RI + i) * ds + d];
        gv[i] = sdO[(ty * RI + i) * ds + d];
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        kv[j] = sK[(tx + 16 * j) * ds + d];
        vv[j] = sV[(tx + 16 * j) * ds + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty * RI + i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        bool vis = r < qn && c < kvn;
        if (a.causal) vis = vis && kv0 + c <= q0 + r;
        if (a.seg) vis = vis && sSegK[c] > 0 && sSegK[c] <= sSegQ[r];
        p[i][j] = vis ? expf(s[i][j] - sLse[r]) : 0.f;
        dsv[i][j] = p[i][j] * (dp[i][j] - sDelta[r]);
      }
    }
  }
};

}  // namespace bvt_blocked_bwd
