// One-shot attention backward in f32 for Hopper (sm_90a): kernel K2 for f32
// inputs, the port of the TPU kernel `_oneshot_bwd_kernel` in
// big_vision_tpu/ops/flash_attention.py (reached from `_oneshot_bwd`), the
// gradient of K1 (csrc/flash_fwd.cu). bf16 inputs take the tensor-core
// kernel of csrc/flash_bwd_tc.cu, which keeps the same contract.
//
// What it computes, per (batch, head), with the forward's masks (causal:
// col <= row; segment: 0 < seg[j] <= seg[i]; rows and columns past the end):
//   p     = exp(s * scale - lse) / l        normalized probabilities, f32
//           (l = rowsum(exp(s * scale - lse)), 1 up to rounding)
//   dv    = round_v(p)^T . do               f32 sums, stored in v's dtype
//   dp    = do . v^T                        f32
//   delta = rowsum(p * dp)                  f32
//   ds    = round_q(p * (dp - delta))       masked entries exactly 0
//   dq    = ds . k * scale,  dk = ds^T . q * scale
// lse is the row log-sum-exp K1 emits beside o. Dividing by l, as the TPU
// kernel divides by its own row sum, makes each row of p sum to 1 up to
// f32 rounding: K1's lse comes from other exponentials summed in another
// order, and in training a row whose p sums to 1 + e gets
// sum_j ds = -e * delta, which moves dq along the mean key by e * delta
// times |mean key| / |key spread|, large in the ViT. delta is the TPU
// kernel's rowsum(p * dp), not the rowsum(do * o) of blocked flash
// backwards: in training dp - delta cancels to a small fraction of dp, and
// o rounded to bf16 shifts each row's delta by about 2^-9 of do . o, which
// moved the ViT's query-bias gradients by more than their size. A row with
// no visible key gets dq = 0, and a key no row sees gets dk = dv = 0.
//
// Layout: q, do, dq [B, Tq, H, D] and k, v, dk, dv [B, Tkv, H, D],
// contiguous, read in place; lse [B*H, Tq] f32; seg [B, T] int32 or null.
// Scratch from the wrapper: dq_acc [B*H, Tq, D] f32 and row statistics
// [B*H, 2, Tq] f32 (delta, then l).
//
// Design. The TPU kernel holds the whole [T, T] f32 p, dp and ds in VMEM;
// at T=196 one such matrix is 150 KB and three of them exceed a Hopper
// block's 227 KB. So each block owns one (batch*head) and walks it in
// tiles of BR rows. A first pass computes the score and dp tiles of every
// (query tile, key tile) pair and sums l and p * dp for its rows.
// The main pass, for each key tile (outer loop), keeps the f32 dk and dv
// sums in registers and visits every query tile (inner loop), where it
// recomputes the score and dp tiles from q, k, do and v in shared memory.
// dq is summed over key tiles in the f32 scratch, which only this block
// touches (each thread always owns the same elements), so there are no
// atomics and the result does not depend on the order of blocks. With
// causal both passes skip tiles that lie wholly above the diagonal.
// Products are scalar f32 FMAs, as in K1: f32 semantics on the tensor
// cores would need TF32 or split-bf16 products held to the f32 bar, which
// is later work. (round_v and round_q, the casts to the inputs' dtype, are
// the identity in f32.)
//
// Bound at FlexiViT-B's seqhw 15 (B*H=384, T=226, D=64, f32): q, k, v, do
// read and dq, dk, dv written once are 156 MB, 0.046 ms at 3.35 TB/s; its
// five products are 12.6 GFLOP, 0.19 ms at the f32 rate outside the
// tensor cores (67 TFLOP/s), which bounds it; the first pass's two extra
// products add two fifths.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads: a 16 x 16 grid

// Shared memory, in floats: sQ, sdO, sK, sV [BR][DS] each; sP, sdS
// [BR][BR + 1]; sLse, sDelta, sL [BR]; then ints sSegQ, sSegK [BR]. DS = D | 1
// is odd so that 16 threads reading 16 rows at one column hit 16 banks.
__host__ __device__ inline int row_stride(int d) { return d | 1; }

inline size_t smem_bytes(int br, int d) {
  const int ds = row_stride(d);
  size_t floats = 4 * size_t(br) * ds + 2 * size_t(br) * (br + 1) + 3 * br;
  return floats * sizeof(float) + 2 * br * sizeof(int);
}

// Fills dst[r * stride + d] (r < ROWS, d < D) with rows r of src (row r at
// src + r * row_elems); rows r >= nrows read as zeros. With VEC (D a
// multiple of 4 and 16-byte aligned rows) each thread issues up to 4 vector
// loads before it stores any.
template <int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src,
                                          long long row_elems, int nrows,
                                          int D, int tid) {
  if (VEC) {
    constexpr int W = 4;  // elements per vector
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
        // Element stores: the odd row stride leaves rows unaligned.
        const float* x = reinterpret_cast<const float*>(&buf[u]);
        float* out = dst + (i / vpr) * stride + (i % vpr) * W;
#pragma unroll
        for (int e = 0; e < W; ++e) out[e] = x[e];
      }
    }
  } else {
    for (int i = tid; i < ROWS * D; i += NT) {
      const int r = i / D, d = i % D;
      dst[r * stride + d] = r < nrows ? src[r * row_elems + d] : 0.f;
    }
  }
}

// BR: rows of a query or key tile (64 or 32); RI = BR / 16 rows (and score
// columns) per thread. MAXC: column groups of 16 per thread in the dk, dv
// and dq sums (D <= 16 * MAXC).
template <int BR, int MAXC, bool VEC>
__global__ void __launch_bounds__(NT)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const int32_t* __restrict__ seg, float* __restrict__ dq,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dq_acc, float* __restrict__ delta,
                 int Tq, int Tkv, int H, int D, int causal, float scale) {
  constexpr int RI = BR / 16;
  constexpr int PS = BR + 1;  // row stride of sP and sdS
  extern __shared__ float smem[];
  const int ds = row_stride(D);
  float* sQ = smem;
  float* sdO = sQ + BR * ds;
  float* sK = sdO + BR * ds;
  float* sV = sK + BR * ds;
  float* sP = sV + BR * ds;
  float* sdS = sP + BR * PS;
  float* sLse = sdS + BR * PS;
  float* sDelta = sLse + BR;
  float* sL = sDelta + BR;
  int* sSegQ = reinterpret_cast<int*>(sL + BR);
  int* sSegK = sSegQ + BR;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long row = (long long)H * D;  // elements between rows
  const float* qb = q + ((long long)b * Tq * H + h) * D;
  const float* dob = dout + ((long long)b * Tq * H + h) * D;
  const float* kb = k + ((long long)b * Tkv * H + h) * D;
  const float* vb = v + ((long long)b * Tkv * H + h) * D;
  float* dqb = dq + ((long long)b * Tq * H + h) * D;
  float* dkb = dk + ((long long)b * Tkv * H + h) * D;
  float* dvb = dv + ((long long)b * Tkv * H + h) * D;
  float* dqa = dq_acc + (long long)bh * Tq * D;
  float* dl = delta + (long long)bh * 2 * Tq;  // delta [Tq], then l [Tq]
  const float* lseb = lse + (long long)bh * Tq;

  // Loads query tile q0 (q, do, lse, seg) into shared memory.
  auto load_q = [&](int q0, int qn) {
    load_tile<BR, VEC>(sQ, ds, qb + q0 * row, row, qn, D, tid);
    load_tile<BR, VEC>(sdO, ds, dob + q0 * row, row, qn, D, tid);
    if (tid < BR) {
      const bool in = tid < qn;
      sLse[tid] = in ? lseb[q0 + tid] : 0.f;
      if (seg) sSegQ[tid] = in ? seg[(long long)b * Tq + q0 + tid] : 0;
    }
  };
  // Loads key tile kv0 (k, v, seg) into shared memory.
  auto load_kv = [&](int kv0, int kvn) {
    load_tile<BR, VEC>(sK, ds, kb + kv0 * row, row, kvn, D, tid);
    load_tile<BR, VEC>(sV, ds, vb + kv0 * row, row, kvn, D, tid);
    if (seg && tid < BR)
      sSegK[tid] = tid < kvn ? seg[(long long)b * Tkv + kv0 + tid] : 0;
  };
  // p (f32, 0 where masked; divided by sL, which the first pass sets to 1)
  // and dp for the loaded tiles, rows ty*RI+i and columns tx+16*j.
  auto probs = [&](int q0, int qn, int kv0, int kvn, float (&p)[RI][RI],
                   float (&dp)[RI][RI]) {
    float s[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
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
        if (causal) vis = vis && kv0 + c <= q0 + r;
        if (seg) vis = vis && sSegK[c] > 0 && sSegK[c] <= sSegQ[r];
        p[i][j] = vis ? __expf(s[i][j] * scale - sLse[r]) / sL[r] : 0.f;
      }
    }
  };

  // First pass, with p not yet divided by l: l[i] = rowsum(p) and
  // delta[i] = rowsum(p * dp) / l[i], summed in registers over key tiles,
  // then over the 16 threads (tx) that share a row.
  if (tid < BR) sL[tid] = 1.f;
  for (int q0 = 0; q0 < Tq; q0 += BR) {
    const int qn = min(BR, Tq - q0);
    __syncthreads();  // the previous tile's readers are done
    load_q(q0, qn);
    float acc[RI], accl[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) acc[i] = accl[i] = 0.f;
    const int kv_end = causal ? min(Tkv, q0 + qn) : Tkv;
    for (int kv0 = 0; kv0 < kv_end; kv0 += BR) {
      const int kvn = min(BR, Tkv - kv0);
      __syncthreads();
      load_kv(kv0, kvn);
      __syncthreads();
      float p[RI][RI], dp[RI][RI];
      probs(q0, qn, kv0, kvn, p, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          acc[i] = fmaf(p[i][j], dp[i][j], acc[i]);
          accl[i] += p[i][j];
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off, 16);
        accl[i] += __shfl_xor_sync(0xffffffffu, accl[i], off, 16);
      }
      const int r = q0 + ty * RI + i;
      if (tx == 0 && r < Tq) {
        // A row with no visible key keeps p = 0: l = 1 avoids 0 / 0.
        const float l = accl[i] > 0.f ? accl[i] : 1.f;
        dl[r] = acc[i] / l;
        dl[Tq + r] = l;
      }
    }
  }
  // The __syncthreads at the top of the main pass's tile loops make this
  // block's global writes of delta visible to all of its threads.

  for (int kv0 = 0; kv0 < Tkv; kv0 += BR) {
    const int kvn = min(BR, Tkv - kv0);
    __syncthreads();  // the previous key tile's readers are done
    load_kv(kv0, kvn);

    float dk_acc[RI][MAXC], dv_acc[RI][MAXC];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < MAXC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

    // With causal, query tiles above the diagonal see none of these keys
    // (tiles start at multiples of BR on both axes). The first key tile
    // visits every query tile, so it initializes the dq sums.
    for (int q0 = causal ? kv0 : 0; q0 < Tq; q0 += BR) {
      const int qn = min(BR, Tq - q0);
      __syncthreads();  // the previous query tile's readers are done
      load_q(q0, qn);
      if (tid < BR) {
        sDelta[tid] = tid < qn ? dl[q0 + tid] : 0.f;
        sL[tid] = tid < qn ? dl[Tq + q0 + tid] : 1.f;
      }
      __syncthreads();

      float p[RI][RI], dp[RI][RI];
      probs(q0, qn, kv0, kvn, p, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty * RI + i;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int c = tx + 16 * j;
          sP[r * PS + c] = p[i][j];
          sdS[r * PS + c] = p[i][j] * (dp[i][j] - sDelta[r]);
        }
      }
      __syncthreads();

      // dv += p^T . do and dk += ds^T . q for key rows ty*RI+i, columns
      // tx+16*c.
      for (int r = 0; r < qn; ++r) {
        float pv[RI], sv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = sP[r * PS + ty * RI + i];
          sv[i] = sdS[r * PS + ty * RI + i];
        }
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int d = tx + 16 * c;
          if (d < D) {
            const float g = sdO[r * ds + d], x = sQ[r * ds + d];
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              dv_acc[i][c] = fmaf(pv[i], g, dv_acc[i][c]);
              dk_acc[i][c] = fmaf(sv[i], x, dk_acc[i][c]);
            }
          }
        }
      }

      // dq += ds . k for query rows ty*RI+i, columns tx+16*c, summed in
      // this block's f32 scratch; a thread always owns the same elements.
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int d = tx + 16 * c;
        if (d >= D) continue;
        float acc[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i] = 0.f;
        for (int j = 0; j < kvn; ++j) {
          const float kval = sK[j * ds + d];
#pragma unroll
          for (int i = 0; i < RI; ++i)
            acc[i] = fmaf(sdS[(ty * RI + i) * PS + j], kval, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int qrow = q0 + ty * RI + i;
          if (qrow < Tq) {
            float* dst = dqa + (long long)qrow * D + d;
            *dst = kv0 == 0 ? acc[i] : *dst + acc[i];
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kr = kv0 + ty * RI + i;
      if (kr >= Tkv) continue;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) {
          dkb[kr * row + d] = dk_acc[i][c] * scale;
          dvb[kr * row + d] = dv_acc[i][c];
        }
      }
    }
  }

  // dq out of the scratch, by the threads that summed each element.
  for (int q0 = 0; q0 < Tq; q0 += BR) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qrow = q0 + ty * RI + i;
      if (qrow >= Tq) continue;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int d = tx + 16 * c;
        if (d < D)
          dqb[qrow * row + d] = dqa[(long long)qrow * D + d] * scale;
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float* lse;
  const int32_t* seg;
  void *dq, *dk, *dv;
  float *dq_acc, *delta;
  int B, Tq, Tkv, H, D, causal;
  float scale;
};

template <int BR, int MAXC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool vec = a.D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v) |
        reinterpret_cast<uintptr_t>(a.dout)) % 16) == 0;
  auto kern = vec ? flash_bwd_kernel<BR, MAXC, true>
                  : flash_bwd_kernel<BR, MAXC, false>;
  const size_t smem = smem_bytes(BR, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<a.B * a.H, NT, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.seg, static_cast<float*>(a.dq), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.dq_acc, a.delta, a.Tq, a.Tkv, a.H, a.D,
      a.causal, a.scale);
  return cudaGetLastError();
}

}  // namespace

// f32 only. seg may be null. dq_acc [B*H, Tq, D] and delta [B*H, 2, Tq]
// (delta and l per row) are f32 scratch, written before they are read.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bvt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* seg, void* dq, void* dk, void* dv,
                             void* dq_acc, void* delta, int B, int Tq,
                             int Tkv, int H, int D, int causal, float scale,
                             void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const int32_t*>(seg), dq, dk, dv,
         static_cast<float*>(dq_acc), static_cast<float*>(delta),
         B, Tq, Tkv, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 64-row tiles up to D=128; 32-row tiles above, so that four [BR, D] f32
  // tiles stay within a block's shared memory.
  if (D <= 64) return (int)launch<64, 4>(a, st);
  if (D <= 128) return (int)launch<64, 8>(a, st);
  return (int)launch<32, 16>(a, st);
}
