// Fused blocked attention backward for Hopper (sm_90a), K5: the port of the
// TPU kernel `_bwd_fused_kernel` in big_vision_tpu/ops/flash_attention.py
// (launched by `_bwd_fused`, taken by `_bwd` when FUSED_BLOCKED_BWD is set
// and `fused_bwd_fits` holds), the one-recompute alternative to K4a + K4b
// (csrc/flash_blocked_bwd.cu).
//
// What it computes, per (batch, head), all in f32 as the TPU body does after
// its casts, with the forward's masks (causal: col <= row; segment:
// 0 < seg[j] <= seg[i]; rows and columns past the end), one key tile at a
// time, in key order:
//   s     = (q * scale) . k^T
//   p     = exp(s - lse) where visible, exactly 0 where masked
//   dp    = do . v^T
//   ds    = p * (dp - delta)
//   dv    = p^T . do,  dk = ds^T . (q * scale)   written in k's, v's dtypes
//   dq   += (ds . k) * scale                      per key tile, in f32
// and dq, summed over the key tiles in key order, is rounded once to q's
// dtype. The TPU kernel sums its revisited f32 accumulator over kv grid
// blocks of `block_kv` keys; this kernel's key tiles are its own (BR below),
// so the grouping of the dq sums matches only where the two are equal.
// Scores and dp are computed once per (query tile, key tile) pair: five
// products (10 T^2 D per head) where K4a + K4b take seven. lse is K3's row
// log-sum-exp and delta = rowsum(do . o) comes from the wrapper (a torch
// op, as the JAX package computes it outside Pallas). A row with no visible
// key has lse = -1e30, so the mask is applied before any product: its dq,
// and dk, dv of a key no row sees, are exactly 0.
//
// Layout: q, do, dq [B, Tq, H, D] and k, v, dk, dv [B, Tkv, H, D],
// contiguous, read in place; lse and delta [B*H, Tq] f32; seg [B, T] int32
// or null. Scratch from the wrapper: dq_acc [B*H, Tq, D] f32.
//
// Design. On the TPU the kv grid axis runs in order on one core and dq is
// one VMEM block that every kv step adds into. Hopper runs blocks in
// parallel and in no order, so here one block owns a whole (batch*head) and
// walks its key tiles in order, as K2 (csrc/flash_bwd.cu) does: for each
// key tile it keeps the f32 dk and dv sums in registers and visits every
// query tile, adding that pair's (ds . k) * scale into the f32 scratch
// rows of the query tile. Each thread always owns the same scratch
// elements, so no block or thread shares one: no atomics, and the sums do
// not depend on the order of blocks. A last pass rounds the scratch into
// dq. Tiles are the K4 kernels' (shared header: BR = 64 rows up to D = 128,
// 32 above). With causal, query tiles wholly above the diagonal are
// skipped. At the FlexiViT-B shape (B=32, H=12, T=1601) the grid is 384
// blocks, two per SM (100 KB of shared memory each): 1.45 waves on 132 SMs.
//
// Bound at that shape in f32: q, k, v, do read and dq, dk, dv written once
// are 1.1 GB, 0.34 ms at 3.35 TB/s; the five products are 6.30e11 FLOP,
// 0.64 ms at the bf16 tensor-core rate (989 TFLOP/s), 9.4 ms at the f32
// rate outside the tensor cores (67 TFLOP/s). The semantics are f32 and
// this version runs scalar f32 FMAs with shared-memory operands, so the f32
// arithmetic is its limit; the 157 MB scratch adds a read and a write per
// pair of tiles (8.3 GB at that shape), most of it from L2. Tensor-core
// MMAs and more blocks per head are later work.

#include "flash_blocked_common.cuh"

namespace {

using namespace bvt_blocked_bwd;

// MAXC: column groups of 16 per thread in the dk, dv and dq sums.
template <typename T, int BR, int MAXC, bool VEC>
__global__ void __launch_bounds__(NT) flash_blocked_bwd_fused_kernel(Args a) {
  extern __shared__ float smem[];
  using Tl = Tiles<T, BR, VEC>;
  constexpr int RI = Tl::RI, PS = Tl::PS;
  Tl t(smem, a, blockIdx.x);
  float* acc = a.dq_acc + (long long)blockIdx.x * a.Tq * a.D;
  const long long koff = t.kb - static_cast<const T*>(a.k);
  T* dkb = static_cast<T*>(a.out_a) + koff;
  T* dvb = static_cast<T*>(a.out_b) + koff;

  for (int kv0 = 0; kv0 < a.Tkv; kv0 += BR) {
    const int kvn = min(BR, a.Tkv - kv0);
    __syncthreads();  // the previous key tile's readers are done
    t.load_kv(kv0, kvn);

    float dk_acc[RI][MAXC], dv_acc[RI][MAXC];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < MAXC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

    // With causal, query tiles above the diagonal see none of these keys
    // (query and key tiles start at multiples of BR). The first key tile
    // visits every query tile, so it writes every scratch row.
    for (int q0 = a.causal ? kv0 : 0; q0 < a.Tq; q0 += BR) {
      const int qn = min(BR, a.Tq - q0);
      __syncthreads();  // the previous query tile's readers are done
      t.load_q(q0, qn);
      __syncthreads();
      float p[RI][RI], dsv[RI][RI];
      t.probs(q0, qn, kv0, kvn, p, dsv);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = t.ty * RI + i;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          t.sP[r * PS + t.tx + 16 * j] = p[i][j];
          t.sdS[r * PS + t.tx + 16 * j] = dsv[i][j];
        }
      }
      __syncthreads();

      // dv += p^T . do and dk += ds^T . (q * scale) for key rows ty*RI+i,
      // columns tx+16*c.
      for (int r = 0; r < qn; ++r) {
        float pv[RI], sv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = t.sP[r * PS + t.ty * RI + i];
          sv[i] = t.sdS[r * PS + t.ty * RI + i];
        }
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int d = t.tx + 16 * c;
          if (d < a.D) {
            const float g = t.sdO[r * t.ds + d], x = t.sQ[r * t.ds + d];
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              dv_acc[i][c] = fmaf(pv[i], g, dv_acc[i][c]);
              dk_acc[i][c] = fmaf(sv[i], x, dk_acc[i][c]);
            }
          }
        }
      }

      // This pair's ds . k for query rows ty*RI+i, columns tx+16*c, times
      // scale, into the scratch (written by the first key tile, added by
      // the others, as the TPU kernel zeroes its accumulator at kv step 0).
      float dq[RI][MAXC];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < MAXC; ++c) dq[i][c] = 0.f;
      for (int j = 0; j < kvn; ++j) {
        float sv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) sv[i] = t.sdS[(t.ty * RI + i) * PS + j];
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int d = t.tx + 16 * c;
          if (d < a.D) {
            const float kval = t.sK[j * t.ds + d];
#pragma unroll
            for (int i = 0; i < RI; ++i) dq[i][c] = fmaf(sv[i], kval, dq[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = t.ty * RI + i;
        if (r >= qn) continue;
        float* row = acc + (long long)(q0 + r) * a.D;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int d = t.tx + 16 * c;
          if (d < a.D)
            row[d] = (kv0 == 0 ? 0.f : row[d]) + dq[i][c] * a.scale;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kr = t.ty * RI + i;
      if (kr >= kvn) continue;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int d = t.tx + 16 * c;
        if (d < a.D) {
          dkb[(kv0 + kr) * t.row + d] = from_f<T>(dk_acc[i][c]);
          dvb[(kv0 + kr) * t.row + d] = from_f<T>(dv_acc[i][c]);
        }
      }
    }
  }

  // dq in q's dtype, once: each thread rounds the scratch elements it
  // wrote, so no barrier is needed.
  T* dqb = static_cast<T*>(a.out_c) + (t.qb - static_cast<const T*>(a.q));
  for (int q0 = 0; q0 < a.Tq; q0 += BR) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + t.ty * RI + i;
      if (r >= a.Tq) continue;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int d = t.tx + 16 * c;
        if (d < a.D) dqb[r * t.row + d] = from_f<T>(acc[(long long)r * a.D + d]);
      }
    }
  }
}

template <typename T, int BR, int MAXC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool vec = a.D % (16 / sizeof(T)) == 0 &&
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v) |
        reinterpret_cast<uintptr_t>(a.dout)) % 16) == 0;
  void (*kern)(Args) = vec ? flash_blocked_bwd_fused_kernel<T, BR, MAXC, true>
                           : flash_blocked_bwd_fused_kernel<T, BR, MAXC, false>;
  const size_t smem = smem_bytes(BR, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<a.B * a.H, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// The K4 kernels' tiles: 64 rows up to D=128, 32 above.
template <typename T>
cudaError_t dispatch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64, 4>(a, stream);
  if (a.D <= 128) return launch<T, 64, 8>(a, stream);
  return launch<T, 32, 16>(a, stream);
}

}  // namespace

// K5: dq, dk and dv. dtype: 0 = float32, 1 = bfloat16. seg may be null;
// dq_acc is the [B*H, Tq, D] f32 scratch. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int bvt_flash_blocked_bwd_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dq, void* dk,
    void* dv, void* dq_acc, int dtype, int B, int Tq, int Tkv, int H, int D,
    int causal, float scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int32_t*>(seg),
         dk, dv, B, Tq, Tkv, H, D, causal, scale, dq,
         static_cast<float*>(dq_acc)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(a, st);
    case 1: return (int)dispatch_d<__nv_bfloat16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
