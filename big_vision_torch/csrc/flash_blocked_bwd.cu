// Blocked attention backward for Hopper (sm_90a), two kernels: the ports of
// the TPU kernels `_bwd_dq_kernel` (K4a) and `_bwd_dkv_kernel` (K4b) in
// big_vision_tpu/ops/flash_attention.py (both launched by `_bwd`), the
// gradient of K3 (csrc/flash_blocked_fwd.cu).
//
// What they compute, per (batch, head), all in f32 as the TPU bodies do
// after their casts, with the forward's masks (causal: col <= row;
// segment: 0 < seg[j] <= seg[i]; rows and columns past the end):
//   s     = (q * scale) . k^T
//   p     = exp(s - lse) where visible, exactly 0 where masked
//   dp    = do . v^T
//   ds    = p * (dp - delta)
//   K4a:  dq = (ds . k) * scale                    written in q's dtype
//   K4b:  dv = p^T . do,  dk = ds^T . (q * scale)  written in k's, v's dtypes
// lse is K3's row log-sum-exp; delta = rowsum(do . o) comes from the
// wrapper (a torch op, as the JAX package computes it outside Pallas). A
// row with no visible key has lse = -1e30, so exp(s - lse) overflows there:
// the mask is applied explicitly, as the TPU kernels' jnp.where does, and a
// masked entry never enters a product. dq of such a row and dk, dv of a key
// no row sees are exactly 0.
//
// Layout: q, do, dq [B, Tq, H, D] and k, v, dk, dv [B, Tkv, H, D],
// contiguous, read in place; lse and delta [B*H, Tq] f32; seg [B, T] int32
// or null.
//
// Design. The TPU kernels hold one head's whole K/V (K4a) or Q/dO (K4b) in
// VMEM and loop over 128-row blocks. Here K4a gives each block one
// (batch*head, query tile) and loops over key tiles, summing dq in
// registers; K4b gives each block one (batch*head, key tile) and loops over
// query tiles, summing dk and dv in registers. Tiles are BR = 64 rows up to
// D = 128 and 32 rows above, so that four [BR, D] f32 tiles fit a block's
// shared memory. Each block writes only its own rows, so there are no
// atomics and the result does not depend on the order of blocks. dq is
// written once, in q's dtype, with no f32 accumulator across blocks. With
// causal both skip tiles that lie wholly above the diagonal. At the
// FlexiViT-B shape (B=32, H=12, T=1601) each grid is 384 x 26 blocks.
//
// Bound at that shape in f32: q, k, v, do read and their gradients written
// once are about 0.6 GB each way, 0.2-0.3 ms at 3.35 TB/s; K4a's three
// products are 3.78e11 FLOP and K4b's four 5.04e11, 0.38 and 0.51 ms at the
// bf16 tensor-core rate (989 TFLOP/s), 5.6 and 7.5 ms at the f32 rate
// outside the tensor cores (67 TFLOP/s). The semantics are f32 and this
// version runs scalar f32 FMAs with shared-memory operands, so the f32
// arithmetic is its limit; tensor-core MMAs are later work.

#include "flash_blocked_common.cuh"

namespace {

using namespace bvt_blocked_bwd;

// K4a. MAXC: column groups of 16 per thread in the dq sums (D <= 16 * MAXC).
template <typename T, int BR, int MAXC, bool VEC>
__global__ void __launch_bounds__(NT) flash_blocked_dq_kernel(Args a) {
  extern __shared__ float smem[];
  using Tl = Tiles<T, BR, VEC>;
  constexpr int RI = Tl::RI, PS = Tl::PS;
  Tl t(smem, a, blockIdx.x);
  const int q0 = blockIdx.y * BR;
  const int qn = min(BR, a.Tq - q0);
  t.load_q(q0, qn);

  float acc[RI][MAXC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[i][c] = 0.f;

  // With causal, key tiles past the last row of this tile are fully masked.
  const int kv_end = a.causal ? min(a.Tkv, q0 + qn) : a.Tkv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BR) {
    const int kvn = min(BR, a.Tkv - kv0);
    __syncthreads();  // the previous key tile's readers are done
    t.load_kv(kv0, kvn);
    __syncthreads();
    float p[RI][RI], dsv[RI][RI];
    t.probs(q0, qn, kv0, kvn, p, dsv);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j)
        t.sdS[(t.ty * RI + i) * PS + t.tx + 16 * j] = dsv[i][j];
    __syncthreads();

    // dq += ds . k for query rows ty*RI+i, columns tx+16*c.
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
          for (int i = 0; i < RI; ++i) acc[i][c] = fmaf(sv[i], kval, acc[i][c]);
        }
      }
    }
  }

  T* dqb = static_cast<T*>(a.out_a) + (t.qb - static_cast<const T*>(a.q));
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = t.ty * RI + i;
    if (r >= qn) continue;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int d = t.tx + 16 * c;
      if (d < a.D) dqb[(q0 + r) * t.row + d] = from_f<T>(acc[i][c] * a.scale);
    }
  }
}

// K4b. MAXC: column groups of 16 per thread in the dk and dv sums.
template <typename T, int BR, int MAXC, bool VEC>
__global__ void __launch_bounds__(NT) flash_blocked_dkv_kernel(Args a) {
  extern __shared__ float smem[];
  using Tl = Tiles<T, BR, VEC>;
  constexpr int RI = Tl::RI, PS = Tl::PS;
  Tl t(smem, a, blockIdx.x);
  const int kv0 = blockIdx.y * BR;
  const int kvn = min(BR, a.Tkv - kv0);
  t.load_kv(kv0, kvn);

  float dk_acc[RI][MAXC], dv_acc[RI][MAXC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // With causal, query tiles above the diagonal see none of these keys
  // (query and key tiles start at multiples of BR).
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
  }

  const long long off = t.kb - static_cast<const T*>(a.k);
  T* dkb = static_cast<T*>(a.out_a) + off;
  T* dvb = static_cast<T*>(a.out_b) + off;
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

template <typename T, int BR, int MAXC, bool DQ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool vec = a.D % (16 / sizeof(T)) == 0 &&
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v) |
        reinterpret_cast<uintptr_t>(a.dout)) % 16) == 0;
  void (*kern)(Args);
  if (DQ)
    kern = vec ? flash_blocked_dq_kernel<T, BR, MAXC, true>
               : flash_blocked_dq_kernel<T, BR, MAXC, false>;
  else
    kern = vec ? flash_blocked_dkv_kernel<T, BR, MAXC, true>
               : flash_blocked_dkv_kernel<T, BR, MAXC, false>;
  const size_t smem = smem_bytes(BR, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, ((DQ ? a.Tq : a.Tkv) + BR - 1) / BR);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// 64-row tiles up to D=128; 32-row tiles above, so that four [BR, D] f32
// tiles stay within a block's shared memory.
template <typename T, bool DQ>
cudaError_t dispatch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64, 4, DQ>(a, stream);
  if (a.D <= 128) return launch<T, 64, 8, DQ>(a, stream);
  return launch<T, 32, 16, DQ>(a, stream);
}

template <bool DQ>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* seg, void* out_a,
        void* out_b, int dtype, int B, int Tq, int Tkv, int H, int D,
        int causal, float scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int32_t*>(seg),
         out_a, out_b, B, Tq, Tkv, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<float, DQ>(a, st);
    case 1: return (int)dispatch_d<__nv_bfloat16, DQ>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K4a: dq. dtype: 0 = float32, 1 = bfloat16. seg may be null; out_b is
// unused. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bvt_flash_blocked_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* seg, void* dq, void* out_b,
                                    int dtype, int B, int Tq, int Tkv, int H,
                                    int D, int causal, float scale,
                                    void* stream) {
  return run<true>(q, k, v, dout, lse, delta, seg, dq, out_b, dtype, B, Tq,
                   Tkv, H, D, causal, scale, stream);
}

// K4b: dk and dv. Arguments as bvt_flash_blocked_dq.
extern "C" int bvt_flash_blocked_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* seg, void* dk, void* dv,
                                     int dtype, int B, int Tq, int Tkv, int H,
                                     int D, int causal, float scale,
                                     void* stream) {
  return run<false>(q, k, v, dout, lse, delta, seg, dk, dv, dtype, B, Tq,
                    Tkv, H, D, causal, scale, stream);
}
