// Tensor-core building blocks shared by the one-shot attention kernels in
// bf16 on Hopper (sm_90a): K1's forward (flash_fwd_tc.cu) and K2's
// backward (flash_bwd_tc.cu). Both run blocks of 4 warps over tiles of 64
// rows held in shared memory as bf16, with rows padded by 8 halves (so
// that the 8 rows an `ldmatrix` reads hit distinct banks) and D
// zero-padded to Dp, a multiple of 16 (the zeros change no product).
//
//   cp_async16 / cp_async_commit / cp_async_wait  16-byte `cp.async.cg`
//       copies from device to shared memory, zero-filling what lies past
//       the end;
//   ldsm_x4 / ldsm_x4_t   `ldmatrix` of four 8 x 8 bf16 matrices, plain and
//       transposed, at the per-lane addresses a_off / b_off give;
//   mma                   c += a . b on `mma.sync.m16n8k16`, bf16 operands,
//       f32 sums;
//   pack_bf16             two f32 rounded to a bf16 pair: a C fragment
//       re-laid as an A fragment;
//   load_tile             the copies of a 64 x Dp tile of a [*, D] head.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // 4 warps
constexpr int BT = 64;    // rows of a query or key tile
constexpr float LOG2E = 1.4426950408889634f;

// D zero-padded: 64, 80, 128 or 256.
inline int dpad(int d) { return d <= 64 ? 64 : d <= 80 ? 80 : d <= 128 ? 128 : 256; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
// without reading `src`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b on a 16 x 8 x 16 tile: bf16 operands, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Per-lane offsets (in elements) of the 8-row addresses that `ldmatrix.x4`
// takes, for a tile with row stride ld:
//   a_off: a 16 x 16 A operand stored [m][k] (non-trans), or a pair of
//          8-column B operands stored [k][n] (.trans);
//   b_off: a pair of 8-column B operands stored [n][k] (non-trans), or a
//          16 x 16 A operand stored [k][m] (.trans).
__device__ __forceinline__ int a_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// Issues the copies of rows [r0, r0 + min(BT, nrows - r0)) of a [*, D]
// head (rows `row` elements apart) into a BT x DP tile; rows past nrows and
// columns past D read as zeros. VEC: 16-byte copies (D % 8 == 0, aligned);
// otherwise plain element loads.
template <int DP, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* head,
                                          long long row, int r0, int nrows,
                                          int D, int tid) {
  constexpr int LD = DP + 8;
  const int n = min(BT, nrows - r0);
  if (VEC) {
    constexpr int CPR = DP / 8;  // 16-byte chunks per row
#pragma unroll 4
    for (int i = tid; i < BT * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool in = r < n && c < D;
      cp_async16(dst + r * LD + c, in ? head + (r0 + r) * row + c : head,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < BT * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = (r < n && c < D) ? head[(r0 + r) * row + c]
                                         : __float2bfloat16(0.f);
    }
  }
}

}  // namespace
