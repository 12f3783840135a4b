// Blocked attention forward on Hopper's tensor cores (sm_90a): kernel K3,
// the port of the TPU kernel `_fwd_kernel` in
// big_vision_tpu/ops/flash_attention.py (launched by `_fwd`, call at :163),
// the forward of the JAX package's blocked path (long T).
//
// What it computes, per (batch, head), all in f32 as the TPU body does after
// its casts: q, k, v read in their storage dtype (bf16 or f32) and widened;
// q multiplied by scale before s = q . k^T; the causal (col <= row) and
// segment (0 < seg[j] <= seg[i]) masks and the ragged edge of the last
// tile; an online softmax with a running row max m and row sum l; masked
// entries excluded from the sums explicitly; o = acc / l rounded once to
// q's dtype; the row log-sum-exp m + log(l) (f32). A row with no visible
// key gets o = 0 and lse = -1e30. Unlike the one-shot kernel K1 in bf16
// (csrc/flash_fwd_tc.cu), p is not rounded to v's dtype before p . v.
//
// Layout: q, o [B, Tq, H, D] and k, v [B, Tkv, H, D], contiguous, read in
// place; seg [B, T] int32 or null; lse [B*H, Tq] f32.
//
// The kernel is `fwd_kernel` of flash_tf32_fwd.cuh with the kBlocked
// semantics (its design notes there): the TPU kernel walks 128-row q blocks
// over 128-row kv blocks of a T padded to the block; here a block of 4
// warps owns a 64-row query tile of one head and streams 64-key tiles
// through shared memory, every product f32 to about 2^-20 as three TF32
// products on the tensor cores (flash_tf32_common.cuh), o, m and l in
// registers. bf16 inputs are widened as the tiles load and take the same
// three products (q * scale and p are not exact in TF32). The ragged edge
// is masked in the kernel, so nothing is padded.
//
// Bound at FlexiViT-B's seqhw 40 (B=32, H=12, T=1601, D=64) in f32: q, k,
// v read and o written once are 0.63 GB, 0.19 ms at 3.35 TB/s; its two
// products are 4*T^2*D*BH = 2.52e11 FLOP, 1.53 ms at 495/3 TFLOP/s (three
// TF32 products per f32 product), 3.76 ms at the f32 rate outside the
// tensor cores (67 TFLOP/s): the products bound it (0.48 ms at seqhw 30,
// T=901). The scalar f32 FMAs of the first design, with shared-memory
// operands, ran at 11.31 ms at seqhw 40 on "NVIDIA H100 80GB HBM3,
// 700.00 W"; this kernel at 5.32 ms (PERF.md).

#include "flash_tf32_fwd.cuh"

using namespace bvt_tf32;

// dtype: 0 = float32, 1 = bfloat16. seg may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bvt_flash_blocked_fwd(const void* q, const void* k,
                                     const void* v, void* o, const void* seg,
                                     void* lse, int dtype, int B, int Tq,
                                     int Tkv, int H, int D, int causal,
                                     float scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, static_cast<const int32_t*>(seg), o,
                  static_cast<float*>(lse), B, Tq, Tkv, H, D, causal, 0,
                  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_fwd<float, FwdSem::kBlocked>(a, st);
    case 1: return (int)dispatch_fwd<__nv_bfloat16, FwdSem::kBlocked>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
