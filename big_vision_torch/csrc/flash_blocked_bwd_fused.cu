// Fused blocked attention backward on Hopper's tensor cores (sm_90a), K5:
// the port of the TPU kernel `_bwd_fused_kernel` in
// big_vision_tpu/ops/flash_attention.py (launched by `_bwd_fused`, taken by
// `_bwd` when FUSED_BLOCKED_BWD is set and `fused_bwd_fits` holds), the
// one-recompute alternative to K4a + K4b (csrc/flash_blocked_bwd.cu).
//
// What it computes, per (batch, head), all in f32 as the TPU body does after
// its casts, with the forward's masks (causal: col <= row; segment:
// 0 < seg[j] <= seg[i]; rows and columns past the end), one key tile at a
// time:
//   s     = (q * scale) . k^T
//   p     = exp(s - lse) where visible, exactly 0 where masked
//   dp    = do . v^T
//   ds    = p * (dp - delta)
//   dv    = p^T . do,  dk = ds^T . (q * scale)   written in k's, v's dtypes
//   dq   += (ds . k) * scale                      per key tile, in f32
// and dq is rounded once to q's dtype. The TPU kernel sums its revisited f32
// accumulator over kv grid blocks of `block_kv` keys in order. Here a chunk
// of `kt_per_block` key tiles of 64 keys sums its tiles' terms in order
// into its own part, and the parts are summed in key order
// (`flash_attention_blocked_bwd_fused_reference` groups its sums alike).
// Scores and dp are computed once per (query tile, key tile) pair: five
// products (10 T^2 D per head) where K4a + K4b take seven. lse is K3's row
// log-sum-exp and delta = rowsum(do . o) comes from the wrapper (a torch
// op, as the JAX package computes it outside Pallas). A row with no visible
// key has lse = -1e30, so the mask is applied before any product: its dq,
// and dk, dv of a key no row sees, are exactly 0.
//
// Layout: q, do, dq [B, Tq, H, D] and k, v, dk, dv [B, Tkv, H, D],
// contiguous, f32 or bf16, read in place; lse and delta [B*H, Tq] f32; seg
// [B, T] int32 or null. Scratch from the wrapper: dq_parts
// [chunks, B*H, Tq, dpad(D)] f32.
//
// Design: the backward pass of flash_tf32_common.cuh with K5's semantics
// (`bwd_kv_kernel<T, DP, Sem::kFused>`, then `dq_reduce_kernel`): a block
// of 4 warps per (batch*head, chunk of key tiles), dk and dv summed in
// registers over the query tiles, ds staged in shared memory for ds.k,
// every product f32 to about 2^-20 as three TF32 products on the tensor
// cores. bf16 inputs are converted to f32 as the tiles load and take the
// same three products: q * scale, p and ds are not exact in TF32, so no
// product is skipped.
//
// Bound at the FlexiViT-B shape of seqhw 40 (B=32, H=12, T=1601, D=64) in
// f32: q, k, v, do read and dq, dk, dv written once are 1.1 GB, 0.34 ms at
// 3.35 TB/s; the five products are 6.30e11 FLOP, three TF32 products each:
// 3.82 ms at 495 TFLOP/s, which bounds it (9.40 ms at the 67 TFLOP/s of
// scalar f32 FMAs). The scalar kernel this replaces ran at 44.8 ms, held
// back by scalar FMAs with shared-memory operands, by one block per head
// (384 blocks, two per SM: 1.45 waves on 132 SMs), and by a dq scratch
// read and written once per pair of tiles. Here the products run on
// `mma.sync`, the wrapper spreads each head's key tiles over several
// blocks (9 chunks of 3 key tiles at that shape: 3456 blocks, three per
// SM), and dq is summed per pair in registers: each pair reads and writes
// the chunk's part once per query tile, most of it from L2, and the parts
// ([chunks, B*H, Tq, 64] f32, 157 MB per chunk at that shape) are written
// once and read once by the reduction.

#include "flash_tf32_common.cuh"

using namespace bvt_tf32;

// K5: dq, dk and dv. dtype: 0 = float32, 1 = bfloat16. seg may be null;
// dq_parts is the [ceil(ceil(Tkv / 64) / kt_per_block), B*H, Tq, dp] f32
// scratch, with dp the D padded as the kernels pad it (32, 64, 128 or 256).
// Returns the first CUDA error of the two launches (0 on success).
extern "C" int bvt_flash_blocked_bwd_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dq, void* dk,
    void* dv, void* dq_parts, int dtype, int B, int Tq, int Tkv, int H, int D,
    int causal, float scale, int kt_per_block, int dp, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1 ||
      kt_per_block < 1 || dp != dpad(D))
    return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), nullptr,
            static_cast<const int32_t*>(seg), dq, dk, dv,
            static_cast<float*>(dq_parts), B, Tq, Tkv, H, D, causal,
            kt_per_block, 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      a.vec = vec_ok<float>(a);
      return (int)dispatch_bwd<float, Sem::kFused>(a, st);
    case 1:
      a.vec = vec_ok<__nv_bfloat16>(a);
      return (int)dispatch_bwd<__nv_bfloat16, Sem::kFused>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
