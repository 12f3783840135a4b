// One-shot attention forward in f32 on Hopper's tensor cores (sm_90a):
// kernel K1 for f32 inputs, the port of the TPU kernel `_oneshot_fwd_kernel`
// / `_oneshot_softmax` in big_vision_tpu/ops/flash_attention.py (reached
// from `_oneshot_fwd`, call at :315). This file holds only the f32 kernel;
// bf16 inputs take the tensor-core kernel of csrc/flash_fwd_tc.cu, which
// keeps the same contract with p rounded to bf16 before p . v.
//
// What it computes, per (batch, head): s = (q . k^T) * scale in f32, the
// optional causal (col <= row) and segment (0 < seg[j] <= seg[i]) masks,
// softmax in f32, o = (p . v) / l in f32. A row with no visible key emits
// exact zeros (masked entries are excluded from the sum explicitly, so a
// fully masked row never becomes mean(V)). Tq may differ from Tkv; D is a
// runtime value up to 256. It also writes each row's log-sum-exp m + log(l)
// (f32; -1e30 for a row with no visible key), which the backward
// (csrc/flash_bwd.cu) takes.
//
// Layout: q, o [B, Tq, H, D] and k, v [B, Tkv, H, D], f32, contiguous, read
// in place (no transposes around the kernel); seg [B, T] int32 or null; lse
// [B*H, Tq] f32.
//
// The kernel is `fwd_kernel` of flash_tf32_fwd.cuh with the kOneShot
// semantics (its design notes there), the same kernel as K3 with the scale
// applied after q . k^T. The TPU kernel holds whole [T, T] f32 matrices in
// 16 MB of VMEM; at T=256 one such matrix is 256 KB, more than a Hopper
// block's 227 KB of shared memory. So a block of 4 warps owns a 64-row query
// tile of one head, streams 64-key tiles through shared memory and keeps an
// online softmax, every product f32 to about 2^-20 as three TF32 products on
// the tensor cores (flash_tf32_common.cuh), o, m and l in registers;
// m + log l is the log-sum-exp the backward takes.
//
// Bound at FlexiViT-B's seqhw 15 (B*H = 384, T = 226, D = 64, f32): q, k, v
// read and o written once are 89 MB, 0.027 ms at 3.35 TB/s; its two
// products are 5.0 GFLOP, 0.030 ms at 495/3 TFLOP/s (three TF32 products
// per f32 product), which bounds it (0.198 ms at seqhw 24, T = 577). The
// scalar f32 FMAs of the first design ran at 0.2986 ms at seqhw 15 on
// "NVIDIA H100 80GB HBM3, 700.00 W"; this kernel at 0.163 ms (PERF.md).

#include "flash_tf32_fwd.cuh"

using namespace bvt_tf32;

// f32 only. seg may be null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bvt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, const void* seg, void* lse, int B,
                             int Tq, int Tkv, int H, int D, int causal,
                             float scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, static_cast<const int32_t*>(seg), o,
                  static_cast<float*>(lse), B, Tq, Tkv, H, D, causal, 0,
                  scale};
  return (int)dispatch_fwd<float, FwdSem::kOneShot>(
      a, static_cast<cudaStream_t>(stream));
}
