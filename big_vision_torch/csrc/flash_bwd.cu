// One-shot attention backward in f32 on Hopper's tensor cores (sm_90a):
// kernel K2 for f32 inputs, the port of the TPU kernel `_oneshot_bwd_kernel`
// in big_vision_tpu/ops/flash_attention.py (reached from `_oneshot_bwd`),
// the gradient of K1 (csrc/flash_fwd.cu). bf16 inputs take the kernel of
// csrc/flash_bwd_tc.cu, which keeps the same contract.
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
// (round_v and round_q, the casts to the inputs' dtype, are the identity in
// f32.) The semantics are f32: every product here is f32 to about 2^-20,
// as three TF32 products on the tensor cores (flash_tf32_common.cuh), so
// only the order of the sums differs from the plain version.
//
// Layout: q, do, dq [B, Tq, H, D] and k, v, dk, dv [B, Tkv, H, D], f32,
// contiguous, read in place; lse [B*H, Tq] f32; seg [B, T] int32 or null.
// Scratch from the wrapper: dq_parts [chunks, B*H, Tq, dpad(D)] f32 and row
// statistics [2, B*H, Tq] f32 (delta, then l).
//
// Design: three kernels on the stream.
//   1. `flash_bwd_stats_kernel`, a block of 4 warps per (batch*head, query
//      tile of 64 rows): warp w computes S = q.k^T and dP = do.v^T for rows
//      16w..16w+15 against key tiles streamed through shared memory and
//      sums l and p.dp per row; delta = sum(p.dp) / l and l go to the row
//      statistics.
//   2. `bvt_tf32::bwd_kv_kernel` (flash_tf32_common.cuh), a block per
//      (batch*head, chunk of key tiles): dk and dv summed in registers over
//      the query tiles, ds staged in shared memory for each pair's ds.k,
//      which goes to the chunk's dq part.
//   3. `bvt_tf32::dq_reduce_kernel`: each dq element's parts summed in key
//      order, times scale, rounded once.
// The wrapper chooses the key tiles per block (`kt_per_block`) so that a
// head spreads over several blocks.
//
// Bound at FlexiViT-B's seqhw 15 (B*H=384, T=226, D=64, f32): q, k, v, do
// read and dq, dk, dv written once are 156 MB, 0.046 ms at 3.35 TB/s; the
// five products are 12.6 GFLOP, three TF32 products each: 0.076 ms at 495
// TFLOP/s, which bounds it (0.188 ms at the 67 TFLOP/s of scalar f32 FMAs).
// The first pass's two products add two fifths. The scalar kernel this
// replaces ran at 1.66 ms, held back by scalar FMAs with shared-memory
// operands on 384 blocks (about 2.9 per SM, 4 warps each); here the
// products run on `mma.sync`, and a head's key tiles spread over several
// blocks (1536 at that shape, one key tile each, three per SM), at the
// price of the f32 dq parts (written once and read once, 89 MB at that
// shape) and the reduction. What holds it back now is latency: few warps
// per SM, each splitting its operands and waiting on its own shared loads
// between `mma.sync` chains (see PERF.md).

#include "flash_tf32_common.cuh"

namespace {

using namespace bvt_tf32;

template <int DP> struct StatTiles {
  static constexpr int BQ = 64;  // query rows, 16 per warp
  // Keys per key tile. Up to D = 64 the next key tile loads while this one
  // computes, in 32 registers a thread.
  static constexpr bool PREFETCH = DP <= 64;
  static constexpr int BKS = PREFETCH ? 32 : DP <= 128 ? 64 : 16;
  static constexpr int LD = DP + 4;
  // Floats: q, do [BQ][LD]; k, v [BKS][LD]; then ints: seg of the rows.
  static constexpr size_t BYTES = (2 * (BQ + BKS) * LD + BQ + BKS) * 4;
};

// delta = rowsum(p * dp) / l and l = rowsum(p) of query tile blockIdx.y,
// with p = exp(s * scale - lse) not yet divided by l.
template <int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_stats_kernel(const BwdArgs a, float* __restrict__ delta,
                       float* __restrict__ lsum_out) {
  using St = StatTiles<DP>;
  constexpr int BQ = St::BQ, BKS = St::BKS, LD = St::LD;
  constexpr int KD = DP / 8, NJ = BKS / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BKS * LD;
  int* sSegQ = reinterpret_cast<int*>(sV + BKS * LD);
  int* sSegK = sSegQ + BQ;

  const int tid = threadIdx.x, w = tid >> 5;
  const Lane l(tid & 31);
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * BQ;
  const long long row = (long long)a.H * a.D;
  const float* qb = static_cast<const float*>(a.q) + ((long long)b * a.Tq * a.H + h) * a.D;
  const float* dob = static_cast<const float*>(a.dout) + ((long long)b * a.Tq * a.H + h) * a.D;
  const long long koff = ((long long)b * a.Tkv * a.H + h) * a.D;
  const float* kb = static_cast<const float*>(a.k) + koff;
  const float* vb = static_cast<const float*>(a.v) + koff;
  const int32_t* segq = a.seg ? a.seg + (long long)b * a.Tq : nullptr;
  const int32_t* segk = a.seg ? a.seg + (long long)b * a.Tkv : nullptr;
  const bool vec = a.vec;

  load_tile<float, BQ, DP>(sQ, qb, row, q0, a.Tq, a.D, 1.f, vec, tid);
  load_tile<float, BQ, DP>(sdO, dob, row, q0, a.Tq, a.D, 1.f, vec, tid);
  if (segq && tid < BQ) sSegQ[tid] = q0 + tid < a.Tq ? segq[q0 + tid] : 0;
  const float s_mul = a.scale * LOG2E;
  float lse2[2], lsum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + 16 * w + l.g + 8 * hf;
    lse2[hf] = r < a.Tq ? a.lse[(long long)bh * a.Tq + r] * LOG2E : 0.f;
  }
  const int kv_end = a.causal ? min(a.Tkv, q0 + BQ) : a.Tkv;
  TileRegs<float, BKS, DP> fk, fv;
  if (St::PREFETCH) {
    fk.fetch(kb, row, 0, a.Tkv, a.D, vec, tid);
    fv.fetch(vb, row, 0, a.Tkv, a.D, vec, tid);
  }
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKS) {
    __syncthreads();  // the previous key tile's readers are done
    if (St::PREFETCH) {
      fk.store(sK, 1.f, tid);
      fv.store(sV, 1.f, tid);
    } else {
      load_tile<float, BKS, DP>(sK, kb, row, kv0, a.Tkv, a.D, 1.f, vec, tid);
      load_tile<float, BKS, DP>(sV, vb, row, kv0, a.Tkv, a.D, 1.f, vec, tid);
    }
    if (segk && tid < BKS)
      sSegK[tid] = kv0 + tid < a.Tkv ? segk[kv0 + tid] : 0;
    __syncthreads();
    if (St::PREFETCH && kv0 + BKS < kv_end) {
      fk.fetch(kb, row, kv0 + BKS, a.Tkv, a.D, vec, tid);
      fv.fetch(vb, row, kv0 + BKS, a.Tkv, a.D, vec, tid);
    }
    float s[NJ][4], dp[NJ][4];
    strip_products<KD, NJ>(sQ, sK, sdO, sV, LD, 16 * w, s, dp, l);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const int ql = 16 * w + l.g + 8 * hf, kl = 8 * j + 2 * l.t4 + (e & 1);
        const int qi = q0 + ql, ki = kv0 + kl;
        bool vis = qi < a.Tq && ki < a.Tkv;
        if (a.causal) vis = vis && ki <= qi;
        if (segk) vis = vis && sSegK[kl] > 0 && sSegK[kl] <= sSegQ[ql];
        if (vis) {
          const float p = exp2f(s[j][e] * s_mul - lse2[hf]);
          lsum[hf] += p;
          dsum[hf] = fmaf(p, dp[j][e], dsum[hf]);
        }
      }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      lsum[hf] += __shfl_xor_sync(0xffffffffu, lsum[hf], off);
      dsum[hf] += __shfl_xor_sync(0xffffffffu, dsum[hf], off);
    }
    const int r = q0 + 16 * w + l.g + 8 * hf;
    if (l.t4 == 0 && r < a.Tq) {
      // A row with no visible key keeps p = 0: l = 1 avoids 0 / 0.
      const float lr = lsum[hf] > 0.f ? lsum[hf] : 1.f;
      delta[(long long)bh * a.Tq + r] = dsum[hf] / lr;
      lsum_out[(long long)bh * a.Tq + r] = lr;
    }
  }
}

template <int DP>
cudaError_t launch_stats(const BwdArgs& a, float* delta, float* lsum,
                         cudaStream_t stream) {
  auto kern = flash_bwd_stats_kernel<DP>;
  const int smem = (int)StatTiles<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Tq + StatTiles<DP>::BQ - 1) / StatTiles<DP>::BQ);
  kern<<<grid, NT, smem, stream>>>(a, delta, lsum);
  return cudaGetLastError();
}

}  // namespace

// f32 only. seg may be null. dq_parts [ceil(ceil(Tkv / 64) / kt_per_block),
// B*H, Tq, dp] and stats [2, B*H, Tq] are f32 scratch, written before they
// are read; dp must be D padded as the kernels pad it (32, 64, 128 or 256).
// Returns the first CUDA error of the three launches (0 on success).
extern "C" int bvt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* seg, void* dq, void* dk, void* dv,
                             void* dq_parts, void* stats, int B, int Tq,
                             int Tkv, int H, int D, int causal, float scale,
                             int kt_per_block, int dp, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1 ||
      kt_per_block < 1 || dp != dpad(D))
    return (int)cudaErrorInvalidValue;
  float* delta = static_cast<float*>(stats);
  float* lsum = delta + (long long)B * H * Tq;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), delta, lsum,
            static_cast<const int32_t*>(seg), dq, dk, dv,
            static_cast<float*>(dq_parts), B, Tq, Tkv, H, D, causal,
            kt_per_block, 0, scale};
  a.vec = vec_ok<float>(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dp) {
    case 32: err = launch_stats<32>(a, delta, lsum, st); break;
    case 64: err = launch_stats<64>(a, delta, lsum, st); break;
    case 128: err = launch_stats<128>(a, delta, lsum, st); break;
    default: err = launch_stats<256>(a, delta, lsum, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_bwd<float, Sem::kOneShot>(a, st);
}
