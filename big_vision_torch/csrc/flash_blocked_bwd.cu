// Blocked attention backward on Hopper's tensor cores (sm_90a), two kernels:
// the ports of the TPU kernels `_bwd_dq_kernel` (K4a) and `_bwd_dkv_kernel`
// (K4b) in big_vision_tpu/ops/flash_attention.py (both launched by `_bwd`,
// calls at :632 and :653), the gradient of K3 (csrc/flash_blocked_fwd.cu).
//
// What they compute, per (batch, head), all in f32 as the TPU bodies do
// after their casts, with the forward's masks (causal: col <= row;
// segment: 0 < seg[j] <= seg[i]; rows and columns past the end):
//   s     = (q * scale) . k^T
//   p     = exp(s - lse) where visible, exactly 0 where masked
//   dp    = do . v^T
//   ds    = p * (dp - delta)
//   K4a:  dq = (sum over keys of ds . k) * scale   written in q's dtype
//   K4b:  dv = p^T . do,  dk = ds^T . (q * scale)  written in k's, v's dtypes
// lse is K3's row log-sum-exp; delta = rowsum(do . o) comes from the
// wrapper (a torch op, as the JAX package computes it outside Pallas). A
// row with no visible key has lse = -1e30, so exp(s - lse) overflows there:
// the mask is applied before any product, as the TPU kernels' jnp.where
// is. dq of such a row and dk, dv of a key no row sees are exactly 0.
//
// Layout: q, do, dq [B, Tq, H, D] and k, v, dk, dv [B, Tkv, H, D], f32 or
// bf16, contiguous, read in place; lse and delta [B*H, Tq] f32; seg [B, T]
// int32 or null. No scratch.
//
// Bound at the FlexiViT-B shape of seqhw 40 (B=32, H=12, T=1601, D=64) in
// f32: q, k, v, do read and the gradients written once are 0.6-0.8 GB,
// 0.2-0.3 ms at 3.35 TB/s. K4a's three products are 3.78e11 FLOP and K4b's
// four 5.04e11; every product is f32 to about 2^-20 as three TF32 products
// on the tensor cores (flash_tf32_common.cuh), so at 495/3 TFLOP/s they
// take at least 2.29 and 3.05 ms (0.73 and 0.97 ms at seqhw 30, T=901):
// the products bound both. bf16 inputs are converted to f32 as the tiles
// load and take the same three products (q * scale, p and ds are not
// exact in TF32, so none is skipped). The scalar f32 FMAs of the first
// design, with shared-memory operands, ran at 16.32 ms (K4a) and 25.63 ms
// (K4b) at seqhw 40 (PERF.md), 2.9 and 3.4 times their bounds at the 67
// TFLOP/s of f32 outside the tensor cores.
//
// K4b is `bwd_kv_kernel` of flash_tf32_common.cuh with the kDkv semantics:
// one key tile of 64 keys per block, grid (key tiles, B*H) with the key
// tiles fastest (the JAX grid (bh, tkv // block_kv) walks them fastest
// too), dk and dv summed in registers over query tiles of 32 rows, S^T and
// dP^T recomputed per 64 columns of D above D = 64. It leaves out K5's ds
// staging, ds.k products and dq parts, so at D <= 64 a block takes 52 KB
// of shared memory, which would let four blocks share an SM; its 231
// registers a thread (f32, D = 64) hold an SM to two blocks, 8 warps.
// Held to 168 registers for three blocks, it spills and measured slower
// on the H100 (tools/tf32_variants.py).
//
// K4a (`bwd_dq_kernel` below): a block of 4 warps per (query tile, batch *
// head), grid (query tiles, B*H) with the query tiles fastest, so that the
// blocks of one head run together and read its k and v from L2. q * scale,
// do and the rows' lse and delta are loaded once (the statistics into the
// lanes' registers); key tiles of 64 keys stream through shared memory in
// key order, each loaded in turn. Each warp owns 16 query rows and, per
// key tile, computes S = q.k^T and dP = do.v^T for its rows from [row][d]
// tiles, forms p and ds in the C fragments, and adds ds.k to its dq sums
// with ds re-laid as A fragments (no shared memory, no wait on another
// warp). The dq sums stay in registers over all key tiles, in key order:
// no parts, no atomics, no second kernel, a result that does not depend on
// the order of blocks. Above D = 64 the key loop runs once per 64 columns
// of dq, recomputing S and dP. Query tiles are 64 rows up to D = 64 (one
// warp per 16-row strip); above, 32 (two warps per strip, each taking half
// of every key tile's keys, their sums added at the end), so that q, do, k
// and v fit a block's shared memory. At D = 64 a block takes 70 KB of
// shared memory and 168 registers a thread: three blocks an SM. Tiles of
// 32 rows at D = 64, and loading the next key tile into registers while
// this one computes (as K4b does; 32 more registers a thread), measured
// slower on the H100 (tools/tf32_variants.py, PERF.md). With causal, key
// tiles wholly above the diagonal are skipped.

#include "flash_tf32_common.cuh"

namespace {

using namespace bvt_tf32;

template <int DP> struct DqTiles {
  static constexpr int BQ = DP <= 64 ? 64 : 32;  // query rows of a block
  static constexpr int WS = 64 / BQ;             // warps per 16-row strip
  static constexpr int KW = BK / WS;             // a warp's keys of a tile
  static constexpr int DC = DP < 64 ? DP : 64;   // dq columns per round
  static constexpr int LD = DP + 4;              // row stride of q, do, k, v
  static constexpr int LDC = DC + 8;             // row stride of the exchange
  // Floats: q, do [BQ][LD]; k, v [BK][LD]; then ints: seg of the keys.
  static constexpr size_t BYTES = (2 * (BQ + BK) * LD + BK) * 4;
  static_assert((WS - 1) * BQ * LDC <= BK * LD, "the exchange fits in sK");
};

// K4a: dq of query tile blockIdx.x of head blockIdx.y.
template <typename T, int DP>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(const BwdArgs a) {
  using Tl = DqTiles<DP>;
  constexpr int BQ = Tl::BQ, WS = Tl::WS, KW = Tl::KW, DC = Tl::DC;
  constexpr int LD = Tl::LD, LDC = Tl::LDC;
  constexpr int KD = DP / 8;   // k steps over D
  constexpr int NJ = KW / 8;   // 8-key tiles of a warp's S and dP
  constexpr int NC = DC / 8;   // 8-column tiles of a dq round
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  int* sSegK = reinterpret_cast<int*>(sV + BK * LD);

  const int tid = threadIdx.x, w = tid >> 5;
  const Lane l(tid & 31);
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int m0 = 16 * (w / WS), j0 = KW * (w % WS);  // the warp's rows, keys
  const long long row = (long long)a.H * a.D;
  const long long qoff = ((long long)b * a.Tq * a.H + h) * a.D;
  const long long koff = ((long long)b * a.Tkv * a.H + h) * a.D;
  const T* qb = static_cast<const T*>(a.q) + qoff;
  const T* dob = static_cast<const T*>(a.dout) + qoff;
  const T* kb = static_cast<const T*>(a.k) + koff;
  const T* vb = static_cast<const T*>(a.v) + koff;
  const int32_t* segk = a.seg ? a.seg + (long long)b * a.Tkv : nullptr;
  const bool vec = a.vec;

  load_tile<T, BQ, DP>(sQ, qb, row, q0, a.Tq, a.D, a.scale, vec, tid);
  load_tile<T, BQ, DP>(sdO, dob, row, q0, a.Tq, a.D, 1.f, vec, tid);
  // lse * log2(e), delta and seg of the lane's rows m0 + g and m0 + g + 8.
  float lse2[2], dl[2];
  int sq[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + m0 + l.g + 8 * hf;
    const bool in = r < a.Tq;
    lse2[hf] = in ? a.lse[(long long)bh * a.Tq + r] * LOG2E : 0.f;
    dl[hf] = in ? a.delta[(long long)bh * a.Tq + r] : 0.f;
    sq[hf] = in && a.seg ? a.seg[(long long)b * a.Tq + r] : 0;
  }
  // With causal, key tiles past the tile's last row see none of its rows.
  const int kv_end = a.causal ? min(a.Tkv, q0 + BQ) : a.Tkv;

  for (int c0 = 0; c0 < DP; c0 += DC) {
    float acc[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
      __syncthreads();  // the previous key tile's readers are done
      load_tile<T, BK, DP>(sK, kb, row, kv0, a.Tkv, a.D, 1.f, vec, tid);
      load_tile<T, BK, DP>(sV, vb, row, kv0, a.Tkv, a.D, 1.f, vec, tid);
      if (segk && tid < BK)
        sSegK[tid] = kv0 + tid < a.Tkv ? segk[kv0 + tid] : 0;
      __syncthreads();

      // S and dP of the warp's rows and keys; then ds (0 where masked).
      float s[NJ][4], dp[NJ][4];
      strip_products<KD, NJ>(sQ, sK + j0 * LD, sdO, sV + j0 * LD, LD, m0, s,
                             dp, l);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, kl = j0 + 8 * j + 2 * l.t4 + (e & 1);
          const int qi = q0 + m0 + l.g + 8 * hf, ki = kv0 + kl;
          bool vis = qi < a.Tq && ki < a.Tkv;
          if (a.causal) vis = vis && ki <= qi;
          if (segk) vis = vis && sSegK[kl] > 0 && sSegK[kl] <= sq[hf];
          dp[j][e] = vis ? exp2f(s[j][e] * LOG2E - lse2[hf]) *
                               (dp[j][e] - dl[hf])
                         : 0.f;
        }

      // dq += ds . k over the warp's keys (k permuted alike in ds's A
      // fragments and k's B fragments), columns c0..c0+DC-1.
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const FragA da = from_c(dp[j]);
#pragma unroll
        for (int n = 0; n < NC; ++n)
          mma3(acc[n], da, ldb_cols(sK, LD, j0 + 8 * j, c0 + 8 * n, l));
      }
    }

    // With several warps per strip, the sums of the later key halves go
    // through shared memory (k's tile) to the first warp of the strip,
    // which adds them in key order.
    if (WS > 1) {
      __syncthreads();  // every warp's products are done with sK
      if (w % WS != 0) {
        float* x = sK + ((w % WS - 1) * BQ + m0 + l.g) * LDC + 2 * l.t4;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          *reinterpret_cast<float2*>(x + 8 * n) =
              make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(x + 8 * LDC + 8 * n) =
              make_float2(acc[n][2], acc[n][3]);
        }
      }
      __syncthreads();
      if (w % WS != 0) continue;
#pragma unroll
      for (int u = 1; u < WS; ++u) {
        const float* x = sK + ((u - 1) * BQ + m0 + l.g) * LDC + 2 * l.t4;
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] += x[8 * LDC * (e >> 1) + 8 * n + (e & 1)];
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + m0 + l.g + 8 * (e >> 1);
        const int d = c0 + 8 * n + 2 * l.t4 + (e & 1);
        if (r < a.Tq && d < a.D)
          static_cast<T*>(a.dq)[qoff + r * row + d] =
              from_f<T>(acc[n][e] * a.scale);
      }
  }
}

template <typename T, int DP>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  auto kern = bwd_dq_kernel<T, DP>;
  const int smem = (int)DqTiles<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (a.Tq + DqTiles<DP>::BQ - 1) / DqTiles<DP>::BQ;
  kern<<<dim3(nq, a.B * a.H), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool DQ>
cudaError_t dispatch(const BwdArgs& a, cudaStream_t stream) {
  if (!DQ) return dispatch_bwd<T, Sem::kDkv>(a, stream);
  switch (dpad(a.D)) {
    case 32: return launch_dq<T, 32>(a, stream);
    case 64: return launch_dq<T, 64>(a, stream);
    case 128: return launch_dq<T, 128>(a, stream);
    default: return launch_dq<T, 256>(a, stream);
  }
}

template <bool DQ>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* seg, void* out_a,
        void* out_b, int dtype, int B, int Tq, int Tkv, int H, int D,
        int causal, float scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), nullptr,
            static_cast<const int32_t*>(seg), DQ ? out_a : nullptr,
            DQ ? nullptr : out_a, DQ ? nullptr : out_b, nullptr, B, Tq, Tkv,
            H, D, causal, 1, 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      a.vec = vec_ok<float>(a);
      return (int)dispatch<float, DQ>(a, st);
    case 1:
      a.vec = vec_ok<__nv_bfloat16>(a);
      return (int)dispatch<__nv_bfloat16, DQ>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
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
