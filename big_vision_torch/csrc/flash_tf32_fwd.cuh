// The attention forward on Hopper's tensor cores (sm_90a) with 3xTF32
// products (flash_tf32_common.cuh), one template for two kernels: K3
// (flash_blocked_fwd.cu) and K1's f32 kernel (flash_fwd.cu).
//
// What it computes, per (batch, head), all in f32:
//   kBlocked (K3, the TPU kernel `_fwd_kernel`): q, k, v read in their
//       storage dtype (f32 or bf16) and widened; q multiplied by scale as
//       it loads, s = (q * scale) . k^T; o rounded once to q's dtype.
//   kOneShot (K1 for f32, `_oneshot_fwd_kernel` / `_oneshot_softmax`):
//       s = (q . k^T) * scale; f32 in and out.
// Both: the causal (col <= row) and segment (0 < seg[j] <= seg[i]) masks
// and keys past the end excluded before any exponential; an online softmax
// with a running row max m and row sum l; masked p exactly 0; p not
// rounded before p . v; o = acc / l (l = 0 taken as 1); the row
// log-sum-exp m + log(l) in f32. A row with no visible key keeps m = -1e30
// and l = 0 (every tile gives it alpha = exp(m - m) = 1 and p = 0): o = 0
// and lse = -1e30 exactly. m stays in natural units; the exponentials are
// exp2f of s * log2(e) - m * log2(e), one fused multiply-add each.
//
// Layout: q, o [B, Tq, H, D] and k, v [B, Tkv, H, D], contiguous, read in
// place; seg [B, T] int32 or null; lse [B*H, Tq] f32.
//
// Design. One block of 4 warps per (query tile of 64 rows, batch * head),
// the grid's query tiles fastest, so that the blocks of one head run
// together and read its k and v from L2. q (times scale for K3) is loaded
// into shared memory once; key tiles of 64 keys, k and v, stream through
// shared memory in key order, each loaded in turn. Warp w owns query rows
// 16w..16w+15. Per key tile it computes S = q . k^T for its rows with
// `mma3` (q's A fragments from lda_rows, k's B fragments from ldb_rows),
// masks it, takes each row's tile max over the quad (lane (g, t4) holds
// rows g and g + 8, so two shuffles, over lanes 1 and 2 apart), forms p
// in the S fragments and the tile's part of l, sums the tile's p . v from
// zero in registers of its own (p re-laid by `from_c` as A fragments
// against v's B fragments from ldb_cols: the same permuted key order on
// both sides, so nothing is staged), and adds it to o * alpha, alpha =
// exp(m_old - m_new), with one f32 multiply-add per element. o, m and l
// stay in registers over all key tiles (l per lane, summed over the quad
// once at the end), in key order: no atomics, no split of a row's keys
// across blocks, a result that does not depend on the order of blocks.
// Above D = 64 the o sums would pass the registers (128 floats a thread at
// D = 256), so the key loop runs once per 64 columns of o, recomputing S
// and the softmax (the same m and l in every round; the LSE is written in
// the first). Shared memory holds q, k and v tiles of 64 rows even at
// D = 256 (200 KB), so query tiles stay 64 rows at every D. At D = 64 a
// block takes 52 KB of shared memory and 128 registers a thread: four
// blocks an SM.
//
// Choices measured on "NVIDIA H100 80GB HBM3, 700.00 W" (tools/
// tf32_variants.py, PERF.md), each a constant of FwdTiles. Each tile's
// p . v summed apart from o (PV_PER_TILE) ran faster than adding it into
// o's tensor-core sums (5.36-5.43 against 6.05 ms for K3 at seqhw 40),
// and its o error stays flat in T (3.3e-06 against 1.5e-05 at T = 1601).
// Slower: query tiles of 32 rows (two warps per strip, each taking half
// of every key tile's keys, their (o, m, l) combined at the end); loading
// the next key tile into registers while this one computes (TileRegs,
// 255 registers a thread); the warp's split q fragments held in
// registers over the key tiles (241-255).

#pragma once

#include <math.h>

#include "flash_tf32_common.cuh"

namespace bvt_tf32 {

constexpr float NEG_INF = -1e30f;

struct FwdArgs {
  const void *q, *k, *v;  // [B, Tq or Tkv, H, D], contiguous
  const int32_t* seg;     // [B, T] or null
  void* o;                // [B, Tq, H, D]
  float* lse;             // [B*H, Tq]
  int B, Tq, Tkv, H, D, causal, vec;
  float scale;
};

enum class FwdSem { kBlocked, kOneShot };

template <int DP> struct FwdTiles {
  // Query rows of a block, 16 per warp and strip (32: two warps a strip).
  static constexpr int BQ = 64;
  static constexpr int WS = 64 / BQ;            // warps per 16-row strip
  static constexpr int KW = BK / WS;            // a warp's keys of a tile
  static constexpr int DC = DP < 64 ? DP : 64;  // o columns per round
  static constexpr int LD = DP + 4;             // row stride of q, k, v
  static constexpr int LDX = DC + 4;            // row stride of the exchange
  // The next key tile loaded into registers while this one computes.
  static constexpr bool PREFETCH = false;
  // The warp's split q fragments held in registers over the key tiles.
  static constexpr bool HOLD_Q = false;
  // Each key tile's p . v summed from zero apart from o, then added to
  // o * alpha on the CUDA cores (else into o's own tensor-core sums).
  static constexpr bool PV_PER_TILE = true;
  // Floats: q [BQ][LD], k, v [BK][LD]; then ints: seg of the keys.
  static constexpr size_t BYTES = ((BQ + 2 * BK) * LD + BK) * 4;
  static_assert((WS - 1) * BQ * LDX <= BK * LD, "the exchange fits in sK");
  static_assert(!(PREFETCH && DP > 64) && !(HOLD_Q && DP > 64),
                "registers: loads ahead and held q up to D = 64 only");
};

template <typename T, int DP, FwdSem SEM>
__global__ void __launch_bounds__(NT) fwd_kernel(const FwdArgs a) {
  using Tl = FwdTiles<DP>;
  constexpr int BQ = Tl::BQ, WS = Tl::WS, KW = Tl::KW, DC = Tl::DC;
  constexpr int LD = Tl::LD, LDX = Tl::LDX;
  constexpr int KD = DP / 8;   // k steps over D
  constexpr int NJ = KW / 8;   // 8-key tiles of a warp's S
  constexpr int NC = DC / 8;   // 8-column tiles of an o round
  constexpr bool ONE_SHOT = SEM == FwdSem::kOneShot;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  int* sSegK = reinterpret_cast<int*>(sV + BK * LD);

  const int tid = threadIdx.x, w = tid >> 5;
  const Lane l(tid & 31);
  const int nq = (a.Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const int b = bh / a.H, h = bh % a.H;
  const int m0 = 16 * (w / WS), j0 = KW * (w % WS);  // the warp's rows, keys
  const long long row = (long long)a.H * a.D;
  const long long qoff = ((long long)b * a.Tq * a.H + h) * a.D;
  const long long koff = ((long long)b * a.Tkv * a.H + h) * a.D;
  const T* kb = static_cast<const T*>(a.k) + koff;
  const T* vb = static_cast<const T*>(a.v) + koff;
  const int32_t* segk = a.seg ? a.seg + (long long)b * a.Tkv : nullptr;
  const bool vec = a.vec;
  // K3: q * scale as it loads; K1: s = (q . k^T) * scale.
  const float q_mul = ONE_SHOT ? 1.f : a.scale;
  const float s_mul = ONE_SHOT ? a.scale : 1.f;

  load_tile<T, BQ, DP>(sQ, static_cast<const T*>(a.q) + qoff, row, q0, a.Tq,
                       a.D, q_mul, vec, tid);
  // The lane's rows m0 + g and m0 + g + 8, and their segments.
  int qi[2], sq[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    qi[hf] = q0 + m0 + l.g + 8 * hf;
    sq[hf] = a.seg && qi[hf] < a.Tq ? a.seg[(long long)b * a.Tq + qi[hf]] : 0;
  }
  // With causal, key tiles past the tile's last row see none of its rows.
  const int kv_end = a.causal ? min(a.Tkv, q0 + BQ) : a.Tkv;

  for (int c0 = 0; c0 < DP; c0 += DC) {
    float acc[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, ls[2] = {0.f, 0.f};
    TileRegs<T, BK, DP> fk, fv;
    if (Tl::PREFETCH) {
      fk.fetch(kb, row, 0, a.Tkv, a.D, vec, tid);
      fv.fetch(vb, row, 0, a.Tkv, a.D, vec, tid);
    }
    FragA qf[Tl::HOLD_Q ? KD : 1];

    for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
      __syncthreads();  // the previous key tile's readers are done
      if (Tl::PREFETCH) {
        fk.store(sK, 1.f, tid);
        fv.store(sV, 1.f, tid);
      } else {
        load_tile<T, BK, DP>(sK, kb, row, kv0, a.Tkv, a.D, 1.f, vec, tid);
        load_tile<T, BK, DP>(sV, vb, row, kv0, a.Tkv, a.D, 1.f, vec, tid);
      }
      if (segk && tid < BK)
        sSegK[tid] = kv0 + tid < a.Tkv ? segk[kv0 + tid] : 0;
      __syncthreads();
      if (Tl::PREFETCH && kv0 + BK < kv_end) {
        fk.fetch(kb, row, kv0 + BK, a.Tkv, a.D, vec, tid);
        fv.fetch(vb, row, kv0 + BK, a.Tkv, a.D, vec, tid);
      }

      // S = q . k^T for the warp's rows and keys.
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (Tl::HOLD_Q) {
        if (kv0 == 0) {
#pragma unroll
          for (int kd = 0; kd < KD; ++kd)
            qf[kd] = lda_rows(sQ, LD, m0, 8 * kd, l);
        }
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma3(s[j], qf[kd], ldb_rows(sK + j0 * LD, LD, 8 * j, 8 * kd, l));
      } else {
#pragma unroll 2
        for (int kd = 0; kd < KD; ++kd) {
          const FragA x = lda_rows(sQ, LD, m0, 8 * kd, l);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma3(s[j], x, ldb_rows(sK + j0 * LD, LD, 8 * j, 8 * kd, l));
        }
      }

      // Masked scores to -inf (rows past Tq hold zero q and are never
      // written); each row's tile max over the quad.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1, kl = j0 + 8 * j + 2 * l.t4 + (e & 1);
          const int ki = kv0 + kl;
          bool vis = ki < a.Tkv;
          if (a.causal) vis = vis && ki <= qi[hf];
          if (segk) vis = vis && sSegK[kl] > 0 && sSegK[kl] <= sq[hf];
          s[j][e] = vis ? s[j][e] * s_mul : -INFINITY;
          mx[hf] = fmaxf(mx[hf], s[j][e]);
        }
      float alpha[2], ml[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m[hf], mx[hf]);  // -1e30 until a key is seen
        alpha[hf] = exp2f((m[hf] - m_new) * LOG2E);
        m[hf] = m_new;
        ml[hf] = m_new * LOG2E;
      }
      // p into s (exp2f(-inf) = 0 where masked); the lane's part of l, the
      // tile's sum added once (not each p into the running sum).
      float ts[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[j][e], LOG2E, -ml[e >> 1]));
          ts[e >> 1] += p;
          s[j][e] = p;
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) ls[hf] = fmaf(ls[hf], alpha[hf], ts[hf]);
      // dst += p . v over the warp's keys (permuted alike in p's A
      // fragments and v's B fragments), columns c0..c0+DC-1.
      auto add_pv = [&](float (&dst)[NC][4]) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const FragA pa = from_c(s[j]);
#pragma unroll
          for (int n = 0; n < NC; ++n)
            mma3(dst[n], pa, ldb_cols(sV, LD, j0 + 8 * j, c0 + 8 * n, l));
        }
      };
      if constexpr (Tl::PV_PER_TILE) {
        float pv[NC][4];
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
        add_pv(pv);
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
      } else {
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
        add_pv(acc);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      ls[hf] += __shfl_xor_sync(0xffffffffu, ls[hf], 1);
      ls[hf] += __shfl_xor_sync(0xffffffffu, ls[hf], 2);
    }

    // With several warps per strip, the later key halves' (o, m, l) go
    // through shared memory (k's tile) to the first warp of the strip,
    // which combines them in key order.
    if (WS > 1) {
      __syncthreads();  // every warp's products are done with sK
      if (w % WS != 0) {
        float* x = sK + ((w % WS - 1) * BQ + m0 + l.g) * LDX + 2 * l.t4;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          *reinterpret_cast<float2*>(x + 8 * n) =
              make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(x + 8 * LDX + 8 * n) =
              make_float2(acc[n][2], acc[n][3]);
        }
        if (l.t4 == 0) {
          x[DC] = m[0], x[DC + 1] = ls[0];
          x[8 * LDX + DC] = m[1], x[8 * LDX + DC + 1] = ls[1];
        }
      }
      __syncthreads();
      if (w % WS != 0) continue;
#pragma unroll
      for (int u = 1; u < WS; ++u) {
        const float* x = sK + ((u - 1) * BQ + m0 + l.g) * LDX;
        float a0[2], a1[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float mu = x[8 * LDX * hf + DC], lu = x[8 * LDX * hf + DC + 1];
          const float m_new = fmaxf(m[hf], mu);
          a0[hf] = exp2f((m[hf] - m_new) * LOG2E);
          a1[hf] = exp2f((mu - m_new) * LOG2E);
          ls[hf] = ls[hf] * a0[hf] + lu * a1[hf];
          m[hf] = m_new;
        }
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = acc[n][e] * a0[e >> 1] +
                        x[8 * LDX * (e >> 1) + 8 * n + 2 * l.t4 + (e & 1)] *
                            a1[e >> 1];
      }
    }

    // o of rows m0 + g and m0 + g + 8, columns of the round; the LSE once.
    float lsafe[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) lsafe[hf] = ls[hf] == 0.f ? 1.f : ls[hf];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, d = c0 + 8 * n + 2 * l.t4 + (e & 1);
        if (qi[hf] < a.Tq && d < a.D)
          static_cast<T*>(a.o)[qoff + qi[hf] * row + d] =
              from_f<T>(acc[n][e] / lsafe[hf]);
      }
    if (c0 == 0 && l.t4 == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (qi[hf] < a.Tq)
          a.lse[(long long)bh * a.Tq + qi[hf]] = m[hf] + logf(lsafe[hf]);
    }
  }
}

template <typename T, int DP, FwdSem SEM>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  auto kern = fwd_kernel<T, DP, SEM>;
  const int smem = (int)FwdTiles<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // One dimension, query tiles fastest: B * H may pass the grid's 65535
  // limit on y.
  const long long nq = (a.Tq + FwdTiles<DP>::BQ - 1) / FwdTiles<DP>::BQ;
  const long long blocks = nq * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// By D padded (32, 64, 128 or 256); `vec` set from the pointers and D.
template <typename T, FwdSem SEM>
cudaError_t dispatch_fwd(FwdArgs a, cudaStream_t stream) {
  a.vec = vec_ok<T>(a.D, {a.q, a.k, a.v});
  switch (dpad(a.D)) {
    case 32: return launch_fwd<T, 32, SEM>(a, stream);
    case 64: return launch_fwd<T, 64, SEM>(a, stream);
    case 128: return launch_fwd<T, 128, SEM>(a, stream);
    default: return launch_fwd<T, 256, SEM>(a, stream);
  }
}

}  // namespace bvt_tf32
