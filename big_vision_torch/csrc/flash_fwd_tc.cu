// One-shot attention forward in bf16 on Hopper's tensor cores (sm_90a):
// kernel K1 for bf16 inputs, the port of the TPU kernel
// `_oneshot_fwd_kernel` / `_oneshot_softmax` in
// big_vision_tpu/ops/flash_attention.py (reached from `_oneshot_fwd`).
// f32 inputs take the 3xTF32 kernel of csrc/flash_fwd.cu. Per (batch, head):
//   s = q . k^T * scale              f32 sums
//   masks: causal col <= row; segment 0 < seg[j] <= seg[i]; keys and rows
//          past the end
//   p = exp(s - m), masked entries exactly 0; l = sum(p) in f32 from the
//       unrounded p
//   o = (round_bf16(p) . v) / l      f32 sums, rounded to bf16 once
//   lse = m + ln(l) in f32 per row, which both K2 kernels read
// A row with no visible key gives exact zeros and an lse of -1e30.
// Inside, the exponentials are base 2 (exp2f of s * scale * log2(e), as in
// flash_bwd_tc.cu); the lse written is the natural-log one. m is the max
// over all of a row's keys, found by a first pass over the key tiles, so
// p is rounded to bf16 where the plain version rounds it. (An online
// softmax, which rounds p against the max of the keys seen so far and
// rescales the sums, moves those roundings: in the ViT-B/16 check of
// chip_smoke.py, which holds the bf16 kernel path's encoder output against
// the plain path's, its worst element came out past the bar.)
//
// Layout: q, o [B, Tq, H, D] and k, v [B, Tkv, H, D], bf16, contiguous,
// read in place; seg [B, T] int32 or null; lse [B*H, Tq] f32.
//
// Bound at the B/16 training shape (B*H = 3072, T = 196, D = 64): q, k, v
// read and o written once are 308 MB, 0.092 ms at 3.35 TB/s; the two
// products are 30.2 GFLOP, 0.031 ms at 989 TFLOP/s. So the bytes bound it.
// The scalar kernel this replaces took 2.18 ms there (scalar f32 FMAs on
// f32 tiles). Here:
//   * both products run on `mma.sync.m16n8k16` with bf16 operands and f32
//     sums: q . k^T with q as the A operand and k as B, both through
//     `ldmatrix`; p . v with p re-laid from the f32 C fragments of S as
//     bf16 A fragments (that rounding is the contract's only rounding of
//     p) and v through `ldmatrix.trans`;
//   * the row max and row sum live in registers, shared by the four
//     threads of a row through `__shfl_xor_sync`; so does the O sum;
//   * tiles stay bf16 in shared memory (flash_tc_common.cuh), loaded by
//     16-byte `cp.async.cg` copies straight from the [B, T, H, D] layout,
//     ragged edges zero-filled by the copies (D % 8 != 0, e.g. D = 20,
//     takes element loads instead);
//   * a ragged last key tile runs only its 16-key steps that hold a key
//     (T = 196: 4 of 64 keys), and a warp whose 16 query rows all lie past
//     Tq skips the products.
//
// Design. A block of 4 warps per (batch*head, 64-row query tile), warp w
// owning rows 16w..16w+15; the query tiles of one head are neighbours in
// the grid, so they read its K and V from L2. 64-row tiles stream through
// a ring of two stages, tile i+1 copying while tile i computes: the key
// tiles alone in the first pass (S and the row max), key and value tiles
// in the second (S again, p, l and O), so S is computed twice. At Dp = 64
// and 47 KB of shared memory an SM holds 4 blocks. Two other block shapes
// were timed against this one, with an online softmax, and were slower or
// no faster at the ViT shape (tools/kernel_timing.py; numbers in
// PERF.md): the head's whole K and V resident in shared memory for a
// group of its query tiles (T <= 256: 94 KB, 2 blocks per SM), and blocks
// of 8 warps over 128 query rows (half the K and V copies per row).
// Above Dp = 128 the O sums (128 f32 per thread at D = 256) would not fit
// in registers beside S: the second pass then runs once per 128 columns
// of D.

#include "flash_tc_common.cuh"

#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory: the query tile, then slot s's k (2s) and v (2s+1) tiles,
// bf16 [64][DP + 8]; then the segment ids of the query tile and of each
// slot.
template <int DP>
constexpr size_t smem_bytes() {
  return size_t(5 * BT) * (DP + 8) * sizeof(__nv_bfloat16) +
         size_t(3 * BT) * sizeof(int);
}

// Blocks an SM holds, as shared memory allows (228 KB, 1 KB of it per
// block for the system; 4 at Dp <= 80, 2 at 128, 1 at 256): registers up
// to 65536 / (NT * this) per thread.
template <int DP>
constexpr int blocks_per_sm() {
  return int(233472 / (smem_bytes<DP>() + 1024));
}

template <int DP, int DC, bool VEC>
__global__ void __launch_bounds__(NT, blocks_per_sm<DP>())
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o,
                    const int32_t* __restrict__ seg, float* __restrict__ lse,
                    int Tq, int Tkv, int H, int D, int causal, float scale) {
  constexpr int LD = DP + 8;
  constexpr int TILE = BT * LD;
  constexpr int NP = DP / 16;  // 16-column steps of D in q . k^T
  constexpr int NC = DC / 8;   // 8-column tiles of O's D chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* skv = sq + TILE;
  int* sseg_q = reinterpret_cast<int*>(skv + 4 * TILE);  // [BT]
  int* sseg_k = sseg_q + BT;                             // [2][BT]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nq = (Tq + BT - 1) / BT;
  const int bh = blockIdx.x / nq, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % nq) * BT;
  const long long row = (long long)H * D;
  const __nv_bfloat16* qb = q + ((long long)b * Tq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Tkv * H + h) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Tkv * H + h) * D;
  __nv_bfloat16* ob = o + ((long long)b * Tq * H + h) * D;
  const int32_t* segk = seg ? seg + (long long)b * Tkv : nullptr;
  const float scale2 = scale * LOG2E;
  // Keys [0, kv_end) can be visible from the block's queries.
  const int kv_end = causal ? min(Tkv, q0 + BT) : Tkv;
  const int nk = (kv_end + BT - 1) / BT;
  const bool live = q0 + 16 * w < Tq;  // this warp has rows in the tile

  // Issues the copies of key tile kt (and with `with_v` its value tile)
  // into `slot`.
  auto load_kv = [&](int slot, int kt, bool with_v) {
    load_tile<DP, VEC>(skv + 2 * slot * TILE, kb, row, kt * BT, Tkv, D, tid);
    if (with_v)
      load_tile<DP, VEC>(skv + (2 * slot + 1) * TILE, vb, row, kt * BT, Tkv,
                         D, tid);
    if (seg && tid < BT) {
      const int r = kt * BT + tid;
      sseg_k[slot * BT + tid] = r < Tkv ? segk[r] : 0;
    }
  };
  // Streams the key tiles (and with `with_v` the value tiles) through the
  // two slots, tile kt+1 copying while body(slot, kt) runs on tile kt in
  // the warps that have rows.
  auto stream = [&](bool with_v, auto&& body) {
    __syncthreads();  // the slots' previous readers are done
    load_kv(0, 0, with_v);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt > 0) __syncthreads();  // the slot of tile kt+1 is free
      if (kt + 1 < nk) {
        load_kv((kt + 1) & 1, kt + 1, with_v);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (live) body(kt & 1, kt);
    }
  };

  // s = q . k^T * scale * log2(e) for this warp's 16 query rows (16w+g,
  // +8) against key tile kt in `slot` (keys 8j+2t4, +1); -inf where masked.
  auto scores = [&](int slot, int kt, float (&s)[8][4]) {
    const __nv_bfloat16* tk = skv + 2 * slot * TILE;
    const int kv0 = kt * BT, kvn = min(BT, Tkv - kv0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const int ao = 16 * w * LD + a_off(lane, LD), bo = b_off(lane, LD);
#pragma unroll
    for (int kd = 0; kd < NP; ++kd) {
      uint32_t fa[4];
      ldsm_x4(fa, sq + ao + kd * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 >= kvn) break;
        uint32_t fb[4];
        ldsm_x4(fb, tk + np * 16 * LD + bo + kd * 16);
        mma(s[2 * np], fa, fb[0], fb[1]);
        mma(s[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 16 * w + g + 8 * (e >> 1), kl = 8 * j + 2 * t4 + (e & 1);
        bool vis = kl < kvn;
        if (causal) vis = vis && kv0 + kl <= q0 + ql;
        if (seg) {
          const int sk = sseg_k[slot * BT + kl];
          vis = vis && sk > 0 && sk <= sseg_q[ql];
        }
        // -inf marks a masked entry: exp2(-inf - m) is exactly 0 below.
        s[j][e] = vis ? s[j][e] * scale2 : -INFINITY;
      }
  };

  load_tile<DP, VEC>(sq, qb, row, q0, Tq, D, tid);  // copied with tile 0
  if (seg && tid < BT)
    sseg_q[tid] = q0 + tid < Tq ? seg[(long long)b * Tq + q0 + tid] : 0;

  // First pass: each row's max m over all its keys (-1e30 where none is
  // visible), so that p below is rounded against it, as the contract says.
  float m[2] = {NEG_INF, NEG_INF};
  stream(false, [&](int slot, int kt) {
    float s[8][4];
    scores(slot, kt, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
  });
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 1));
    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], 2));
  }

  // Second pass, once per chunk of DC columns of O: p = exp2(s - m), l =
  // sum(p) unrounded, O += round_bf16(p) . v; then O / l, rounded once.
  for (int c0 = 0; c0 < DP; c0 += DC) {
    float acc[NC][4], l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    stream(true, [&](int slot, int kt) {
      float s[8][4];
      scores(slot, kt, s);
      const int kvn = min(BT, Tkv - kt * BT);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      // p's C fragments as bf16 A fragments, 16 keys per step; v through
      // ldmatrix.trans.
      const __nv_bfloat16* tv = skv + (2 * slot + 1) * TILE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk * 16 >= kvn) break;
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int off = kk * 16 * LD + a_off(lane, LD) + c0;
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          uint32_t fv[4];
          ldsm_x4_t(fv, tv + off + np * 16);
          mma(acc[2 * np], pa, fv[0], fv[1]);
          mma(acc[2 * np + 1], pa, fv[2], fv[3]);
        }
      }
    });
    if (!live) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      const int qi = q0 + 16 * w + g + 8 * hf;
      if (qi >= Tq) continue;
      // A row with no visible key: every p was 0, so O is 0 and l is 0.
      const float div = l[hf] > 0.f ? l[hf] : 1.f;
      if (c0 == 0 && t4 == 0)
        lse[(long long)bh * Tq + qi] =
            l[hf] > 0.f ? m[hf] * LN2 + logf(l[hf]) : NEG_INF;
      __nv_bfloat16* orow = ob + qi * row;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int d = c0 + 8 * j + 2 * t4;
        const float x0 = acc[j][2 * hf] / div, x1 = acc[j][2 * hf + 1] / div;
        if (VEC) {  // D % 8 == 0: d and d + 1 both in or both out
          if (d < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < D) orow[d] = __float2bfloat16(x0);
          if (d + 1 < D) orow[d + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const int32_t* seg;
  float* lse;
  int B, Tq, Tkv, H, D, causal;
  float scale;
};

template <int DP, int DC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool vec = a.D % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o)) %
       16) == 0;
  auto kern = vec ? flash_fwd_tc_kernel<DP, DC, true>
                  : flash_fwd_tc_kernel<DP, DC, false>;
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  // The query tiles of one head are neighbours in the grid.
  const long long blocks = (long long)a.B * a.H * ((a.Tq + BT - 1) / BT);
  kern<<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.seg, a.lse, a.Tq,
      a.Tkv, a.H, a.D, a.causal, a.scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. seg may be null. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int bvt_flash_fwd_tc(const void* q, const void* k, const void* v,
                                void* o, const void* seg, void* lse, int B,
                                int Tq, int Tkv, int H, int D, int causal,
                                float scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, static_cast<const int32_t*>(seg),
         static_cast<float*>(lse), B, Tq, Tkv, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The O sums in chunks of at most 128 columns.
  switch (dpad(D)) {
    case 64: return (int)launch<64, 64>(a, st);
    case 80: return (int)launch<80, 80>(a, st);
    case 128: return (int)launch<128, 128>(a, st);
    default: return (int)launch<256, 128>(a, st);
  }
}
