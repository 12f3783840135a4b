// One-shot attention backward in bf16 on Hopper's tensor cores (sm_90a):
// kernel K2 for bf16 inputs, the port of the TPU kernel
// `_oneshot_bwd_kernel` in big_vision_tpu/ops/flash_attention.py (reached
// from `_oneshot_bwd`), the gradient of K1 (csrc/flash_fwd.cu). f32 inputs
// take the 3xTF32 kernel of csrc/flash_bwd.cu, which states the contract
// both keep; in short, per (batch, head), with the forward's masks (causal:
// col <= row; segment: 0 < seg[j] <= seg[i]; rows and keys past the end):
//   p     = exp(s * scale - lse) / l     f32, l = rowsum(exp(s * scale - lse))
//   dv    = round_bf16(p)^T . do         f32 sums
//   dp    = do . v^T                     f32
//   delta = rowsum(p * dp)               f32
//   ds    = round_bf16(p * (dp - delta)), masked entries exactly 0
//   dq    = ds . k * scale,  dk = ds^T . q * scale
// Every product takes bf16 operands and sums in f32, which is what
// `mma.sync.m16n8k16.f32.bf16.bf16.f32` computes: only the order of the
// sums differs from the plain version.
//
// Bound at the B/16 training shape (B*H = 3072, T = 196, D = 64): q, k, v,
// do read and dq, dk, dv written once are 539 MB, 0.161 ms at 3.35 TB/s;
// the five products are 75.5 GFLOP, 0.076 ms at 989 TFLOP/s. So the bytes
// bound it. The scalar version this replaces ran at about 9 TFLOP/s
// (11.36 ms), held back by four things, and the design answers each:
//   * scalar f32 FMAs (67 TFLOP/s at best): every product here is
//     `mma.sync` on bf16 operands loaded with `ldmatrix` (`.trans` where the
//     tile is stored the other way round);
//   * f32 tiles in shared memory, twice the bytes: tiles stay bf16, rows
//     padded by 8 halves so that the 8 rows of an `ldmatrix` hit distinct
//     banks, and D zero-padded to Dp, a multiple of 16 (the zeros change no
//     product);
//   * synchronous loads: the query-side tiles (q and do) stream through a
//     ring of two stages filled by 16-byte `cp.async.cg` copies straight
//     from the [B, T, H, D] layout, so tile i+1 loads while tile i
//     computes; ragged edges are zero-filled by the copies, not padded in
//     device memory;
//   * a first pass on the same scalar units: it runs on the same `mma.sync`
//     tiles, with warps owning query strips and key tiles streaming
//     through the same ring.
//
// Layout: q, do, dq [B, Tq, H, D] and k, v, dk, dv [B, Tkv, H, D], bf16,
// contiguous, read in place; lse [B*H, Tq] f32 (K1's row log-sum-exp); seg
// [B, T] int32 or null. Scratch from the wrapper: dq_acc, f32, of
// `bvt_flash_bwd_tc_scratch` floats per (batch, head), and row statistics
// [B*H, 2, Tq] f32 (delta, then l).
//
// Design. One block of 4 warps per (batch*head), as in the scalar kernel,
// so no atomics, and results that do not depend on the order of blocks.
// Shared memory holds three slots of two 64 x Dp bf16 tiles each.
//   First pass, per query tile of 64 rows (slot 0: q, do): key tiles
//   (k, v) alternate between slots 1 and 2, the next one loading while the
//   current one computes. Warp w owns query rows 16w..16w+15 and computes
//   S = q.k^T and dP = do.v^T for them, summing l and p.dp per row in
//   registers; then the four threads that share a row add theirs, and
//   delta = sum(p.dp) / l and l go to the row-statistics scratch.
//   Main pass, per key tile of 64 keys (slot 0: k, v): query tiles (q, do
//   and their statistics) alternate between slots 1 and 2. Warp w owns
//   keys 16w..16w+15: it computes S^T = k.q^T and dP^T = v.do^T for its
//   strip, forms p and ds in registers, and re-lays their C fragments as
//   bf16 A fragments (the bf16 rounding there is the contract's) for
//   dv += p^T.do and dk += ds^T.q, whose f32 sums stay in registers across
//   the whole query loop (flash-attention-2's backward). ds (64 x 64 bf16)
//   also goes to shared memory; the warps then split the query rows and
//   compute dq_i += ds.k_j, each thread adding its C fragments to the
//   elements of dq_acc that only it ever touches, which are stored in the
//   fragments' order, so that a warp reads and writes 512 contiguous bytes
//   at a time. dq is scaled and rounded once at the end. Above Dp = 80, the dk and dv sums would not fit in registers: the
//   query loop then runs once per 64 columns of D, recomputing S^T and
//   dP^T (dq in the first round only).
// With causal both passes skip the tiles wholly above the diagonal.

#include "flash_tc_common.cuh"

namespace {

constexpr int LDS = BT + 8;  // row stride (halves) of the ds tile

template <int DP>
struct Smem {
  static constexpr int LD = DP + 8;  // row stride (halves) of the tiles
  static constexpr int TILE = BT * LD;
  // slot s holds tiles 2s (q or k) and 2s+1 (do or v)
  __nv_bfloat16 tiles[6 * TILE];
  __nv_bfloat16 ds[BT * LDS];  // ds^T of the current pair, [key][query]
  int seg[3][BT];              // segment ids of each slot's rows
  float stat[3][3][BT];        // per query slot: lse * log2(e), 1 / l, delta
};

template <int DP, int DC, bool VEC>
__global__ void __launch_bounds__(NT)
flash_bwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const int32_t* __restrict__ seg,
                    __nv_bfloat16* __restrict__ dq,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ dq_acc, float* __restrict__ stats,
                    int Tq, int Tkv, int H, int D, int causal, float scale) {
  using S = Smem<DP>;
  constexpr int LD = S::LD;
  constexpr int NP = DP / 16;   // 16-column steps of D
  constexpr int NC = DC / 8;    // 8-column tiles of a D chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  auto tile = [&](int slot, int which) {
    return sm.tiles + (2 * slot + which) * S::TILE;
  };

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long row = (long long)H * D;
  const __nv_bfloat16* qb = q + ((long long)b * Tq * H + h) * D;
  const __nv_bfloat16* dob = dout + ((long long)b * Tq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Tkv * H + h) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Tkv * H + h) * D;
  float4* dqa = reinterpret_cast<float4*>(dq_acc) +
                (long long)bh * ((Tq + BT - 1) / BT) * BT * DP / 4;
  // dq_acc in the order of the dq product's C fragments: for each query
  // tile, warp, 16 columns and lane, the lane's 8 values (2 float4), so a
  // warp's read-modify-write of them is contiguous.
  auto frag = [&](int qt, int np) {
    return ((qt * 4 + w) * NP + np) * 64 + 2 * lane;
  };
  float* st = stats + (long long)bh * 2 * Tq;  // delta [Tq], then l [Tq]
  const float* lseb = lse + (long long)bh * Tq;
  const int32_t* segq = seg ? seg + (long long)b * Tq : nullptr;
  const int32_t* segk = seg ? seg + (long long)b * Tkv : nullptr;
  const float scale2 = scale * LOG2E;
  const int nq = (Tq + BT - 1) / BT;

  // Issue the copies of query tile qt (q, do) into `slot`; with `stat`,
  // also fill its row statistics from the first pass.
  auto load_q = [&](int slot, int qt, bool stat) {
    load_tile<DP, VEC>(tile(slot, 0), qb, row, qt * BT, Tq, D, tid);
    load_tile<DP, VEC>(tile(slot, 1), dob, row, qt * BT, Tq, D, tid);
    if (tid < BT) {
      const int r = qt * BT + tid;
      const bool in = r < Tq;
      if (seg) sm.seg[slot][tid] = in ? segq[r] : 0;
      if (stat) {
        sm.stat[slot][0][tid] = in ? lseb[r] * LOG2E : 0.f;
        sm.stat[slot][1][tid] = in ? 1.f / st[Tq + r] : 0.f;
        sm.stat[slot][2][tid] = in ? st[r] : 0.f;
      }
    }
  };
  auto load_kv = [&](int slot, int kt) {
    load_tile<DP, VEC>(tile(slot, 0), kb, row, kt * BT, Tkv, D, tid);
    load_tile<DP, VEC>(tile(slot, 1), vb, row, kt * BT, Tkv, D, tid);
    if (seg && tid < BT) {
      const int r = kt * BT + tid;
      sm.seg[slot][tid] = r < Tkv ? segk[r] : 0;
    }
  };
  // Whether key kl of the slot `ks` tile at key offset kv0 is visible from
  // query ql of the slot `qs` tile at offset q0.
  auto visible = [&](int qs, int q0, int ql, int ks, int kv0, int kl) {
    const int qi = q0 + ql, ki = kv0 + kl;
    bool vis = qi < Tq && ki < Tkv;
    if (causal) vis = vis && ki <= qi;
    if (seg) {
      const int sk = sm.seg[ks][kl];
      vis = vis && sk > 0 && sk <= sm.seg[qs][ql];
    }
    return vis;
  };
  // acc_a += a_strip . b_tile^T and acc_b += c_strip . d_tile^T over all
  // DP columns: a 16-row strip (rows r0.. of tiles a and c) against the 64
  // rows of tiles b and d, [16][64] f32 C fragments in 8 column tiles.
  auto strip_products = [&](const __nv_bfloat16* ta, const __nv_bfloat16* tb,
                            const __nv_bfloat16* tc, const __nv_bfloat16* td,
                            int r0, float (&acc_a)[8][4],
                            float (&acc_b)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_a[j][e] = acc_b[j][e] = 0.f;
    const int ao = r0 * LD + a_off(lane, LD), bo = b_off(lane, LD);
#pragma unroll
    for (int kd = 0; kd < NP; ++kd) {
      uint32_t fa[4], fc[4];
      ldsm_x4(fa, ta + ao + kd * 16);
      ldsm_x4(fc, tc + ao + kd * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t fb[4], fd[4];
        ldsm_x4(fb, tb + np * 16 * LD + bo + kd * 16);
        ldsm_x4(fd, td + np * 16 * LD + bo + kd * 16);
        mma(acc_a[2 * np], fa, fb[0], fb[1]);
        mma(acc_a[2 * np + 1], fa, fb[2], fb[3]);
        mma(acc_b[2 * np], fc, fd[0], fd[1]);
        mma(acc_b[2 * np + 1], fc, fd[2], fd[3]);
      }
    }
  };

  // ---- First pass: l and delta of every query row. ----
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BT;
    const int kv_end = causal ? min(Tkv, q0 + BT) : Tkv;
    const int nk = (kv_end + BT - 1) / BT;
    __syncthreads();  // the previous tile's readers are done
    load_q(0, qt, false);
    load_kv(1, 0);
    cp_async_commit();
    float lse2[2], lsum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = q0 + 16 * w + g + 8 * hf;
      lse2[hf] = r < Tq ? lseb[r] * LOG2E : 0.f;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int cur = 1 + (kt & 1);
      if (kt > 0) __syncthreads();  // the slot of tile kt+1 is free
      if (kt + 1 < nk) {
        load_kv(1 + ((kt + 1) & 1), kt + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float s[8][4], dp[8][4];
      strip_products(tile(0, 0), tile(cur, 0), tile(0, 1), tile(cur, 1),
                     16 * w, s, dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          if (visible(0, q0, 16 * w + g + 8 * hf, cur, kt * BT,
                      8 * j + 2 * t4 + (e & 1))) {
            const float p = exp2f(s[j][e] * scale2 - lse2[hf]);
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
      const int r = q0 + 16 * w + g + 8 * hf;
      if (t4 == 0 && r < Tq) {
        // A row with no visible key keeps p = 0: l = 1 avoids 0 / 0.
        const float l = lsum[hf] > 0.f ? lsum[hf] : 1.f;
        st[r] = dsum[hf] / l;
        st[Tq + r] = l;
      }
    }
  }
  // The __syncthreads below make these global writes visible to the block.

  // ---- Main pass: dk, dv per key tile; dq summed in dq_acc. ----
  const int nkv = (Tkv + BT - 1) / BT;
  for (int kt = 0; kt < nkv; ++kt) {
    const int kv0 = kt * BT;
    // With causal, query tiles above the diagonal see none of these keys
    // (tiles start at multiples of BT on both axes). The first key tile
    // visits every query tile, so it initializes the dq sums.
    const int qt0 = causal ? kt : 0;
    const int iters = max(0, nq - qt0);
    for (int c0 = 0; c0 < DP; c0 += DC) {
      __syncthreads();  // every slot's readers are done
      if (c0 == 0) load_kv(0, kt);
      if (iters > 0) load_q(1, qt0, true);
      cp_async_commit();
      float dk_acc[NC][4], dv_acc[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

      for (int it = 0; it < iters; ++it) {
        const int qt = qt0 + it, q0 = qt * BT, cur = 1 + (it & 1);
        if (it > 0) __syncthreads();  // slot of tile it+1 and ds are free
        if (it + 1 < iters) {
          load_q(1 + ((it + 1) & 1), qt + 1, true);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();

        // S^T and dP^T for keys 16w..16w+15 against the tile's 64 queries.
        float s[8][4], dp[8][4];
        strip_products(tile(0, 0), tile(cur, 0), tile(0, 1), tile(cur, 1),
                       16 * w, s, dp);
        // p (f32, normalized, 0 where masked) into s; ds into dp.
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = 8 * j + 2 * t4 + (e & 1);
            const int kl = 16 * w + g + 8 * (e >> 1);
            float p = 0.f, ds = 0.f;
            if (visible(cur, q0, ql, 0, kv0, kl)) {
              p = exp2f(s[j][e] * scale2 - sm.stat[cur][0][ql]) *
                  sm.stat[cur][1][ql];
              ds = p * (dp[j][e] - sm.stat[cur][2][ql]);
            }
            s[j][e] = p;
            dp[j][e] = ds;
          }
        // C fragments -> bf16 A fragments over the tile's queries (16 per
        // step): round(p) for dv, round(ds) for dk (and dq).
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          da[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
          da[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
          da[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
          da[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        }
        // dv += p^T . do and dk += ds^T . q over columns c0..c0+DC.
        const __nv_bfloat16* tq = tile(cur, 0);
        const __nv_bfloat16* tdo = tile(cur, 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int off = kk * 16 * LD + a_off(lane, LD) + c0;
#pragma unroll
          for (int np = 0; np < NC / 2; ++np) {
            uint32_t fo[4], fq[4];
            ldsm_x4_t(fo, tdo + off + np * 16);
            ldsm_x4_t(fq, tq + off + np * 16);
            mma(dv_acc[2 * np], pa[kk], fo[0], fo[1]);
            mma(dv_acc[2 * np + 1], pa[kk], fo[2], fo[3]);
            mma(dk_acc[2 * np], da[kk], fq[0], fq[1]);
            mma(dk_acc[2 * np + 1], da[kk], fq[2], fq[3]);
          }
        }
        if (c0 != 0) continue;

        // ds^T to shared memory, [key][query], as the rounded bf16 values.
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<uint32_t*>(
                &sm.ds[(16 * w + g + 8 * hf) * LDS + 8 * j + 2 * t4]) =
                hf ? da[j >> 1][(j & 1) * 2 + 1] : da[j >> 1][(j & 1) * 2];
        __syncthreads();
        // dq += ds . k for query rows 16w..16w+15 of the tile.
        uint32_t fs[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4_t(fs[kk], sm.ds + kk * 16 * LDS + b_off(lane, LDS) + 16 * w);
        const __nv_bfloat16* tk = tile(0, 0);
        float4* dst = dqa + frag(qt, 0);
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          float4 acc[2] = {};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t fk[4];
            ldsm_x4_t(fk, tk + kk * 16 * LD + a_off(lane, LD) + np * 16);
            mma(reinterpret_cast<float(&)[4]>(acc[0]), fs[kk], fk[0], fk[1]);
            mma(reinterpret_cast<float(&)[4]>(acc[1]), fs[kk], fk[2], fk[3]);
          }
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            if (kt != 0) {
              const float4 old = dst[2 * 32 * np + x];
              acc[x].x += old.x, acc[x].y += old.y;
              acc[x].z += old.z, acc[x].w += old.w;
            }
            dst[2 * 32 * np + x] = acc[x];
          }
        }
      }
      cp_async_wait<0>();  // with no query tile, the key tile's copies

      // dk (scaled) and dv of keys 16w+g and 16w+g+8, columns of the chunk.
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = kv0 + 16 * w + g + 8 * (e >> 1);
          const int d = c0 + 8 * j + 2 * t4 + (e & 1);
          if (kr < Tkv && d < D) {
            const long long o = ((long long)b * Tkv + kr) * row + h * D + d;
            dk[o] = __float2bfloat16(dk_acc[j][e] * scale);
            dv[o] = __float2bfloat16(dv_acc[j][e]);
          }
        }
    }
  }

  // dq out of the scratch, scaled and rounded once, by the threads that
  // summed each element.
  __nv_bfloat16* dqb = dq + ((long long)b * Tq * H + h) * D;
  for (int qt = 0; qt < nq; ++qt)
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float4 a = dqa[frag(qt, np) + x];
        const float vals[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qt * BT + 16 * w + g + 8 * (e >> 1);
          const int d = np * 16 + 8 * x + 2 * t4 + (e & 1);
          if (qi < Tq && d < D)
            dqb[qi * row + d] = __float2bfloat16(vals[e] * scale);
        }
      }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float* lse;
  const int32_t* seg;
  void *dq, *dk, *dv;
  float *dq_acc, *stats;
  int B, Tq, Tkv, H, D, causal;
  float scale;
};

template <int DP, int DC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const bool vec = a.D % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v) |
        reinterpret_cast<uintptr_t>(a.dout)) % 16) == 0;
  auto kern = vec ? flash_bwd_tc_kernel<DP, DC, true>
                  : flash_bwd_tc_kernel<DP, DC, false>;
  const int smem = (int)sizeof(Smem<DP>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  kern<<<a.B * a.H, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.seg,
      static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.dq_acc, a.stats, a.Tq, a.Tkv, a.H, a.D, a.causal, a.scale);
  return cudaGetLastError();
}

}  // namespace

// The floats of dq_acc the kernel needs for each (batch, head): Tq rounded
// up to 64 times D padded to Dp.
extern "C" long long bvt_flash_bwd_tc_scratch(int Tq, int D) {
  return (long long)((Tq + BT - 1) / BT) * BT * dpad(D);
}

// bf16 only. seg may be null. dq_acc [B*H * bvt_flash_bwd_tc_scratch(Tq,
// D)] and stats [B*H, 2, Tq] (delta and l per row) are f32 scratch,
// written before they are read; dq_acc 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bvt_flash_bwd_tc(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* seg, void* dq, void* dk, void* dv,
                                void* dq_acc, void* stats, int B, int Tq,
                                int Tkv, int H, int D, int causal,
                                float scale, void* stream) {
  if (D < 1 || D > 256 || B < 1 || H < 1 || Tq < 1 || Tkv < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const int32_t*>(seg), dq, dk, dv,
         static_cast<float*>(dq_acc), static_cast<float*>(stats),
         B, Tq, Tkv, H, D, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The dk, dv sums in chunks of at most 80 columns.
  switch (dpad(D)) {
    case 64: return (int)launch<64, 64>(a, st);
    case 80: return (int)launch<80, 80>(a, st);
    case 128: return (int)launch<128, 64>(a, st);
    default: return (int)launch<256, 64>(a, st);
  }
}
