// Single-token grouped-query decode attention for Hopper (sm_90a): kernel
// K6, the port of the TPU kernel `_kernel` / `decode_attention` in
// big_vision_tpu/ops/decode_attention.py.
//
// What it computes, per (batch b, kv head k), for its G <= 8 query rows:
// q and the cache rows rounded to bf16 (int8 and bf16 storage are exact),
// s = q . k in f32, times the per-slot k-scale when the cache is int8, then
// the optional softcap cap*tanh(s/cap), the [B, S] mask (a masked slot gets
// p = 0 exactly), the softmax sum l taken BEFORE the per-slot v-scale
// multiplies p, p rounded to bf16, and o = (p . v) / l in q's dtype. There
// is no 1/sqrt(D): q arrives pre-scaled. A row with no visible slot emits
// exact zeros.
//
// Layout: q [B, K, G, H] (f32 or bf16), cache k, v [B, K, S, H] read in
// their storage dtype (int8, bf16 or f32), scales [B, K, S] f32 or null,
// mask [B, S] bool (one byte), out [B, K, G, H] in q's dtype; any H <= 256.
//
// Bound: the bytes of the cache. At the serving shape (B=8, K=1, S=352,
// H=256, bf16) that is 2.9 MB, 0.9 us at 3.35 TB/s. The first design, one
// block per (b, k) walking S in tiles, used 8 of the 132 SMs there and
// took 60 us: latency, about two memory round trips per tile.
//
// Design: the cache is split over the SMs.
//   * Grid (splits, B*K) of 8-warp blocks. Split i of (b, k) takes the
//     slots [i*P, (i+1)*P) in tiles of T <= 64 slots; `plan` in
//     ops/decode_attention.py picks T and P from B*K and S so that the grid
//     fills the SMs (16 slots a split at the serving shape).
//   * Loads: q (on the first tile) and a tile's K rows and V rows are
//     issued at once, as 16-byte cp.async copies into shared memory
//     (element loads where H or the pointers do not allow them), with the
//     tile's mask and scales; the V copies are waited on only before
//     p . v, so one memory round trip covers the tile.
//   * Products on the tensor cores (`mma.sync` m16n8k16, bf16 operands, f32
//     sums; the G query rows fill half of A's 16): scores [G, T] = q . K^T
//     over H, then o += p . V over T. The cache stays in its storage dtype
//     in shared memory: a bf16 cache gives its operands by `ldmatrix`, an
//     int8 or f32 one is made bf16 pair by pair as it is read (int8
//     exactly, f32 rounded), so an int8 cache moves one byte per element.
//     Each tile's compute is a chain of phases between barriers, latency
//     more than work: the eight warps share each phase (a 16-slot pair of
//     scores and a slice of H's depth each, one query row each in the
//     softmax, two 16-column pairs each in p . v).
//   * Softmax per split, with a running max over its tiles: p is rounded to
//     bf16 against the split's max where the plain version uses the row's
//     (each rounds every p once; K6_BAR holds the difference).
//   * Each split writes its max m, its sum l (taken before the v-scale) and
//     its unnormalised o (f32) to scratch. The combine rescales and sums
//     the splits in split order, with no float atomics (a repeat launch
//     gives the same bits): w_i = exp(m_i - max m), 0 for a split with no
//     visible slot (m_i = -inf); o = sum w_i o_i / sum w_i l_i, with 1 for
//     a zero sum. It is a second small kernel, launched as a programmatic
//     dependent of the first (its blocks start while the splits finish and
//     wait for their results); each thread loads all its splits' parts at
//     once. A single split writes o itself.
//   * What holds it back (PERF.md, section 6): the loads alone reach about
//     2.4 TB/s at B=64, S=1120, and each tile's compute is not hidden
//     behind them. Tried and measured slower: the last split block of each
//     (b, k) combining (found by a counter), long splits streaming their
//     tiles through a ring of two or four buffers.

#include "flash_tc_common.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int MAXG = 8;         // query rows per kv head (the TPU's _GP)
constexpr int MAXH = 256;       // head dim
constexpr int MAXSPLIT = 64;    // splits of one (b, k): the combine's table
constexpr int KT = 256;         // threads of a split block: 8 warps
constexpr int KW = KT / 32;
constexpr int ACC = MAXH / 8 / KW;  // p . v column tiles of 8 per warp
constexpr int CB = 32;          // splits a combine thread loads at once

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;        // [B*K*S] per-slot scales, int8 cache only
  const float* vs;
  const uint8_t* mask;    // [B, S]
  void* o;                // [B*K, G, H] in q's dtype
  float* part;            // [BK, splits, G, Hp] o, then [BK, splits, G] (m, l)
  int BK, K, G, S, H;
  int tile, per_split, splits;
  float softcap;
  bool qvec, cvec;        // 16-byte copies of q rows, of cache rows
};

// H padded to the mma depth (16), and to float4s in the scratch.
__host__ __device__ __forceinline__ int hpad(int h) { return (h + 15) & ~15; }
__host__ __device__ __forceinline__ int hpart(int h) { return (h + 3) & ~3; }
// Shared-memory row stride in bytes of a cache tile or of q: the padded
// row plus 16 bytes (32 for f32 q), so that the 8 rows of an operand load
// start in distinct banks.
template <typename T>
__host__ __device__ __forceinline__ int row_bytes(int h) {
  return hpad(h) * static_cast<int>(sizeof(T)) + (sizeof(T) == 4 ? 32 : 16);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ int8_t from_f<int8_t>(float x) {
  return static_cast<int8_t>(x);
}

// Elements i and i + 1 (i even) of a shared-memory row as a bf16 pair.
template <typename T>
__device__ __forceinline__ uint32_t row_pair(const unsigned char* row, int i);
template <>
__device__ __forceinline__ uint32_t row_pair<__nv_bfloat16>(
    const unsigned char* row, int i) {
  return *reinterpret_cast<const uint32_t*>(row + 2 * i);
}
template <>
__device__ __forceinline__ uint32_t row_pair<int8_t>(const unsigned char* row,
                                                     int i) {
  const char2 c = *reinterpret_cast<const char2*>(row + i);
  return pack_bf16(static_cast<float>(c.x), static_cast<float>(c.y));
}
template <>
__device__ __forceinline__ uint32_t row_pair<float>(const unsigned char* row,
                                                    int i) {
  const float2 f = *reinterpret_cast<const float2*>(row + 4 * i);
  return pack_bf16(f.x, f.y);
}

// Element c of two shared-memory rows as a bf16 pair (r0's in the low half).
template <typename CT>
__device__ __forceinline__ uint32_t col_pair(const unsigned char* r0,
                                             const unsigned char* r1, int c) {
  return pack_bf16(to_f(reinterpret_cast<const CT*>(r0)[c]),
                   to_f(reinterpret_cast<const CT*>(r1)[c]));
}

// B operands of two 8-slot column tiles, slots [r0, r0 + 16), at depth
// [k0, k0 + 16) of a K tile stored [slot][h]: b[0], b[1] for the first,
// b[2], b[3] for the second.
template <typename CT>
__device__ __forceinline__ void k_frags(uint32_t (&b)[4],
                                        const unsigned char* tile, int rb,
                                        int r0, int k0, int lane) {
  if (std::is_same<CT, __nv_bfloat16>::value) {
    ldsm_x4(b, tile + r0 * rb + 2 * (k0 + b_off(lane, rb / 2)));
  } else {
    const int t2 = 2 * (lane % 4);
    const unsigned char* lo = tile + (r0 + lane / 4) * rb;
    const unsigned char* hi = lo + 8 * rb;
    b[0] = row_pair<CT>(lo, k0 + t2);
    b[1] = row_pair<CT>(lo, k0 + 8 + t2);
    b[2] = row_pair<CT>(hi, k0 + t2);
    b[3] = row_pair<CT>(hi, k0 + 8 + t2);
  }
}

// B operands of two 8-column tiles, columns [c0, c0 + 16), at depth (slots)
// [k0, k0 + 16) of a V tile stored [slot][h].
template <typename CT>
__device__ __forceinline__ void v_frags(uint32_t (&b)[4],
                                        const unsigned char* tile, int rb,
                                        int k0, int c0, int lane) {
  if (std::is_same<CT, __nv_bfloat16>::value) {
    ldsm_x4_t(b, tile + k0 * rb + 2 * (c0 + a_off(lane, rb / 2)));
  } else {
    const int c = c0 + lane / 4;
    const unsigned char* r0 = tile + (k0 + 2 * (lane % 4)) * rb;
    b[0] = col_pair<CT>(r0, r0 + rb, c);
    b[1] = col_pair<CT>(r0 + 8 * rb, r0 + 9 * rb, c);
    b[2] = col_pair<CT>(r0, r0 + rb, c + 8);
    b[3] = col_pair<CT>(r0 + 8 * rb, r0 + 9 * rb, c + 8);
  }
}

// Issues the copies of rows [0, n) of `src` (rows H elements apart) into
// rows [0, n) of a shared tile of row stride rb, zero-filling the rows
// [n, np) and the columns [H, hpad(H)). vec: 16-byte cp.async copies (H *
// sizeof(T) a multiple of 16, src 16-byte aligned); otherwise element
// loads.
template <typename T>
__device__ __forceinline__ void load_rows(unsigned char* dst, int rb,
                                          const T* src, int n, int np, int H,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);           // elements per copy
    const int cpr = hpad(H) / E, live = H / E;  // copies per padded row
    // Copy i = tid + KT j is (row r, copy c) of the tile, stepped without
    // a division (cpr <= 64 < KT).
    const int dr = KT / cpr, dc = KT % cpr;
    int r = tid / cpr, c = tid % cpr;
#pragma unroll 4
    while (r < np) {
      const bool in = r < n && c < live;
      cp_async16(dst + r * rb + c * 16,
                 in ? src + static_cast<long long>(r) * H + c * E : src,
                 in ? 16 : 0);
      r += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  } else {
    const int hp = hpad(H);
    for (int i = tid; i < np * hp; i += KT) {
      const int r = i / hp, c = i % hp;
      reinterpret_cast<T*>(dst + r * rb)[c] =
          (r < n && c < H) ? src[static_cast<long long>(r) * H + c]
                           : from_f<T>(0.f);
    }
  }
}

template <typename QT, typename CT>
__global__ void __launch_bounds__(KT) decode_split(const Args a) {
  constexpr bool QUANT = std::is_same<CT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  // The scores' parts [slice][MAXG][np]: slice i of the depth for the slot
  // pair (16 slots) p is summed by warp p + P i, P = np / 16 pairs, KW / P
  // slices of them; at most KW * MAXG * 16 floats.
  __shared__ float sS[KW * MAXG * 16];
  __shared__ __align__(16) __nv_bfloat16 sP[MAXG][BT + 8];  // bf16 p (x v-scale)
  __shared__ float sKs[BT], sVs[BT];
  __shared__ bool sVis[BT];
  __shared__ float sM[MAXG], sL[MAXG], sAlpha[MAXG];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t2 = 2 * (lane % 4);  // mma fragment row, columns
  const int split = blockIdx.x, bk = blockIdx.y, b = bk / a.K;
  const int G = a.G, S = a.S, H = a.H, hp = hpad(H), rb = row_bytes<CT>(H);
  const int tp = (a.tile + 15) & ~15, qrb = row_bytes<QT>(H);
  unsigned char* sK = smem;
  unsigned char* sV = sK + tp * rb;
  unsigned char* sQ = sV + tp * rb;  // [MAXG] rows of qrb bytes
  const long long plane = static_cast<long long>(bk) * S * H;
  const CT* kp = static_cast<const CT*>(a.k) + plane;
  const CT* vp = static_cast<const CT*>(a.v) + plane;
  const uint8_t* mrow = a.mask + static_cast<long long>(b) * S;
  const int s_begin = split * a.per_split;
  const int s_end = min(S, s_begin + a.per_split);

  // q [MAXG, hp] in its own dtype, rows past G and columns past H zero:
  // its copies join the first tile's K copies.
  load_rows<QT>(sQ, qrb,
                static_cast<const QT*>(a.q) + static_cast<long long>(bk) * G * H,
                G, MAXG, H, a.qvec, tid);
  if (tid < MAXG) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  // o sums of query row gq, columns nt * 8 + t2 (+1), for the column tiles
  // nt = 2 pi and 2 pi + 1 of the pairs pi = warp + KW i.
  float acc[ACC][4];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int t0 = s_begin; t0 < s_end; t0 += a.tile) {
    const int n = min(a.tile, s_end - t0), np = (n + 15) & ~15;
    __syncthreads();  // the previous tile's readers are done
    load_rows<CT>(sK, rb, kp + static_cast<long long>(t0) * H, n, np, H,
                  a.cvec, tid);
    cp_async_commit();
    load_rows<CT>(sV, rb, vp + static_cast<long long>(t0) * H, n, np, H,
                  a.cvec, tid);
    cp_async_commit();
    if (tid < np) {
      const bool in = tid < n;
      sVis[tid] = in && mrow[t0 + tid] != 0;
      if (QUANT) {
        const long long at = static_cast<long long>(bk) * S + t0 + tid;
        sKs[tid] = in ? a.ks[at] : 0.f;
        sVs[tid] = in ? a.vs[at] : 0.f;
      }
    }
    // Every block has issued its loads: the combine may start launching.
    asm volatile("griddepcontrol.launch_dependents;");
    cp_async_wait<1>();  // q and K have landed; V may still be in flight
    __syncthreads();

    // Scores: warp w takes the 16-slot column pair w % P of the tile and
    // the depth steps w / P, w / P + KW / P, ... of H, into its part.
    const int pairs = np / 16, slices = KW / pairs;
    if (warp < pairs * slices) {
      const int pi = warp % pairs;
      const unsigned char* qrow = sQ + gq * qrb;
      float c[2][4] = {};
      for (int k0 = 16 * (warp / pairs); k0 < hp; k0 += 16 * slices) {
        const uint32_t fa[4] = {row_pair<QT>(qrow, k0 + t2), 0u,
                                row_pair<QT>(qrow, k0 + 8 + t2), 0u};
        uint32_t fb[4];
        k_frags<CT>(fb, sK, rb, 16 * pi, k0, lane);
        mma(c[0], fa, fb[0], fb[1]);
        mma(c[1], fa, fb[2], fb[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sS[((warp / pairs) * MAXG + gq) * np + 16 * pi + 8 * (e / 2) + t2 +
           e % 2] = c[e / 2][e % 2];
    }
    __syncthreads();

    // Online softmax over the split's tiles: warp g owns query row g, lane
    // j the slots j and j + 32. A score is its parts summed in order.
    if (warp < G) {
      const int g = warp;
      float x[2], p[2], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        x[e] = -INFINITY;
        if (j < n && sVis[j]) {
          float y = sS[g * np + j];
          for (int i = 1; i < slices; ++i) y += sS[(i * MAXG + g) * np + j];
          if (QUANT) y *= sKs[j];
          if (a.softcap > 0.f) y = a.softcap * tanhf(y / a.softcap);
          x[e] = y;
        }
        mx = fmaxf(mx, x[e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        p[e] = (j < n && sVis[j]) ? __expf(x[e] - m_new) : 0.f;
        sum += p[e];
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // l is summed before the v-scale; p goes to p . v as bf16.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        if (j < np) sP[g][j] = __float2bfloat16(QUANT ? p[e] * sVs[j] : p[e]);
      }
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : __expf(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // o = o * alpha + p . V: warp w takes the 16-column pairs w + KW i of hp.
    const float alpha = gq < G ? sAlpha[gq] : 0.f;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      acc[i][0] *= alpha;
      acc[i][1] *= alpha;
    }
    for (int k0 = 0; k0 < np; k0 += 16) {
      const unsigned char* prow = reinterpret_cast<const unsigned char*>(sP[gq]);
      const uint32_t fa[4] = {gq < G ? row_pair<__nv_bfloat16>(prow, k0 + t2) : 0u,
                              0u,
                              gq < G ? row_pair<__nv_bfloat16>(prow, k0 + 8 + t2) : 0u,
                              0u};
#pragma unroll
      for (int i = 0; i < ACC / 2; ++i) {
        const int c0 = 16 * (warp + KW * i);
        if (c0 < hp) {
          uint32_t fb[4];
          v_frags<CT>(fb, sV, rb, k0, c0, lane);
          mma(acc[2 * i], fa, fb[0], fb[1]);
          mma(acc[2 * i + 1], fa, fb[2], fb[3]);
        }
      }
    }
  }

  // Column of acc[i][e]: 16 (warp + KW (i / 2)) + 8 (i % 2) + t2 + e.
  if (a.splits == 1) {  // the whole row: o / l
    if (gq < G) {
      const float l = sL[gq] == 0.f ? 1.f : sL[gq];
      QT* out = static_cast<QT*>(a.o) + (static_cast<long long>(bk) * G + gq) * H;
#pragma unroll
      for (int i = 0; i < ACC; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int h = 16 * (warp + KW * (i / 2)) + 8 * (i % 2) + t2 + e;
          if (h < H) out[h] = from_f<QT>(acc[i][e] / l);
        }
    }
    return;
  }

  const int hq = hpart(H);
  float* po = a.part + ((static_cast<long long>(bk) * a.splits + split) * G + gq) * hq;
  if (gq < G) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int h = 16 * (warp + KW * (i / 2)) + 8 * (i % 2) + t2;
      if (h < hq) *reinterpret_cast<float2*>(po + h) = make_float2(acc[i][0], acc[i][1]);
    }
  }
  if (tid < G) {
    float* ml = a.part + static_cast<long long>(a.BK) * a.splits * G * hq;
    reinterpret_cast<float2*>(ml)[(bk * a.splits + split) * G + tid] =
        make_float2(sM[tid], sL[tid]);
  }
}

// Writes o of (b, k) = blockIdx.y from its splits' parts, one float4 of o
// [G, Hp / 4] a thread.
template <typename QT>
__global__ void __launch_bounds__(NT) decode_combine(const Args a) {
  __shared__ float2 sML[MAXSPLIT][MAXG];
  __shared__ float sW[MAXSPLIT][MAXG];
  __shared__ float sMax[MAXG], sDen[MAXG];
  const int tid = threadIdx.x, bk = blockIdx.y, splits = a.splits;
  const int G = a.G, H = a.H, hq = hpart(H) / 4;
  const int e = blockIdx.x * NT + tid, g = e / hq, h = (e % hq) * 4;
  const bool live = e < G * hq;
  const float4* part = reinterpret_cast<const float4*>(a.part) +
                       static_cast<long long>(bk) * splits * G * hq + e;
  const float2* ml =
      reinterpret_cast<const float2*>(a.part + static_cast<long long>(a.BK) *
                                                   splits * G * hq * 4) +
      static_cast<long long>(bk) * splits * G;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the splits are done

  // All loads at once: the splits' (m, l) to shared memory, this thread's
  // parts of the first CB splits to registers.
  for (int i = tid; i < splits * G; i += NT) sML[i / G][i % G] = __ldcg(ml + i);
  float4 x[CB];
#pragma unroll
  for (int u = 0; u < CB; ++u)
    if (live && u < splits) x[u] = __ldcg(part + static_cast<long long>(u) * G * hq);
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int i = 0; i < splits; ++i) mx = fmaxf(mx, sML[i][tid].x);
    sMax[tid] = mx;
  }
  __syncthreads();
  for (int i = tid; i < splits * G; i += NT) {
    const float m = sML[i / G][i % G].x;
    sW[i / G][i % G] = m == -INFINITY ? 0.f : expf(m - sMax[i % G]);
  }
  __syncthreads();
  if (tid < G) {
    float l = 0.f;
    for (int i = 0; i < splits; ++i) l = fmaf(sW[i][tid], sML[i][tid].y, l);
    sDen[tid] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  if (!live) return;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < splits; i0 += CB) {
    if (i0 > 0) {
#pragma unroll
      for (int u = 0; u < CB; ++u)
        if (i0 + u < splits)
          x[u] = __ldcg(part + static_cast<long long>(i0 + u) * G * hq);
    }
#pragma unroll
    for (int u = 0; u < CB; ++u) {  // in split order
      if (i0 + u < splits) {
        const float w = sW[i0 + u][g];
        o.x = fmaf(w, x[u].x, o.x);
        o.y = fmaf(w, x[u].y, o.y);
        o.z = fmaf(w, x[u].z, o.z);
        o.w = fmaf(w, x[u].w, o.w);
      }
    }
  }
  const float den = sDen[g], r[4] = {o.x, o.y, o.z, o.w};
  QT* out = static_cast<QT*>(a.o) + (static_cast<long long>(bk) * G + g) * H;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (h + c < H) out[h + c] = from_f<QT>(r[c] / den);
}

template <typename QT, typename CT>
cudaError_t launch(const Args& a, cudaStream_t st) {
  // Dynamic shared memory: the K and V tiles and q. The limit is raised
  // once, to what the largest tile at H = 256 takes.
  static const cudaError_t raised = cudaFuncSetAttribute(
      decode_split<QT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * BT * row_bytes<CT>(MAXH) + MAXG * row_bytes<QT>(MAXH));
  if (raised != cudaSuccess) return raised;
  const int smem = 2 * ((a.tile + 15) & ~15) * row_bytes<CT>(a.H) +
                   MAXG * row_bytes<QT>(a.H);
  decode_split<QT, CT><<<dim3(a.splits, a.BK), KT, smem, st>>>(a);
  if (a.splits > 1) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((a.G * hpart(a.H) / 4 + NT - 1) / NT, a.BK);
    cfg.blockDim = dim3(NT);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_combine<QT>, a);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_cache(int cache_dtype, Args& a, bool cache_aligned,
                           cudaStream_t st) {
  // 16-byte copies of cache rows: aligned planes of whole 16-byte rows.
  switch (cache_dtype) {
    case 0:
      a.cvec = cache_aligned && a.H % 4 == 0;
      return launch<QT, float>(a, st);
    case 1:
      a.cvec = cache_aligned && a.H % 8 == 0;
      return launch<QT, __nv_bfloat16>(a, st);
    case 2:
      a.cvec = cache_aligned && a.H % 16 == 0;
      return launch<QT, int8_t>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. cache_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then k_scale and v_scale are required).
// softcap <= 0 means none. The grid: splits of per_split slots (a multiple
// of tile, tile <= 64), splits = ceil(S / per_split) <= 64. scratch: f32,
// B*K*splits*G*(round_up(H, 4) + 2) of them when splits > 1. Returns
// cudaGetLastError() after the launches.
extern "C" int bvt_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* mask, void* o, void* scratch,
    int q_dtype, int cache_dtype, int B, int K, int G, int S, int H,
    float softcap, int tile, int per_split, int splits, void* stream) {
  if (G < 1 || G > MAXG || H < 1 || H > MAXH || S < 1 || B < 1 || K < 1 ||
      tile < 1 || tile > BT || per_split < tile || per_split % tile ||
      splits != (S + per_split - 1) / per_split || splits > MAXSPLIT ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((cache_dtype == 2) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.mask = static_cast<const uint8_t*>(mask);
  a.o = o;
  a.part = static_cast<float*>(scratch);
  a.BK = B * K;
  a.K = K;
  a.G = G;
  a.S = S;
  a.H = H;
  a.tile = tile;
  a.per_split = per_split;
  a.splits = splits;
  a.softcap = softcap;
  const int q_bytes = q_dtype == 0 ? 4 : 2;
  a.qvec = reinterpret_cast<uintptr_t>(q) % 16 == 0 && H * q_bytes % 16 == 0;
  const bool cache_aligned = (reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return static_cast<int>(dispatch_cache<float>(cache_dtype, a, cache_aligned, st));
    case 1: return static_cast<int>(dispatch_cache<__nv_bfloat16>(cache_dtype, a, cache_aligned, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
