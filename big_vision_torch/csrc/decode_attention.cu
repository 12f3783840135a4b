// Single-token grouped-query decode attention for Hopper (sm_90a): the port
// of the TPU kernel `_kernel` / `decode_attention` in
// big_vision_tpu/ops/decode_attention.py.
//
// What it computes, per (batch b, kv head k), for its G <= 8 query rows:
// q and the cache rows rounded to bf16 (int8 and bf16 storage are exact),
// s = q . k in f32, times the per-slot k-scale when the cache is int8, then
// the optional softcap cap*tanh(s/cap), the [B, S] mask, the softmax sum l
// taken BEFORE the per-slot v-scale multiplies p, p rounded to bf16, and
// o = (p . v) / l in q's dtype. There is no 1/sqrt(D): q arrives pre-scaled.
// A row with no visible slot emits exact zeros.
//
// Layout: q [B, K, G, H] (f32 or bf16), cache k, v [B, K, S, H] read in
// their storage dtype (int8, bf16 or f32), scales [B, K, S] f32 or null,
// mask [B, S] bool (one byte), out [B, K, G, H] in q's dtype. H is a
// multiple of 8 up to 256 and rows are 16-byte aligned: lane l owns the 8
// consecutive elements [8l, 8l + 8) of every row and reads them with one
// vector load.
//
// Design. One block per (b, k), 256 threads (8 warps). Each lane keeps its
// 8 elements of the G query rows in registers; the block walks S in tiles
// of 64 slots, and warp w owns slots w, w+8, ... of every tile. Per tile:
// the warp issues the loads of the K rows of its 8 slots at once (with the
// tile's mask and scales), a warp shuffle reduces each of the G dot
// products; the warp then issues its V loads, and one warp per query row
// updates an online softmax (running f32 max m and sum l in shared memory)
// while they are in flight; then each warp adds p . v into its own partial
// output in registers. At the end the 8 partial outputs are summed in a
// fixed order in shared memory. The kernel is bound by the latency of
// about two memory round trips per tile. The cache is read once, in its
// storage dtype: a bf16 cache moves 2 bytes per element, int8 one.
//
// Bound: the bytes of K and V. At gemma_2b serving shapes (B=8, K=1, S=352,
// H=256, bf16) that is 2.9 MB, about 0.9 us at 3.35 TB/s. Known weakness:
// with one KV head there are only B = 8 blocks for 132 SMs, so a launch is
// latency-bound far above that; splitting S across blocks is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int TS = 64;         // cache slots per tile
constexpr int SPW = TS / NW;   // slots per warp per tile
constexpr int MAXG = 8;        // query rows per kv head
constexpr int EPL = 8;         // row elements per lane (H <= 32 * EPL)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Eight consecutive elements at p (16-byte aligned for 2- and 4-byte types,
// 8-byte for int8) as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = (float)b[i];
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// This warp's rows j = warp + NW * i (i < SPW) of a [S, H] plane from slot
// s0, as floats rounded to bf16 (exact for bf16 and int8 storage). All the
// loads are issued before any is used; rows past the tile's n read as 0.
template <typename CT>
__device__ __forceinline__ void load_rows(const CT* plane, int s0, int n,
                                          int H, int h0, bool active,
                                          int warp, float (&out)[SPW][EPL]) {
#pragma unroll
  for (int i = 0; i < SPW; ++i) {
    const int j = warp + NW * i;
    if (j < n && active) {
      load8(plane + (long long)(s0 + j) * H + h0, out[i]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) out[i][e] = 0.f;
    }
  }
  if (std::is_same<CT, float>::value) {
#pragma unroll
    for (int i = 0; i < SPW; ++i)
#pragma unroll
      for (int e = 0; e < EPL; ++e) out[i][e] = bf16_round(out[i][e]);
  }
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename QT, typename CT, bool QUANT>
__global__ void __launch_bounds__(NT)
decode_kernel(const QT* __restrict__ q, const CT* __restrict__ k,
              const CT* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const uint8_t* __restrict__ mask, QT* __restrict__ o, int K,
              int G, int S, int H, float softcap) {
  __shared__ float sS[MAXG][TS];  // scores, then bf16 probabilities
  __shared__ float sO[MAXG][32 * EPL];
  __shared__ float sM[MAXG], sL[MAXG], sAlpha[MAXG];
  __shared__ float sKs[TS], sVs[TS];  // per-slot scales of the tile
  __shared__ bool sVis[TS];           // the tile's mask

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bk = blockIdx.x;  // b * K + kv_head
  const int b = bk / K;
  const long long plane = (long long)bk * S * H;
  const uint8_t* mrow = mask + (long long)b * S;
  const int h0 = lane * EPL;
  const bool active = h0 < H;  // lanes past H hold zeros

  // This lane's 8 elements of every query row, rounded to bf16 once.
  float qr[MAXG][EPL], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G && active) {
      load8(q + ((long long)bk * G + g) * H + h0, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = bf16_round(qr[g][e]);
      acc[g][e] = 0.f;
    }
  }
  if (tid < MAXG) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  // Per tile: K loads and the tile's mask and scales in flight together;
  // the V loads are issued before the softmax so that it hides them.
  for (int s0 = 0; s0 < S; s0 += TS) {
    const int n = min(TS, S - s0);
    __syncthreads();  // the previous tile's readers are done with sS, sVis
    float kv[SPW][EPL];
    load_rows(k + plane, s0, n, H, h0, active, warp, kv);
    if (tid < TS) {
      const bool vis = tid < n && mrow[s0 + tid] != 0;
      const long long at = (long long)bk * S + s0 + tid;
      sVis[tid] = vis;
      sKs[tid] = (QUANT && tid < n) ? k_scale[at] : 1.f;
      sVs[tid] = (QUANT && tid < n) ? v_scale[at] : 1.f;
    }
    __syncthreads();

    // Scores of this warp's slots j = warp + NW * i. The G dot products of
    // a slot are reduced across lanes together, so their shuffles overlap.
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const int j = warp + NW * i;
      float x[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        x[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) x[g] = fmaf(qr[g][e], kv[i][e], x[g]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          x[g] += __shfl_xor_sync(0xffffffffu, x[g], off);
      if (lane < G) {  // lane g writes query row g's score
        float y = x[0];
#pragma unroll
        for (int g = 1; g < MAXG; ++g) y = lane == g ? x[g] : y;
        y *= sKs[j];
        if (softcap > 0.f) y = softcap * tanhf(y / softcap);
        // -inf marks a masked slot: exp(-inf - m) is exactly 0 below.
        sS[lane][j] = sVis[j] ? y : -INFINITY;
      }
    }
    float vv[SPW][EPL];
    load_rows(v + plane, s0, n, H, h0, active, warp, vv);
    __syncthreads();

    // Online softmax: warp g owns query row g, two slots per lane.
    if (warp < G) {
      const int g = warp;
      const float a = sS[g][lane], c = sS[g][lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);  // finite: m starts at NEG_INF
      const float pa = __expf(a - m_new), pc = __expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // l is summed before the v-scale; p goes to p.v as bf16.
      sS[g][lane] = bf16_round(pa * sVs[lane]);
      sS[g][lane + 32] = bf16_round(pc * sVs[lane + 32]);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // This warp's partial output: acc = acc * alpha + p . v over its slots.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
      const float al = sAlpha[g];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= al;
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        const float p = sS[g][warp + NW * i];  // 0 for slots past n
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vv[i][e], acc[g][e]);
      }
    }
  }

  // Sum the warps' partial outputs in a fixed order.
  for (int w = 0; w < NW; ++w) {
    if (warp == w && active) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) continue;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          sO[g][h0 + e] = (w == 0 ? 0.f : sO[g][h0 + e]) + acc[g][e];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < G * H; i += NT) {
    const int g = i / H, h = i % H;
    const float l = sL[g];
    o[(long long)bk * G * H + i] = from_f<QT>(sO[g][h] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename CT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const uint8_t* mask,
                   void* o, int B, int K, int G, int S, int H, float softcap,
                   cudaStream_t stream) {
  dim3 grid(B * K);
  if (ks != nullptr) {
    decode_kernel<QT, CT, true><<<grid, NT, 0, stream>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(k),
        static_cast<const CT*>(v), ks, vs, mask, static_cast<QT*>(o), K, G,
        S, H, softcap);
  } else {
    decode_kernel<QT, CT, false><<<grid, NT, 0, stream>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(k),
        static_cast<const CT*>(v), nullptr, nullptr, mask,
        static_cast<QT*>(o), K, G, S, H, softcap);
  }
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_cache(int cache_dtype, const void* q, const void* k,
                           const void* v, const float* ks, const float* vs,
                           const uint8_t* mask, void* o, int B, int K, int G,
                           int S, int H, float softcap, cudaStream_t st) {
  switch (cache_dtype) {
    case 0: return launch<QT, float>(q, k, v, ks, vs, mask, o, B, K, G, S, H, softcap, st);
    case 1: return launch<QT, __nv_bfloat16>(q, k, v, ks, vs, mask, o, B, K, G, S, H, softcap, st);
    case 2: return launch<QT, int8_t>(q, k, v, ks, vs, mask, o, B, K, G, S, H, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. cache_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then k_scale and v_scale are required).
// softcap <= 0 means none. Returns cudaGetLastError() after the launch.
extern "C" int bvt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* k_scale,
                                    const void* v_scale, const void* mask,
                                    void* o, int q_dtype, int cache_dtype,
                                    int B, int K, int G, int S, int H,
                                    float softcap, void* stream) {
  if (G < 1 || G > MAXG || H < 8 || H > 32 * EPL || H % 8 || S < 1 || B < 1 ||
      K < 1)
    return (int)cudaErrorInvalidValue;
  if ((cache_dtype == 2) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return (int)dispatch_cache<float>(cache_dtype, q, k, v, ks, vs, m, o, B, K, G, S, H, softcap, st);
    case 1: return (int)dispatch_cache<__nv_bfloat16>(cache_dtype, q, k, v, ks, vs, m, o, B, K, G, S, H, softcap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
