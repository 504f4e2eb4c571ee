// Shared device code of the attention kernels: warp reductions, row loads
// (bf16, or int8 codes times a per-row scale), the Rows functor that says
// where key t of one (row, kv head) lives and how it is stored, and the
// one-token flash-decode fold (row and paged decode, and one shard's
// unnormalized partial).  The multi-query verify body (row and paged
// verify, chunked prefill) is verify_tc.cuh, on the tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;   // the JAX kernels' masked score
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// N consecutive bf16 values -> floats.  N % 8 == 0 loads 16-byte vectors
// (the address must be 16-byte aligned); N of 1, 2 or 4 loads one word.
template <int N>
__device__ __forceinline__ void load_row(const bf16* __restrict__ src,
                                         float* dst) {
  if constexpr (N % 8 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      uint4 u = s[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        dst[8 * i + 2 * j] = f.x;
        dst[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (N == 1) {
    dst[0] = __bfloat162float(src[0]);
  } else if constexpr (N == 2) {
    float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src));
    dst[0] = f.x;
    dst[1] = f.y;
  } else {
    static_assert(N == 4, "1, 2, 4 or a multiple of 8 values");
    uint2 u = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
  }
}

// N consecutive int8 codes -> floats, each times `scale` (the JAX int8
// bank's dequantization, codes * scale in f32).  N % 16 == 0 loads
// 16-byte vectors; N of 1, 2, 4 or 8 loads one word of N bytes (the
// address must be aligned to the load).
template <int N>
__device__ __forceinline__ void load_row(const int8_t* __restrict__ src,
                                         float scale, float* dst) {
  if constexpr (N % 16 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      uint4 u = s[i];
      const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[16 * i + j] = (float)c[j] * scale;
    }
  } else {
    static_assert(N == 1 || N == 2 || N == 4 || N == 8,
                  "1, 2, 4, 8 or a multiple of 16 codes");
    using W = typename std::conditional<
        N == 8, uint2,
        typename std::conditional<
            N == 4, uint32_t,
            typename std::conditional<N == 2, uint16_t,
                                      uint8_t>::type>::type>::type;
    W u = *reinterpret_cast<const W*>(src);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = (float)c[j] * scale;
  }
}

// How keys and values are stored.  Both index an (HD,) key or value row
// by its flat row number r in the cache tensor (row cache: (b*Hkv+h)*S+t;
// page pool: (pid*Hkv+h)*page+slot).
template <int HD>
struct Bf16KV {                   // full precision
  const bf16* k;
  const bf16* v;
  template <int N>
  __device__ __forceinline__ void key(size_t r, int c, float* dst) const {
    load_row<N>(k + r * HD + c, dst);
  }
  template <int N>
  __device__ __forceinline__ void value(size_t r, int c, float* dst) const {
    load_row<N>(v + r * HD + c, dst);
  }
};

template <int HD>
struct Int8KV {                   // int8 codes + one f32 scale per row
  const int8_t* k;
  const int8_t* v;
  const float* ks;                // (NP, Hkv, page): the same flat rows
  const float* vs;
  template <int N>
  __device__ __forceinline__ void key(size_t r, int c, float* dst) const {
    load_row<N>(k + r * HD + c, ks[r], dst);
  }
  template <int N>
  __device__ __forceinline__ void value(size_t r, int c, float* dst) const {
    load_row<N>(v + r * HD + c, vs[r], dst);
  }
};

// Where key t of one (row, kv head) lives: a contiguous run of rows...
struct ContigMap {
  size_t base;
  __device__ __forceinline__ size_t operator()(int t) const {
    return base + t;
  }
};

// ... or slot t % page of pool page table[t / page].
struct PagedMap {
  const int* table;               // (P,) page ids of this row
  int page, Hkv, h;
  __device__ __forceinline__ size_t operator()(int t) const {
    return ((size_t)table[t / page] * Hkv + h) * page + (t % page);
  }
};

// Key / value t of one (row, kv head): N values from head dim c, as
// floats.  The attention blocks below read every key through this.
template <class KV, class Map>
struct Rows {
  KV kv;
  Map map;
  template <int N>
  __device__ __forceinline__ void key(int t, int c, float* dst) const {
    kv.template key<N>(map(t), c, dst);
  }
  template <int N>
  __device__ __forceinline__ void value(int t, int c, float* dst) const {
    kv.template value<N>(map(t), c, dst);
  }
};

// Which keys of a one-token decode a lane may fold: all of them (row and
// paged decode), or those a predicate admits (one shard's partial over
// the pages it owns).
struct AllKeys {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

// Epilogues of the decode fold: the normalized output in bf16 ...
struct NormOut {
  bf16* out;                      // (G, HD)
  __device__ __forceinline__ void operator()(int i, int, int, float A,
                                             float L, float) const {
    out[i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
};

// ... or the unnormalized flash state in f32: acc (G, HD), m and l (G,).
struct PartialOut {
  float* acc;
  float* m;
  float* l;
  __device__ __forceinline__ void operator()(int i, int g, int d, float A,
                                             float L, float M) const {
    acc[i] = A;
    if (d == 0) {
      m[g] = M;
      l[g] = L;
    }
  }
};

// One-token flash-decode for one (row, kv head): the G query heads of the
// kv head attend over the keys t < n that vis(t) admits.  NW warps split
// the keys into 32-key tiles (tile i goes to warp i % NW).  In a tile
// every lane scores ONE key against all G heads (its key row loads as
// whole 16-byte vectors), the warp updates its running (m, l) per head
// with two shuffles, writes its probabilities to shared memory, and then
// every lane folds the tile's admitted keys into the HD/32 head dims it
// owns (value rows load coalesced).  A tile with no admitted key is
// skipped whole.  Each warp keeps its own (m, l, acc) in registers; one
// combine through shared memory at the end merges the NW partial states
// and hands each (head, dim) to the epilogue as (A, L, M).  Keys at or
// past n are never loaded, so a row's unwritten tail (and, paged, its
// park page) is never read.  A row that admits no key ends at (0, NEG_INF,
// 0): NEG_INF is finite, so the combine's exp(m - M) stays 1 there.  A key
// row is scored in slices of at most 64 head dims (in order, so each dot
// product sums as one loop would), which keeps a 256-wide row out of the
// registers; q's f32 copy and the combine share one shared-memory buffer.
template <int HD, int G, int NW, class R, class Vis, class Epi>
__device__ __forceinline__ void decode_fold(const bf16* __restrict__ q,
                                            const R& rows, int n, Vis vis,
                                            float scale, Epi epi) {
  static_assert(HD % 32 == 0, "head dim must be a multiple of 32");
  constexpr int DPL = HD / 32;
  constexpr int KC = HD < 64 ? HD : 64;     // head dims of a key slice
  __shared__ float qa_s[NW * G * HD];       // q_s, then acc_s
  __shared__ float p_s[NW][G][32];
  __shared__ float m_s[NW][G];
  __shared__ float l_s[NW][G];
  float (*q_s)[HD] = reinterpret_cast<float (*)[HD]>(qa_s);
  float (*acc_s)[G][HD] = reinterpret_cast<float (*)[G][HD]>(qa_s);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < G * HD; i += NW * 32)
    q_s[i / HD][i % HD] = __bfloat162float(q[i]) * scale;
  __syncthreads();

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  // every key admitted: no ballot, no skips (the decode kernels' code)
  constexpr bool kAll = std::is_same<Vis, AllKeys>::value;
  for (int t0 = warp * 32; t0 < n; t0 += NW * 32) {
    const int t = t0 + lane;
    const bool valid = t < n && vis(t);
    [[maybe_unused]] unsigned vmask = FULL;
    if constexpr (!kAll) {
      vmask = __ballot_sync(FULL, valid);
      if (vmask == 0u) continue;        // warp-uniform: nothing to fold
    }
    float s[G];
    if (valid) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += KC) {
        float kr[KC];
        rows.template key<KC>(t, c, kr);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = s[g];
#pragma unroll
          for (int d = 0; d < KC; ++d) dot += q_s[g][c + d] * kr[d];
          s[g] = dot;
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = NEG_INF;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_new = fmaxf(m[g], warp_max(s[g]));
      const float alpha = expf(m[g] - m_new);
      const float p = valid ? expf(s[g] - m_new) : 0.f;
      l[g] = alpha * l[g] + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
      p_s[warp][g][lane] = p;
    }
    __syncwarp();
    const int cnt = min(32, n - t0);
    for (int j = 0; j < cnt; ++j) {
      if constexpr (!kAll) {
        if (!((vmask >> j) & 1u)) continue;   // warp-uniform
      }
      float vv[DPL];
      rows.template value<DPL>(t0 + j, lane * DPL, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = p_s[warp][g][j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] += pj * vv[i];
      }
    }
    __syncwarp();
  }

  __syncthreads();                      // every warp is done with q_s
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[warp][g][lane * DPL + i] = acc[g][i];
  __syncthreads();

  for (int i = threadIdx.x; i < G * HD; i += NW * 32) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m_s[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(m_s[w][g] - M);
      L += l_s[w][g] * c;
      A += acc_s[w][g][d] * c;
    }
    epi(i, g, d, A, L, M);
  }
}

// Warps of a decode block: 8, fewer where G * HD is wide, so that the
// combine's and the probabilities' NW * G * (HD + 32) floats stay within
// 40 KB of static shared memory.
template <int HD, int G>
constexpr int decode_warps() {
  return 10240 / (G * (HD + 32)) >= 8 ? 8 : 10240 / (G * (HD + 32));
}

// The normalized one-token decode over keys [0, n) (row and paged decode).
template <int HD, int G, int NW, class R>
__device__ __forceinline__ void decode_block(const bf16* __restrict__ q,
                                             const R& rows, int n,
                                             float scale,
                                             bf16* __restrict__ out) {
  decode_fold<HD, G, NW>(q, rows, n, AllKeys{}, scale, NormOut{out});
}

}  // namespace repro

// Instantiate LAUNCH(HD, G) for every supported (head dim, group) pair:
// head dim 32, 64, 128 or 256 and group 1, 2, 4, 8 or 16 (the wrappers pad
// any other width or group with zeros); the C entry points return
// cudaErrorInvalidValue for any other pair.
#define REPRO_DECODE_G(hd_, G, LAUNCH)                              \
  do {                                                              \
    if (G == 1) { LAUNCH(hd_, 1); }                                 \
    else if (G == 2) { LAUNCH(hd_, 2); }                            \
    else if (G == 4) { LAUNCH(hd_, 4); }                            \
    else if (G == 8) { LAUNCH(hd_, 8); }                            \
    else if (G == 16) { LAUNCH(hd_, 16); }                          \
    else { return (int)cudaErrorInvalidValue; }                     \
  } while (0)

#define REPRO_DECODE_DISPATCH(hd, G, LAUNCH)                        \
  do {                                                              \
    if (hd == 32) { REPRO_DECODE_G(32, G, LAUNCH); }                \
    else if (hd == 64) { REPRO_DECODE_G(64, G, LAUNCH); }           \
    else if (hd == 128) { REPRO_DECODE_G(128, G, LAUNCH); }         \
    else if (hd == 256) { REPRO_DECODE_G(256, G, LAUNCH); }         \
    else { return (int)cudaErrorInvalidValue; }                     \
  } while (0)
