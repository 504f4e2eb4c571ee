// Shared device code of the attention kernels: warp reductions, row loads
// (bf16, or int8 codes times a per-row scale), the Rows functor that says
// where key t of one (row, kv head) lives and how it is stored, the
// one-token flash-decode fold (row and paged decode, and one shard's
// unnormalized partial) and the multi-query verify block (row and paged
// verify / chunked prefill).
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
// 0): NEG_INF is finite, so the combine's exp(m - M) stays 1 there.
template <int HD, int G, int NW, class R, class Vis, class Epi>
__device__ __forceinline__ void decode_fold(const bf16* __restrict__ q,
                                            const R& rows, int n, Vis vis,
                                            float scale, Epi epi) {
  static_assert(HD % 32 == 0, "head dim must be a multiple of 32");
  constexpr int DPL = HD / 32;
  __shared__ float q_s[G][HD];
  __shared__ float p_s[NW][G][32];
  __shared__ float m_s[NW][G];
  __shared__ float l_s[NW][G];
  __shared__ float acc_s[NW][G][HD];

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
      float kr[HD];
      rows.template key<HD>(t, 0, kr);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot += q_s[g][d] * kr[d];
        s[g] = dot;
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

// The normalized one-token decode over keys [0, n) (row and paged decode).
template <int HD, int G, int NW, class R>
__device__ __forceinline__ void decode_block(const bf16* __restrict__ q,
                                             const R& rows, int n,
                                             float scale,
                                             bf16* __restrict__ out) {
  decode_fold<HD, G, NW>(q, rows, n, AllKeys{}, scale, NormOut{out});
}

// ---------------------------------------------------------------------------
// Multi-query verify block (chunked prefill, speculative verify)
// ---------------------------------------------------------------------------

constexpr int VQ = 64;          // score rows per verify block
constexpr int VTHREADS = 128;   // two threads per score row

// Key tile width of the verify block: the two f32 tiles stay under 48 KB.
template <int HD>
struct VerifyTile {
  static constexpr int BK = HD >= 128 ? 32 : 64;
};

// Fold keys [0, n) of `rows` into one thread's running softmax state
// (m, l, acc).  n is the same for the whole block.  Each tile of BK keys
// is staged once in shared memory as f32 (int8 codes dequantized on the
// way in), rows padded by one word against bank conflicts, and shared by
// the block's VQ score rows.  Thread (row, half) scores the tile's keys
// 2i + half (vis(col) says whether its row sees key col) and owns head
// dims [half * HD/2, (half + 1) * HD/2) of the PV update; the partner's
// probabilities arrive through one shuffle.  Keys at or past n are never
// loaded.
template <int HD, int BK, class R, class Vis>
__device__ __forceinline__ void fold_keys(const R& rows, int n, Vis vis,
                                          const float* qr,
                                          float (&k_s)[BK][HD + 1],
                                          float (&v_s)[BK][HD + 1], float& m,
                                          float& l, float* acc) {
  constexpr int KPT = BK / 2;   // keys of a tile per thread
  constexpr int DH = HD / 2;    // head dims per thread in the PV update
  const int half = threadIdx.x & 1;
  for (int t0 = 0; t0 < n; t0 += BK) {
    for (int i = threadIdx.x; i < BK * HD / 8; i += VTHREADS) {
      const int kk = i / (HD / 8), c = (i % (HD / 8)) * 8;
      float kf[8], vf[8];
      if (t0 + kk < n) {
        rows.template key<8>(t0 + kk, c, kf);
        rows.template value<8>(t0 + kk, c, vf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        k_s[kk][c + e] = kf[e];
        v_s[kk][c + e] = vf[e];
      }
    }
    __syncthreads();

    float p[KPT];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kk = 2 * i + half;
      const int col = t0 + kk;
      const bool valid = col < n && vis(col);
      float s = NEG_INF;
      if (valid) {
        s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s += qr[d] * k_s[kk][d];
      }
      p[i] = valid ? s : -INFINITY;   // -inf marks masked for the exp below
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      p[i] = (p[i] == -INFINITY) ? 0.f : expf(p[i] - m_new);
      psum += p[i];
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;

    const int dbase = half * DH;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float mine = p[i];
      const float other = __shfl_xor_sync(FULL, mine, 1);
      const float* va = v_s[2 * i + half] + dbase;
      const float* vo = v_s[2 * i + 1 - half] + dbase;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] += mine * va[d] + other * vo[d];
    }
    __syncthreads();
  }
}

// Keys [0, n) of `a`, then the keys of `b`, as one key range: the verify
// block's cache before the block, followed by the block's own keys.
template <class A, class B>
struct Concat {
  A a;
  B b;
  int n;
  template <int N>
  __device__ __forceinline__ void key(int t, int c, float* dst) const {
    if (t < n) a.template key<N>(t, c, dst);
    else b.template key<N>(t - n, c, dst);
  }
  template <int N>
  __device__ __forceinline__ void value(int t, int c, float* dst) const {
    if (t < n) a.template value<N>(t, c, dst);
    else b.template value<N>(t - n, c, dst);
  }
};

// K block queries of one (row, kv head) at positions pos .. pos+K-1, the
// score rows [row0, row0 + VQ) of this block.  q holds the (K*G, HD) score
// rows: row r is block query i = r / G under query head r % G.  Every row
// sees the n_cache cache keys (the cache BEFORE the block: positions
// < pos), then block key j when j <= i (anc == nullptr) or when bit j of
// anc[i] is set (tree verify, K <= 31).  Cache and block fold as one key
// range into one softmax, so the result is the JAX kernel's
// cache-plus-block joint softmax.  Under the causal mask the range stops
// after the last block key any row of this block sees; block key i is
// visible to query i, so l > 0 even at pos == 0 where the cache is empty.
//
// ring_S > 0 makes the cache a ring of ring_S slots (a sliding window;
// n_cache = min(pos, ring_S), ring_pos = pos): cache slot s holds position
// p(s) = (pos-1) - ((pos-1-s) mod S) and is visible to query i only inside
// its window, p(s) > pos + i - S (p(s) >= 0 holds for every s < n_cache).
// Block keys stay visible under j <= i: K <= S keeps them in the window.
template <int HD, class CacheRows, class BlockRows>
__device__ __forceinline__ void verify_block(
    const bf16* __restrict__ q, const CacheRows& cache, int n_cache,
    const BlockRows& blk, int K, int G, const int* __restrict__ anc,
    float scale, bf16* __restrict__ out, int row0, int ring_pos = 0,
    int ring_S = 0) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BK = VerifyTile<HD>::BK;
  constexpr int DH = HD / 2;
  __shared__ float k_s[BK][HD + 1];
  __shared__ float v_s[BK][HD + 1];

  const int KG = K * G;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qrow = row0 + r;
  const bool live = qrow < KG;          // rows past KG compute, never store
  const int i = (live ? qrow : KG - 1) / G;

  float qr[HD];
  if (live) {
    load_row<HD>(q + (size_t)qrow * HD, qr);
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] *= scale;
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f, acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  const bool tree = anc != nullptr;
  const unsigned bits = tree ? (unsigned)anc[i] : 0u;
  const int n_blk = tree ? K : min(K, (min(row0 + VQ, KG) - 1) / G + 1);
  const Concat<CacheRows, BlockRows> keys{cache, blk, n_cache};
  fold_keys<HD, BK>(keys, n_cache + n_blk,
                    [=](int col) {
                      const int j = col - n_cache;
                      if (j < 0) {
                        if (ring_S == 0) return true;
                        const int p = ring_pos - 1 -
                                      (ring_pos - 1 - col) % ring_S;
                        return p >= 0 && p > ring_pos + i - ring_S;
                      }
                      return tree ? ((bits >> j) & 1u) != 0u : j <= i;
                    },
                    qr, k_s, v_s, m, l, acc);

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* o = out + (size_t)qrow * HD + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = __float2bfloat16(acc[d] * inv);
  }
}

}  // namespace repro

// Instantiate LAUNCH(HD, G) for every supported (head dim, group) pair;
// the C entry points return cudaErrorInvalidValue for any other pair.
#define REPRO_DECODE_DISPATCH(hd, G, LAUNCH)                        \
  do {                                                              \
    if (hd == 32 && G == 1) { LAUNCH(32, 1); }                      \
    else if (hd == 32 && G == 2) { LAUNCH(32, 2); }                 \
    else if (hd == 32 && G == 4) { LAUNCH(32, 4); }                 \
    else if (hd == 32 && G == 8) { LAUNCH(32, 8); }                 \
    else if (hd == 64 && G == 1) { LAUNCH(64, 1); }                 \
    else if (hd == 64 && G == 2) { LAUNCH(64, 2); }                 \
    else if (hd == 64 && G == 4) { LAUNCH(64, 4); }                 \
    else if (hd == 64 && G == 8) { LAUNCH(64, 8); }                 \
    else if (hd == 128 && G == 1) { LAUNCH(128, 1); }               \
    else if (hd == 128 && G == 2) { LAUNCH(128, 2); }               \
    else if (hd == 128 && G == 4) { LAUNCH(128, 4); }               \
    else if (hd == 128 && G == 8) { LAUNCH(128, 8); }               \
    else { return (int)cudaErrorInvalidValue; }                     \
  } while (0)

// Instantiate LAUNCH(HD) for every supported head dim of the verify block,
// after checking the shape arguments every verify entry point takes.
#define REPRO_VERIFY_DISPATCH(hd, G, K, LAUNCH)                     \
  do {                                                              \
    if (G < 1 || K < 1) return (int)cudaErrorInvalidValue;          \
    if (hd == 32) { LAUNCH(32); }                                   \
    else if (hd == 64) { LAUNCH(64); }                              \
    else if (hd == 128) { LAUNCH(128); }                            \
    else { return (int)cudaErrorInvalidValue; }                     \
  } while (0)
