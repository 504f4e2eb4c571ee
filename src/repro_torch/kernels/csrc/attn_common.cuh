// Shared device code of the attention kernels: warp reductions, bf16 row
// loads, and the one-token flash-decode block that the row-cache and the
// paged-cache decode kernels both run (they differ only in where key t of
// a (row, kv head) lives, which the Rows functor answers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// N bf16 values at a 16-byte aligned address -> N floats (N % 8 == 0).
template <int N>
__device__ __forceinline__ void load_bf16x8(const bf16* __restrict__ src,
                                            float* dst) {
  static_assert(N % 8 == 0, "rows are loaded 8 values at a time");
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
}

// N (1, 2 or 4) consecutive bf16 values -> floats.
template <int N>
__device__ __forceinline__ void load_bf16_small(const bf16* __restrict__ src,
                                                float* dst) {
  if constexpr (N == 1) {
    dst[0] = __bfloat162float(src[0]);
  } else if constexpr (N == 2) {
    float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src));
    dst[0] = f.x;
    dst[1] = f.y;
  } else {
    static_assert(N == 4, "2 or 4 dims per lane");
    uint2 u = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
  }
}

// One-token flash-decode for one (row, kv head): the G query heads of the
// kv head attend over keys [0, n).  NW warps split the keys into 32-key
// tiles (tile i goes to warp i % NW).  In a tile every lane scores ONE key
// against all G heads (its key row loads as whole 16-byte vectors), the
// warp updates its running (m, l) per head with two shuffles, writes its
// probabilities to shared memory, and then every lane folds all keys of
// the tile into the HD/32 head dims it owns (value rows load coalesced).
// Each warp keeps its own (m, l, acc) in registers; one combine through
// shared memory at the end merges the NW partial states.  Keys at or past
// n are never loaded, so a row's unwritten tail (and, paged, its park
// page) is never read.
template <int HD, int G, int NW, class Rows>
__device__ __forceinline__ void decode_block(const bf16* __restrict__ q,
                                             const Rows& rows, int n,
                                             float scale,
                                             bf16* __restrict__ out) {
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

  for (int t0 = warp * 32; t0 < n; t0 += NW * 32) {
    const int t = t0 + lane;
    const bool valid = t < n;
    float s[G];
    if (valid) {
      float kr[HD];
      load_bf16x8<HD>(rows.key(t), kr);
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
      float vv[DPL];
      load_bf16_small<DPL>(rows.value(t0 + j) + lane * DPL, vv);
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
    out[i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
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
