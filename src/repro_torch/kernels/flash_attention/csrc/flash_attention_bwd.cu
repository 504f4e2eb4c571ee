// Backward of the causal (optionally sliding-window, GQA) prefill attention
// of flash_attention.cu, for Hopper (sm_90a), on the CUDA cores.
//
// Replaces: no TPU kernel.  repro/kernels/flash_attention/kernel.py ::
//   flash_attention has no VJP (jax.grad through it raises); the JAX
//   package trains through XLA's gradient of its plain attention, and so
//   cannot train with its Pallas kernels on.  The port's trainer
//   differentiates B1 on the card, so B1 needs a backward: this kernel.
//
// Computes, from Q, K, V, O, dO and the forward's per-row log-sum-exp L
// (natural log of sum_j exp(scale q.k_j) over the row's unmasked keys):
//   P = exp(scale Q K^T - L) (masked), D = rowsum(dO * O),
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - D),
//   dQ = scale dS K, dK = scale dS^T Q.
// L comes from the forward, which writes it through an optional output
// pointer (null when serving, so serving's launches do not change): the
// forward holds each row's running max and sum in registers at its end,
// and one float a row costs it nothing, where a pass recomputing L here
// would read Q and K once more.
//
// Deterministic: no atomics, so every output element is summed in one
// fixed order and a run repeats bit for bit.  Two kernels, each owning
// its outputs:
//   dq   -- a block per (T query rows, q head, batch row): D of its rows
//           (also written for the second kernel), then the key tiles its
//           rows see; dQ in registers.
//   dkdv -- a block per (T keys, kv head, batch row): the group's G query
//           heads in order, and for each the query tiles that see its
//           keys; dK and dV in registers, so the GQA sum over the group
//           runs in one fixed order.
// Both recompute P and dP from the tiles (seven T x T x hd products a
// tile pair against the five of a backward that adds dQ with atomics).
// Tiles wholly above the diagonal or behind the window are skipped.
//
// Bound on an H100: the backward reads Q, K, V, O, dO (bf16) and L once
// and writes dQ, dK, dV, about 16 S hd bytes a head; it does about 2.5x
// the forward's 4 S^2 hd / 2 causal flops.  At the training shapes (S of
// a few hundred, hd 32-64) it is bound by bf16 tensor-core operations.
// This first version is simple and right: f32 products on the CUDA cores
// (67 TFLOP/s peak), tiles staged in shared memory as bf16 pairs (row
// stride odd in 32-bit words, so the 16 rows a warp reads at once fall in
// 16 banks), each thread holding a micro-tile of scores and of its
// outputs in registers.  It is therefore far off the tensor-core bound; a
// wgmma redesign is later work.  Instantiated head widths: 32, 64, 128
// and 256, as the forward; tiles of 64 rows (32 at hd 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int T = HD == 256 ? 32 : 64;  // rows of a tile
  static constexpr int HW = HD / 2;              // bf16 pairs of a row
  static constexpr int W = HW + 1;               // words of a smem row (odd)
  static constexpr int SR = T / 16;              // a thread's score tile side
  static constexpr int PW = T + 1;               // floats of a P / dS row
  // accumulation: a thread grid RT x DT over (T rows, HW column pairs)
  static constexpr int CR = 4;                   // rows a thread accumulates
  static constexpr int RT = T / CR;
  static constexpr int DT = THREADS / RT;
  static constexpr int CP = HW / DT;             // pairs a thread accumulates
  static constexpr int TILE = T * W;             // words of one tile
  static constexpr int SMEM = (4 * TILE + 2 * T * PW + 2 * T) * 4;
  static_assert(CP >= 1 && HW % DT == 0, "column pairs must split evenly");
};

// (sb, sh, ss): element strides of batch, head and sequence
struct Strides {
  long long sb, sh, ss;
};

__device__ __forceinline__ float2 unpack(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + T) of one (S, HD) operand into a smem tile of bf16 pairs,
// zeros past S
template <int HD>
__device__ void load_tile(uint32_t* dst, const bf16* src, long long ss,
                          int r0, int S) {
  using C = Cfg<HD>;
  for (int i = threadIdx.x; i < C::T * C::HW; i += THREADS) {
    const int r = i / C::HW, w = i % C::HW;
    uint32_t v = 0u;
    if (r0 + r < S)
      v = *reinterpret_cast<const uint32_t*>(src + (r0 + r) * ss + 2 * w);
    dst[r * C::W + w] = v;
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over the head width (f32)
template <int HD>
__device__ __forceinline__ void tile_dot(float (&s)[Cfg<HD>::SR][Cfg<HD>::SR],
                                         const uint32_t* a, const uint32_t* b,
                                         int ty, int tx) {
  using C = Cfg<HD>;
#pragma unroll
  for (int i = 0; i < C::SR; ++i)
#pragma unroll
    for (int j = 0; j < C::SR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int w = 0; w < C::HW; ++w) {
    float2 av[C::SR], bv[C::SR];
#pragma unroll
    for (int i = 0; i < C::SR; ++i) av[i] = unpack(a[(ty + 16 * i) * C::W + w]);
#pragma unroll
    for (int j = 0; j < C::SR; ++j) bv[j] = unpack(b[(tx + 16 * j) * C::W + w]);
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
#pragma unroll
      for (int j = 0; j < C::SR; ++j)
        s[i][j] = fmaf(av[i].y, bv[j].y, fmaf(av[i].x, bv[j].x, s[i][j]));
  }
}

// the scores' mask: key col visible to query row
__device__ __forceinline__ bool visible(int row, int col, int S, int causal,
                                        int window) {
  return row < S && col < S && (!causal || col <= row) &&
         (window <= 0 || row - col < window);
}

// P and dS of one (query tile q0, key tile k0) pair into smem (P only
// where ps is not null): p = exp(scale s - L) where visible, ds = p (dp - D)
template <int HD>
__device__ __forceinline__ void scores(float* ps, float* dss,
                                       const uint32_t* qs, const uint32_t* dos,
                                       const uint32_t* ks, const uint32_t* vs,
                                       const float* lse2, const float* dsum,
                                       int q0, int k0, int S, int causal,
                                       int window, float scale_log2) {
  using C = Cfg<HD>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[C::SR][C::SR], dp[C::SR][C::SR];
  tile_dot<HD>(s, qs, ks, ty, tx);
  tile_dot<HD>(dp, dos, vs, ty, tx);
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < C::SR; ++j) {
      const int c = tx + 16 * j;
      const float p = visible(q0 + r, k0 + c, S, causal, window)
                          ? exp2f(s[i][j] * scale_log2 - lse2[r])
                          : 0.f;
      if (ps != nullptr) ps[r * C::PW + c] = p;
      dss[r * C::PW + c] = p * (dp[i][j] - dsum[r]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ dsum_out, bf16* __restrict__ dq, Strides tq,
              Strides tk, Strides tv, Strides to, Strides tdo, Strides tdq,
              int H, int Hkv, int S, int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int T = C::T;
  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* dos = qs + C::TILE;
  uint32_t* ks = dos + C::TILE;   // first O, for D
  uint32_t* vs = ks + C::TILE;
  float* dss = reinterpret_cast<float*>(vs + C::TILE);
  float* lse2 = dss + 2 * T * C::PW;
  float* dsum = lse2 + T;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * T;
  const long long row_base = ((long long)b * H + h) * S;
  load_tile<HD>(qs, q + b * tq.sb + h * tq.sh, tq.ss, q0, S);
  load_tile<HD>(dos, dout + b * tdo.sb + h * tdo.sh, tdo.ss, q0, S);
  load_tile<HD>(ks, o + b * to.sb + h * to.sh, to.ss, q0, S);
  __syncthreads();
  for (int r = threadIdx.x; r < T; r += THREADS) {
    float d = 0.f;
    for (int w = 0; w < C::HW; ++w) {
      const float2 a = unpack(dos[r * C::W + w]), c = unpack(ks[r * C::W + w]);
      d = fmaf(a.y, c.y, fmaf(a.x, c.x, d));
    }
    const bool live = q0 + r < S;
    dsum[r] = d;
    lse2[r] = live ? lse[row_base + q0 + r] * LOG2E : 0.f;
    if (live) dsum_out[row_base + q0 + r] = d;
  }

  const int n_tiles = (S + T - 1) / T;
  const int kt_end = causal ? qt + 1 : n_tiles;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / T : 0;
  const int tr = threadIdx.x / C::DT, td = threadIdx.x % C::DT;
  float2 acc[C::CR][C::CP];
#pragma unroll
  for (int i = 0; i < C::CR; ++i)
#pragma unroll
    for (int p = 0; p < C::CP; ++p) acc[i][p] = make_float2(0.f, 0.f);
  const float scale_log2 = scale * LOG2E;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __syncthreads();              // the last tile's (or D's) reads are done
    load_tile<HD>(ks, k + b * tk.sb + hk * tk.sh, tk.ss, kt * T, S);
    load_tile<HD>(vs, v + b * tv.sb + hk * tv.sh, tv.ss, kt * T, S);
    __syncthreads();
    scores<HD>(nullptr, dss, qs, dos, ks, vs, lse2, dsum, q0, kt * T, S,
               causal, window, scale_log2);
    __syncthreads();
    // dQ[r] += dS[r][c] K[c] over the tile's keys, in key order
    for (int c = 0; c < T; ++c) {
      float x[C::CR];
#pragma unroll
      for (int i = 0; i < C::CR; ++i) x[i] = dss[(tr + C::RT * i) * C::PW + c];
#pragma unroll
      for (int p = 0; p < C::CP; ++p) {
        const float2 kv = unpack(ks[c * C::W + td + C::DT * p]);
#pragma unroll
        for (int i = 0; i < C::CR; ++i) {
          acc[i][p].x = fmaf(x[i], kv.x, acc[i][p].x);
          acc[i][p].y = fmaf(x[i], kv.y, acc[i][p].y);
        }
      }
    }
  }
  bf16* out = dq + b * tdq.sb + h * tdq.sh;
#pragma unroll
  for (int i = 0; i < C::CR; ++i) {
    const int row = q0 + tr + C::RT * i;
    if (row >= S) continue;
#pragma unroll
    for (int p = 0; p < C::CP; ++p)
      *reinterpret_cast<uint32_t*>(out + row * tdq.ss +
                                   2 * (td + C::DT * p)) =
          pack(acc[i][p].x * scale, acc[i][p].y * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum_in, bf16* __restrict__ dk,
                bf16* __restrict__ dv, Strides tq, Strides tk, Strides tv,
                Strides tdo, Strides tdk, Strides tdv, int H, int Hkv, int S,
                int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int T = C::T;
  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* dos = qs + C::TILE;
  uint32_t* ks = dos + C::TILE;
  uint32_t* vs = ks + C::TILE;
  float* ps = reinterpret_cast<float*>(vs + C::TILE);
  float* dss = ps + T * C::PW;
  float* lse2 = dss + T * C::PW;
  float* dsum = lse2 + T;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int k0 = kt * T;
  load_tile<HD>(ks, k + b * tk.sb + hk * tk.sh, tk.ss, k0, S);
  load_tile<HD>(vs, v + b * tv.sb + hk * tv.sh, tv.ss, k0, S);

  const int n_tiles = (S + T - 1) / T;
  const int qt_begin = causal ? kt : 0;
  // a key c is seen by rows r < c + window
  const int qt_end =
      window > 0 ? min(n_tiles, (k0 + T - 2 + window) / T + 1) : n_tiles;
  const int tr = threadIdx.x / C::DT, td = threadIdx.x % C::DT;
  float2 acc_k[C::CR][C::CP], acc_v[C::CR][C::CP];
#pragma unroll
  for (int i = 0; i < C::CR; ++i)
#pragma unroll
    for (int p = 0; p < C::CP; ++p) {
      acc_k[i][p] = make_float2(0.f, 0.f);
      acc_v[i][p] = make_float2(0.f, 0.f);
    }
  const float scale_log2 = scale * LOG2E;

  for (int g = 0; g < G; ++g) {     // the group's heads, in order
    const int h = hk * G + g;
    const long long row_base = ((long long)b * H + h) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * T;
      __syncthreads();            // the last tile's reads are done
      load_tile<HD>(qs, q + b * tq.sb + h * tq.sh, tq.ss, q0, S);
      load_tile<HD>(dos, dout + b * tdo.sb + h * tdo.sh, tdo.ss, q0, S);
      for (int r = threadIdx.x; r < T; r += THREADS) {
        const bool live = q0 + r < S;
        lse2[r] = live ? lse[row_base + q0 + r] * LOG2E : 0.f;
        dsum[r] = live ? dsum_in[row_base + q0 + r] : 0.f;
      }
      __syncthreads();
      scores<HD>(ps, dss, qs, dos, ks, vs, lse2, dsum, q0, k0, S, causal,
                 window, scale_log2);
      __syncthreads();
      // dV[c] += P[r][c] dO[r], dK[c] += dS[r][c] Q[r], in row order
      for (int r = 0; r < T; ++r) {
        float pv[C::CR], sv[C::CR];
#pragma unroll
        for (int i = 0; i < C::CR; ++i) {
          pv[i] = ps[r * C::PW + tr + C::RT * i];
          sv[i] = dss[r * C::PW + tr + C::RT * i];
        }
#pragma unroll
        for (int p = 0; p < C::CP; ++p) {
          const float2 dov = unpack(dos[r * C::W + td + C::DT * p]);
          const float2 qv = unpack(qs[r * C::W + td + C::DT * p]);
#pragma unroll
          for (int i = 0; i < C::CR; ++i) {
            acc_v[i][p].x = fmaf(pv[i], dov.x, acc_v[i][p].x);
            acc_v[i][p].y = fmaf(pv[i], dov.y, acc_v[i][p].y);
            acc_k[i][p].x = fmaf(sv[i], qv.x, acc_k[i][p].x);
            acc_k[i][p].y = fmaf(sv[i], qv.y, acc_k[i][p].y);
          }
        }
      }
    }
  }
  bf16* ok = dk + b * tdk.sb + hk * tdk.sh;
  bf16* ov = dv + b * tdv.sb + hk * tdv.sh;
#pragma unroll
  for (int i = 0; i < C::CR; ++i) {
    const int row = k0 + tr + C::RT * i;
    if (row >= S) continue;
#pragma unroll
    for (int p = 0; p < C::CP; ++p) {
      const int col = 2 * (td + C::DT * p);
      *reinterpret_cast<uint32_t*>(ok + row * tdk.ss + col) =
          pack(acc_k[i][p].x * scale, acc_k[i][p].y * scale);
      *reinterpret_cast<uint32_t*>(ov + row * tdv.ss + col) =
          pack(acc_v[i][p].x, acc_v[i][p].y);
    }
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* dsum, bf16* dq,
           bf16* dk, bf16* dv, int B, int H, int Hkv, int S, int causal,
           int window, float scale, const long long* st,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  const Strides tq{st[0], st[1], st[2]}, tk{st[3], st[4], st[5]},
      tv{st[6], st[7], st[8]}, to{st[9], st[10], st[11]},
      tdo{st[12], st[13], st[14]}, tdq{st[15], st[16], st[17]},
      tdk{st[18], st[19], st[20]}, tdv{st[21], st[22], st[23]};
  cudaError_t rc = cudaFuncSetAttribute(
      bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncSetAttribute(bwd_dkdv_kernel<HD>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const int n_tiles = (S + C::T - 1) / C::T;
  // dq first: it writes D, which dkdv reads (same stream, in order)
  bwd_dq_kernel<HD><<<dim3(n_tiles, H, B), THREADS, C::SMEM, stream>>>(
      q, k, v, o, dout, lse, dsum, dq, tq, tk, tv, to, tdo, tdq, H, Hkv, S,
      causal, window, scale);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  bwd_dkdv_kernel<HD><<<dim3(n_tiles, Hkv, B), THREADS, C::SMEM, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, tq, tk, tv, tdo, tdk, tdv, H, Hkv, S,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, H, S, hd); k, v, dk, dv (B, Hkv, S, hd): bf16 views
// whose last dimension is contiguous, 4-byte aligned, the other strides
// (elements, even) in `strides` as (sb, sh, ss) for q, k, v, o, dout, dq,
// dk, dv in turn.  lse (B, H, S) f32, the forward's natural-log row sums;
// dsum (B, H, S) f32 scratch, written with D.  hd one of 32, 64, 128, 256;
// H % Hkv == 0.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int hd, int causal, int window,
    float scale, const long long* strides, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD(HD)                                                       \
  return launch<HD>((const bf16*)q, (const bf16*)k, (const bf16*)v,         \
                    (const bf16*)o, (const bf16*)dout, (const float*)lse,   \
                    (float*)dsum, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, H, Hkv, \
                    S, causal, window, scale, strides, s)
  switch (hd) {
    case 32: REPRO_BWD(32);
    case 64: REPRO_BWD(64);
    case 128: REPRO_BWD(128);
    case 256: REPRO_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD
}
