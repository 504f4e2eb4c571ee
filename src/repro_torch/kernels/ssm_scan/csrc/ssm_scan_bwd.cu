// Backward of the Mamba selective scan (ssm_scan.cu), for Hopper (sm_90a).
//
// Replaces: nothing of the JAX package.  Its Pallas scan
// (repro/kernels/ssm_scan/kernel.py :: ssm_scan_kernel) has no VJP, and
// JAX differentiates the plain scan (_selective_scan_ref) instead.  This
// kernel was added so that the hybrid family trains on the card, where a
// CUDA tensor launches a kernel or raises.
//
// What it computes, per row b and channel d, in f32, for cotangents dy_t
// of y_t and ds of the final state, with a_t = exp(dt_t A) and the
// states s_t of the forward (s_0 = init_state or zeros):
//   g_L = C_L dy_L + ds,   g_t = C_t dy_t + a_{t+1} g_{t+1}   (N values)
//   du_t  = D dy_t + dt_t sum_n g_t B_t
//   ddt_t = sum_n g_t (A a_t s_{t-1} + B_t u_t)
//   dB_t  = sum_d g_t dt_t u_t            dC_t = sum_d dy_t s_t
//   dA    = sum_{b,t} g_t dt_t a_t s_{t-1}
//   dD    = sum_{b,t} dy_t u_t            d init_state = a_1 g_1
//
// What bounds it on an H100: like the forward, bytes and the
// exponentials.  It reads u, dt, dy and writes du, ddt (20 bytes per
// (row, step, channel)), and takes three exponentials per (row, step,
// channel, state): the checkpoint pass, the chunk's recompute and the
// reverse step.  Each channel is a chain of 2 L dependent steps.
//
// What the design does:
//   * One block of 128 threads owns a tile of CH = 512 / N channels of
//     one row; each channel's N states are split over G = N / 4 lanes of
//     4 states, as in the forward (CH = 32, G = 4 at jamba's N = 16).
//   * Checkpoint pass: the block runs the forward recurrence over L, the
//     exponential computed as the forward computes it (ex2.approx of
//     dt * (A log2 e)), and writes each lane's state at the start of
//     every chunk of T = 16 steps to a workspace (B, L / T, d_in, N).
//   * Reverse pass: the chunks back to front.  A chunk's u, dt, dy, B, C
//     land in shared memory; its T states are recomputed from the
//     chunk's checkpoint into shared memory (each lane its own); then
//     the reverse recurrence runs step by step, the carry a_{t+1}
//     g_{t+1} in registers across chunks.  Steps past L and channels past
//     d_in read zeros (dt = 0 passes the carry on unchanged and adds
//     nothing), so the ragged edges need no branch but the stores.
//   * du, ddt and d init_state are per channel: the sums over n are
//     butterfly shuffles over the channel's lanes, and each is written
//     once.  dB and dC sum over every channel: a warp sums its channels
//     by shuffles, the block its 4 warps in shared memory in a fixed
//     order, and the block writes its tile's partial (tiles, B, L, N).
//     dA and dD sum over rows and steps: each lane sums its steps in
//     registers and writes the row's partial (B, d_in, N) and (B, d_in).
//     A second launch sums the partials, each output in one thread in a
//     fixed order.  No atomics: two launches give the same bits.
// Not done: overlapping the chunk loads with the chain (cp.async), and
// splitting the time axis over blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int SPL = 4;          // states per lane
constexpr int THREADS = 128;    // threads per block: 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int T = 16;           // steps per chunk = checkpoint interval
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Cfg {
  static constexpr int G = N / SPL;             // lanes per channel
  static constexpr int CH = THREADS / G;        // channels per block
  // u, dt, dy (T x CH); B, C (T x N); the chunk's states (T x THREADS x
  // SPL, each lane its own); the warps' dB, dC sums (2 x T x WARPS x N);
  // du, ddt (2 x T x CH)
  static constexpr int IN_F = 3 * T * CH + 2 * T * N;
  static constexpr int ST_F = T * THREADS * SPL;
  static constexpr int RED_F = 2 * T * WARPS * N;
  static constexpr int OUT_F = 2 * T * CH;
  static constexpr int SMEM = 4 * (IN_F + ST_F + RED_F + OUT_F);
};

__device__ __forceinline__ void load4(float (&v)[SPL], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[SPL]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ D,
                    const float* __restrict__ s0,
                    const float* __restrict__ dy,
                    const float* __restrict__ ds, float* __restrict__ ckpt,
                    float* __restrict__ dBp, float* __restrict__ dCp,
                    float* __restrict__ dAp, float* __restrict__ dDp,
                    float* __restrict__ du, float* __restrict__ ddt,
                    float* __restrict__ ds0, int L, int d_in) {
  using C = Cfg<N>;
  constexpr int G = C::G, CH = C::CH;
  extern __shared__ __align__(16) float smem[];
  float* us = smem;                       // [T][CH]
  float* dts = us + T * CH;               // [T][CH]
  float* dys = dts + T * CH;              // [T][CH]
  float* bs = dys + T * CH;               // [T][N]
  float* cs = bs + T * N;                 // [T][N]
  float* sts = cs + T * N;                // [T][THREADS][SPL]
  float* red = sts + C::ST_F;             // [2][T][WARPS][N]
  float* outs = red + C::RED_F;           // [2][T][CH]: du, ddt

  const int tid = threadIdx.x;
  const int ch = tid / G, g = tid % G;    // channel in block, lane
  const int warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, b = blockIdx.y, nB = gridDim.y;
  const int d0 = tile * CH, d = d0 + ch;
  const bool live = d < d_in;             // lanes past d_in scan zeros
  const size_t row = (size_t)b * L;
  const int chunks = (L + T - 1) / T;
  const size_t nbc = (size_t)nB * L * N;  // one tile's dB (or dC) partial

  // chunk k's inputs into shared memory, zeros past L and d_in; the
  // reverse pass (`rev`) also takes dy and C
  auto load = [&](int k, bool rev) {
    const int t0 = k * T;
    for (int i = tid; i < T * CH; i += THREADS) {
      const int j = i / CH, c = i % CH;
      const bool in = t0 + j < L && d0 + c < d_in;
      const size_t off = in ? (row + t0 + j) * d_in + d0 + c : 0;
      us[i] = in ? u[off] : 0.f;
      dts[i] = in ? dt[off] : 0.f;
      if (rev) dys[i] = in ? dy[off] : 0.f;
    }
    for (int i = tid; i < T * N; i += THREADS) {
      const bool in = t0 + i / N < L;
      const size_t off = in ? (row + t0) * N + i : 0;
      bs[i] = in ? Bm[off] : 0.f;
      if (rev) cs[i] = in ? Cm[off] : 0.f;
    }
  };

  float av[SPL] = {0.f, 0.f, 0.f, 0.f}, a2[SPL], s[SPL] = {0.f, 0.f, 0.f,
                                                           0.f};
  float carry[SPL] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    load4(av, A + (size_t)d * N + g * SPL);
    if (s0 != nullptr) load4(s, s0 + ((size_t)b * d_in + d) * N + g * SPL);
    if (ds != nullptr)
      load4(carry, ds + ((size_t)b * d_in + d) * N + g * SPL);
  }
#pragma unroll
  for (int i = 0; i < SPL; ++i) a2[i] = av[i] * LOG2E;
  const float dg = live ? D[d] : 0.f;
  // this lane's checkpoint of chunk k
  auto ck = [&](int k) {
    return ckpt + (((size_t)b * chunks + k) * d_in + d) * N + g * SPL;
  };

  // checkpoint pass: the state at the start of every chunk
  for (int k = 0; k < chunks; ++k) {
    if (live) store4(ck(k), s);
    if (k + 1 == chunks) break;
    __syncthreads();                      // the last chunk's reads done
    load(k, false);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      const float dtv = dts[j * CH + ch];
      const float du_ = dtv * us[j * CH + ch];
      float bb[SPL];
      load4(bb, bs + j * N + g * SPL);
#pragma unroll
      for (int i = 0; i < SPL; ++i)
        s[i] = hopper::exp2_approx(dtv * a2[i]) * s[i] + du_ * bb[i];
    }
  }

  // reverse pass
  float dA_acc[SPL] = {0.f, 0.f, 0.f, 0.f};
  float dD_acc = 0.f;
  float* mine = sts + tid * SPL;          // this lane's states, step j at
                                          // mine + j * THREADS * SPL
  for (int k = chunks - 1; k >= 0; --k) {
    __syncthreads();                      // the last chunk's reads done
    load(k, true);
    float sp[SPL] = {0.f, 0.f, 0.f, 0.f}; // the state before the chunk
    if (live) load4(sp, ck(k));
    __syncthreads();
    {
      float sc[SPL] = {sp[0], sp[1], sp[2], sp[3]};
#pragma unroll 4
      for (int j = 0; j < T; ++j) {
        const float dtv = dts[j * CH + ch];
        const float du_ = dtv * us[j * CH + ch];
        float bb[SPL];
        load4(bb, bs + j * N + g * SPL);
#pragma unroll
        for (int i = 0; i < SPL; ++i)
          sc[i] = hopper::exp2_approx(dtv * a2[i]) * sc[i] + du_ * bb[i];
        store4(mine + j * THREADS * SPL, sc);
      }
    }
    for (int j = T - 1; j >= 0; --j) {
      const float dtv = dts[j * CH + ch], uv = us[j * CH + ch];
      const float dyv = dys[j * CH + ch];
      const float dtu = dtv * uv;
      float bb[SPL], cc[SPL], sj[SPL], sprev[SPL];
      load4(bb, bs + j * N + g * SPL);
      load4(cc, cs + j * N + g * SPL);
      load4(sj, mine + j * THREADS * SPL);
      if (j > 0) {
        load4(sprev, mine + (j - 1) * THREADS * SPL);
      } else {
#pragma unroll
        for (int i = 0; i < SPL; ++i) sprev[i] = sp[i];
      }
      float pdu = 0.f, pddt = 0.f, pb[SPL], pc[SPL];
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const float a = hopper::exp2_approx(dtv * a2[i]);
        const float gi = cc[i] * dyv + carry[i];
        const float as = a * sprev[i];
        pdu += gi * bb[i];
        pddt += gi * (av[i] * as + bb[i] * uv);
        dA_acc[i] += gi * dtv * as;
        pb[i] = gi * dtu;
        pc[i] = dyv * sj[i];
        carry[i] = a * gi;
      }
      dD_acc += dyv * uv;
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {  // over the channel's lanes
        pdu += __shfl_xor_sync(0xffffffffu, pdu, off);
        pddt += __shfl_xor_sync(0xffffffffu, pddt, off);
      }
      if (g == j % G) {
        outs[j * CH + ch] = dg * dyv + dtv * pdu;
        outs[T * CH + j * CH + ch] = pddt;
      }
#pragma unroll
      for (int off = G; off < 32; off <<= 1) { // over the warp's channels
#pragma unroll
        for (int i = 0; i < SPL; ++i) {
          pb[i] += __shfl_xor_sync(0xffffffffu, pb[i], off);
          pc[i] += __shfl_xor_sync(0xffffffffu, pc[i], off);
        }
      }
      if (lane < G) {
        store4(red + ((size_t)j * WARPS + warp) * N + g * SPL, pb);
        store4(red + ((size_t)(T + j) * WARPS + warp) * N + g * SPL, pc);
      }
    }
    __syncthreads();                      // outs and red complete
    const int t0 = k * T, nt = min(T, L - t0);
    for (int i = tid; i < nt * CH; i += THREADS) {
      const int j = i / CH, c = i % CH;
      if (d0 + c < d_in) {
        const size_t off = (row + t0 + j) * d_in + d0 + c;
        du[off] = outs[i];
        ddt[off] = outs[T * CH + i];
      }
    }
    for (int i = tid; i < nt * N; i += THREADS) {
      const int j = i / N, n = i % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {   // the warps in a fixed order
        sb += red[((size_t)j * WARPS + w) * N + n];
        sc += red[((size_t)(T + j) * WARPS + w) * N + n];
      }
      const size_t off = (size_t)tile * nbc + (row + t0 + j) * N + n;
      dBp[off] = sb;
      dCp[off] = sc;
    }
  }
  if (live) {
    const size_t off = ((size_t)b * d_in + d) * N + g * SPL;
    store4(ds0 + off, carry);
    store4(dAp + off, dA_acc);
    if (g == 0) dDp[(size_t)b * d_in + d] = dD_acc;
  }
}

// the partial sums, each output summed by one thread in a fixed order:
// dB and dC over the channel tiles, dA and dD over the rows
__global__ void __launch_bounds__(RED_THREADS)
ssm_scan_bwd_reduce(const float* __restrict__ dBp,
                    const float* __restrict__ dCp,
                    const float* __restrict__ dAp,
                    const float* __restrict__ dDp, float* __restrict__ dB,
                    float* __restrict__ dC, float* __restrict__ dA,
                    float* __restrict__ dD, int tiles, int nB, int L,
                    int d_in, int N) {
  const size_t nbc = (size_t)nB * L * N, na = (size_t)d_in * N;
  const size_t total = 2 * nbc + na + d_in;
  for (size_t i = (size_t)blockIdx.x * RED_THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * RED_THREADS) {
    float acc = 0.f;
    if (i < 2 * nbc) {
      const bool c = i >= nbc;
      const size_t e = c ? i - nbc : i;
      const float* p = (c ? dCp : dBp) + e;
      for (int t = 0; t < tiles; ++t) acc += p[(size_t)t * nbc];
      (c ? dC : dB)[e] = acc;
    } else if (i < 2 * nbc + na) {
      const size_t e = i - 2 * nbc;
      for (int r = 0; r < nB; ++r) acc += dAp[(size_t)r * na + e];
      dA[e] = acc;
    } else {
      const size_t e = i - 2 * nbc - na;
      for (int r = 0; r < nB; ++r) acc += dDp[(size_t)r * d_in + e];
      dD[e] = acc;
    }
  }
}

template <int N>
int launch(const float* u, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* D, const float* s0, const float* dy,
           const float* ds, float* ws, float* du, float* ddt, float* dB,
           float* dC, float* dA, float* dD, float* ds0, int B, int L,
           int d_in, long long ws_floats, cudaStream_t stream) {
  using C = Cfg<N>;
  const int tiles = (d_in + C::CH - 1) / C::CH;
  const int chunks = (L + T - 1) / T;
  // workspace: checkpoints (B, chunks, d_in, N), the dB and dC partials
  // (tiles, B, L, N) each, the dA partials (B, d_in, N), dD's (B, d_in)
  const long long n_ck = (long long)B * chunks * d_in * N;
  const long long n_bc = (long long)tiles * B * L * N;
  const long long n_a = (long long)B * d_in * N;
  if (ws_floats < n_ck + 2 * n_bc + n_a + (long long)B * d_in)
    return (int)cudaErrorInvalidValue;
  float* ckpt = ws;
  float* dBp = ckpt + n_ck;
  float* dCp = dBp + n_bc;
  float* dAp = dCp + n_bc;
  float* dDp = dAp + n_a;
  cudaError_t rc = hopper::allow_smem<ssm_scan_bwd_kernel<N>>(C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  ssm_scan_bwd_kernel<N><<<dim3(tiles, B), THREADS, C::SMEM, stream>>>(
      u, dt, Bm, Cm, A, D, s0, dy, ds, ckpt, dBp, dCp, dAp, dDp, du, ddt,
      ds0, L, d_in);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const long long total = 2LL * B * L * N + (long long)d_in * N + d_in;
  long long blocks = (total + RED_THREADS - 1) / RED_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride past that
  ssm_scan_bwd_reduce<<<(int)blocks, RED_THREADS, 0, stream>>>(
      dBp, dCp, dAp, dDp, dB, dC, dA, dD, tiles, B, L, d_in, N);
  return (int)cudaGetLastError();
}

}  // namespace

// The workspace floats the backward takes at (B, L, d_in, N).
extern "C" long long ssm_scan_bwd_workspace(int B, int L, int d_in, int N) {
  if (N < 8 || N > 64 || (N & (N - 1))) return -1;
  const int ch = THREADS / (N / SPL);
  const long long tiles = (d_in + ch - 1) / ch, chunks = (L + T - 1) / T;
  return (long long)B * chunks * d_in * N + 2 * tiles * B * L * N +
         (long long)B * d_in * N + (long long)B * d_in;
}

// u/dt/dy (B, L, d_in), Bm/Cm (B, L, N), A (d_in, N), D (d_in,),
// init_state s0 and the final state's cotangent ds (B, d_in, N) or NULL
// (zeros); outputs du/ddt (B, L, d_in), dB/dC (B, L, N), dA (d_in, N),
// dD (d_in,), ds0 (B, d_in, N); ws a scratch of ws_floats floats
// (ssm_scan_bwd_workspace).  All f32, contiguous and 16-byte aligned.  N
// is 8, 16, 32 or 64 (the wrapper pads any other N with zero state
// columns).  Two launches on `stream`; returns a cudaError_t.
extern "C" int ssm_scan_bwd_f32(const void* u, const void* dt,
                                const void* Bm, const void* Cm,
                                const void* A, const void* D, const void* s0,
                                const void* dy, const void* ds, void* ws,
                                void* du, void* ddt, void* dB, void* dC,
                                void* dA, void* dD, void* ds0, int B, int L,
                                int d_in, int N, long long ws_floats,
                                void* stream) {
  if (B < 1 || B > 65535 || L < 1 || d_in < 1)
    return (int)cudaErrorInvalidValue;
#define LAUNCH(N_)                                                          \
  return launch<N_>((const float*)u, (const float*)dt, (const float*)Bm,   \
                    (const float*)Cm, (const float*)A, (const float*)D,    \
                    (const float*)s0, (const float*)dy, (const float*)ds,  \
                    (float*)ws, (float*)du, (float*)ddt, (float*)dB,       \
                    (float*)dC, (float*)dA, (float*)dD, (float*)ds0, B, L, \
                    d_in, ws_floats, (cudaStream_t)stream)
  switch (N) {
    case 8: LAUNCH(8);
    case 16: LAUNCH(16);
    case 32: LAUNCH(32);
    case 64: LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
}
