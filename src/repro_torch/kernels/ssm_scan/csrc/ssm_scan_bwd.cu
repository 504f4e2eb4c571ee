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
// from the forward's checkpoints: the state before every chunk of T = 16
// steps, (B, ceil(L / T), d_in, N), which ssm_scan.cu writes when it is
// given the pointer (its first one is init_state).
//
// What bounds it on an H100: like the forward, bytes and the
// exponentials.  It reads u, dt, dy and writes du, ddt (20 bytes per
// (row, step, channel)), and takes two exponentials per (row, step,
// channel, state): the chunk's recompute and the reverse step.  Each
// channel is a chain of 2 L dependent steps; the sums of dB and dC over
// 8192 channels are as many products again.
//
// What the design does:
//   * One block of 256 threads owns a tile of CH = 1024 / N channels of
//     one row; each channel's N states are split over G = N / 4 lanes of
//     4 states, as in the forward (CH = 64, G = 4 at jamba's N = 16).
//   * The chunks run back to front.  A chunk's u, dt, dy, B, C and
//     checkpoint come into shared memory through cp.async, double
//     buffered: the next chunk's copies are in flight while this chunk
//     runs.
//   * Pass 1 recomputes the chunk's 16 states from its checkpoint into
//     registers (16 x 4 a lane: no shared memory), the exponential as
//     the forward computes it (ex2.approx of dt * (A log2 e)), and
//     stages dC's products dy_t s_t.  The reverse pass then steps back
//     through the registers, the carry a_{t+1} g_{t+1} kept across
//     chunks, and stages dB's products g_t dt_t u_t.  Steps past L and
//     channels past d_in read zeros (dt = 0 passes the carry on
//     unchanged and adds nothing), so the ragged edges need no branch
//     but the stores.
//   * dB and dC: each lane writes its 4 products of a step to shared
//     memory, and every 8 steps each warp sums its channels' products in
//     channel order (a float4 of states a lane, no block barrier).  Once
//     a chunk the block adds its 8 warps' sums in order, and a cluster of
//     2 blocks (adjacent channel tiles of one row) adds its blocks' sums
//     in rank order through distributed shared memory, a chunk
//     late: each block arrives at the cluster barrier after the next
//     chunk's first pass (when its global stores have landed: the
//     arrive's release waits for them) and waits at that chunk's end.  One
//     partial per cluster reaches device memory (cluster tiles, B, L, N):
//     64 a row at jamba's d_in, where one a block of 32 channels took
//     256.  (Clusters of 4 and 8 ran slower on an H100, by a fifth.)
//   * du and ddt sum each channel's lanes by shuffles that halve the
//     work at the first level (one lane keeps du, its neighbour ddt), and
//     the two lanes store them.  dA and dD sum over rows and steps: each
//     lane sums its steps in registers and writes the row's partial (B,
//     d_in, N) and (B, d_in).  A second launch sums the partials, each
//     output in one thread in a fixed order.  No atomics: two launches
//     give the same bits.
// On an H100 at jamba's training shape it takes 128 registers a thread
// (a few spilled, outside the steps) and 94 KB of shared memory a block:
// 2 blocks (16 warps) an SM, two waves of the 512 blocks.
// Not done: splitting the time axis over blocks (the padded record's 32
// blocks leave most of the card idle; jamba's 512 fill it).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using hopper::cp_async16;
using hopper::cp_async4;

constexpr int SPL = 4;          // states per lane
constexpr int THREADS = 256;    // threads per block: 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int T = 16;           // steps per chunk: ssm_scan.cu's CKPT_T
constexpr int H = T / 2;        // steps between two warp sums
constexpr int MAX_CLUSTER = 2;  // blocks of a cluster, at most
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int N>
struct Cfg {
  static constexpr int G = N / SPL;             // lanes per channel
  static constexpr int CH = THREADS / G;        // channels per block
  static constexpr int CW = 32 / G;             // channels per warp
  // one stage: u, dt, dy (T x CH), B, C (T x N) and the chunk's
  // checkpoint (CH x N) floats
  static constexpr int STAGE_F = 3 * T * CH + 2 * T * N + CH * N;
  // a warp's products of half a chunk, step j's at j * PW: a pad of N
  // floats a step keeps the column sums' reads on distinct banks
  static constexpr int PW = (CW + 1) * N;
  static constexpr int PROD_F = WARPS * H * PW;
  // the warps' column sums of a chunk ([dB, dC][warp][T][N]) and the
  // block's ([dB, dC][T][N]) by chunk parity
  static constexpr int WSUM_F = 2 * WARPS * T * N;
  static constexpr int SUM_F = 2 * 2 * T * N;
  static constexpr int SMEM = 4 * (2 * STAGE_F + PROD_F + WSUM_F + SUM_F);
};

__device__ __forceinline__ void load4(float (&v)[SPL], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[SPL]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// fn(i) for i = first, first + STRIDE, ... below CNT: the trip count
// known to the compiler
template <int CNT, int STRIDE, typename F>
__device__ __forceinline__ void strided(int first, F fn) {
#pragma unroll
  for (int r = 0; r < (CNT + STRIDE - 1) / STRIDE; ++r) {
    const int i = first + r * STRIDE;
    if (CNT % STRIDE == 0 || i < CNT) fn(i);
  }
}

__device__ __forceinline__ void add4(float4& a, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
}

// hopper::exp2_approx again, as a volatile asm: the reverse step's
// exponentials are the recompute's, and a compiler that merged the two
// would hold 64 more registers a lane across the chunk
__device__ __forceinline__ float exp2_again(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two halves of a cluster barrier: arrive (this thread's writes
// released to the cluster) now, wait (every thread of every block
// arrived) later
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int N>
__global__ void __launch_bounds__(THREADS, 2)
ssm_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ D,
                    const float* __restrict__ ckpt,
                    const float* __restrict__ dy,
                    const float* __restrict__ ds, float* __restrict__ dBp,
                    float* __restrict__ dCp, float* __restrict__ dAp,
                    float* __restrict__ dDp, float* __restrict__ du,
                    float* __restrict__ ddt, float* __restrict__ ds0, int L,
                    int d_in) {
  using C = Cfg<N>;
  constexpr int G = C::G, CH = C::CH, CW = C::CW, PW = C::PW;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch = tid / G, g = tid % G;    // channel in block, lane
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH, d = d0 + ch;
  const bool live = d < d_in;             // lanes past d_in scan zeros
  const bool vec = d_in % 4 == 0;         // 16-byte rows of u, dt, dy
  const size_t row = (size_t)b * L;
  const int chunks = (L + T - 1) / T;
  const int ctile = blockIdx.x / csize;   // the cluster's tile
  const size_t nbc = (size_t)gridDim.y * L * N;  // one cluster tile's dB
  float* wprod = smem + 2 * C::STAGE_F + warp * H * PW;  // [H][PW]
  float* wsum = smem + 2 * C::STAGE_F + C::PROD_F;  // [dB, dC][warp][T][N]
  float* sums = wsum + C::WSUM_F;                   // [parity][dB, dC][T][N]
  float* mine = wprod + (ch % CW) * N + g * SPL;    // step j's at j * PW

  // chunk k's u, dt, dy, B, C and checkpoint into stage `st`; zeros past
  // L and d_in
  auto load = [&](int st, int k) {
    float* us = smem + st * C::STAGE_F;
    float* dts = us + T * CH;
    float* dys = dts + T * CH;
    float* bs = dys + T * CH;
    float* cs = bs + T * N;
    float* cks = cs + T * N;
    const int t0 = k * T;
    const float* ckg = ckpt + (((size_t)b * chunks + k) * d_in + d0) * N;
    strided<CH * N / 4, THREADS>(tid, [&](int i) {
      const bool in = d0 + 4 * i / N < d_in;
      cp_async16(cks + 4 * i, in ? ckg + 4 * i : ckpt, in ? 16 : 0);
    });
    if (vec) {
      strided<T * CH / 4, THREADS>(tid, [&](int i) {
        const int j = i / (CH / 4), c4 = 4 * (i % (CH / 4));
        const bool in = t0 + j < L && d0 + c4 < d_in;
        const size_t off = in ? (row + t0 + j) * d_in + d0 + c4 : 0;
        cp_async16(us + j * CH + c4, u + off, in ? 16 : 0);
        cp_async16(dts + j * CH + c4, dt + off, in ? 16 : 0);
        cp_async16(dys + j * CH + c4, dy + off, in ? 16 : 0);
      });
    } else {
      strided<T * CH, THREADS>(tid, [&](int i) {
        const int j = i / CH, c = i % CH;
        const bool in = t0 + j < L && d0 + c < d_in;
        const size_t off = in ? (row + t0 + j) * d_in + d0 + c : 0;
        cp_async4(us + i, u + off, in ? 4 : 0);
        cp_async4(dts + i, dt + off, in ? 4 : 0);
        cp_async4(dys + i, dy + off, in ? 4 : 0);
      });
    }
    strided<T * N / 4, THREADS>(tid, [&](int i) {
      const int j = 4 * i / N;
      const bool in = t0 + j < L;
      const size_t off = in ? (row + t0) * N + 4 * i : 0;
      cp_async16(bs + 4 * i, Bm + off, in ? 16 : 0);
      cp_async16(cs + 4 * i, Cm + off, in ? 16 : 0);
    });
  };

  // the warp's products of steps [j0, j0 + H) summed over its channels
  // in channel order into out [T][N] (a lane a float4 of states at a
  // time); the warp's writes before, and its next writes after
  auto warp_sums = [&](float* out, int j0) {
    __syncwarp();
    strided<H * N / 4, 32>(lane, [&](int i) {
      const int j = 4 * i / N, n4 = 4 * i % N;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < CW; ++c) add4(acc, wprod + j * PW + c * N + n4);
      *reinterpret_cast<float4*>(out + (j0 + j) * N + n4) = acc;
    });
    __syncwarp();
  };

  // the cluster's sums of chunk k in rank order: output i of [dB, dC][T]
  // [N] by thread i - rank * THREADS of each stride; after the barrier's
  // wait
  auto cluster_sums = [&](int k) {
    const float* ks = sums + (k & 1) * 2 * T * N;
    const int t0 = k * T;
    for (int i = rank * THREADS + tid; i < 2 * T * N;
         i += csize * THREADS) {
      float acc = 0.f;
      for (int r = 0; r < csize; ++r)
        acc += cluster.map_shared_rank(ks, r)[i];
      const int p = i / (T * N), j = i % (T * N) / N, n = i % N;
      if (t0 + j < L)
        (p ? dCp : dBp)[(size_t)ctile * nbc + (row + t0 + j) * N + n] = acc;
    }
  };

  load((chunks - 1) & 1, chunks - 1);
  hopper::cp_async_commit();

  // A log2 e: exp(dt A) = 2^(dt a2), and A a s = ln 2 (a2 a s)
  float a2[SPL] = {0.f, 0.f, 0.f, 0.f};
  float carry[SPL] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    load4(a2, A + (size_t)d * N + g * SPL);
    if (ds != nullptr)
      load4(carry, ds + ((size_t)b * d_in + d) * N + g * SPL);
  }
#pragma unroll
  for (int i = 0; i < SPL; ++i) a2[i] *= LOG2E;
  const float dg = live ? D[d] : 0.f;

  float dA_acc[SPL] = {0.f, 0.f, 0.f, 0.f};
  float dD_acc = 0.f;
  for (int k = chunks - 1; k >= 0; --k) {
    hopper::cp_async_wait<0>();           // chunk k (this thread's) ...
    __syncthreads();                      // ... and everyone's; the last
                                          // chunk's warp sums added
    if (k > 0) load((k - 1) & 1, k - 1);
    hopper::cp_async_commit();
    const float* us = smem + (k & 1) * C::STAGE_F;
    const float* dts = us + T * CH;
    const float* dys = dts + T * CH;
    const float* bs = dys + T * CH;
    const float* cs = bs + T * N;
    const float* sp = cs + T * N + ch * N + g * SPL;  // the state before
    const int t0 = k * T;                              // the chunk
    // lane 0 of a channel stores du, lane 1 ddt: its steps to store, and
    // where the chunk's first one goes
    const int nout = live && g < 2 ? min(T, L - t0) : 0;
    float* out = (g ? ddt : du) + (row + t0 + T - 1) * d_in + d;  // step
                                                                 // T - 1

    // pass 1: the chunk's states, in registers; dC's products, summed
    // over the warp's channels every H steps
    float st[T][SPL];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float dtv = dts[j * CH + ch];
      const float du_ = dtv * us[j * CH + ch];
      const float dyv = dys[j * CH + ch];
      float bb[SPL], pc[SPL];
      load4(bb, bs + j * N + g * SPL);
      float s0[SPL];
      if (j == 0) load4(s0, sp);
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const float prev = j > 0 ? st[j > 0 ? j - 1 : 0][i] : s0[i];
        st[j][i] = hopper::exp2_approx(dtv * a2[i]) * prev + du_ * bb[i];
        pc[i] = dyv * st[j][i];
      }
      store4(mine + (j % H) * PW, pc);
      if (j % H == H - 1) warp_sums(wsum + (WARPS + warp) * T * N, j + 1 - H);
    }
    // arrive for the chunk before's block sums, written at its end: its
    // du and ddt stores have landed by now, so the release waits for
    // none of them
    if (k + 1 < chunks) cluster_arrive();

    // the reverse pass; dB's products summed as dC's
#pragma unroll
    for (int j = T - 1; j >= 0; --j) {
      const float dtv = dts[j * CH + ch], uv = us[j * CH + ch];
      const float dyv = dys[j * CH + ch];
      const float dtu = dtv * uv;
      float bb[SPL], cc[SPL], pb[SPL];
      load4(bb, bs + j * N + g * SPL);
      load4(cc, cs + j * N + g * SPL);
      float pdu = 0.f, pas = 0.f, s0[SPL];
      if (j == 0) load4(s0, sp);
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const float prev = j > 0 ? st[j > 0 ? j - 1 : 0][i] : s0[i];
        const float a = exp2_again(dtv * a2[i]);
        const float gi = cc[i] * dyv + carry[i];
        carry[i] = a * gi;
        const float gas = carry[i] * prev;          // g a s_{t-1}
        pdu += gi * bb[i];
        pas += gas * a2[i];
        dA_acc[i] += gas * dtv;
        pb[i] = gi * dtu;
      }
      dD_acc += dyv * uv;
      store4(mine + (j % H) * PW, pb);
      if (j % H == 0) warp_sums(wsum + warp * T * N, j);
      // du = D dy + dt sum g B, ddt = sum g A a s + u sum g B over the
      // channel's lanes: at the first level an even lane keeps du's sum
      // and an odd one ddt's, each sending the other
      const float pddt = LN2 * pas + uv * pdu;
      float keep = (g & 1) ? pddt : pdu;
      keep += __shfl_xor_sync(0xffffffffu, (g & 1) ? pdu : pddt, 1);
#pragma unroll
      for (int off = 2; off < G; off <<= 1)
        keep += __shfl_xor_sync(0xffffffffu, keep, off);
      if (j < nout) *out = g ? keep : dg * dyv + dtv * keep;
      out -= d_in;
    }
    __syncthreads();                      // every warp's sums written
    // the chunk before's cluster sums (every block arrived after writing
    // them, and after reading the ones before from the other parity's
    // buffer, which this chunk's then take); then the block's sums, the
    // warps added in order
    if (k + 1 < chunks) {
      cluster_wait();
      cluster_sums(k + 1);
    }
    strided<2 * T * N / 4, THREADS>(tid, [&](int i) {
      const int p = 4 * i / (T * N), e = 4 * i % (T * N);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        add4(acc, wsum + (p * WARPS + w) * T * N + e);
      *reinterpret_cast<float4*>(sums + (k & 1) * 2 * T * N + p * T * N +
                                 e) = acc;
    });
  }
  cluster_arrive();
  cluster_wait();
  cluster_sums(0);
  cluster_arrive();                       // no block leaves while read
  cluster_wait();
  if (live) {
    const size_t off = ((size_t)b * d_in + d) * N + g * SPL;
    store4(ds0 + off, carry);
    store4(dAp + off, dA_acc);
    if (g == 0) dDp[(size_t)b * d_in + d] = dD_acc;
  }
}

// the partial sums, each output summed by one thread in a fixed order:
// dB and dC over the cluster tiles, dA and dD over the rows
__global__ void __launch_bounds__(RED_THREADS)
ssm_scan_bwd_reduce(const float* __restrict__ dBp,
                    const float* __restrict__ dCp,
                    const float* __restrict__ dAp,
                    const float* __restrict__ dDp, float* __restrict__ dB,
                    float* __restrict__ dC, float* __restrict__ dA,
                    float* __restrict__ dD, int ctiles, int nB, int L,
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
      for (int t = 0; t < ctiles; ++t) acc += p[(size_t)t * nbc];
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

// blocks of a cluster for `tiles` channel tiles: MAX_CLUSTER, or the
// least power of two that covers them
int cluster_size(long long tiles) {
  int c = 1;
  while (c < MAX_CLUSTER && c < tiles) c *= 2;
  return c;
}

// channel tiles, rounded up to whole clusters, and the clusters
void grid_tiles(int d_in, int N, long long* tiles, long long* ctiles) {
  const int ch = THREADS / (N / SPL);
  const long long t = (d_in + ch - 1) / ch;
  const int cs = cluster_size(t);
  *ctiles = (t + cs - 1) / cs;
  *tiles = *ctiles * cs;
}

template <int N>
int launch(const float* u, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* D, const float* ckpt,
           const float* dy, const float* ds, float* ws, float* du,
           float* ddt, float* dB, float* dC, float* dA, float* dD,
           float* ds0, int B, int L, int d_in, long long ws_floats,
           cudaStream_t stream) {
  using C = Cfg<N>;
  long long tiles, ctiles;
  grid_tiles(d_in, N, &tiles, &ctiles);
  // workspace: the dB and dC partials (cluster tiles, B, L, N) each, the
  // dA partials (B, d_in, N), dD's (B, d_in)
  const long long n_bc = ctiles * B * L * N;
  const long long n_a = (long long)B * d_in * N;
  if (ws_floats < 2 * n_bc + n_a + (long long)B * d_in)
    return (int)cudaErrorInvalidValue;
  float* dBp = ws;
  float* dCp = dBp + n_bc;
  float* dAp = dCp + n_bc;
  float* dDp = dAp + n_a;
  cudaError_t rc = hopper::allow_smem<ssm_scan_bwd_kernel<N>>(C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)(tiles / ctiles);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, ssm_scan_bwd_kernel<N>, u, dt, Bm, Cm, A, D,
                          ckpt, dy, ds, dBp, dCp, dAp, dDp, du, ddt, ds0, L,
                          d_in);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const long long total = 2LL * B * L * N + (long long)d_in * N + d_in;
  long long blocks = (total + RED_THREADS - 1) / RED_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride past that
  ssm_scan_bwd_reduce<<<(int)blocks, RED_THREADS, 0, stream>>>(
      dBp, dCp, dAp, dDp, dB, dC, dA, dD, (int)ctiles, B, L, d_in, N);
  return (int)cudaGetLastError();
}

}  // namespace

// The workspace floats the backward takes at (B, L, d_in, N).
extern "C" long long ssm_scan_bwd_workspace(int B, int L, int d_in, int N) {
  if (N < 8 || N > 64 || (N & (N - 1))) return -1;
  long long tiles, ctiles;
  grid_tiles(d_in, N, &tiles, &ctiles);
  return 2 * ctiles * B * L * N + (long long)B * d_in * N +
         (long long)B * d_in;
}

// u/dt/dy (B, L, d_in), Bm/Cm (B, L, N), A (d_in, N), D (d_in,), the
// forward's checkpoints ckpt (B, ceil(L / 16), d_in, N) (ssm_scan_f32's
// `ckpt`), the final state's cotangent ds (B, d_in, N) or NULL (zeros);
// outputs du/ddt (B, L, d_in), dB/dC (B, L, N), dA (d_in, N), dD (d_in,),
// ds0 (B, d_in, N); ws a scratch of ws_floats floats
// (ssm_scan_bwd_workspace).  All f32, contiguous and 16-byte aligned.  N
// is 8, 16, 32 or 64 (the wrapper pads any other N with zero state
// columns).  Two launches on `stream`; returns a cudaError_t.
extern "C" int ssm_scan_bwd_f32(const void* u, const void* dt,
                                const void* Bm, const void* Cm,
                                const void* A, const void* D,
                                const void* ckpt, const void* dy,
                                const void* ds, void* ws, void* du,
                                void* ddt, void* dB, void* dC, void* dA,
                                void* dD, void* ds0, int B, int L, int d_in,
                                int N, long long ws_floats, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || d_in < 1 || ckpt == nullptr)
    return (int)cudaErrorInvalidValue;
#define LAUNCH(N_)                                                          \
  return launch<N_>((const float*)u, (const float*)dt, (const float*)Bm,   \
                    (const float*)Cm, (const float*)A, (const float*)D,    \
                    (const float*)ckpt, (const float*)dy,                  \
                    (const float*)ds, (float*)ws, (float*)du, (float*)ddt, \
                    (float*)dB, (float*)dC, (float*)dA, (float*)dD,        \
                    (float*)ds0, B, L, d_in, ws_floats,                    \
                    (cudaStream_t)stream)
  switch (N) {
    case 8: LAUNCH(8);
    case 16: LAUNCH(16);
    case 32: LAUNCH(32);
    case 64: LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
}
