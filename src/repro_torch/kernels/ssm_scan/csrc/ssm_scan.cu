// Mamba selective scan with a carried state, for Hopper (sm_90a).
//
// Replaces: repro/kernels/ssm_scan/kernel.py ::
//   ssm_scan_kernel (body _ssm_kernel).
//
// What it computes, per row b and channel d, in f32:
//   s_t = exp(dt_t * A[d]) * s_{t-1} + dt_t * u_t * B_t      (s: N values)
//   y_t = s_t . C_t + u_t * D[d]
// from s_0 = init_state (or zeros); it returns every y_t and the last s,
// and, where it is given the pointer (a forward that a backward follows),
// checkpoints: the state before every CKPT_T = 16 steps, (B, ceil(L / 16),
// d_in, N), which ssm_scan_bwd.cu reads instead of running the
// recurrence again.  Serving passes no pointer.
//
// What bounds it on an H100: bytes, and beside them the exponentials.
// u, dt and y move 12 bytes per (row, step, channel) against about 7 N
// flops (N = 16 for jamba), under the ~20 flop/byte ridge of the card's
// f32 CUDA-core rate; and each (row, step, channel, state) takes one
// exp, at 16 a clock on an SM's special-function units, about as long
// as the bytes at jamba's N.  Step t needs step t-1, so each channel is
// a chain of L dependent steps; enough chains must be in flight to hide
// it.
//
// What the design does:
//   * Each channel's N states are split over G = N / 4 lanes of 4 states
//     (4 lanes at N = 16): a block of 32 channels is 32 G threads, so the
//     grid holds G times the warps of one thread per channel.  A lane
//     keeps its 4 states and its 4 values of A (times log2 e) in
//     registers for the whole scan; y's dot product s . C_t is summed
//     over the group with __shfl_xor_sync.  exp(dt A) does not depend on
//     s, so in the unrolled tile the exponentials are issued ahead of
//     the chain, which is one FMA a state and step.
//   * Time runs in tiles of T = 32 steps.  A tile's u and dt (32 channels
//     each step) and its B_t and C_t (N values each step, shared by every
//     channel of the row) land in shared memory through cp.async, double
//     buffered: the next tile's copies are in flight while this tile's
//     chain runs.  Steps past L are zero-filled, so dt = 0 keeps the
//     state as it is (exp(0) s + 0) and the ragged last tile needs no
//     branch.  The tile's y is gathered in shared memory and stored
//     coalesced.
//   * Checkpoints: at steps 0 and 16 of a tile each lane stores its 4
//     states (a float4) before it updates them; the arithmetic is the
//     same with or without the pointer, so y and the last state are too.
// Not done: splitting the time axis over blocks (a chunked scan that
// passes each chunk's state on); at jamba's d_in = 8192 the grid fills
// the card's SMs at B = 1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;

constexpr int CH = 32;          // channels per block
constexpr int SPL = 4;          // states per lane
constexpr int T = 32;           // time steps per staged tile
constexpr int CKPT_T = 16;      // steps between checkpoints: the
                                // backward's chunk (ssm_scan_bwd.cu T)
static_assert(T % CKPT_T == 0, "a checkpoint falls on a tile's step");
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Cfg {
  static constexpr int G = N / SPL;             // lanes per channel
  static constexpr int THREADS = CH * G;
  // one stage: u, dt (T x CH) and B, C (T x N) floats
  static constexpr int STAGE_F = 2 * T * CH + 2 * T * N;
  static constexpr int SMEM = 4 * (2 * STAGE_F + T * CH);
};

template <int N>
__global__ void __launch_bounds__(Cfg<N>::THREADS)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ D,
                const float* __restrict__ s0, float* __restrict__ y,
                float* __restrict__ s_out, float* __restrict__ ckpt, int L,
                int d_in) {
  using C = Cfg<N>;
  constexpr int G = C::G, THREADS = C::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* ys = smem + 2 * C::STAGE_F;            // [T][CH] this tile's y

  const int tid = threadIdx.x;
  const int ch = tid / G, g = tid % G;          // channel in block, lane
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int d = d0 + ch;
  const bool live = d < d_in;          // lanes past d_in scan zeros
  const int dc = live ? d : d_in - 1;
  const bool vec = d_in % 4 == 0;      // 16-byte rows of u, dt and y
  const size_t row = (size_t)b * L;

  // the tile of steps [t0, t0 + T) into stage `st`; zeros past L / d_in
  auto load = [&](int st, int t0) {
    float* us = smem + st * C::STAGE_F;
    float* dts = us + T * CH;
    float* bs = dts + T * CH;
    float* cs = bs + T * N;
    if (vec) {
      for (int i = tid; i < T * CH / 4; i += THREADS) {
        const int j = i / (CH / 4), c4 = 4 * (i % (CH / 4));
        const bool in = t0 + j < L && d0 + c4 < d_in;
        const size_t off = in ? (row + t0 + j) * d_in + d0 + c4 : 0;
        cp_async16(us + j * CH + c4, u + off, in ? 16 : 0);
        cp_async16(dts + j * CH + c4, dt + off, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < T * CH; i += THREADS) {
        const int j = i / CH, c = i % CH;
        const bool in = t0 + j < L && d0 + c < d_in;
        const size_t off = in ? (row + t0 + j) * d_in + d0 + c : 0;
        cp_async4(us + i, u + off, in ? 4 : 0);
        cp_async4(dts + i, dt + off, in ? 4 : 0);
      }
    }
    for (int i = tid; i < T * N / 4; i += THREADS) {
      const int j = 4 * i / N;
      const bool in = t0 + j < L;
      const size_t off = in ? (row + t0) * N + 4 * i : 0;
      cp_async16(bs + 4 * i, Bm + off, in ? 16 : 0);
      cp_async16(cs + 4 * i, Cm + off, in ? 16 : 0);
    }
  };

  const int tiles = (L + T - 1) / T;
  const int chunks = (L + CKPT_T - 1) / CKPT_T;
  // this lane's checkpoint before step t (a multiple of CKPT_T)
  float* ck = ckpt == nullptr || !live
                  ? nullptr
                  : ckpt + ((size_t)b * chunks * d_in + d) * N + g * SPL;
  load(0, 0);
  hopper::cp_async_commit();
  float a2[SPL], s[SPL];
  {
    const float4 av = *reinterpret_cast<const float4*>(
        A + (size_t)dc * N + g * SPL);
    a2[0] = av.x * LOG2E, a2[1] = av.y * LOG2E;
    a2[2] = av.z * LOG2E, a2[3] = av.w * LOG2E;
    float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 != nullptr)
      sv = *reinterpret_cast<const float4*>(
          s0 + ((size_t)b * d_in + dc) * N + g * SPL);
    s[0] = sv.x, s[1] = sv.y, s[2] = sv.z, s[3] = sv.w;
  }
  const float dg = D[dc];

  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) load((k + 1) & 1, (k + 1) * T);
    hopper::cp_async_commit();                  // empty group at the end
    hopper::cp_async_wait<1>();                 // tile k (this thread's)
    __syncthreads();                            // ... and everyone's
    const float* us = smem + (k & 1) * C::STAGE_F;
    const float* dts = us + T * CH;
    const float* bs = dts + T * CH;
    const float* cs = bs + T * N;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float dtv = dts[j * CH + ch], uv = us[j * CH + ch];
      const float du = dtv * uv;
      const float4 bv = *reinterpret_cast<const float4*>(bs + j * N + g * SPL);
      const float4 cv = *reinterpret_cast<const float4*>(cs + j * N + g * SPL);
      const float bb[SPL] = {bv.x, bv.y, bv.z, bv.w};
      const float cc[SPL] = {cv.x, cv.y, cv.z, cv.w};
      if (j % CKPT_T == 0 && ck != nullptr && k * T + j < L)
        *reinterpret_cast<float4*>(
            ck + (size_t)((k * T + j) / CKPT_T) * d_in * N) =
            make_float4(s[0], s[1], s[2], s[3]);
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        s[i] = hopper::exp2_approx(dtv * a2[i]) * s[i] + du * bb[i];
        p += s[i] * cc[i];
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (g == j % G) ys[j * CH + ch] = p + uv * dg;
    }
    __syncthreads();                            // ys complete; stage free
    const int nt = min(T, L - k * T);
    float* yb = y + (row + (size_t)k * T) * d_in + d0;
    if (vec) {
      for (int i = tid; i < nt * CH / 4; i += THREADS) {
        const int j = i / (CH / 4), c4 = 4 * (i % (CH / 4));
        if (d0 + c4 < d_in)
          *reinterpret_cast<float4*>(yb + (size_t)j * d_in + c4) =
              *reinterpret_cast<const float4*>(ys + j * CH + c4);
      }
    } else {
      for (int i = tid; i < nt * CH; i += THREADS) {
        const int j = i / CH, c = i % CH;
        if (d0 + c < d_in) yb[(size_t)j * d_in + c] = ys[i];
      }
    }
  }
  if (live)
    *reinterpret_cast<float4*>(s_out + ((size_t)b * d_in + d) * N +
                               g * SPL) = make_float4(s[0], s[1], s[2], s[3]);
}

template <int N>
int launch(const float* u, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* D, const float* s0, float* y,
           float* s_out, float* ckpt, int B, int L, int d_in,
           cudaStream_t stream) {
  using C = Cfg<N>;
  cudaError_t rc = hopper::allow_smem<ssm_scan_kernel<N>>(C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((d_in + CH - 1) / CH, B);
  ssm_scan_kernel<N><<<grid, C::THREADS, C::SMEM, stream>>>(
      u, dt, Bm, Cm, A, D, s0, y, s_out, ckpt, L, d_in);
  return (int)cudaGetLastError();
}

}  // namespace

// u/dt (B, L, d_in), Bm/Cm (B, L, N), A (d_in, N), D (d_in,), init_state
// (B, d_in, N) or NULL (zeros), y (B, L, d_in), s_out (B, d_in, N), the
// checkpoints ckpt (B, ceil(L / 16), d_in, N) or NULL (none written); all
// f32, contiguous and 16-byte aligned.  N is 8, 16, 32 or 64 (the wrapper
// pads any other N with zero state columns).  Returns a cudaError_t.
extern "C" int ssm_scan_f32(const void* u, const void* dt, const void* Bm,
                            const void* Cm, const void* A, const void* D,
                            const void* s0, void* y, void* s_out, void* ckpt,
                            int B, int L, int d_in, int N, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || d_in < 1)
    return (int)cudaErrorInvalidValue;
#define LAUNCH(N_)                                                         \
  return launch<N_>((const float*)u, (const float*)dt, (const float*)Bm,  \
                    (const float*)Cm, (const float*)A, (const float*)D,   \
                    (const float*)s0, (float*)y, (float*)s_out,           \
                    (float*)ckpt, B, L, d_in, (cudaStream_t)stream)
  switch (N) {
    case 8: LAUNCH(8);
    case 16: LAUNCH(16);
    case 32: LAUNCH(32);
    case 64: LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
}
