// Mamba selective scan with a carried state, for Hopper (sm_90a).
//
// Replaces: repro/kernels/ssm_scan/kernel.py ::
//   ssm_scan_kernel (body _ssm_kernel).
//
// What it computes, per row b and channel d, in f32:
//   s_t = exp(dt_t * A[d]) * s_{t-1} + dt_t * u_t * B_t      (s: N values)
//   y_t = s_t . C_t + u_t * D[d]
// from s_0 = init_state (or zeros); it returns every y_t and the last s.
//
// What bounds it on an H100: bytes on paper.  u, dt and y move 12 bytes
// per (row, step, channel) against about 7 * N flops (N = 16 for jamba),
// under the ~20 flop/byte ridge of the card's f32 CUDA-core rate.  In
// practice the recurrence bounds it: step t needs step t-1, so each
// channel is a chain of L dependent steps, and at B = 2, d_in = 8192 the
// 128 blocks of 128 threads put one block on most SMs (4 warps an SM).
//
// What the design does: one thread per (row, channel) keeps the channel's
// N state values and its row of A in registers for the whole scan; the
// TPU grid's sequential time axis, with the state carried in VMEM
// scratch, is a loop inside the thread.  The block walks time in tiles of
// T steps: the tile's B_t and C_t (N values each, shared by all channels
// of a row) are staged once in shared memory, and each thread loads its
// own u and dt for the tile up front, coalesced across the block's
// channels, so the tile's loads are in flight together before the chain
// runs.  y stores coalesce the same way.  Any L: the last tile is ragged.
// Not yet done: splitting the time axis over blocks (a chunked scan that
// passes each chunk's state on), which the thin grid above calls for.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;    // channels per block
constexpr int T = 32;           // time steps per staged tile

template <int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ D,
                const float* __restrict__ s0, float* __restrict__ y,
                float* __restrict__ s_out, int L, int d_in) {
  __shared__ float b_s[T][N];
  __shared__ float c_s[T][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < d_in;         // threads past d_in load, never store
  const int dc = live ? d : d_in - 1;

  float a[N], s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = A[(size_t)dc * N + n];
    s[n] = s0 == nullptr ? 0.f : s0[((size_t)b * d_in + dc) * N + n];
  }
  const float dg = D[dc];
  const size_t row = (size_t)b * L;
  const float* ub = u + row * d_in + dc;
  const float* dtb = dt + row * d_in + dc;
  float* yb = y + row * d_in + dc;
  const float* bb = Bm + row * N;
  const float* cb = Cm + row * N;

  for (int t0 = 0; t0 < L; t0 += T) {
    const int nt = min(T, L - t0);
    for (int i = threadIdx.x; i < nt * N; i += THREADS) {
      b_s[i / N][i % N] = bb[(size_t)t0 * N + i];
      c_s[i / N][i % N] = cb[(size_t)t0 * N + i];
    }
    float ur[T], dtr[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const bool in = j < nt;
      ur[j] = in ? ub[(size_t)(t0 + j) * d_in] : 0.f;
      dtr[j] = in ? dtb[(size_t)(t0 + j) * d_in] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (j < nt) {
        const float du = dtr[j] * ur[j];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          s[n] = expf(dtr[j] * a[n]) * s[n] + du * b_s[j][n];
          acc += s[n] * c_s[j][n];
        }
        if (live) yb[(size_t)(t0 + j) * d_in] = acc + ur[j] * dg;
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) s_out[((size_t)b * d_in + d) * N + n] = s[n];
  }
}

}  // namespace

// u/dt (B, L, d_in), Bm/Cm (B, L, N), A (d_in, N), D (d_in,), init_state
// (B, d_in, N) or NULL (zeros), y (B, L, d_in), s_out (B, d_in, N); all
// f32 and contiguous.  N is 8, 16, 32 or 64 (the wrapper pads any other N
// with zero state columns).  Returns a cudaError_t.
extern "C" int ssm_scan_f32(const void* u, const void* dt, const void* Bm,
                            const void* Cm, const void* A, const void* D,
                            const void* s0, void* y, void* s_out, int B,
                            int L, int d_in, int N, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || d_in < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((d_in + THREADS - 1) / THREADS, B);
#define LAUNCH(N_)                                                          \
  ssm_scan_kernel<N_><<<grid, THREADS, 0, (cudaStream_t)stream>>>(          \
      (const float*)u, (const float*)dt, (const float*)Bm, (const float*)Cm, \
      (const float*)A, (const float*)D, (const float*)s0, (float*)y,         \
      (float*)s_out, L, d_in)
  if (N == 8) {
    LAUNCH(8);
  } else if (N == 16) {
    LAUNCH(16);
  } else if (N == 32) {
    LAUNCH(32);
  } else if (N == 64) {
    LAUNCH(64);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
