// Grouped (per-expert) matmul for Hopper (sm_90a): x (E, C, D) @ w (E, D, F)
// -> (E, C, F), bf16 in, f32 accumulation, bf16 out -- the expert FFN of
// the expert-parallel MoE, after the all_to_all has grouped each expert's
// capacity-padded tokens.
//
// Replaces: repro/kernels/gmm/kernel.py :: gmm_kernel (body _gmm_kernel).
//
// What bounds it on an H100: at mixtral-8x7b's shapes after a 4-shard
// all_to_all, (2, 320, 4096) @ (2, 4096, 14336), the call moves 258 MB
// (each weight byte once) and does 75.2 GFLOP: about 292 flops per byte,
// on the ridge of the card (0.077 ms for the bytes over 3.35 TB/s, 0.076
// ms for the operations over 989 TFLOP/s of bf16 tensor cores).
//
// What the design does about it: the TPU kernel's (E, C/bc, F/bf, D/bd)
// grid with an f32 VMEM accumulator over the sequential D axis becomes one
// block per (128 x 128 output tile, expert) with the D loop inside the
// block, so each output tile is written once.  Each 32-deep step stages an
// x tile (128 x 32) and a w tile (32 x 128) in shared memory with 16-byte
// loads; the block's 8 warps (4 x 2) each own a 32 x 64 tile of f32
// accumulators and run bf16 tensor-core products on them through
// nvcuda::wmma 16x16x16 fragments.  Rows past C (a ragged capacity: 80 x 4
// shards gives C = 320) load as zeros and are never stored.  This first
// version has no pipelining of the loads (no cp.async / TMA ring) and no
// wgmma: a simple kernel that is right, far from the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 128;          // output rows (tokens) of a block
constexpr int BN = 128;          // output columns of a block
constexpr int BK = 32;           // contraction depth of one staged step
constexpr int THREADS = 256;     // 8 warps: 4 along M x 2 along N
constexpr int WM = 32, WN = 64;  // one warp's output tile
constexpr int AS = BK + 8;       // padded shared row strides (multiples
constexpr int BS = BN + 8;       // of 8 bf16, as wmma loads need)

__global__ void __launch_bounds__(THREADS)
gmm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
           bf16* __restrict__ out, int C, int D, int F) {
  __shared__ __align__(32) bf16 a_s[BM][AS];
  __shared__ __align__(32) bf16 b_s[BK][BS];
  __shared__ __align__(32) float c_s[THREADS / 32][16][16];

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const bf16* xe = x + (size_t)e * C * D;
  const bf16* we = w + (size_t)e * D * F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = (warp >> 1) * WM, wc = (warp & 1) * WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < D; k0 += BK) {
    // x tile: BM x BK = 512 vectors of 8 bf16, two a thread
#pragma unroll
    for (int v = threadIdx.x; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int gr = row0 + r;
      *reinterpret_cast<uint4*>(&a_s[r][c]) =
          gr < C ? *reinterpret_cast<const uint4*>(xe + (size_t)gr * D + k0 + c)
                 : zero;
    }
    // w tile: BK x BN = 512 vectors, two a thread
#pragma unroll
    for (int v = threadIdx.x; v < BK * BN / 8; v += THREADS) {
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      const int gc = col0 + c;
      *reinterpret_cast<uint4*>(&b_s[r][c]) =
          gc < F ? *reinterpret_cast<const uint4*>(we + (size_t)(k0 + r) * F + gc)
                 : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(fa[i], &a_s[wr + 16 * i][kk], AS);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        wmma::load_matrix_sync(fb, &b_s[kk][wc + 16 * j], BS);
#pragma unroll
        for (int i = 0; i < WM / 16; ++i)
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: each 16 x 16 accumulator through the warp's f32 scratch,
  // rounded to bf16; rows past C and columns past F are not stored
  bf16* oe = out + (size_t)e * C * F;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      wmma::store_matrix_sync(&c_s[warp][0][0], acc[i][j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1, c = (lane & 1) * 8;
      const int gr = row0 + wr + 16 * i + r;
      const int gc = col0 + wc + 16 * j + c;
      if (gr < C && gc < F) {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = __float2bfloat16(c_s[warp][r][c + t]);
        *reinterpret_cast<uint4*>(oe + (size_t)gr * F + gc) =
            *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
}

}  // namespace

// x (E, C, D), w (E, D, F), out (E, C, F), all bf16 and contiguous; any
// C >= 1, D a multiple of 32, F a multiple of 8.  Returns a cudaError_t.
extern "C" int gmm_bf16(const void* x, const void* w, void* out, int E,
                        int C, int D, int F, void* stream) {
  if (E < 1 || C < 1 || D < BK || D % BK || F < 8 || F % 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)out, C, D, F);
  return (int)cudaGetLastError();
}
