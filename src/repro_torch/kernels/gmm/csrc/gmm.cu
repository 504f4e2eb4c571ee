// Grouped (per-expert) matmul for Hopper (sm_90a), on the tensor cores:
// x (E, C, D) @ w (E, D, F) -> (E, C, F), bf16 in, f32 accumulation, bf16
// out -- the expert FFN of the expert-parallel MoE, after the all_to_all
// has grouped each expert's capacity-padded tokens.
//
// Replaces: repro/kernels/gmm/kernel.py :: gmm_kernel (body _gmm_kernel).
//
// What bounds it on an H100: at mixtral-8x7b's shapes after a 4-shard
// all_to_all, (2, 320, 4096) @ (2, 4096, 14336) and (2, 320, 14336) @ (2,
// 14336, 4096), a call moves about 240-260 MB (each weight byte once) and
// does 75.2 GFLOP: about 290 flops per byte, on the ridge of the card
// (0.077 ms for the bytes over 3.35 TB/s, 0.076 ms for the operations
// over 989 TFLOP/s of bf16 tensor cores).  The weights stream once; the
// few token rows are re-read from L2 by every column tile.
//
// What the design does about it: one block per (128 x BN output tile,
// expert), with a producer warp and two consumer warpgroups of 64 rows.
// The producer keeps a ring of 4 stages full by TMA: each stage holds a
// 64-deep x tile (128 x 64, K-major) and w tile (64 x BN, N-major in
// 64-column atoms), loaded from 3-D descriptors over (E, C, D) and (E, D,
// F) that zero-fill rows past C and a depth tail past D, and completes on
// an mbarrier.  The consumers run wgmma m64nBNk16 on the tiles that have
// arrived (w with the transpose bit), keep one group of products in
// flight and release a stage as soon as the products that read it are
// done, so copies overlap products.  A warpgroup whose 64 rows lie wholly
// past C (the half-empty last tile of C = 320) skips its products.
// Stores clip at C and F.  The blocks run the M tiles of one weight tile
// next to each other, so the weights cross HBM about once.  The tile is
// 256 columns wide, as the token rows are re-read from L2 by every column
// tile (128 columns ran 1.4x slower on the card at both of mixtral's
// products).  The down product's 96 tiles leave 36 SMs idle in its one
// round of blocks; 192-column tiles, which fill the card once, measured
// no faster there.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // output rows of a block
constexpr int BN = 256;          // output columns of a block
constexpr int BK = 64;           // depth of one stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;   // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int ATOM_B = BK * 128;           // one 64-column atom of a w tile
constexpr int SMEM_BYTES = STAGES * (A_BYTES + B_BYTES) + 1024;

__global__ void __launch_bounds__(THREADS, 1)
gmm_kernel(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tw, bf16* __restrict__ out,
           int C, int D, int F, int mt, int nt) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* a_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* b_s = a_s + STAGES * A_BYTES;

  // M tiles of one (expert, weight tile) run next to each other
  const int m = blockIdx.x % mt;
  const int n = (blockIdx.x / mt) % nt;
  const int e = blockIdx.x / (mt * nt);
  const int nk = (D + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS / 32) {
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
        hopper::tma_load_3d(a_s + s * A_BYTES, &tx, &full[s], kt * BK, m * BM,
                            e);
        for (int a = 0; a < BN / 64; ++a)
          hopper::tma_load_3d(b_s + s * B_BYTES + a * ATOM_B, &tw, &full[s],
                              n * BN + a * 64, kt * BK, e);
      }
    }
  } else {
    const int wg = warp / 4;
    const int r0 = m * BM + 64 * wg;
    if (r0 >= C) {
      // all 64 rows past C: release each stage unread
      for (int kt = 0; kt < nk; ++kt) {
        hopper::mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
        hopper::mbar_arrive(&empty[kt % STAGES]);
      }
      return;
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = hopper::make_desc(
            a_s + s * A_BYTES + wg * 64 * 128 + kk * 32, 16, 1024,
            hopper::SW128);
        const uint64_t db = hopper::make_desc(
            b_s + s * B_BYTES + kk * 16 * 128, ATOM_B, 1024, hopper::SW128);
        hopper::wgmma_ss<BN, 1>(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      // the previous stage's products are done: release it
      hopper::wgmma_wait<1>();
      if (kt > 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();

    const int row0 = r0 + 16 * (warp % 4) + lane / 4;
    const int c0 = n * BN + 2 * (lane % 4);
    bf16* oe = out + (size_t)e * C * F;
#pragma unroll
    for (int j = 0; j < BN / 2; j += 2) {
      const int row = row0 + 8 * ((j >> 1) & 1);
      const int col = c0 + (j / 4) * 8;
      if (row < C && col < F)
        *reinterpret_cast<uint32_t*>(oe + (size_t)row * F + col) =
            hopper::pack_bf16(acc[j], acc[j + 1]);
    }
  }
}

}  // namespace

// x (E, C, D), w (E, D, F), out (E, C, F), all bf16, contiguous and
// 16-byte aligned; any C >= 1, D and F multiples of 8 (the 16-byte row
// stride TMA needs).  Returns a cudaError_t.
extern "C" int gmm_bf16(const void* x, const void* w, void* out, int E,
                        int C, int D, int F, void* stream) {
  if (E < 1 || C < 1 || D < 8 || D % 8 || F < 8 || F % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  const uint64_t dx[3] = {(uint64_t)D, (uint64_t)C, (uint64_t)E};
  const uint64_t sx[2] = {2ull * D, 2ull * C * D};
  const uint32_t bx[3] = {BK, BM, 1};
  const uint64_t dw[3] = {(uint64_t)F, (uint64_t)D, (uint64_t)E};
  const uint64_t sw[2] = {2ull * F, 2ull * D * F};
  const uint32_t bw[3] = {64, BK, 1};
  if (!hopper::encode_map(&mx, x, 3, dx, sx, bx, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_map(&mw, w, 3, dw, sw, bw, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc = hopper::allow_smem<gmm_kernel>(SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  const int mt = (C + BM - 1) / BM, nt = (F + BN - 1) / BN;
  gmm_kernel<<<mt * nt * E, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      mx, mw, (bf16*)out, C, D, F, mt, nt);
  return (int)cudaGetLastError();
}
