// 3xTF32 matrix products on the tensor cores (mma.sync m16n8k8) and a
// cp.async tile copy, shared by the chunkwise mLSTM's forward
// (mlstm_chunk.cu) and backward (mlstm_chunk_bwd.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tf32x3 {

// x = hi + lo: hi is x with the low 13 mantissa bits cleared (a TF32
// value), lo the rest, exact in f32; an mma reads only the top 19 bits
// of its TF32 operands, so lo enters truncated to TF32 (x - hi - lo below
// 2^-20 |x|).  Two integer/f32 operations, where cvt.rna costs more.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8, row) b (8 x 8, col), TF32 in, f32 out
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's (16 MT) x (8 NT) block of acc += A B over a depth of K, in
// 3xTF32: A[m][kk] = fa(m, kk) and B[kk][n] = fb(kk, n), m and n counted
// from the warp's block.  acc[i][j] is the m16n8 fragment of rows 16 i..,
// columns 8 j..: element e at row gq + 8 (e / 2), column 2 tq + e % 2.
template <int MT, int NT, int K, class FA, class FB>
__device__ __forceinline__ void mma3(float (&acc)[MT][NT][4], FA fa, FB fb) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      split_tf32(fa(16 * i + gq, k0 + tq), ah[i][0], al[i][0]);
      split_tf32(fa(16 * i + gq + 8, k0 + tq), ah[i][1], al[i][1]);
      split_tf32(fa(16 * i + gq, k0 + tq + 4), ah[i][2], al[i][2]);
      split_tf32(fa(16 * i + gq + 8, k0 + tq + 4), ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(fb(k0 + tq, 8 * j + gq), bh0, bl0);
      split_tf32(fb(k0 + tq + 4, 8 * j + gq), bh1, bl1);
#pragma unroll
      for (int i = 0; i < MT; ++i) {     // the small terms first
        mma_tf32(acc[i][j], al[i], bh0, bh1);
        mma_tf32(acc[i][j], ah[i], bl0, bl1);
        mma_tf32(acc[i][j], ah[i], bh0, bh1);
      }
    }
  }
}

// rows [row0, row0 + rows) x `cols` floats (a multiple of 4) of a matrix
// with rows of `ld` floats, into dst (row stride `stride`) by cp.async;
// rows at or past `lim` zero-filled
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const float* src, size_t ld, int row0,
                                      int rows, int cols, int lim,
                                      int threads) {
  const int cpr = cols / 4;
  for (int i = threadIdx.x; i < rows * cpr; i += threads) {
    const int r = i / cpr, c4 = 4 * (i % cpr);
    const bool in = row0 + r < lim;
    hopper::cp_async16(dst + r * stride + c4,
                       src + (in ? (size_t)(row0 + r) * ld : 0) + c4,
                       in ? 16 : 0);
  }
}

}  // namespace tf32x3
