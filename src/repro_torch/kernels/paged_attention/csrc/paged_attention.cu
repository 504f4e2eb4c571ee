// One-token flash-decode through a page table, for Hopper (sm_90a).
//
// Replaces: repro/kernels/paged_attention/kernel.py ::
//   paged_decode_attention_kernel (body _paged_decode_kernel), the
//   full-precision body; the int8 body (_paged_decode_kernel_q) is not
//   ported yet.
//
// What bounds it on an H100: bytes, as for the row-cache decode: each
// live key of a row is read once from the shared page pool, at about
// 2 * G flops per byte.
//
// What the design does about it: the decode block of attn_common.cuh
// with a paged key address.  The TPU kernel's scalar-prefetched BlockSpec
// index map (pt[b, j]) becomes the block reading its own page ids: key t
// of row b lives at pool[table[b, t / page], h, t % page].  Only keys
// 0..pos are visited, so a page starting past pos -- and the park page 0
// that dead table entries point at -- is never read.  G query heads share
// every K/V byte; (m, l, acc) stay in registers across all pages.
#include "attn_common.cuh"

namespace {

using repro::bf16;

template <int HD>
struct PagedRows {
  const bf16* kp;       // (NP, Hkv, page, HD) pools
  const bf16* vp;
  const int* table;     // (P,) page ids of this row
  int page, Hkv, h;
  __device__ __forceinline__ size_t off(int t) const {
    const int pid = table[t / page];
    return (((size_t)pid * Hkv + h) * page + (t % page)) * HD;
  }
  __device__ __forceinline__ const bf16* key(int t) const {
    return kp + off(t);
  }
  __device__ __forceinline__ const bf16* value(int t) const {
    return vp + off(t);
  }
};

template <int HD, int G, int NW>
__global__ void __launch_bounds__(NW * 32)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, bf16* __restrict__ out,
                    int Hkv, int P, int page, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * Hkv + h;
  PagedRows<HD> rows{kp, vp, table + (size_t)b * P, page, Hkv, h};
  const int n = min(pos[b], P * page - 1) + 1;
  repro::decode_block<HD, G, NW>(q + bh * G * HD, rows, n, scale,
                                 out + bh * G * HD);
}

}  // namespace

// q (B, Hkv, G, hd) bf16, k/v pools (NP, Hkv, page, hd) bf16, table (B, P)
// int32, pos (B,) int32, out (B, Hkv, G, hd) bf16; all contiguous.
// Returns a cudaError_t.
extern "C" int paged_decode_attention_bf16(const void* q, const void* kp,
                                           const void* vp, const void* table,
                                           const void* pos, void* out, int B,
                                           int Hkv, int G, int P, int page,
                                           int hd, float scale,
                                           void* stream) {
  constexpr int NW = 8;
  const dim3 grid(Hkv, B);
#define LAUNCH(HD_, G_)                                                 \
  paged_decode_kernel<HD_, G_, NW>                                      \
      <<<grid, NW * 32, 0, (cudaStream_t)stream>>>(                     \
          (const bf16*)q, (const bf16*)kp, (const bf16*)vp,             \
          (const int*)table, (const int*)pos, (bf16*)out, Hkv, P, page, \
          scale)
  REPRO_DECODE_DISPATCH(hd, G, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
