// K-query verify attention over a row KV cache, for Hopper (sm_90a):
// chunked prefill on the row cache (and speculative verify).
//
// Replaces: repro/kernels/verify_attention/kernel.py ::
//   verify_attention_kernel (body _verify_kernel): causal or tree mask,
//   and the sliding-window ring (ring=True, causal only).
//
// What bounds it on an H100: each row's cache keys 0..pos-1 and the K
// block keys are read once for K * G query rows, about 2 * K * G flops
// per byte (2048 at K = 128, G = 8): bound by operations on paper, and
// this first version runs its products on the CUDA cores in f32.
//
// What the design does: the verify block of attn_common.cuh (shared with
// the paged verify kernel, which differs only in where key t lives), one
// block per (tile of 64 score rows, kv head, row).  The TPU grid's
// sequential kv axis, with (m, l, acc) carried in VMEM scratch, is a loop
// inside the block with the state in registers; the cache tiles (keys
// < pos, the cache BEFORE the block's writes) and then the block's own
// keys fold into one running softmax, the block's under the causal mask
// (stopping after the last key the tile's rows see) or the tree bitmask.
// Cache slots at or past pos are never read.  A ring cache (a runtime
// flag, not a template parameter: instantiations dominate the build)
// reads its min(pos, S) written slots and masks each by the position it
// holds against the query's window.
// Not yet done: tensor-core products, and reading each cache tile once
// for all score-row tiles of a (row, kv head) instead of once per tile.
#include "attn_common.cuh"

namespace {

using repro::bf16;

template <int HD>
__global__ void __launch_bounds__(repro::VTHREADS)
verify_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ kb,
              const bf16* __restrict__ vb, const int* __restrict__ pos,
              const int* __restrict__ anc, bf16* __restrict__ out, int Hkv,
              int G, int K, int S, int ring, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * Hkv + h;
  const size_t KG = (size_t)K * G;
  using KV = repro::Bf16KV<HD>;
  repro::Rows<KV, repro::ContigMap> cache{{k, v}, {bh * S}};
  repro::Rows<KV, repro::ContigMap> blk{{kb, vb}, {bh * K}};
  const int n = min(max(pos[b], 0), S);            // cache keys < pos
  repro::verify_block<HD>(q + bh * KG * HD, cache, n, blk, K, G,
                          anc == nullptr ? nullptr : anc + (size_t)b * K,
                          scale, out + bh * KG * HD, blockIdx.x * repro::VQ,
                          ring ? pos[b] : 0, ring ? S : 0);
}

}  // namespace

// q (B, Hkv, K*G, hd) bf16 (row r = block query r / G, head r % G), k/v
// (B, Hkv, S, hd) bf16 cache as it stood BEFORE the block, kb/vb (B, Hkv,
// K, hd) bf16 block keys/values, pos (B,) int32 base positions, tree
// (B, K) int32 ancestor bitmasks or NULL (causal), out like q; all
// contiguous.  ring != 0: the cache is a sliding-window ring of S slots
// (causal only, K <= S).  Returns a cudaError_t.
extern "C" int verify_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* kb,
                                     const void* vb, const void* pos,
                                     const void* tree, void* out, int B,
                                     int Hkv, int G, int K, int S, int hd,
                                     int ring, float scale, void* stream) {
  if (ring && (tree != nullptr || K > S)) return (int)cudaErrorInvalidValue;
  const dim3 grid((K * G + repro::VQ - 1) / repro::VQ, Hkv, B);
#define LAUNCH(HD_)                                                         \
  verify_kernel<HD_><<<grid, repro::VTHREADS, 0, (cudaStream_t)stream>>>(  \
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)kb,      \
      (const bf16*)vb, (const int*)pos, (const int*)tree, (bf16*)out, Hkv, \
      G, K, S, ring, scale)
  REPRO_VERIFY_DISPATCH(hd, G, K, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
