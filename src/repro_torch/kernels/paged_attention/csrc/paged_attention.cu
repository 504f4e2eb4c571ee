// Paged attention through a page table, for Hopper (sm_90a): one-token
// decode, K-query verify (chunked prefill, speculative verify) and one
// shard's unnormalized decode partial over its slice of a sharded bank,
// each over a full-precision or an int8 page pool.
//
// Replaces: repro/kernels/paged_attention/kernel.py ::
//   paged_decode_attention_kernel (bodies _paged_decode_kernel and
//   _paged_decode_kernel_q), paged_verify_attention_kernel (bodies
//   _paged_verify_kernel and _paged_verify_kernel_q, causal or tree) and
//   paged_decode_partial_kernel (bodies _paged_decode_partial_kernel and
//   _paged_decode_partial_kernel_q).
//
// What bounds it on an H100: bytes for decode, as for the row-cache
// decode: each live key of a row is read once from the shared page pool,
// at about 2 * G flops per byte (int8 halves the bytes).  Verify reads the
// same keys once for K * G query rows, about 2 * K * G flops per byte
// (2048 at K = 128, G = 8): bound by operations on paper, and this first
// version runs its products on the CUDA cores in f32.
//
// What the design does about it: the TPU kernel's scalar-prefetched
// BlockSpec index map (pt[b, j]) becomes the block reading its own page
// ids: key t of row b lives at pool[table[b, t / page], h, t % page]
// (attn_common.cuh's PagedMap).  The storage is a template argument of the
// same body (Bf16KV, or Int8KV: codes and the (NP, Hkv, page) f32 scales,
// flat-indexed alike and dequantized in registers before the dot product).
//   * decode: the decode block of attn_common.cuh, one block per (row, kv
//     head), the G query heads sharing every K/V byte.  Only keys 0..pos
//     are visited.
//   * verify: the verify block of attn_common.cuh, one block per (tile of
//     64 score rows, kv head, row).  The cache side walks keys 0..pos-1
//     (the pool BEFORE the block's writes), then the block's own K keys
//     and values (bf16: not yet written to the pool, even for an int8
//     pool) fold in under the causal or tree mask.
//   * partial: the decode fold of attn_common.cuh over one shard's LOCAL
//     slice of L pages.  The table holds GLOBAL page ids; the block
//     reads page table[b, j] - base only when the shard owns it (0 <= id
//     - base < L) and stops at pos like decode, so a page the shard does
//     not own is never read (a whole 32-key tile of it is skipped).  It
//     writes the unnormalized state acc (G, hd), m, l (G) in f32 for the
//     caller's cross-shard pmax/psum merge; a row that owns no valid page
//     ends at exactly (0, -1e30, 0).  Bound like decode: bytes, each owned
//     live key read once by its owning shard.
// In all three, a page starting past the last read position -- and the
// park page 0 that dead table entries point at -- is never read.
#include "attn_common.cuh"

namespace {

using repro::bf16;

template <int HD, int G, int NW, class KV>
__global__ void __launch_bounds__(NW * 32)
paged_decode_kernel(const bf16* __restrict__ q, KV kv,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, bf16* __restrict__ out,
                    int Hkv, int P, int page, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * Hkv + h;
  repro::Rows<KV, repro::PagedMap> rows{kv,
                                        {table + (size_t)b * P, page, Hkv, h}};
  const int n = min(pos[b], P * page - 1) + 1;
  repro::decode_block<HD, G, NW>(q + bh * G * HD, rows, n, scale,
                                 out + bh * G * HD);
}

template <int HD, class KV>
__global__ void __launch_bounds__(repro::VTHREADS)
paged_verify_kernel(const bf16* __restrict__ q, KV kv,
                    const bf16* __restrict__ kb, const bf16* __restrict__ vb,
                    const int* __restrict__ table,
                    const int* __restrict__ pos, const int* __restrict__ anc,
                    bf16* __restrict__ out, int Hkv, int G, int K, int P,
                    int page, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * Hkv + h;
  const size_t KG = (size_t)K * G;
  repro::Rows<KV, repro::PagedMap> cache{
      kv, {table + (size_t)b * P, page, Hkv, h}};
  repro::Rows<repro::Bf16KV<HD>, repro::ContigMap> blk{{kb, vb}, {bh * K}};
  const int n = min(max(pos[b], 0), P * page);   // cache keys < pos
  repro::verify_block<HD>(q + bh * KG * HD, cache, n, blk, K, G,
                          anc == nullptr ? nullptr : anc + (size_t)b * K,
                          scale, out + bh * KG * HD, blockIdx.x * repro::VQ);
}

// Slot t % page of the LOCAL page table[t / page] - base of one shard's
// slice of L pages; a page the shard does not own maps to its local park
// page 0 (LocalOwner keeps such keys out of the fold, so it is never read).
struct LocalPagedMap {
  const int* table;               // (P,) GLOBAL page ids of this row
  int base, L, page, Hkv, h;
  __device__ __forceinline__ size_t operator()(int t) const {
    int lp = table[t / page] - base;
    lp = (lp >= 0 && lp < L) ? lp : 0;
    return ((size_t)lp * Hkv + h) * page + (t % page);
  }
};

struct LocalOwner {               // key t lies on a page this shard owns
  const int* table;
  int base, L, page;
  __device__ __forceinline__ bool operator()(int t) const {
    const int lp = table[t / page] - base;
    return lp >= 0 && lp < L;
  }
};

template <int HD, int G, int NW, class KV>
__global__ void __launch_bounds__(NW * 32)
paged_partial_kernel(const bf16* __restrict__ q, KV kv,
                     const int* __restrict__ table,
                     const int* __restrict__ pos, float* __restrict__ acc,
                     float* __restrict__ m, float* __restrict__ l, int Hkv,
                     int P, int page, int base, int L, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * Hkv + h;
  const int* tb = table + (size_t)b * P;
  repro::Rows<KV, LocalPagedMap> rows{kv, {tb, base, L, page, Hkv, h}};
  const int n = min(pos[b], P * page - 1) + 1;
  repro::decode_fold<HD, G, NW>(
      q + bh * G * HD, rows, n, LocalOwner{tb, base, L, page}, scale,
      repro::PartialOut{acc + bh * G * HD, m + bh * G, l + bh * G});
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
#define LAUNCH(HD_, G_)                                                  \
  paged_decode_kernel<HD_, G_, NW>                                       \
      <<<grid, NW * 32, 0, (cudaStream_t)stream>>>(                      \
          (const bf16*)q,                                                \
          repro::Bf16KV<HD_>{(const bf16*)kp, (const bf16*)vp},          \
          (const int*)table, (const int*)pos, (bf16*)out, Hkv, P, page,  \
          scale)
  REPRO_DECODE_DISPATCH(hd, G, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// As paged_decode_attention_bf16 over an int8 pool: k/v codes (NP, Hkv,
// page, hd) int8 and their scales ks/vs (NP, Hkv, page) f32.
extern "C" int paged_decode_attention_int8(const void* q, const void* kp,
                                           const void* vp, const void* ks,
                                           const void* vs, const void* table,
                                           const void* pos, void* out, int B,
                                           int Hkv, int G, int P, int page,
                                           int hd, float scale,
                                           void* stream) {
  constexpr int NW = 8;
  const dim3 grid(Hkv, B);
#define LAUNCH(HD_, G_)                                                  \
  paged_decode_kernel<HD_, G_, NW>                                       \
      <<<grid, NW * 32, 0, (cudaStream_t)stream>>>(                      \
          (const bf16*)q,                                                \
          repro::Int8KV<HD_>{(const int8_t*)kp, (const int8_t*)vp,       \
                             (const float*)ks, (const float*)vs},        \
          (const int*)table, (const int*)pos, (bf16*)out, Hkv, P, page,  \
          scale)
  REPRO_DECODE_DISPATCH(hd, G, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// q (B, Hkv, K*G, hd) bf16 (row r = block query r / G, head r % G), k/v
// pools (NP, Hkv, page, hd) bf16 as they stood BEFORE the block, kb/vb
// (B, Hkv, K, hd) bf16 block keys/values, table (B, P) int32, pos (B,)
// int32 base positions, tree (B, K) int32 ancestor bitmasks or NULL
// (causal), out like q; all contiguous.  Returns a cudaError_t.
extern "C" int paged_verify_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* kb,
    const void* vb, const void* table, const void* pos, const void* tree,
    void* out, int B, int Hkv, int G, int K, int P, int page, int hd,
    float scale, void* stream) {
  const dim3 grid((K * G + repro::VQ - 1) / repro::VQ, Hkv, B);
#define LAUNCH(HD_)                                                      \
  paged_verify_kernel<HD_>                                               \
      <<<grid, repro::VTHREADS, 0, (cudaStream_t)stream>>>(              \
          (const bf16*)q,                                                \
          repro::Bf16KV<HD_>{(const bf16*)kp, (const bf16*)vp},          \
          (const bf16*)kb, (const bf16*)vb, (const int*)table,           \
          (const int*)pos, (const int*)tree, (bf16*)out, Hkv, G, K, P,   \
          page, scale)
  REPRO_VERIFY_DISPATCH(hd, G, K, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// As paged_verify_attention_bf16 over an int8 pool (codes kp/vp int8,
// scales ks/vs (NP, Hkv, page) f32); the block's kb/vb stay bf16.
extern "C" int paged_verify_attention_int8(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* kb, const void* vb, const void* table,
    const void* pos, const void* tree, void* out, int B, int Hkv, int G,
    int K, int P, int page, int hd, float scale, void* stream) {
  const dim3 grid((K * G + repro::VQ - 1) / repro::VQ, Hkv, B);
#define LAUNCH(HD_)                                                      \
  paged_verify_kernel<HD_>                                               \
      <<<grid, repro::VTHREADS, 0, (cudaStream_t)stream>>>(              \
          (const bf16*)q,                                                \
          repro::Int8KV<HD_>{(const int8_t*)kp, (const int8_t*)vp,       \
                             (const float*)ks, (const float*)vs},        \
          (const bf16*)kb, (const bf16*)vb, (const int*)table,           \
          (const int*)pos, (const int*)tree, (bf16*)out, Hkv, G, K, P,   \
          page, scale)
  REPRO_VERIFY_DISPATCH(hd, G, K, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// One shard's decode partial: q (B, Hkv, G, hd) bf16, k/v the shard's
// LOCAL slice (L, Hkv, page, hd) bf16, table (B, P) int32 GLOBAL page ids,
// pos (B,) int32, base the shard's first global page id; acc (B, Hkv, G,
// hd), m and l (B, Hkv, G) f32 out; all contiguous.  Returns a cudaError_t.
extern "C" int paged_decode_partial_bf16(const void* q, const void* kp,
                                         const void* vp, const void* table,
                                         const void* pos, void* acc, void* m,
                                         void* l, int B, int Hkv, int G,
                                         int P, int page, int hd, int base,
                                         int L, float scale, void* stream) {
  constexpr int NW = 8;
  const dim3 grid(Hkv, B);
#define LAUNCH(HD_, G_)                                                  \
  paged_partial_kernel<HD_, G_, NW>                                      \
      <<<grid, NW * 32, 0, (cudaStream_t)stream>>>(                      \
          (const bf16*)q,                                                \
          repro::Bf16KV<HD_>{(const bf16*)kp, (const bf16*)vp},          \
          (const int*)table, (const int*)pos, (float*)acc, (float*)m,    \
          (float*)l, Hkv, P, page, base, L, scale)
  REPRO_DECODE_DISPATCH(hd, G, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// As paged_decode_partial_bf16 over an int8 slice: k/v codes (L, Hkv,
// page, hd) int8 and their scales ks/vs (L, Hkv, page) f32.
extern "C" int paged_decode_partial_int8(const void* q, const void* kp,
                                         const void* vp, const void* ks,
                                         const void* vs, const void* table,
                                         const void* pos, void* acc, void* m,
                                         void* l, int B, int Hkv, int G,
                                         int P, int page, int hd, int base,
                                         int L, float scale, void* stream) {
  constexpr int NW = 8;
  const dim3 grid(Hkv, B);
#define LAUNCH(HD_, G_)                                                  \
  paged_partial_kernel<HD_, G_, NW>                                      \
      <<<grid, NW * 32, 0, (cudaStream_t)stream>>>(                      \
          (const bf16*)q,                                                \
          repro::Int8KV<HD_>{(const int8_t*)kp, (const int8_t*)vp,       \
                             (const float*)ks, (const float*)vs},        \
          (const int*)table, (const int*)pos, (float*)acc, (float*)m,    \
          (float*)l, Hkv, P, page, base, L, scale)
  REPRO_DECODE_DISPATCH(hd, G, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
