// One shard's unnormalized decode partial over its LOCAL slice of a
// sharded page bank, for Hopper (sm_90a), over a full-precision or an
// int8 page pool.
//
// Replaces: repro/kernels/paged_attention/kernel.py ::
//   paged_decode_partial_kernel (bodies _paged_decode_partial_kernel and
//   _paged_decode_partial_kernel_q).
//
// What bounds it on an H100: bytes, as for paged decode: each owned live
// key of a row is read once by its owning shard, at about 2 * G flops per
// byte (int8 halves the bytes).
//
// What the design does: the decode fold of attn_common.cuh over one
// shard's slice of L pages, one block per (row, kv head).  The table holds
// GLOBAL page ids; the block reads page table[b, j] - base only when the
// shard owns it (0 <= id - base < L) and stops at pos like decode, so a
// page the shard does not own, or one starting past pos, is never read (a
// whole 32-key tile of it is skipped).  It writes the unnormalized state
// acc (G, hd), m, l (G) in f32 for the caller's cross-shard pmax/psum
// merge; a row that owns no valid page ends at exactly (0, -1e30, 0).
// Instantiated for head widths 32/64/128/256 and groups 1/2/4/8/16 (the
// wrapper pads any other width or group with zeros).
#include "attn_common.cuh"

namespace {

using repro::bf16;

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
  const dim3 grid(Hkv, B);
#define LAUNCH(HD_, G_)                                                  \
  paged_partial_kernel<HD_, G_, repro::decode_warps<HD_, G_>()>         \
      <<<grid, repro::decode_warps<HD_, G_>() * 32, 0,                   \
         (cudaStream_t)stream>>>(                                        \
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
  const dim3 grid(Hkv, B);
#define LAUNCH(HD_, G_)                                                  \
  paged_partial_kernel<HD_, G_, repro::decode_warps<HD_, G_>()>         \
      <<<grid, repro::decode_warps<HD_, G_>() * 32, 0,                   \
         (cudaStream_t)stream>>>(                                        \
          (const bf16*)q,                                                \
          repro::Int8KV<HD_>{(const int8_t*)kp, (const int8_t*)vp,       \
                             (const float*)ks, (const float*)vs},        \
          (const int*)table, (const int*)pos, (float*)acc, (float*)m,    \
          (float*)l, Hkv, P, page, base, L, scale)
  REPRO_DECODE_DISPATCH(hd, G, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
