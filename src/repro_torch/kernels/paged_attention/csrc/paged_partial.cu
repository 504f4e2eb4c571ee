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
// What the design does: the tensor-core decode body of decode_tc.cuh in
// its partial mode, the same body, runs and arithmetic as the global
// paged decode (paged_attention.cu): a row's keys split by key index over
// a cluster of up to 8 blocks, 64-key tiles through a cp.async ring,
// Q K^T and P V as mma.sync.  The table holds GLOBAL page ids; a key on a
// page the shard does not own (0 <= id - base < L fails), or past pos, is
// zero-filled and scored -inf, so it is never read.  The cluster's merged
// state leaves unnormalized in f32, acc (G, hd), m, l (G), for the
// caller's cross-shard pmax/psum merge; a row that owns no valid key ends
// at exactly (0, -1e30, 0).  A row whose pages all lie on one shard thus
// comes out of that merge as the global decode's output, bit for bit.
// Instantiated for head widths 32/64/128/256, any group up to 16 (the
// wrapper pads other widths with zeros and slices wider groups).
#include "decode_tc.cuh"

namespace {

int partial(const void* q, const void* table, const void* pos, void* acc,
            void* m, void* l, int B, int Hkv, int G, int P, int page, int hd,
            int base, int L, int splits, float scale, repro::dtc::Args a,
            bool quant, void* stream) {
  if (P < 1 || page < 1) return (int)cudaErrorInvalidValue;
  a.q = (const repro::bf16*)q;
  a.table = (const int*)table;
  a.pos = (const int*)pos;
  a.Hkv = Hkv;
  a.G = G;
  a.P = P;
  a.page = page;
  a.cap = P * page;
  a.base = base;
  a.L = L;
  a.acc = (float*)acc;
  a.m = (float*)m;
  a.l = (float*)l;
  return quant ? repro::dtc::dispatch<true, true>(hd, a, B, splits, scale,
                                                  (cudaStream_t)stream)
               : repro::dtc::dispatch<false, true>(hd, a, B, splits, scale,
                                                   (cudaStream_t)stream);
}

}  // namespace

// One shard's decode partial: q (B, Hkv, G, hd) bf16, k/v the shard's
// LOCAL slice (L, Hkv, page, hd) bf16, table (B, P) int32 GLOBAL page ids,
// pos (B,) int32, base the shard's first global page id; acc (B, Hkv, G,
// hd), m and l (B, Hkv, G) f32 out; all contiguous.  `splits` (1, 2, 4 or
// 8) is the blocks a row's keys are split over (kernels.decode_splits of
// the table's P * page keys, as the global decode).  Returns a
// cudaError_t.
extern "C" int paged_decode_partial_bf16(const void* q, const void* kp,
                                         const void* vp, const void* table,
                                         const void* pos, void* acc, void* m,
                                         void* l, int B, int Hkv, int G,
                                         int P, int page, int hd, int base,
                                         int L, int splits, float scale,
                                         void* stream) {
  repro::dtc::Args a{};
  a.k = kp;
  a.v = vp;
  return partial(q, table, pos, acc, m, l, B, Hkv, G, P, page, hd, base, L,
                 splits, scale, a, false, stream);
}

// As paged_decode_partial_bf16 over an int8 slice: k/v codes (L, Hkv,
// page, hd) int8 and their scales ks/vs (L, Hkv, page) f32.
extern "C" int paged_decode_partial_int8(const void* q, const void* kp,
                                         const void* vp, const void* ks,
                                         const void* vs, const void* table,
                                         const void* pos, void* acc, void* m,
                                         void* l, int B, int Hkv, int G,
                                         int P, int page, int hd, int base,
                                         int L, int splits, float scale,
                                         void* stream) {
  repro::dtc::Args a{};
  a.k = kp;
  a.v = vp;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  return partial(q, table, pos, acc, m, l, B, Hkv, G, P, page, hd, base, L,
                 splits, scale, a, true, stream);
}
