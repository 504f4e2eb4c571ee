// Paged attention through a page table, for Hopper (sm_90a): one-token
// decode and K-query verify (chunked prefill, speculative verify), each
// over a full-precision or an int8 page pool.  One shard's decode partial
// over its slice of a sharded bank is paged_partial.cu (a library of its
// own, so the two compile in parallel).
//
// Replaces: repro/kernels/paged_attention/kernel.py ::
//   paged_decode_attention_kernel (bodies _paged_decode_kernel and
//   _paged_decode_kernel_q) and paged_verify_attention_kernel (bodies
//   _paged_verify_kernel and _paged_verify_kernel_q, causal or tree).
//
// What bounds it on an H100: bytes for decode, as for the row-cache
// decode: each live key of a row is read once from the shared page pool,
// at about 2 * G flops per byte (int8 halves the bytes).  Verify reads the
// same keys once for K * G query rows, about K * G / 2 flops a byte (512
// at K = 128, G = 8); at tinyllama-1.1b's chunk (B 4, K 128, 740 cache
// keys in all) 0.0016 ms of bytes against 0.0011 of operations, so a
// launch is bound by latency: a few TMA round trips a block.
//
// What the design does about it: the TPU kernel's scalar-prefetched
// BlockSpec index map (pt[b, j]) becomes the block reading its own page
// ids: key t of row b lives at pool[table[b, t / page], h, t % page].
//   * decode: the tensor-core decode body of decode_tc.cuh, shared with
//     the row-cache decode: the G query heads of a kv head are the M rows
//     of mma.sync and share every K/V byte; a row's keys are split by key
//     index (never by page id) over a cluster of up to 8 blocks that merge
//     their flash states through distributed shared memory in the same
//     launch; every 16-byte chunk of a 64-key tile finds its page itself
//     and streams in by cp.async through a 3-4 stage ring, so any page
//     size works and no descriptor is encoded on the host.  An int8
//     pool's codes are copied as bytes and converted to bf16 in shared
//     memory; the k scales multiply score columns, the v scales the
//     probabilities.  Only keys 0..pos are loaded.  Instantiated for head
//     widths 32/64/128/256, any group up to 16.
//   * verify: the tensor-core verify body of verify_tc.cuh, shared with
//     the row-cache verify: one block per (128 score rows, kv head, row),
//     Q K^T and P V as wgmma, each cache tile read once for all its rows.
//     A bf16 pool's full tiles arrive by TMA page by page (the producer
//     reads table[b, t / page] and loads at (col, t % page, h, page id));
//     the last partial tile, and every tile of a page that is not a
//     multiple of 8 rows, the producer warpgroup copies itself.  An int8 pool's
//     codes are converted to bf16 in shared memory by a producer
//     warpgroup; the k scales multiply the scores and the v scales the
//     probabilities, never an operand.  The cache side is the pool BEFORE
//     the block's writes (keys < pos); the block's own K keys and values
//     (bf16, not yet written to the pool, even for an int8 pool) follow
//     under the causal or tree mask, in one softmax.
// In both, a page starting past the last read position -- and the
// park page 0 that dead table entries point at -- is never read.
#include "decode_tc.cuh"
#include "verify_tc.cuh"

namespace {

// the decode's launch: the pool side of `a` set by the caller
int paged_decode(const void* q, const int* table, const void* pos,
                 void* out, int B, int Hkv, int G, int P, int page, int hd,
                 int splits, float scale, repro::dtc::Args a, bool quant,
                 void* stream) {
  if (P < 1 || page < 1) return (int)cudaErrorInvalidValue;
  a.q = (const repro::bf16*)q;
  a.table = table;
  a.pos = (const int*)pos;
  a.out = (repro::bf16*)out;
  a.Hkv = Hkv;
  a.G = G;
  a.P = P;
  a.page = page;
  a.cap = P * page;
  return quant ? repro::dtc::dispatch<true>(hd, a, B, splits, scale,
                                            (cudaStream_t)stream)
               : repro::dtc::dispatch<false>(hd, a, B, splits, scale,
                                             (cudaStream_t)stream);
}

}  // namespace

// q (B, Hkv, G, hd) bf16, k/v pools (NP, Hkv, page, hd) bf16, table (B, P)
// int32, pos (B,) int32, out (B, Hkv, G, hd) bf16; all contiguous.
// `splits` (1, 2, 4 or 8) is the blocks a row's keys are split over
// (kernels.decode_splits).  Returns a cudaError_t.
extern "C" int paged_decode_attention_bf16(const void* q, const void* kp,
                                           const void* vp, const void* table,
                                           const void* pos, void* out, int B,
                                           int Hkv, int G, int P, int page,
                                           int hd, int splits, float scale,
                                           void* stream) {
  repro::dtc::Args a{};
  a.k = kp;
  a.v = vp;
  return paged_decode(q, (const int*)table, pos, out, B, Hkv, G, P, page, hd,
                      splits, scale, a, false, stream);
}

// As paged_decode_attention_bf16 over an int8 pool: k/v codes (NP, Hkv,
// page, hd) int8 and their scales ks/vs (NP, Hkv, page) f32.
extern "C" int paged_decode_attention_int8(const void* q, const void* kp,
                                           const void* vp, const void* ks,
                                           const void* vs, const void* table,
                                           const void* pos, void* out, int B,
                                           int Hkv, int G, int P, int page,
                                           int hd, int splits, float scale,
                                           void* stream) {
  repro::dtc::Args a{};
  a.k = kp;
  a.v = vp;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  return paged_decode(q, (const int*)table, pos, out, B, Hkv, G, P, page, hd,
                      splits, scale, a, true, stream);
}

// q (B, K, H, hd) bf16, H = Hkv * G; k/v pools (NP, Hkv, page, hd) bf16
// as they stood BEFORE the block; kb/vb (B, K, Hkv, hd) bf16 block
// keys/values; table (B, P) int32; pos (B,) int32 base positions; tree
// (B, K) int32 ancestor bitmasks or NULL (causal); out (B, K, H, hd) bf16;
// all contiguous, 16-byte aligned.  hd one of 32, 64, 128, 256.  Returns a
// cudaError_t.
extern "C" int paged_verify_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* kb,
    const void* vb, const void* table, const void* pos, const void* tree,
    void* out, int B, int Hkv, int G, int K, int P, int page, int NP,
    int hd, float scale, void* stream) {
  if (P < 1 || NP < 1) return (int)cudaErrorInvalidValue;
  repro::vtc::Args a{};
  a.k = kp;
  a.v = vp;
  a.table = (const int*)table;
  a.pos = (const int*)pos;
  a.anc = (const int*)tree;
  a.out = (repro::bf16*)out;
  a.Hkv = Hkv;
  a.G = G;
  a.K = K;
  a.P = P;
  a.page = page;
  a.cap = P * page;
  return repro::vtc::dispatch<false, false>(hd, q, kb, vb, B, NP, scale, a,
                                            (cudaStream_t)stream);
}

// As paged_verify_attention_bf16 over an int8 pool (codes kp/vp int8,
// scales ks/vs (NP, Hkv, page) f32); the block's kb/vb stay bf16.
extern "C" int paged_verify_attention_int8(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* kb, const void* vb, const void* table,
    const void* pos, const void* tree, void* out, int B, int Hkv, int G,
    int K, int P, int page, int NP, int hd, float scale, void* stream) {
  if (P < 1 || NP < 1) return (int)cudaErrorInvalidValue;
  repro::vtc::Args a{};
  a.k = kp;
  a.v = vp;
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  a.table = (const int*)table;
  a.pos = (const int*)pos;
  a.anc = (const int*)tree;
  a.out = (repro::bf16*)out;
  a.Hkv = Hkv;
  a.G = G;
  a.K = K;
  a.P = P;
  a.page = page;
  a.cap = P * page;
  return repro::vtc::dispatch<true, false>(hd, q, kb, vb, B, NP, scale, a,
                                           (cudaStream_t)stream);
}
