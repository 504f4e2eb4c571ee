// K-query verify attention over a row KV cache, for Hopper (sm_90a), on
// the tensor cores: chunked prefill on the row cache (and speculative
// verify).
//
// Replaces: repro/kernels/verify_attention/kernel.py ::
//   verify_attention_kernel (body _verify_kernel): causal or tree mask,
//   and the sliding-window ring (ring=True, causal only).
//
// What bounds it on an H100: each row's cache keys 0..pos-1 and the K
// block keys are read once for K * G query rows, about K * G / 2 flops a
// byte (512 at K = 128, G = 8).  At tinyllama-1.1b's chunk (B 4, K 128,
// 740 cache keys in all) that is 0.0016 ms of bytes against 0.0011 of
// operations: a few microseconds, so what bounds a launch is latency (one
// TMA round trip per tile, a handful of tiles per block).  A 4096-slot
// ring at mixtral-8x7b's heads does about 21.7 GFLOP of products, 0.0219 ms
// at the bf16 tensor-core rate: bound by operations.
//
// What the design does: the tensor-core verify body of verify_tc.cuh
// (shared with the paged verify, which differs only in where a cache tile
// comes from), one block per (128 score rows, kv head, batch row): Q K^T
// and P V as wgmma, K and V tiles streamed by TMA through an mbarrier
// ring by a producer warpgroup, each cache tile read once for all the rows of
// the tile (G heads of up to 128 / G queries).  The row cache is read
// through a 4-D TMA view, a full tile in one load; the last partial tile
// is copied by the producer warpgroup, so slots at or past pos are never read.
// A ring cache (a template flag) reads its min(pos, S) written slots,
// masks each by the position it holds against the query's window, and
// splits P into two bf16 parts for its one-ulp records.
#include "verify_tc.cuh"

// q (B, K, H, hd) bf16, H = Hkv * G; k/v (B, Hkv, S, hd) bf16 cache as it
// stood BEFORE the block; kb/vb (B, K, Hkv, hd) bf16 block keys/values;
// pos (B,) int32 base positions; tree (B, K) int32 ancestor bitmasks or
// NULL (causal); out (B, K, H, hd) bf16; all contiguous, 16-byte aligned.
// hd one of 32, 64, 128, 256.  ring != 0: the cache is a sliding-window
// ring of S slots (causal only, K <= S).  Returns a cudaError_t.
extern "C" int verify_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* kb,
                                     const void* vb, const void* pos,
                                     const void* tree, void* out, int B,
                                     int Hkv, int G, int K, int S, int hd,
                                     int ring, float scale, void* stream) {
  if (S < 1 || (ring && (tree != nullptr || K > S)))
    return (int)cudaErrorInvalidValue;
  repro::vtc::Args a{};
  a.k = k;
  a.v = v;
  a.pos = (const int*)pos;
  a.anc = (const int*)tree;
  a.out = (repro::bf16*)out;
  a.Hkv = Hkv;
  a.G = G;
  a.K = K;
  a.P = 1;
  a.page = S;
  a.cap = S;
  cudaStream_t s = (cudaStream_t)stream;
  if (ring)
    return repro::vtc::dispatch<false, true>(hd, q, kb, vb, B, B, scale, a,
                                             s);
  return repro::vtc::dispatch<false, false>(hd, q, kb, vb, B, B, scale, a,
                                            s);
}
