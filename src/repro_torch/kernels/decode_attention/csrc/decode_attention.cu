// One-token flash-decode over a row KV cache, for Hopper (sm_90a).
//
// Replaces: repro/kernels/decode_attention/kernel.py ::
//   decode_attention_kernel (body _decode_kernel), ring=False and
//   ring=True.  The JAX ring mask (idx <= pos % S) | (pos >= S) selects
//   slots 0 .. min(pos, S-1), the same slots this body reads for a full
//   cache, so one body serves both (the wrapper counts them apart).
//
// What bounds it on an H100: bytes.  A decode step reads each row's cache
// up to its position once (2 * (pos+1) * hd bf16 per kv head) and does
// 4 * G * hd flops per key -- about 2 * G flops per byte, far below the
// ~295 flop/byte ridge of the card, so HBM bandwidth is the limit; at a
// few hundred keys a row, the launch's latency.
//
// What the design does about it: the tensor-core decode body of
// decode_tc.cuh, shared with the paged decode.  The G query heads of a kv
// head share every K/V byte (the M rows of mma.sync); a row's keys are
// split by key index over a cluster of up to 8 blocks (grid (splits, Hkv,
// B), as many as the cache length gives each two tiles or more), so a
// small batch still fills the SMs, and the blocks merge their
// flash states through distributed shared memory in the same launch; K/V
// tiles of 64 keys stream through a 3-4 stage cp.async ring; keys past
// the row's position are never loaded (the per-row skip of the TPU
// kernel's `k_start <= pos` tile gate, at key granularity).  The row
// cache is read as a store whose page b holds row b's S slots, so the
// paged decode over the same keys gives this output bit for bit.
// Instantiated for head widths 32/64/128/256, any group up to 16 (the
// wrapper pads other widths with zeros and slices wider groups).
#include "decode_tc.cuh"

// q (B, Hkv, G, hd), k/v (B, Hkv, S, hd) bf16, pos (B,) int32,
// out (B, Hkv, G, hd) bf16; all contiguous.  `splits` (1, 2, 4 or 8) is
// the blocks a row's keys are split over (kernels.decode_splits).
// Returns a cudaError_t.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* pos,
                                     void* out, int B, int Hkv, int G,
                                     int S, int hd, int splits, float scale,
                                     void* stream) {
  repro::dtc::Args a{};
  a.q = (const repro::bf16*)q;
  a.k = k;
  a.v = v;
  a.pos = (const int*)pos;
  a.out = (repro::bf16*)out;
  a.Hkv = Hkv;
  a.G = G;
  a.P = 1;
  a.page = S;
  a.cap = S;
  return repro::dtc::dispatch<false>(hd, a, B, splits, scale,
                                     (cudaStream_t)stream);
}
