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
// ~295 flop/byte ridge of the card, so HBM bandwidth is the limit.
//
// What the design does about it: one block per (row, kv head) with the G
// query heads of that kv head batched together, so every K/V byte is
// loaded from HBM once and reused G times from registers; keys past the
// row's position are never loaded (the per-row skip of the TPU kernel's
// `k_start <= pos` tile gate, at key granularity); the running softmax
// state (m, l, acc) lives in registers for the whole scan -- the loop
// inside the block replaces the TPU grid's sequential "arbitrary" axis.
// Instantiated for head widths 32/64/128/256 and groups 1/2/4/8/16 (the
// wrapper pads any other width or group with zeros); a wide group keeps
// fewer warps a block (decode_warps), so its combine fits in shared memory.
// Not yet done: splitting one row's keys over several blocks, so a small
// batch (B * Hkv blocks) fills only part of the 132 SMs.
#include "attn_common.cuh"

namespace {

using repro::bf16;

template <int HD, int G, int NW>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ pos,
              bf16* __restrict__ out, int Hkv, int S, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = (size_t)b * Hkv + h;
  // key t of this (row, kv head) is row bh*S + t of the cache
  repro::Rows<repro::Bf16KV<HD>, repro::ContigMap> rows{{k, v}, {bh * S}};
  const int n = min(pos[b], S - 1) + 1;     // keys 0..pos are valid
  repro::decode_block<HD, G, NW>(q + bh * G * HD, rows, n, scale,
                                 out + bh * G * HD);
}

}  // namespace

// q (B, Hkv, G, hd), k/v (B, Hkv, S, hd) bf16, pos (B,) int32,
// out (B, Hkv, G, hd) bf16; all contiguous.  Returns a cudaError_t.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* pos,
                                     void* out, int B, int Hkv, int G,
                                     int S, int hd, float scale,
                                     void* stream) {
  const dim3 grid(Hkv, B);
#define LAUNCH(HD_, G_)                                                    \
  decode_kernel<HD_, G_, repro::decode_warps<HD_, G_>()>                   \
      <<<grid, repro::decode_warps<HD_, G_>() * 32, 0,                     \
         (cudaStream_t)stream>>>(                                          \
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)pos,    \
      (bf16*)out, Hkv, S, scale)
  REPRO_DECODE_DISPATCH(hd, G, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}
