// Causal (optionally sliding-window) prefill attention, for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention/kernel.py ::
//   flash_attention_kernel (body _flash_kernel).
//
// What bounds it on an H100: at serving prompt lengths (S <= 2k, hd 64)
// it is bound by bytes on paper (Q, K, V, O are read/written once: ~8 * S
// * hd bytes per head against ~2 * S^2 * hd causal flops, i.e. S/4 flops
// per byte), but this first version runs its products on the CUDA cores
// in f32, so in practice it is bound by operations at the f32 FMA rate,
// far below the 989 TFLOP/s bf16 tensor-core peak.
//
// What the design does: one block per (q tile of 64 rows, head, row); the
// kv scan that the TPU grid carried across its "arbitrary" axis in VMEM
// scratch is a loop inside the block with (m, l, acc) in registers, so
// the S x S scores never reach HBM.  Each K/V tile is staged once in
// shared memory (f32, rows padded by one word against bank conflicts) and
// shared by the block's 64 query rows; two threads own a query row (keys
// and head dims split between them, partner values through one shuffle).
// GQA reads kv head h / G, with no head repeat.  Tiles wholly above the
// causal diagonal or behind the window are skipped; the ragged edge past
// S is masked here, so the caller needs no padding.
// Not yet done: wgmma/mma tensor-core products and TMA staging.
#include "attn_common.cuh"

namespace {

using repro::bf16;
using repro::NEG_INF;
using repro::FULL;

constexpr int BQ = 64;          // query rows per block
constexpr int THREADS = 128;    // 2 threads per query row

template <int HD, int BK>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int H,
             int Hkv, int S, int causal, int window, float scale) {
  constexpr int KPT = BK / 2;   // keys of a tile per thread
  constexpr int DH = HD / 2;    // head dims per thread in the PV update
  __shared__ float k_s[BK][HD + 1];
  __shared__ float v_s[BK][HD + 1];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int q_start = qt * BQ;
  const int qrow = q_start + r;
  const bf16* kb = k + ((size_t)b * Hkv + hk) * S * HD;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * S * HD;

  float qr[HD];
  if (qrow < S) {
    repro::load_row<HD>(q + (((size_t)b * H + h) * S + qrow) * HD, qr);
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] *= scale;
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f, acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  const int q_last = min(q_start + BQ, S) - 1;
  const int nk = (S + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k_start = j * BK;
    if (causal && k_start > q_last) break;                  // above diagonal
    if (window > 0 && k_start + BK - 1 <= q_start - window) continue;

    // stage the K and V tiles (8 bf16 per vector load; rows past S -> 0)
    for (int i = threadIdx.x; i < BK * HD / 8; i += THREADS) {
      const int row = i / (HD / 8), c = (i % (HD / 8)) * 8;
      float kf[8], vf[8];
      if (k_start + row < S) {
        repro::load_row<8>(kb + (size_t)(k_start + row) * HD + c, kf);
        repro::load_row<8>(vb + (size_t)(k_start + row) * HD + c, vf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        k_s[row][c + e] = kf[e];
        v_s[row][c + e] = vf[e];
      }
    }
    __syncthreads();

    // scores of this thread's keys kk = 2i + half
    float p[KPT];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kk = 2 * i + half;
      const int col = k_start + kk;
      bool valid = col < S;
      if (causal) valid = valid && col <= qrow;
      if (window > 0) valid = valid && (qrow - col) < window;
      float s = NEG_INF;
      if (valid) {
        s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s += qr[d] * k_s[kk][d];
      }
      p[i] = valid ? s : -INFINITY;   // -inf marks masked for the exp below
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      p[i] = (p[i] == -INFINITY) ? 0.f : expf(p[i] - m_new);
      psum += p[i];
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;

    // acc[d] += sum over the tile's keys of p * v, for dims half*DH + d
    const int dbase = half * DH;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float mine = p[i];
      const float other = __shfl_xor_sync(FULL, mine, 1);
      const float* va = v_s[2 * i + half] + dbase;
      const float* vo = v_s[2 * i + 1 - half] + dbase;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] += mine * va[d] + other * vo[d];
    }
    __syncthreads();
  }

  if (qrow < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* o = out + (((size_t)b * H + h) * S + qrow) * HD + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = __float2bfloat16(acc[d] * inv);
  }
}

}  // namespace

// q (B, H, S, hd), k/v (B, Hkv, S, hd), out (B, H, S, hd), all bf16 and
// contiguous.  Returns a cudaError_t.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int Hkv, int S, int hd, int causal,
                                    int window, float scale, void* stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
#define LAUNCH(HD_, BK_)                                                 \
  flash_kernel<HD_, BK_><<<grid, THREADS, 0, (cudaStream_t)stream>>>(   \
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, H, Hkv, \
      S, causal, window, scale)
  if (hd == 32) LAUNCH(32, 64);
  else if (hd == 64) LAUNCH(64, 64);
  else if (hd == 128) LAUNCH(128, 32);
  else return (int)cudaErrorInvalidValue;
#undef LAUNCH
  return (int)cudaGetLastError();
}
