// Causal (optionally sliding-window) prefill attention for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces: repro/kernels/flash_attention/kernel.py ::
//   flash_attention_kernel (body _flash_kernel).
//
// What bounds it on an H100: Q, K, V and O cross device memory once (about
// 8 S hd bytes a head) against 4 S^2 hd / 2 causal flops, S / 4 flops a
// byte: at serving prompt lengths (S of a few hundred to a few thousand)
// it is bound by bytes below S of about 1200 and by the bf16 tensor-core
// rate above it.  Either way the products must run on the tensor cores
// and the loads must overlap them.
//
// What the design does: one block per (128 query rows, q head, batch row):
// two consumer warpgroups of 64 rows each and a producer warp.  The
// producer loads the block's Q tile once, then streams the K and V tiles
// through a ring of shared-memory stages by TMA (4-D descriptors over the
// caller's strided (B, H, S, hd) views, so no copy is made; rows past S
// arrive as zeros), each stage completing on an mbarrier and released by
// the consumers when both products have read it.  Each consumer computes
// S = Q K^T with wgmma (both operands in shared memory, K-major), keeps
// the online softmax (m, l) of its two rows a thread in registers, rounds
// P to bf16 in registers in the layout of wgmma's A operand and adds
// P V with wgmma (V MN-major in shared memory, the transpose bit).  The
// kv scan that the TPU grid carried across its "arbitrary" axis in VMEM
// scratch is the loop inside the block.  GQA reads kv head h / G (any G).
// Tiles wholly above the diagonal or behind the window are neither loaded
// nor multiplied (per block), and a warpgroup skips the products of a
// tile that is wholly masked for its 64 rows.  Within a warpgroup the
// products of the next tile's scores are started before this tile's P V,
// so the softmax of one tile runs while the tensor cores work on the
// other.  Instantiated head widths: 32 (64-byte swizzle), 64, 128 and 256
// (128-byte swizzle, 64 columns an atom); the wrapper pads any other
// width to the next one.  Key tiles are 128 wide (64 at hd 256).  The
// compiler holds each thread of a wgmma kernel to 168 registers (with
// setmaxnreg or without), so at hd 128 the 128-key tile spills about 200
// bytes and its products run serialized; on the card it still beat
// 64-key tiles at mixtral's 4160-token prefill (0.331 against 0.382 ms
// of kernel time).
//
// For training, the kernel also writes each row's log-sum-exp L (natural
// log, f32, (B, H, S)) through an optional pointer: the backward
// (flash_attention_bwd.cu) recomputes P from it.  Chosen over a pass in
// the backward that recomputes L: the consumer holds each row's running
// max and sum in registers at its end, so L costs one store a row, where
// a recompute would read Q and K once more.  Serving passes null, and
// its launches do the same work as before.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;          // query rows of a block
constexpr int CONSUMERS = 256;   // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;       // keys of a tile
  static constexpr int STAGES = HD <= 64 ? 3 : 2;
  static constexpr int ATOM = HD == 32 ? 32 : 64;       // columns of an atom
  static constexpr int ROWB = 2 * ATOM;                 // bytes of an atom row
  static constexpr int ATOMS = HD / ATOM;
  static constexpr int SWZ = HD == 32 ? hopper::SW64 : hopper::SW128;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
             float* __restrict__ lse, long long osb, long long osh,
             long long oss, int H, int Hkv, int S, int causal, int window,
             float scale_log2) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[ST], v_full[ST], empty[ST];
  // tiles start on 1024-byte boundaries (the swizzle atoms' phase)
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* k_s = q_s + C::Q_BYTES;              // stage s: + s * KV_BYTES
  uint8_t* v_s = k_s + ST * C::KV_BYTES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest rows first
  const int hk = h / (H / Hkv);
  const int q_end = min(q0 + BQ, S);
  const int kt_end = causal ? (q_end + BK - 1) / BK : (S + BK - 1) / BK;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, warp-uniform as the compiler sees it (so the
  // roles' branches, and the products under them, are not divergent)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wg == CONSUMERS / 128) {
    // producer (one thread loads): Q once, then the K and V tiles
    // through the ring
    if (threadIdx.x == CONSUMERS) {
      hopper::mbar_expect_tx(&q_full, C::Q_BYTES);
      for (int a = 0; a < C::ATOMS; ++a)
        hopper::tma_load_4d(q_s + a * BQ * C::ROWB, &tq, &q_full, a * C::ATOM,
                            q0, h, b);
      for (int t = kt_begin, i = 0; t < kt_end; ++t, ++i) {
        const int s = i % ST;
        hopper::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        uint8_t* ks = k_s + s * C::KV_BYTES;
        uint8_t* vs = v_s + s * C::KV_BYTES;
        hopper::mbar_expect_tx(&k_full[s], C::KV_BYTES);
        for (int a = 0; a < C::ATOMS; ++a)
          hopper::tma_load_4d(ks + a * BK * C::ROWB, &tk, &k_full[s],
                              a * C::ATOM, t * BK, hk, b);
        hopper::mbar_expect_tx(&v_full[s], C::KV_BYTES);
        for (int a = 0; a < C::ATOMS; ++a)
          hopper::tma_load_4d(vs + a * BK * C::ROWB, &tv, &v_full[s],
                              a * C::ATOM, t * BK, hk, b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows r0 .. r0 + 63; this thread holds
    // rows row0 and row0 + 8 (the wgmma accumulator layout)
    const int r0 = q0 + 64 * wg;
    const int row0 = r0 + 16 * (warp % 4) + lane / 4;
    const int cq = 2 * (lane % 4);
    // the tiles this warpgroup's rows need: a contiguous part of the
    // block's [kt_begin, kt_end); the rest it releases unread
    int lo = kt_begin, hi = kt_end;
    if (r0 >= S) {
      lo = hi = kt_end;
    } else {
      if (causal) hi = min(hi, min(r0 + 63, S - 1) / BK + 1);
      if (window > 0) lo = max(lo, max(0, r0 - window + 1) / BK);
      lo = min(lo, hi);
    }
    float o[HD / 2], sc[BK / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
    // running max (scaled, log2 domain) and sum of each of the two rows
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pa[BK / 16][4];

    // S = Q K^T of tile t into sc, once its K tile has arrived
    // (asynchronous: committed, not waited)
    auto scores = [&](int t) {
      const int i = t - kt_begin;
      const uint8_t* ks = k_s + (i % ST) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a = kk * 16 / C::ATOM, off = (kk * 16 % C::ATOM) * 2;
        const uint64_t dq = hopper::make_desc(
            q_s + a * BQ * C::ROWB + wg * 64 * C::ROWB + off, 16, 8 * C::ROWB,
            C::SWZ);
        const uint64_t dk = hopper::make_desc(ks + a * BK * C::ROWB + off, 16,
                                              8 * C::ROWB, C::SWZ);
        hopper::wgmma_ss<BK, 0>(sc, dq, dk, kk > 0);
      }
      hopper::wgmma_commit();
    };
    // O += P V of tile t (asynchronous)
    auto pv = [&](int t) {
      const uint8_t* vs = v_s + ((t - kt_begin) % ST) * C::KV_BYTES;
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
        hopper::wgmma_rs<HD>(
            o, pa[c],
            hopper::make_desc(vs + c * 16 * C::ROWB, BK * C::ROWB,
                              8 * C::ROWB, C::SWZ));
      hopper::wgmma_commit();
    };
    auto wait_k = [&](int t) {
      const int i = t - kt_begin;
      hopper::mbar_wait(&k_full[i % ST], (i / ST) & 1);
    };
    auto wait_v = [&](int t) {
      const int i = t - kt_begin;
      hopper::mbar_wait(&v_full[i % ST], (i / ST) & 1);
    };
    auto free_tile = [&](int t) {
      hopper::mbar_arrive(&empty[(t - kt_begin) % ST]);
    };
    // online softmax of the scores in sc (tile t): scales them into the
    // log2 domain, masks, updates m and l, sets alpha (the factor of the
    // old sums) and leaves exp2 of the scores less the new max in sc
    auto softmax = [&](int t) {
      const int k0 = t * BK;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] *= scale_log2;
      if (k0 + BK > S || (causal && k0 + BK - 1 > r0) ||
          (window > 0 && k0 <= r0 + 63 - window)) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int col = k0 + (j / 4) * 8 + cq + (j & 1);
          const int row = row0 + 8 * ((j >> 1) & 1);
          if (col >= S || (causal && col > row) ||
              (window > 0 && row - col >= window))
            sc[j] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY}, base[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        base[r] = m_new == -INFINITY ? 0.f : m_new;   // a row masked so far
        alpha[r] = hopper::exp2_approx(m[r] - base[r]);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1;
        sc[j] = hopper::exp2_approx(sc[j] - base[r]);
        sum[r] += sc[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
    };
    // rescale O by alpha and round P to bf16 as wgmma's A fragments (the
    // 16 keys of step c: four bf16 pairs in the accumulator's order)
    auto to_p = [&]() {
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[c][e] = hopper::pack_bf16(sc[8 * c + 2 * e],
                                       sc[8 * c + 2 * e + 1]);
    };

    auto release = [&](int t) {            // wait for tile t, then free it
      wait_k(t);
      wait_v(t);
      free_tile(t);
    };
    for (int t = kt_begin; t < lo; ++t) release(t);
    hopper::mbar_wait(&q_full, 0);

    // Pipelined: while the tensor cores add P V of tile t, the softmax of
    // tile t + 1 (whose scores were started first) runs on the CUDA cores.
    // Every batch of products follows its barrier waits and a fence in
    // straight-line code, so the compiler keeps them asynchronous.
    if (lo < hi) {
      wait_k(lo);
      hopper::wgmma_fence();
      scores(lo);
      hopper::wgmma_wait<0>();
      softmax(lo);
      to_p();
    }
    for (int t = lo; t + 1 < hi; ++t) {
      wait_k(t + 1);
      wait_v(t);
      hopper::wgmma_fence();
      scores(t + 1);
      pv(t);
      hopper::wgmma_wait<1>();           // the scores of tile t + 1
      softmax(t + 1);
      hopper::wgmma_wait<0>();           // P V of tile t
      free_tile(t);
      to_p();
    }
    if (lo < hi) {
      wait_v(hi - 1);
      hopper::wgmma_fence();
      pv(hi - 1);
      hopper::wgmma_wait<0>();
      free_tile(hi - 1);
    }
    for (int t = hi; t < kt_end; ++t) release(t);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* ob = out + b * osb + h * osh;
#pragma unroll
    for (int j = 0; j < HD / 2; j += 2) {
      const int r = (j >> 1) & 1;
      const int row = row0 + 8 * r;
      if (row < S)
        *reinterpret_cast<uint32_t*>(ob + row * oss + (j / 4) * 8 + cq) =
            hopper::pack_bf16(o[j] * inv[r], o[j + 1] * inv[r]);
    }
    // L = ln 2 (m + log2 l): m is the row's max in the scaled log2 domain
    // and l its sum of 2^(s - m); the four lanes of a quad hold the same
    if (lse != nullptr && cq == 0) {
      float* lb = lse + ((long long)b * H + h) * S;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S)
          lb[row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f
                               : INFINITY;
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int Hkv, int S, int causal, int window,
           float scale, const long long* st, cudaStream_t stream) {
  using C = Cfg<HD>;
  const CUtensorMapSwizzle swz = HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap mq, mk, mv;
  const uint64_t dq[4] = {HD, (uint64_t)S, (uint64_t)H, (uint64_t)B};
  const uint64_t dkv[4] = {HD, (uint64_t)S, (uint64_t)Hkv, (uint64_t)B};
  // byte strides of (S, heads, B): st holds (sb, sh, ss) per operand
  const uint64_t sq[3] = {2ull * st[2], 2ull * st[1], 2ull * st[0]};
  const uint64_t sk[3] = {2ull * st[5], 2ull * st[4], 2ull * st[3]};
  const uint64_t sv[3] = {2ull * st[8], 2ull * st[7], 2ull * st[6]};
  const uint32_t bq[4] = {C::ATOM, BQ, 1, 1};
  const uint32_t bk[4] = {C::ATOM, C::BK, 1, 1};
  if (!hopper::encode_map(&mq, q, 4, dq, sq, bq, swz) ||
      !hopper::encode_map(&mk, k, 4, dkv, sk, bk, swz) ||
      !hopper::encode_map(&mv, v, 4, dkv, sv, bk, swz))
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc = hopper::allow_smem<flash_kernel<HD>>(C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  flash_kernel<HD><<<grid, THREADS, C::SMEM, stream>>>(
      mq, mk, mv, (bf16*)out, lse, st[9], st[10], st[11], H, Hkv, S, causal,
      window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, S, hd), k/v (B, Hkv, S, hd), out (B, H, S, hd): bf16 views
// whose last dimension is contiguous, 16-byte aligned, with the other
// strides (elements, multiples of 8) in `strides` as (sb, sh, ss) for q,
// k, v, out in turn.  hd one of 32, 64, 128, 256; H % Hkv == 0.  lse:
// null, or (B, H, S) f32 that takes each row's log-sum-exp.  Returns a
// cudaError_t.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int B, int H, int Hkv, int S, int hd,
                                    int causal, int window, float scale,
                                    const long long* strides, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, l, B, H, Hkv, S, causal, window,
                               scale, strides, s);
    case 64: return launch<64>(q, k, v, out, l, B, H, Hkv, S, causal, window,
                               scale, strides, s);
    case 128: return launch<128>(q, k, v, out, l, B, H, Hkv, S, causal,
                                 window, scale, strides, s);
    case 256: return launch<256>(q, k, v, out, l, B, H, Hkv, S, causal,
                                 window, scale, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
