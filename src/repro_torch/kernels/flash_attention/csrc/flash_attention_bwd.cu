// Backward of the causal (optionally sliding-window, GQA) prefill attention
// of flash_attention.cu, for Hopper (sm_90a), on the tensor cores.
//
// Replaces: no TPU kernel.  repro/kernels/flash_attention/kernel.py ::
//   flash_attention has no VJP (jax.grad through it raises); the JAX
//   package trains through XLA's gradient of its plain attention, and so
//   cannot train with its Pallas kernels on.  The port's trainer
//   differentiates B1 on the card, so B1 needs a backward: this kernel.
//
// Computes, from Q, K, V, O, dO and the forward's per-row log-sum-exp L
// (natural log of sum_j exp(scale q.k_j) over the row's unmasked keys):
//   P = exp(scale Q K^T - L) (masked), D = rowsum(dO * O),
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - D),
//   dQ = scale dS K, dK = scale dS^T Q.
// L comes from the forward, which writes it through an optional output
// pointer (null when serving, so serving's launches do not change): the
// forward holds each row's running max and sum in registers at its end,
// and one float a row costs it nothing, where a pass recomputing L here
// would read Q and K once more.
//
// Bound on an H100: the backward reads Q, K, V, O, dO (bf16) and L once
// and writes dQ, dK, dV, about 16 S hd bytes a head; it does about 2.5x
// the forward's 4 S^2 hd / 2 causal flops.  At the training shapes (S of
// a few hundred, hd 32-64) the two bounds are close: the products must
// run on the tensor cores and the loads overlap them.
//
// Deterministic: no atomics, so every output element is summed in one
// fixed order and a run repeats bit for bit (the trainer's resume must
// equal the uninterrupted run).  Two kernels, each owning its outputs,
// each shaped like the forward (a producer warp loading by TMA through
// mbarrier rings, 4-D descriptors over the caller's strided (B, H, S, hd)
// views, rows past S arriving as zeros; consumer warpgroups of 64 rows
// issuing wgmma):
//   dq_kernel   -- a block per (128 query rows, q head, batch row), two
//       consumer warpgroups.  Q and dO are loaded once, the K and V tiles
//       (64 keys) stream through the ring.  Each consumer first computes
//       D = rowsum(dO * O) of its rows from device memory (also written
//       for the second kernel), then a tile at a time: S = Q K^T and
//       dP = dO V^T (both operands K-major), P = exp2(S scale log2e -
//       L log2e) and dS = P (dP - D) in registers, dS rounded to bf16 in
//       the layout of wgmma's A operand (as the forward rounds P), and
//       dQ += dS K (K MN-major, the transpose bit, as V in the forward).
//   dkdv_kernel -- a block per (64 keys, kv head, batch row), one
//       consumer warpgroup.  K and V are loaded once; the producer warp
//       streams the (Q, dO) tile pairs, and their rows of L and D, of each
//       head of the group in order and, for each, each query tile that
//       sees the keys, in order.  S^T = K Q^T and dP^T = V dO^T; P^T and
//       dS^T in registers (L and D indexed by column, from shared memory),
//       each rounded to bf16; dV += P^T dO and dK += dS^T Q (dO and Q
//       MN-major).  The GQA sum over the group is the loop inside the
//       block, in head order.
// So P and dP are computed twice, seven products a tile pair against the
// five of a backward that adds dQ from the key-tile loop with atomics:
// the price of a fixed summation order without a second pass over
// partial sums.  Tiles wholly above the diagonal or behind the window are
// neither loaded nor multiplied (per block; a dq warpgroup releases
// unread the tiles wholly masked for its 64 rows), and only tiles that
// cross the diagonal, the window's edge or S mask element by element.
// Within a warpgroup the score products and the gradient products each
// run as one batch: the dq block's two warpgroups, and the two dkdv
// blocks an SM holds, overlap one's register work with the other's
// products.  The longest dq blocks run first; dkdv pairs its longest
// blocks with its shortest (dkdv_kernel's order).
//
// Choices measured on an H100 80GB HBM3 at 700 W, at tinyllama-1.1b's
// training batch (B 8, S 512, H 32, Hkv 4, hd 64) unless said:
//   - dK/dV blocks of 64 keys and one warpgroup, not 128 keys and two:
//     0.156 against 0.163 ms for the whole backward, and 0.057 against
//     0.100 ms at hd 128 (B 2, S 640, H 8, Hkv 2, window 256), where two
//     warpgroups' threads are held to 168 registers and spill; the
//     160-thread block is not held so (no spill at hd 128).
//   - No pipelining inside a warpgroup (the forward's overlap of one
//     tile's register work with the next tile's products): a pipelined
//     dq took 80 against 73 us, its separate bf16 fragments raising it
//     from 122 to 153 registers.
//   - The group is not split over blocks: the dkdv kernel takes 80 us of
//     the 155, and a split would need partial sums and a second pass to
//     keep one summation order.
//   - The paired dkdv order: 79-80 against 82-84 us with key tiles in
//     order.
//
// Registers: a dkdv consumer thread holds dK and dV (HD / 2 f32 each)
// and S^T and dP^T of its 64 keys against a query tile: 64 query rows at
// hd 32 and 64, 32 at hd 128 (dK and dV alone take 128).  At hd 256 dK
// and dV (256 f32 a thread) do not fit, and no arch of the registry
// trains at that width: hd 256 keeps the first version's body on the
// CUDA cores (f32 products, tiles staged in shared memory, the same tile
// order and the same no-atomics split), simt_* below.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG = 128;   // threads of a warpgroup

// (sb, sh, ss): element strides of batch, head and sequence
struct Strides {
  long long sb, sh, ss;
};

__device__ __forceinline__ float2 unpack(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(v);
}

// ------------------------------------------------------------ tensor cores

// A TMA-loaded (R rows x HD) bf16 tile in shared memory: HD / ATOM column
// atoms of R rows x ATOM, each row ROWB bytes, swizzled (hopper.cuh).
template <int HD>
struct Tile {
  static constexpr int ATOM = HD == 32 ? 32 : 64;   // columns of an atom
  static constexpr int ROWB = 2 * ATOM;             // bytes of an atom row
  static constexpr int ATOMS = HD / ATOM;
  static constexpr int SWZ = HD == 32 ? hopper::SW64 : hopper::SW128;

  // K-major operand (hd contracted): 64 rows from `row` of an R-row tile,
  // the 16 columns of step kk
  template <int R>
  static __device__ __forceinline__ uint64_t kmajor(const uint8_t* t, int row,
                                                    int kk) {
    const int a = kk * 16 / ATOM, off = (kk * 16 % ATOM) * 2;
    return hopper::make_desc(t + a * R * ROWB + row * ROWB + off, 16,
                             8 * ROWB, SWZ);
  }
  // MN-major operand (rows contracted): rows 16c .. 16c + 15 of an R-row
  // tile, every column
  template <int R>
  static __device__ __forceinline__ uint64_t mnmajor(const uint8_t* t,
                                                     int c) {
    return hopper::make_desc(t + c * 16 * ROWB, R * ROWB, 8 * ROWB, SWZ);
  }
  // rows r0 .. r0 + R - 1 of head h, batch row b, into an R-row tile, in
  // boxes of BOX rows (the map's)
  template <int R, int BOX>
  static __device__ __forceinline__ void load(uint8_t* t,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int r0, int h,
                                              int b) {
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int r = 0; r < R; r += BOX)
        hopper::tma_load_4d(t + a * R * ROWB + r * ROWB, map, bar, a * ATOM,
                            r0 + r, h, b);
  }
};

// the TMA maps' boxes: Q and dO by the dK/dV kernel's query tile, K and V
// by 64 keys; both kernels read the same four maps
template <int HD>
struct Box {
  static constexpr int QROWS = HD == 128 ? 32 : 64;
  static constexpr int KROWS = 64;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  // tiles start on 1024-byte boundaries (the swizzle atoms' phase)
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// An accumulator of N columns in wgmma's layout: register j of the thread
// with quad column cq (2 (lane % 4)) holds column acc_col(j) of row
// row0 + 8 acc_half(j).
__device__ __forceinline__ int acc_col(int j, int cq) {
  return (j / 4) * 8 + cq + (j & 1);
}
__device__ __forceinline__ int acc_half(int j) { return (j >> 1) & 1; }

// Rounds an N-column f32 accumulator to bf16 wgmma A fragments in place:
// the four bf16 pairs of step c (16 columns, the accumulator's order) land
// in x[8c .. 8c + 3].  In place because the products' asm reads and
// writes the score arrays ("+f"), which keeps them live across the loop:
// separate fragments would hold N / 4 more registers.
template <int N>
__device__ __forceinline__ void pack_frags(float (&x)[N / 2]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[8 * c + e] = __uint_as_float(
          hopper::pack_bf16(x[8 * c + 2 * e], x[8 * c + 2 * e + 1]));
}

// acc += (step c of the fragments packed in x) B, B MN-major at db
template <int HD, int N>
__device__ __forceinline__ void rs_packed(float (&acc)[HD / 2],
                                          const float (&x)[N / 2], int c,
                                          uint64_t db) {
  const uint32_t a[4] = {__float_as_uint(x[8 * c]),
                         __float_as_uint(x[8 * c + 1]),
                         __float_as_uint(x[8 * c + 2]),
                         __float_as_uint(x[8 * c + 3])};
  hopper::wgmma_rs<HD>(acc, a, db);
}

template <int HD>
struct DqCfg {
  static constexpr int BQ = 128;                // query rows of a block
  static constexpr int BK = 64;                 // keys of a tile
  static constexpr int CONSUMERS = 2 * WG;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int STAGES = HD <= 64 ? 3 : 2;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

template <int HD>
__global__ void __launch_bounds__(DqCfg<HD>::THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ dsum, bf16* __restrict__ dq, Strides so,
          Strides sdo, Strides sdq, int H, int Hkv, int S, int causal,
          int window, float scale_log2, float scale) {
  using C = DqCfg<HD>;
  using T = Tile<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, kv_full[ST], empty[ST];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* do_s = q_s + C::Q_BYTES;
  uint8_t* k_s = do_s + C::Q_BYTES;              // stage s: + s * KV_BYTES
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
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&empty[s], C::CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, warp-uniform as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wg == C::CONSUMERS / WG) {
    // producer (one thread loads): Q and dO once, then K and V by tile
    if (threadIdx.x == C::CONSUMERS) {
      hopper::mbar_expect_tx(&q_full, 2 * C::Q_BYTES);
      T::template load<BQ, Box<HD>::QROWS>(q_s, &tq, &q_full, q0, h, b);
      T::template load<BQ, Box<HD>::QROWS>(do_s, &tdo, &q_full, q0, h, b);
      for (int t = kt_begin, i = 0; t < kt_end; ++t, ++i) {
        const int s = i % ST;
        hopper::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        hopper::mbar_expect_tx(&kv_full[s], 2 * C::KV_BYTES);
        T::template load<BK, Box<HD>::KROWS>(k_s + s * C::KV_BYTES, &tk,
                                             &kv_full[s], t * BK, hk, b);
        T::template load<BK, Box<HD>::KROWS>(v_s + s * C::KV_BYTES, &tv,
                                             &kv_full[s], t * BK, hk, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r0 .. r0 + 63; this thread holds
  // rows row0 and row0 + 8 (the accumulator layout)
  const int r0 = q0 + 64 * wg;
  const int row0 = r0 + 16 * (warp % 4) + lane / 4;
  const int cq = 2 * (lane % 4);
  int lo = kt_begin, hi = kt_end;      // the tiles this warpgroup's rows see
  if (r0 >= S) {
    lo = hi = kt_end;
  } else {
    if (causal) hi = min(hi, min(r0 + 63, S - 1) / BK + 1);
    if (window > 0) lo = max(lo, max(0, r0 - window + 1) / BK);
    lo = min(lo, hi);
  }

  // D of the thread's two rows (the quad's four lanes each sum a quarter
  // of the row, then add across the quad) and L in the log2 domain
  const long long rb = ((long long)b * H + h) * S;
  float dd[2], l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float d = 0.f;
    if (row < S) {
      const int c0 = (lane % 4) * (HD / 4);
      const bf16* orow = o + b * so.sb + h * so.sh + row * so.ss + c0;
      const bf16* drow = dout + b * sdo.sb + h * sdo.sh + row * sdo.ss + c0;
#pragma unroll
      for (int c = 0; c < HD / 4; c += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 a = unpack(xs[w]), e = unpack(ys[w]);
          d = fmaf(a.y, e.y, fmaf(a.x, e.x, d));
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    dd[r] = d;
    l2[r] = row < S ? lse[rb + row] * LOG2E : 0.f;
    if (row < S && cq == 0) dsum[rb + row] = d;
  }

  auto wait_kv = [&](int t) {
    const int i = t - kt_begin;
    hopper::mbar_wait(&kv_full[i % ST], (i / ST) & 1);
  };
  auto free_tile = [&](int t) {
    hopper::mbar_arrive(&empty[(t - kt_begin) % ST]);
  };
  for (int t = kt_begin; t < lo; ++t) {
    wait_kv(t);
    free_tile(t);
  }
  hopper::mbar_wait(&q_full, 0);

  float acc[HD / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
  for (int t = lo; t < hi; ++t) {
    wait_kv(t);
    const int stage = (t - kt_begin) % ST;
    const uint8_t* ks = k_s + stage * C::KV_BYTES;
    const uint8_t* vs = v_s + stage * C::KV_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_ss<BK, 0>(s, T::template kmajor<BQ>(q_s, 64 * wg, kk),
                              T::template kmajor<BK>(ks, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_ss<BK, 0>(dp, T::template kmajor<BQ>(do_s, 64 * wg, kk),
                              T::template kmajor<BK>(vs, 0, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    const int k0 = t * BK;
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > r0) ||
                      (window > 0 && k0 <= r0 + 63 - window);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int r = acc_half(j);
      float p = hopper::exp2_approx(fmaf(s[j], scale_log2, -l2[r]));
      if (edge) {
        const int col = k0 + acc_col(j, cq), row = row0 + 8 * r;
        if (col >= S || (causal && col > row) ||
            (window > 0 && row - col >= window))
          p = 0.f;
      }
      s[j] = p * (dp[j] - dd[r]);                  // dS
    }
    pack_frags<BK>(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
      rs_packed<HD, BK>(acc, s, c, T::template mnmajor<BK>(ks, c));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    free_tile(t);
  }
  for (int t = hi; t < kt_end; ++t) {
    wait_kv(t);
    free_tile(t);
  }

  bf16* ob = dq + b * sdq.sb + h * sdq.sh;
#pragma unroll
  for (int j = 0; j < HD / 2; j += 2) {
    const int row = row0 + 8 * acc_half(j);
    if (row < S)
      *reinterpret_cast<uint32_t*>(ob + row * sdq.ss + acc_col(j, cq)) =
          hopper::pack_bf16(acc[j] * scale, acc[j + 1] * scale);
  }
}

template <int HD>
struct KvCfg {
  static constexpr int BKV = 64;                    // keys of a block
  static constexpr int BQ = Box<HD>::QROWS;         // query rows of a tile
  static constexpr int THREADS = WG + 32;
  static constexpr int STAGES = 4;
  static constexpr int KV_BYTES = BKV * HD * 2;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int SMEM = 2 * KV_BYTES + 2 * STAGES * Q_BYTES + 1024;
};

template <int HD>
__global__ void __launch_bounds__(KvCfg<HD>::THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk,
            Strides sdv, int H, int Hkv, int S, int causal, int window,
            float scale_log2, float scale) {
  using C = KvCfg<HD>;
  using T = Tile<HD>;
  constexpr int BKV = C::BKV, BQ = C::BQ, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t kv_full, full[ST], empty[ST];
  // (L log2e, D) of each row of each stage's query tile
  __shared__ __align__(16) float2 ld_s[ST][BQ];
  uint8_t* k_s = align1024(smem_raw);
  uint8_t* v_s = k_s + C::KV_BYTES;
  uint8_t* q_s = v_s + C::KV_BYTES;              // stage s: + s * Q_BYTES
  uint8_t* do_s = q_s + ST * C::Q_BYTES;

  // Key tiles in the order 0, 1, .., then the last first: under the causal
  // mask key tile t walks n - t query tiles, and the blocks of the second
  // half share the card's SMs with the first's, so the longest block
  // runs beside one of the shortest.
  const int hk = blockIdx.x, b = blockIdx.y, half = (gridDim.z + 1) / 2;
  const int kt = blockIdx.z < half ? blockIdx.z
                                   : gridDim.z - 1 - (blockIdx.z - half);
  const int k0 = kt * BKV;
  const int G = H / Hkv;
  const int n_qt = (S + BQ - 1) / BQ;
  // the query tiles that see these keys (a key c is seen by rows
  // r < c + window)
  const int qt_begin = causal ? k0 / BQ : 0;
  const int qt_end =
      window > 0 ? min(n_qt, (k0 + BKV - 2 + window) / BQ + 1) : n_qt;
  const int nq = qt_end - qt_begin;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 33);   // the expect_tx and the warp
      hopper::mbar_init(&empty[s], WG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wg == 1) {
    // producer warp: K and V once; then, head by head of the group and
    // query tile by tile, Q and dO by TMA (lane 0) and the tile's rows of
    // L and D (every lane)
    if (lane == 0) {
      hopper::mbar_expect_tx(&kv_full, 2 * C::KV_BYTES);
      T::template load<BKV, Box<HD>::KROWS>(k_s, &tk, &kv_full, k0, hk, b);
      T::template load<BKV, Box<HD>::KROWS>(v_s, &tv, &kv_full, k0, hk, b);
    }
    for (int i = 0; i < G * nq; ++i) {
      const int h = hk * G + i / nq, q0 = (qt_begin + i % nq) * BQ;
      const int s = i % ST;
      hopper::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], 2 * C::Q_BYTES);
        T::template load<BQ, BQ>(q_s + s * C::Q_BYTES, &tq, &full[s], q0, h,
                                 b);
        T::template load<BQ, BQ>(do_s + s * C::Q_BYTES, &tdo, &full[s], q0,
                                 h, b);
      }
      const long long rb = ((long long)b * H + h) * S;
      for (int r = lane; r < BQ; r += 32) {
        const int row = q0 + r;
        ld_s[s][r] = row < S ? make_float2(lse[rb + row] * LOG2E,
                                           dsum[rb + row])
                             : make_float2(0.f, 0.f);
      }
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // consumer warpgroup: keys k0 .. k0 + 63; this thread holds keys row0
  // and row0 + 8, and query columns by the accumulator layout
  const int row0 = k0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  float acc_k[HD / 2], acc_v[HD / 2], st[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc_k[j] = acc_v[j] = 0.f;
  hopper::mbar_wait(&kv_full, 0);

  // nested as the producer's stream (a flat loop over the stream index,
  // with its division by nq, ran this kernel 35% slower on an H100)
  for (int g = 0; g < G; ++g) {          // the group's heads, in order
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int i = g * nq + qt - qt_begin;
      const int stage = i % ST, q0 = qt * BQ;
      const uint8_t* qs = q_s + stage * C::Q_BYTES;
      const uint8_t* dos = do_s + stage * C::Q_BYTES;
      hopper::mbar_wait(&full[stage], (i / ST) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<BQ, 0>(st, T::template kmajor<BKV>(k_s, 0, kk),
                                T::template kmajor<BQ>(qs, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<BQ, 0>(dp, T::template kmajor<BKV>(v_s, 0, kk),
                                T::template kmajor<BQ>(dos, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      const bool edge = q0 + BQ > S || (causal && q0 < k0 + BKV - 1) ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window);
#pragma unroll
      for (int j = 0; j < BQ / 2; j += 2) {
        // registers j, j + 1: query columns col, col + 1 of one key row
        const int col = acc_col(j, cq);
        const float4 ld = *reinterpret_cast<const float4*>(&ld_s[stage][col]);
        const int key = row0 + 8 * acc_half(j);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = hopper::exp2_approx(
              fmaf(st[j + e], scale_log2, e ? -ld.z : -ld.x));
          if (edge) {
            const int q = q0 + col + e;
            if (q >= S || (causal && key > q) ||
                (window > 0 && q - key >= window))
              p = 0.f;
          }
          st[j + e] = p;                                     // P^T
          dp[j + e] = p * (dp[j + e] - (e ? ld.w : ld.y));    // dS^T
        }
      }
      pack_frags<BQ>(st);
      pack_frags<BQ>(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c)
        rs_packed<HD, BQ>(acc_v, st, c, T::template mnmajor<BQ>(dos, c));
#pragma unroll
      for (int c = 0; c < BQ / 16; ++c)
        rs_packed<HD, BQ>(acc_k, dp, c, T::template mnmajor<BQ>(qs, c));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(&empty[stage]);
    }
  }

  bf16* okb = dk + b * sdk.sb + hk * sdk.sh;
  bf16* ovb = dv + b * sdv.sb + hk * sdv.sh;
#pragma unroll
  for (int j = 0; j < HD / 2; j += 2) {
    const int row = row0 + 8 * acc_half(j), col = acc_col(j, cq);
    if (row < S) {
      *reinterpret_cast<uint32_t*>(okb + row * sdk.ss + col) =
          hopper::pack_bf16(acc_k[j] * scale, acc_k[j + 1] * scale);
      *reinterpret_cast<uint32_t*>(ovb + row * sdv.ss + col) =
          hopper::pack_bf16(acc_v[j], acc_v[j + 1]);
    }
  }
}

// st: (sb, sh, ss) in elements for q, k, v, o, dout, dq, dk, dv in turn
template <int HD>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
              const bf16* dout, const float* lse, float* dsum, bf16* dq,
              bf16* dk, bf16* dv, int B, int H, int Hkv, int S, int causal,
              int window, float scale, const long long* st,
              cudaStream_t stream) {
  using T = Tile<HD>;
  using DQ = DqCfg<HD>;
  using KV = KvCfg<HD>;
  const CUtensorMapSwizzle swz = HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t dq_dims[4] = {HD, (uint64_t)S, (uint64_t)H, (uint64_t)B};
  const uint64_t dkv_dims[4] = {HD, (uint64_t)S, (uint64_t)Hkv, (uint64_t)B};
  // byte strides of (S, heads, B) of operand n of st
  auto bytes = [&](int n, uint64_t (&out)[3]) {
    out[0] = 2ull * st[3 * n + 2];
    out[1] = 2ull * st[3 * n + 1];
    out[2] = 2ull * st[3 * n];
  };
  uint64_t sq[3], sk[3], sv[3], sdo[3];
  bytes(0, sq);
  bytes(1, sk);
  bytes(2, sv);
  bytes(4, sdo);
  const uint32_t box_q[4] = {T::ATOM, Box<HD>::QROWS, 1, 1};
  const uint32_t box_k[4] = {T::ATOM, Box<HD>::KROWS, 1, 1};
  CUtensorMap mq, mdo, mk, mv;
  if (!hopper::encode_map(&mq, q, 4, dq_dims, sq, box_q, swz) ||
      !hopper::encode_map(&mdo, dout, 4, dq_dims, sdo, box_q, swz) ||
      !hopper::encode_map(&mk, k, 4, dkv_dims, sk, box_k, swz) ||
      !hopper::encode_map(&mv, v, 4, dkv_dims, sv, box_k, swz))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = hopper::allow_smem<dq_kernel<HD>>(DQ::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  rc = hopper::allow_smem<dkdv_kernel<HD>>(KV::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const Strides so{st[9], st[10], st[11]}, sdo_e{st[12], st[13], st[14]},
      sdq{st[15], st[16], st[17]}, sdk{st[18], st[19], st[20]},
      sdv{st[21], st[22], st[23]};
  const float scale_log2 = scale * LOG2E;
  // dq first: it writes D, which dkdv reads (same stream, in order)
  dq_kernel<HD><<<dim3(H, B, (S + DQ::BQ - 1) / DQ::BQ), DQ::THREADS,
                  DQ::SMEM, stream>>>(mq, mdo, mk, mv, o, dout, lse,
                                      dsum, dq, so, sdo_e, sdq, H, Hkv, S,
                                      causal, window, scale_log2, scale);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  dkdv_kernel<HD><<<dim3(Hkv, B, (S + KV::BKV - 1) / KV::BKV), KV::THREADS,
                    KV::SMEM, stream>>>(
      mq, mdo, mk, mv, lse, dsum, dk, dv, sdk, sdv, H, Hkv, S, causal,
      window, scale_log2, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ hd 256: the CUDA cores

constexpr int SIMT_THREADS = 256;

// tiles of 32 rows, staged in shared memory as bf16 pairs (row stride odd
// in 32-bit words, so the 16 rows a warp reads at once fall in 16 banks);
// each thread holds a micro-tile of scores and of its outputs
struct SimtCfg {
  static constexpr int HD = 256;
  static constexpr int T = 32;                   // rows of a tile
  static constexpr int HW = HD / 2;              // bf16 pairs of a row
  static constexpr int W = HW + 1;               // words of a smem row (odd)
  static constexpr int SR = T / 16;              // a thread's score tile side
  static constexpr int PW = T + 1;               // floats of a P / dS row
  // accumulation: a thread grid RT x DT over (T rows, HW column pairs)
  static constexpr int CR = 4;                   // rows a thread accumulates
  static constexpr int RT = T / CR;
  static constexpr int DT = SIMT_THREADS / RT;
  static constexpr int CP = HW / DT;             // pairs a thread accumulates
  static constexpr int TILE = T * W;             // words of one tile
  static constexpr int SMEM = (4 * TILE + 2 * T * PW + 2 * T) * 4;
  static_assert(CP >= 1 && HW % DT == 0, "column pairs must split evenly");
};

// rows [r0, r0 + T) of one (S, HD) operand into a smem tile of bf16 pairs,
// zeros past S
__device__ void simt_load(uint32_t* dst, const bf16* src, long long ss,
                          int r0, int S) {
  using C = SimtCfg;
  for (int i = threadIdx.x; i < C::T * C::HW; i += SIMT_THREADS) {
    const int r = i / C::HW, w = i % C::HW;
    uint32_t v = 0u;
    if (r0 + r < S)
      v = *reinterpret_cast<const uint32_t*>(src + (r0 + r) * ss + 2 * w);
    dst[r * C::W + w] = v;
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over the head width (f32)
__device__ __forceinline__ void simt_dot(float (&s)[SimtCfg::SR][SimtCfg::SR],
                                         const uint32_t* a, const uint32_t* b,
                                         int ty, int tx) {
  using C = SimtCfg;
#pragma unroll
  for (int i = 0; i < C::SR; ++i)
#pragma unroll
    for (int j = 0; j < C::SR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int w = 0; w < C::HW; ++w) {
    float2 av[C::SR], bv[C::SR];
#pragma unroll
    for (int i = 0; i < C::SR; ++i) av[i] = unpack(a[(ty + 16 * i) * C::W + w]);
#pragma unroll
    for (int j = 0; j < C::SR; ++j) bv[j] = unpack(b[(tx + 16 * j) * C::W + w]);
#pragma unroll
    for (int i = 0; i < C::SR; ++i)
#pragma unroll
      for (int j = 0; j < C::SR; ++j)
        s[i][j] = fmaf(av[i].y, bv[j].y, fmaf(av[i].x, bv[j].x, s[i][j]));
  }
}

// the scores' mask: key col visible to query row
__device__ __forceinline__ bool visible(int row, int col, int S, int causal,
                                        int window) {
  return row < S && col < S && (!causal || col <= row) &&
         (window <= 0 || row - col < window);
}

// P and dS of one (query tile q0, key tile k0) pair into smem (P only
// where ps is not null): p = exp(scale s - L) where visible, ds = p (dp - D)
__device__ __forceinline__ void simt_scores(float* ps, float* dss,
                                            const uint32_t* qs,
                                            const uint32_t* dos,
                                            const uint32_t* ks,
                                            const uint32_t* vs,
                                            const float* lse2,
                                            const float* dsum, int q0, int k0,
                                            int S, int causal, int window,
                                            float scale_log2) {
  using C = SimtCfg;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[C::SR][C::SR], dp[C::SR][C::SR];
  simt_dot(s, qs, ks, ty, tx);
  simt_dot(dp, dos, vs, ty, tx);
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < C::SR; ++j) {
      const int c = tx + 16 * j;
      const float p = visible(q0 + r, k0 + c, S, causal, window)
                          ? exp2f(s[i][j] * scale_log2 - lse2[r])
                          : 0.f;
      if (ps != nullptr) ps[r * C::PW + c] = p;
      dss[r * C::PW + c] = p * (dp[i][j] - dsum[r]);
    }
  }
}

__global__ void __launch_bounds__(SIMT_THREADS)
simt_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ dsum_out, bf16* __restrict__ dq,
               Strides tq, Strides tk, Strides tv, Strides to, Strides tdo,
               Strides tdq, int H, int Hkv, int S, int causal, int window,
               float scale) {
  using C = SimtCfg;
  constexpr int T = C::T;
  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* dos = qs + C::TILE;
  uint32_t* ks = dos + C::TILE;   // first O, for D
  uint32_t* vs = ks + C::TILE;
  float* dss = reinterpret_cast<float*>(vs + C::TILE);
  float* lse2 = dss + 2 * T * C::PW;
  float* dsum = lse2 + T;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * T;
  const long long row_base = ((long long)b * H + h) * S;
  simt_load(qs, q + b * tq.sb + h * tq.sh, tq.ss, q0, S);
  simt_load(dos, dout + b * tdo.sb + h * tdo.sh, tdo.ss, q0, S);
  simt_load(ks, o + b * to.sb + h * to.sh, to.ss, q0, S);
  __syncthreads();
  for (int r = threadIdx.x; r < T; r += SIMT_THREADS) {
    float d = 0.f;
    for (int w = 0; w < C::HW; ++w) {
      const float2 a = unpack(dos[r * C::W + w]), c = unpack(ks[r * C::W + w]);
      d = fmaf(a.y, c.y, fmaf(a.x, c.x, d));
    }
    const bool live = q0 + r < S;
    dsum[r] = d;
    lse2[r] = live ? lse[row_base + q0 + r] * LOG2E : 0.f;
    if (live) dsum_out[row_base + q0 + r] = d;
  }

  const int n_tiles = (S + T - 1) / T;
  const int kt_end = causal ? qt + 1 : n_tiles;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / T : 0;
  const int tr = threadIdx.x / C::DT, td = threadIdx.x % C::DT;
  float2 acc[C::CR][C::CP];
#pragma unroll
  for (int i = 0; i < C::CR; ++i)
#pragma unroll
    for (int p = 0; p < C::CP; ++p) acc[i][p] = make_float2(0.f, 0.f);
  const float scale_log2 = scale * LOG2E;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __syncthreads();              // the last tile's (or D's) reads are done
    simt_load(ks, k + b * tk.sb + hk * tk.sh, tk.ss, kt * T, S);
    simt_load(vs, v + b * tv.sb + hk * tv.sh, tv.ss, kt * T, S);
    __syncthreads();
    simt_scores(nullptr, dss, qs, dos, ks, vs, lse2, dsum, q0, kt * T, S,
                causal, window, scale_log2);
    __syncthreads();
    // dQ[r] += dS[r][c] K[c] over the tile's keys, in key order
    for (int c = 0; c < T; ++c) {
      float x[C::CR];
#pragma unroll
      for (int i = 0; i < C::CR; ++i) x[i] = dss[(tr + C::RT * i) * C::PW + c];
#pragma unroll
      for (int p = 0; p < C::CP; ++p) {
        const float2 kv = unpack(ks[c * C::W + td + C::DT * p]);
#pragma unroll
        for (int i = 0; i < C::CR; ++i) {
          acc[i][p].x = fmaf(x[i], kv.x, acc[i][p].x);
          acc[i][p].y = fmaf(x[i], kv.y, acc[i][p].y);
        }
      }
    }
  }
  bf16* out = dq + b * tdq.sb + h * tdq.sh;
#pragma unroll
  for (int i = 0; i < C::CR; ++i) {
    const int row = q0 + tr + C::RT * i;
    if (row >= S) continue;
#pragma unroll
    for (int p = 0; p < C::CP; ++p)
      *reinterpret_cast<uint32_t*>(out + row * tdq.ss +
                                   2 * (td + C::DT * p)) =
          hopper::pack_bf16(acc[i][p].x * scale, acc[i][p].y * scale);
  }
}

__global__ void __launch_bounds__(SIMT_THREADS)
simt_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum_in, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, Strides tq, Strides tk, Strides tv,
                 Strides tdo, Strides tdk, Strides tdv, int H, int Hkv, int S,
                 int causal, int window, float scale) {
  using C = SimtCfg;
  constexpr int T = C::T;
  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;
  uint32_t* dos = qs + C::TILE;
  uint32_t* ks = dos + C::TILE;
  uint32_t* vs = ks + C::TILE;
  float* ps = reinterpret_cast<float*>(vs + C::TILE);
  float* dss = ps + T * C::PW;
  float* lse2 = dss + T * C::PW;
  float* dsum = lse2 + T;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int k0 = kt * T;
  simt_load(ks, k + b * tk.sb + hk * tk.sh, tk.ss, k0, S);
  simt_load(vs, v + b * tv.sb + hk * tv.sh, tv.ss, k0, S);

  const int n_tiles = (S + T - 1) / T;
  const int qt_begin = causal ? kt : 0;
  // a key c is seen by rows r < c + window
  const int qt_end =
      window > 0 ? min(n_tiles, (k0 + T - 2 + window) / T + 1) : n_tiles;
  const int tr = threadIdx.x / C::DT, td = threadIdx.x % C::DT;
  float2 acc_k[C::CR][C::CP], acc_v[C::CR][C::CP];
#pragma unroll
  for (int i = 0; i < C::CR; ++i)
#pragma unroll
    for (int p = 0; p < C::CP; ++p) {
      acc_k[i][p] = make_float2(0.f, 0.f);
      acc_v[i][p] = make_float2(0.f, 0.f);
    }
  const float scale_log2 = scale * LOG2E;

  for (int g = 0; g < G; ++g) {     // the group's heads, in order
    const int h = hk * G + g;
    const long long row_base = ((long long)b * H + h) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * T;
      __syncthreads();            // the last tile's reads are done
      simt_load(qs, q + b * tq.sb + h * tq.sh, tq.ss, q0, S);
      simt_load(dos, dout + b * tdo.sb + h * tdo.sh, tdo.ss, q0, S);
      for (int r = threadIdx.x; r < T; r += SIMT_THREADS) {
        const bool live = q0 + r < S;
        lse2[r] = live ? lse[row_base + q0 + r] * LOG2E : 0.f;
        dsum[r] = live ? dsum_in[row_base + q0 + r] : 0.f;
      }
      __syncthreads();
      simt_scores(ps, dss, qs, dos, ks, vs, lse2, dsum, q0, k0, S, causal,
                  window, scale_log2);
      __syncthreads();
      // dV[c] += P[r][c] dO[r], dK[c] += dS[r][c] Q[r], in row order
      for (int r = 0; r < T; ++r) {
        float pv[C::CR], sv[C::CR];
#pragma unroll
        for (int i = 0; i < C::CR; ++i) {
          pv[i] = ps[r * C::PW + tr + C::RT * i];
          sv[i] = dss[r * C::PW + tr + C::RT * i];
        }
#pragma unroll
        for (int p = 0; p < C::CP; ++p) {
          const float2 dov = unpack(dos[r * C::W + td + C::DT * p]);
          const float2 qv = unpack(qs[r * C::W + td + C::DT * p]);
#pragma unroll
          for (int i = 0; i < C::CR; ++i) {
            acc_v[i][p].x = fmaf(pv[i], dov.x, acc_v[i][p].x);
            acc_v[i][p].y = fmaf(pv[i], dov.y, acc_v[i][p].y);
            acc_k[i][p].x = fmaf(sv[i], qv.x, acc_k[i][p].x);
            acc_k[i][p].y = fmaf(sv[i], qv.y, acc_k[i][p].y);
          }
        }
      }
    }
  }
  bf16* ok = dk + b * tdk.sb + hk * tdk.sh;
  bf16* ov = dv + b * tdv.sb + hk * tdv.sh;
#pragma unroll
  for (int i = 0; i < C::CR; ++i) {
    const int row = k0 + tr + C::RT * i;
    if (row >= S) continue;
#pragma unroll
    for (int p = 0; p < C::CP; ++p) {
      const int col = 2 * (td + C::DT * p);
      *reinterpret_cast<uint32_t*>(ok + row * tdk.ss + col) =
          hopper::pack_bf16(acc_k[i][p].x * scale, acc_k[i][p].y * scale);
      *reinterpret_cast<uint32_t*>(ov + row * tdv.ss + col) =
          hopper::pack_bf16(acc_v[i][p].x, acc_v[i][p].y);
    }
  }
}

int launch_simt(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                const bf16* dout, const float* lse, float* dsum, bf16* dq,
                bf16* dk, bf16* dv, int B, int H, int Hkv, int S, int causal,
                int window, float scale, const long long* st,
                cudaStream_t stream) {
  using C = SimtCfg;
  const Strides tq{st[0], st[1], st[2]}, tk{st[3], st[4], st[5]},
      tv{st[6], st[7], st[8]}, to{st[9], st[10], st[11]},
      tdo{st[12], st[13], st[14]}, tdq{st[15], st[16], st[17]},
      tdk{st[18], st[19], st[20]}, tdv{st[21], st[22], st[23]};
  cudaError_t rc = hopper::allow_smem<simt_dq_kernel>(C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  rc = hopper::allow_smem<simt_dkdv_kernel>(C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const int n_tiles = (S + C::T - 1) / C::T;
  // dq first: it writes D, which dkdv reads (same stream, in order)
  simt_dq_kernel<<<dim3(n_tiles, H, B), SIMT_THREADS, C::SMEM, stream>>>(
      q, k, v, o, dout, lse, dsum, dq, tq, tk, tv, to, tdo, tdq, H, Hkv, S,
      causal, window, scale);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  simt_dkdv_kernel<<<dim3(n_tiles, Hkv, B), SIMT_THREADS, C::SMEM, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, tq, tk, tv, tdo, tdk, tdv, H, Hkv, S,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, H, S, hd); k, v, dk, dv (B, Hkv, S, hd): bf16 views
// whose last dimension is contiguous, 16-byte aligned, the other strides
// (elements, multiples of 8) in `strides` as (sb, sh, ss) for q, k, v, o,
// dout, dq, dk, dv in turn.  lse (B, H, S) f32, the forward's natural-log
// row sums; dsum (B, H, S) f32 scratch, written with D.  hd one of 32, 64,
// 128, 256; H % Hkv == 0.  Returns a cudaError_t.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int hd, int causal, int window,
    float scale, const long long* strides, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD_ARGS                                                     \
  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,          \
      (const bf16*)dout, (const float*)lse, (float*)dsum, (bf16*)dq,       \
      (bf16*)dk, (bf16*)dv, B, H, Hkv, S, causal, window, scale, strides, s
  switch (hd) {
    case 32: return launch_tc<32>(REPRO_BWD_ARGS);
    case 64: return launch_tc<64>(REPRO_BWD_ARGS);
    case 128: return launch_tc<128>(REPRO_BWD_ARGS);
    case 256: return launch_simt(REPRO_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD_ARGS
}
