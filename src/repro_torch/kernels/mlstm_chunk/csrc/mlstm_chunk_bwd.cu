// Backward of the chunkwise mLSTM (xLSTM) from no history, for Hopper
// (sm_90a): the cotangents of q, k, v, li and lf from h's.
//
// Replaces: no TPU kernel.  The JAX package's Pallas mLSTM
// (repro/kernels/mlstm_chunk/kernel.py :: mlstm_chunk_kernel) has no VJP;
// JAX trains through the jnp chunkwise form.  This kernel is the backward
// of the forward kernel mlstm_chunk.cu, held to jax.grad of that form.
//
// What it computes.  Every stabilizer (m_t, m_p, m') is a constant here:
// h does not depend on them (num and den both scale by exp(-m_t), the
// exp(-m_t) branch of den's max too), so their gradient is 0 and the
// exp(-m_t) branch of den's max passes none.  With the forward's names
// (g the chunk's cumulative log forget gate, D[l,s] = exp(g_l - g_s +
// li_s - m_t[l]) on s <= l, P = scale q k^T, S = P D, w_l = exp(g_l + m_p
// - m_t[l]), wk_s, decay, C_p and n_p the chunk's carried state), per
// chunk and cotangent dh:
//   dnum_l = dh_l / den_l;  ddsum_l = -(dh_l . h_l) / den_l sign(dsum_l)
//     where |dsum_l| wins den's max, else 0 (dsum the signed den before
//     the max, which the forward saves)
//   dS = dnum v^T + ddsum 1^T;  dP = dS D;  da = dS S       (s <= l)
//   dq = scale dP k + w (dnum C_p^T + ddsum n_p^T)           (inter)
//   dk = scale dP^T q + scale wk (v dC'^T + 1 dn'^T)          (state)
//   dv = S^T dnum + scale wk (k dC')                          (state)
//   dg_l = sum_s da[l,s] - sum_l' da[l',l] + q_l . dq_inter_l
//          - k_l . dk_state_l,  and dg_{c-1} += sum_s k_s . dk_state_s
//          + decay (<dC', C_p> + <dn', n_p>)
//   dli_s = sum_l da[l,s] + k_s . dk_state_s;  dlf = dg summed from the
//     chunk's end (g is lf's cumulative sum)
// where (dC', dn') is the cotangent of the state after the chunk, run back
// over the chunks: dC_j = decay_j dC_{j+1} + sum_l w_l q_l^T dnum_l, the
// last chunk's dC' 0 (the final state takes no cotangent; the wrapper
// refuses one).
//
// What bounds it on an H100: operations.  Per chunk of c tokens and head
// of width dh it does about 5 c^2 dh (the scores and dnum v^T over the
// causal pairs; dq, dk and dv's intra products) + 8 c dh^2 (the inter
// and state products and the chunk's own inter term) flops, against
// about 40 c dh bytes (q, k, v, h, dh and the state read, dq, dk and dv
// written): about 260 flops a byte at c = 256, dh = 384.  Every product
// runs on the tensor cores in 3xTF32, three TF32 products for each f32
// one: the bound is 3x the operations at 495 TFLOP/s.
//
// What the design does.  The forward's chunks are independent once each
// carried state is known, and so are the backward's once each dC' is:
// six launches, none of which walks the chunks except the elementwise
// reverse combine, the forward's launches 2-3 mirrored.
//   1. prep, a warp a token: dnum = dh / den and ddsum, from the saved
//      dsum and m_t.
//   2. inter, grid (128-row strips of d x column strips of e x chunks
//      after the first x B x H): every chunk's own E_j = sum_l (w_l
//      q_l)^T dnum_l and its n counterpart at once.
//   3. combine, elementwise over dh x dh, chunks back to front: dC' of
//      chunk j into E_j's slot, then dC = decay_j dC' + E_j; each warp's
//      share of <dC', C_p> + <dn', n_p> a chunk.
//   4. scores, grid (causal pairs of 128 query x 64 key tiles x chunks x
//      B x H): S and dS over the full depth, then S and dP' = scale dP
//      kept in a (cp x cp) scratch a chunk, and da's row and column sums
//      a tile.
//   5. products, grid (dq | dk | dv x 128-row strips x column strips x
//      chunks x B x H): each a 128-row strip of its output across up to
//      192 columns, first the inter or state term over the depth from
//      C_p or dC' (its row factor taken into A, its rank-one part the
//      accumulator's start; its gate term q . dq_inter or k . dk_state
//      summed over the strip's columns), then the intra product over the
//      tokens from dP' or S added on top.
//   6. gates, a block a chunk: dg, dli, and dlf by a reverse sum.
// Launches 2, 4 and 5 share one product engine (`product`): a block of
// two warpgroups computes a 128 x N strip (N 192, and 128 or 64 for the
// last strip of a dh that 192 does not divide; the scores' tiles 64), so
// each operand crosses L2 about once per strip rather than once per 64 x
// 64 tile.  Each product is wgmma m64nNk8 in 3xTF32: A from registers,
// each thread splitting its fragment into TF32 hi and lo as it loads it
// from the raw tile, two sets of fragments so that one stage's load
// overlaps the other's products; B from shared memory as hi and lo planes
// in the canonical 128-byte swizzle, which the block splits once per
// stage of 32 deep into one of two buffers; three wgmmas a step, the
// small terms first (lo hi, hi lo, hi hi), as mma.sync's 3xTF32 did.
// tf32 wgmma reads both operands K-major only, and most operands here lie
// with the contraction index as rows (k, q and dnum in the intra
// products, dC' in dv's state term, S and dP' as dk's and dv's A, q and
// dnum in the inter term): the split of B, which reads f32 and writes the
// planes anyway, transposes 4 x 4 a thread, and A's fragments are read
// transposed from the raw tile.  Loads: a ring of three raw stages fed by
// TMA (thread 0 issues, an mbarrier a stage), every tile in the 128-byte
// swizzle; the token-major tensors are mapped as (dh, c, chunks), so
// that rows past a chunk's end fall past the map's edge and read as 0.
// Stage s + 3 is in flight while stage s + 1 is split and stage s's
// wgmmas run.  B's planes (96 KB) and the ring (120 KB) fill the SM's
// shared memory, one block an SM.
// Deterministic: no atomics; every sum (over warps, tiles, column strips,
// blocks and chunks) runs in one fixed order, so two launches agree bit
// for bit.  S and dP' go through device memory (a chunk's S alone is
// 256 KB at c = 256, more than an SM holds; both stay L2-sized), and the
// scores are recomputed rather than kept from the forward.
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::fence_regs;
using tf32x3::split_tf32;
using tf32x3::swz128;

constexpr int TILE = 128;           // output rows of a block, scores' tiles
constexpr int WIDE = 192;           // the widest output strip
constexpr int KEYS = 64;            // the keys of a score tile
constexpr int KEY_TILES = TILE / KEYS;  // key tiles a query tile reaches
constexpr int MAX_C = 256;          // the forward's largest chunk
constexpr int MAX_DH = 512;
constexpr int THREADS = 256;        // two warpgroups of 64 rows
constexpr int KS = 32;              // depth of a stage: one 128-byte row
constexpr int STAGES = 3;           // the ring of raw tiles
constexpr int A_F = TILE * KS;      // floats of A's raw tile
constexpr int B_F = WIDE * KS;      // floats of B's raw tile, or a plane
constexpr int RAW_F = A_F + B_F;    // a raw stage
constexpr int BUF_F = 2 * B_F;      // a buffer of planes: B's hi, lo
constexpr int SMEM_BYTES = 4 * (2 * BUF_F + STAGES * RAW_F) + 1024;

// Dynamic shared memory: two buffers of B's hi and lo planes (up to 192 x
// 32 each), then the ring of raw stages, each A's tile then B's; every
// tile 1024-byte aligned, as the swizzle needs.
__device__ __forceinline__ float* planes() {
  extern __shared__ uint8_t smem_raw[];
  return reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// The TMA descriptors of one backward, f32, 128-byte swizzle.  The
// token-major tensors (B H L dh) are seen as (dh, c, B H nc), so that a
// box's rows past a chunk's end lie past the tensor's edge and read as 0;
// the states and dC' as (dh, dh, slots), S and dP' as (cp, cp, slots).
// A direct map reads boxes of 64 rows x 32 (a K-major tile's rows), a
// transposed one boxes of 32 rows x 32 (a slab of a tile whose rows are
// the depth).
struct Maps {
  CUtensorMap q, k, v, dnum, C, dC, dP;         // direct
  CUtensorMap qt, kt, dnumt, dCt, St, dPt;      // transposed
};

// One operand of a product: its map, the slot or chunk z it reads (the
// map's outer coordinate), and whether it is transposed: direct, the map's
// rows are the product's M (or N) index and its columns the depth;
// transposed, the reverse.
struct Opnd {
  const CUtensorMap* map;
  int z;
  bool trans;
};

// One product's operands: rows m0.. of A, rows n0.. of B, over the depth
// [kbeg, kend) (a multiple of 32 long).
struct Seg {
  Opnd A;
  int m0;
  Opnd B;
  int n0, kbeg, kend;
};

// The ring's barriers, the count of stages it has taken (each a barrier
// phase) and how many stages of the coming product are already in flight,
// carried from one product to the next.
struct Ring {
  uint64_t* full;
  int pos, ahead;
};

// element (k, i) of a transposed raw tile: slab i / 32 (32 x 32 floats) of
// the 128-byte swizzle, depth k its row
__device__ __forceinline__ int swz_t(int k, int i) {
  return (i >> 5) * (32 * KS) + k * KS + ((((i >> 2) ^ k) & 7) << 2) +
         (i & 3);
}

// the stage (rows i0.., depth k0..) of a W-row operand into a raw tile by
// TMA, completing on `bar`: direct, W x 32 (swz128) in boxes of 64 rows;
// transposed, W / 32 slabs (swz_t)
template <int W>
__device__ __forceinline__ void tma_tile(float* dst, const Opnd& o, int i0,
                                         int k0, uint64_t* bar) {
  if (!o.trans)
#pragma unroll
    for (int b = 0; b < W / 64; ++b)
      hopper::tma_load_3d(dst + 64 * KS * b, o.map, bar, k0, i0 + 64 * b,
                          o.z);
  else
#pragma unroll
    for (int s = 0; s < W / 32; ++s)
      hopper::tma_load_3d(dst + 32 * KS * s, o.map, bar, i0 + 32 * s, k0,
                          o.z);
}

// x = hi + lo (tf32x3::split_tf32) of four values, into row-chunk `at` of
// the planes
__device__ __forceinline__ void put4(float* hi, float* lo, int at, float4 x) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<float4*>(hi + at) =
      make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                  __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo + at) =
      make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                  __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// B's raw tile (W rows of the product) into its hi and lo planes (W x 32,
// swz128).  Direct: the raw tile lies as the planes do, chunk for chunk.
// Transposed: a thread turns 4 x 4 blocks; the 8 threads of a
// shared-memory phase take depth chunks kb % 4 = 0..3 of two neighbouring
// row blocks, so that their plane stores meet no conflict.
// The thread's work comes in four parts (its iterations it % 4 == part;
// -1 for all), so that a stage's split can run between the previous
// stage's wgmmas.
template <int W>
__device__ __forceinline__ void split(float* hi, float* lo, const float* raw,
                                      bool trans, int part = -1) {
  if (!trans) {
#pragma unroll
    for (int it = 0; it < W * KS / 4 / THREADS; ++it)
      if (part < 0 || it % 4 == part) {
        const int i = threadIdx.x + THREADS * it;
        put4(hi, lo, 4 * i, reinterpret_cast<const float4*>(raw)[i]);
      }
    return;
  }
#pragma unroll
  for (int it = 0; it < (2 * W + THREADS - 1) / THREADS; ++it) {
    const int b = threadIdx.x + THREADS * it;
    if ((part >= 0 && it % 4 != part) || b >= 2 * W) continue;
    const int rest = b >> 3;
    const int kb = (b & 3) + 4 * (rest & 1);
    const int nb = 2 * (rest >> 1) + ((b >> 2) & 1);
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const float4*>(raw + swz_t(4 * kb + i, 4 * nb));
    put4(hi, lo, swz128(4 * nb, 4 * kb),
         make_float4(v[0].x, v[1].x, v[2].x, v[3].x));
    put4(hi, lo, swz128(4 * nb + 1, 4 * kb),
         make_float4(v[0].y, v[1].y, v[2].y, v[3].y));
    put4(hi, lo, swz128(4 * nb + 2, 4 * kb),
         make_float4(v[0].z, v[1].z, v[2].z, v[3].z));
    put4(hi, lo, swz128(4 * nb + 3, 4 * kb),
         make_float4(v[0].w, v[1].w, v[2].w, v[3].w));
  }
}

// A's fragments of stage k0 (a warpgroup's 64 rows, depth 32: element
// (row gq + 8 (e % 2), depth 8 j + tq + 4 (e / 2)) of the warp's 16 rows)
// from its raw tile, each times mscale[m] and kscale[k0 + k] where those
// are given, split into TF32 hi and lo as they load
struct AFrag {
  uint32_t hi[4][4], lo[4][4];
};

__device__ __forceinline__ void frag(AFrag& f, const float* raw, bool trans,
                                     int mrow, int k0, const float* kscale,
                                     const float* mscale, int part = -1) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < KS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (part >= 0 && j != part) continue;
      const int m = mrow + 8 * (e & 1), k = 8 * j + tq + 4 * (e >> 1);
      float x = trans ? raw[swz_t(k, m)] : raw[swz128(m, k)];
      if (mscale != nullptr) x *= mscale[m];
      if (kscale != nullptr) x *= kscale[k0 + k];
      split_tf32(x, f.hi[j][e], f.lo[j][e]);
    }
}

__device__ __forceinline__ void fence_frag(AFrag& f) {
#pragma unroll
  for (int j = 0; j < KS / 8; ++j) {
    fence_regs(f.hi[j]);
    fence_regs(f.lo[j]);
  }
}

// the ring's barriers, once a block, by thread 0, which then primes the
// ring (prime); the block synchronizes before any other thread waits on
// them
__device__ __forceinline__ void ring_init(uint64_t* full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
}

// stage hst of the product h into the ring's stage st from its position,
// by thread 0
template <int N>
__device__ __forceinline__ void issue(const Ring& ring, const Seg& h, int hst,
                                      int st) {
  float* raw = planes() + 2 * BUF_F + (ring.pos + st) % STAGES * RAW_F;
  uint64_t* bar = &ring.full[(ring.pos + st) % STAGES];
  hopper::mbar_expect_tx(bar, 4 * KS * (TILE + N));
  tma_tile<TILE>(raw, h.A, h.m0, h.kbeg + hst * KS, bar);
  tma_tile<N>(raw + A_F, h.B, h.n0, h.kbeg + hst * KS, bar);
}

// the first stages of the block's first product into the ring, before the
// block's other set-up
template <int N>
__device__ __forceinline__ void prime(Ring& ring, const Seg& h) {
  const int steps = (h.kend - h.kbeg) / KS;
  ring.ahead = steps < STAGES ? steps : STAGES;
  if (threadIdx.x == 0)
    for (int st = 0; st < ring.ahead; ++st) issue<N>(ring, h, st, st);
}

// the descriptors of a later product into the descriptor cache
__device__ __forceinline__ void prefetch(const Seg& h) {
  if (threadIdx.x == 0) {
    hopper::prefetch_map(h.A.map);
    hopper::prefetch_map(h.B.map);
  }
}

struct NoExtra {
  __device__ void operator()(const float*, int) const {}
};

// acc (a warpgroup's 64 x N: rows m0 + 64 wg.. of A, columns n0.. of B)
// += sum over the depth of A B^T (the product `g`), in 3xTF32; A's
// element (m, k) times mscale[m - m0] and kscale[k] where those are
// given.  Rows of A at or past m0 + mvalid are not needed: a warpgroup
// whose 64 rows all are skips its products.  Stage s + 3 is in flight in
// the ring (TMA, issued by thread 0) while stage s + 1 is split (B into
// the other buffer of planes, A into the other set of fragment registers)
// between stage s's wgmmas; past its last stage the ring takes the first
// stages of `next`, the product that follows.  extra(A's raw tile, its
// depth) runs on each stage as it is split.  Every thread of the block
// calls it; it leaves the planes free.
template <int N, class Extra = NoExtra>
__device__ __forceinline__ void product(float (&acc)[N / 2], Ring& ring,
                                        const Seg& g, int mvalid,
                                        const float* kscale = nullptr,
                                        const float* mscale = nullptr,
                                        const Seg* next = nullptr,
                                        Extra extra = Extra()) {
  const int steps = (g.kend - g.kbeg) / KS;
  const int next_steps = next ? (next->kend - next->kbeg) / KS : 0;
  const Opnd& A = g.A;
  const Opnd& B = g.B;
  // the warpgroup, warp-uniform as the compiler sees it (a branch it takes
  // for divergent would serialize the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const bool idle = 64 * wg >= mvalid;
  const int mrow = 64 * wg + 16 * ((threadIdx.x / 32) % 4) +
                   (threadIdx.x % 32) / 4;
  float* const smem = planes();
  float* const raws = smem + 2 * BUF_F;
  auto raw = [&](int st) { return raws + (ring.pos + st) % STAGES * RAW_F; };
  auto bar = [&](int st) { return &ring.full[(ring.pos + st) % STAGES]; };
  auto load = [&](int st) {                     // the stream's stage st
    if (threadIdx.x != 0) return;
    if (st < steps) {
      if (st >= ring.ahead) issue<N>(ring, g, st, st);
    } else if (st - steps < next_steps) {
      issue<N>(ring, *next, st - steps, st);
    }
  };
  auto landed = [&](int st) {
    hopper::mbar_wait(bar(st), ((ring.pos + st) / STAGES) & 1);
  };
  auto put = [&](int st, int part) {            // B's raw stage -> planes
    float* buf = smem + (st & 1) * BUF_F;
    split<N>(buf, buf + B_F, raw(st) + A_F, B.trans, part);
    if (part <= 0) extra(raw(st), g.kbeg + st * KS);
  };
  auto take = [&](AFrag& f, int st, int part) { // A's raw stage -> f
    frag(f, raw(st), A.trans, mrow, g.kbeg + st * KS, kscale, mscale, part);
  };
  AFrag f0, f1;
  for (int st = 0; st < STAGES; ++st) load(st);
  if (steps > 0) {
    landed(0);
    put(0, -1);
    hopper::fence_proxy_async();
    if (!idle) take(f0, 0, -1);
  }
  __syncthreads();                              // stage 0's planes written
  // Stage st: its first depth-8 step issued; once stage st - 1's wgmmas
  // are done in both warpgroups, stage st + 3 into the room stage st had
  // in the ring; then the rest of stage st's wgmmas, each step followed by
  // a quarter of stage st + 1's split (into the other buffer of planes)
  // and fragments (into the other registers), so that the tensor cores
  // always hold a queue.
  auto begin = [&](int st) {
    __syncthreads();                            // stage st - 1 done
    load(st + STAGES);
    if (st + 1 < steps) landed(st + 1);
  };
  if (idle) {                                   // loads and splits alone
    for (int st = 0; st < steps; ++st) {
      begin(st);
      if (st + 1 < steps) {
        put(st + 1, -1);
        hopper::fence_proxy_async();
      }
      __syncthreads();                          // stage st + 1's planes
    }
  } else {
    auto step = [&](int st, AFrag& cur, AFrag& nxt) {
      const float* b = smem + (st & 1) * BUF_F;
      const bool more = st + 1 < steps;
      auto mma = [&](int j) {
        const uint64_t bh =
            hopper::make_desc(b + 8 * j, 16, 1024, hopper::SW128);
        const uint64_t bl =
            hopper::make_desc(b + B_F + 8 * j, 16, 1024, hopper::SW128);
        tf32x3::wgmma_tf32<N>(acc, cur.lo[j], bh);   // the small terms first
        tf32x3::wgmma_tf32<N>(acc, cur.hi[j], bl);
        tf32x3::wgmma_tf32<N>(acc, cur.hi[j], bh);
      };
      hopper::wgmma_fence();
      mma(0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();                  // stage st - 1 done
      fence_frag(nxt);                          // ... with its fragments
      begin(st);
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
        if (j > 0) mma(j);
        if (more) {
          put(st + 1, j);
          take(nxt, st + 1, j);
        }
      }
      hopper::wgmma_commit();
      if (more) hopper::fence_proxy_async();
      __syncthreads();                          // stage st + 1's planes
    };
    fence_regs(acc);
    for (int st = 0; st < steps; st += 2) {
      step(st, f0, f1);
      if (st + 1 < steps) step(st + 1, f1, f0);
    }
    hopper::wgmma_wait<0>();
    fence_regs(acc);
    fence_frag(f0);
    fence_frag(f1);
  }
  ring.pos += steps;
  ring.ahead = next_steps < STAGES ? next_steps : STAGES;
  __syncthreads();                              // the planes free
}

// Where a thread's accumulator element i lies in the block's 128 x N
// strip: row m (warpgroup, warp, lane) and column n.
struct Frag {
  int m0, tq;
  __device__ Frag() {
    const int lane = threadIdx.x % 32;
    m0 = 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
    tq = lane % 4;
  }
  __device__ int row(int i) const { return m0 + 8 * ((i >> 1) & 1); }
  __device__ int col(int i) const { return 8 * (i >> 2) + 2 * tq + (i & 1); }
};

// sum over the quad (the 4 threads that hold one row's columns)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// sum over the block's threads of v, in one fixed order (red >= 8)
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) s += red[w];
  return s;
}

// Where everything lies.  Per (b, h) = bh, chunk j, token l of the chunk:
// token t = bh L + j c + l of the (B H L ...) tensors; slot bh nc + j of
// the per-chunk ones; the forward's gates: planes g, m_t, w, wk of B H L
// floats, then decay (B H, nc); its states: C_j (slots of dh^2), then n_j
// (slots of dh).  cp = ceil(c / 128) 128 pads a chunk to whole tiles; nt =
// cp / 128; ncs column strips of dh: 192 wide, the last 64, 128 or 192.
struct Dims {
  int BH, L, dh, c, nc, cp, nt, ncs, cvec;
  float scale;
  __host__ __device__ size_t plane() const { return (size_t)BH * L; }
  __host__ __device__ size_t slots() const { return (size_t)BH * nc; }
  __device__ int width(int strip) const {
    return min(WIDE, dh - WIDE * strip);
  }
};

// the workspace, in floats: dnum (B H L dh), ddsum (B H L), dC' (slots x
// dh^2), dn' (slots x dh), S and dP' (slots x cp^2 each), da's row sums
// (slots x nt query tiles x 2 nt key tiles x 128) and column sums (slots x
// 2 nt key tiles x nt x 64), the gate terms q . dq_inter and
// k . dk_state (B H L x ncs each), the decay dot (slots x parts x the
// combine's warps)
struct Workspace {
  float *dnum, *ddsum, *dC, *dn, *S, *dP, *rowp, *colp, *xw, *xk, *dot;
  size_t floats;
};

constexpr int CB_THREADS = 256;
constexpr int CB_WARPS = CB_THREADS / 32;
// blocks a (b, h) of the combine, whose threads hold `vec` float4s of dC
__host__ __device__ inline int combine_parts(int dh, int vec) {
  return (dh * dh / 4 + CB_THREADS * vec - 1) / (CB_THREADS * vec);
}

Workspace carve(float* base, const Dims& d) {
  Workspace w;
  size_t o = 0;
  auto take = [&](size_t n) {
    float* p = base == nullptr ? nullptr : base + o;
    o += (n + 3) / 4 * 4;                       // 16-byte aligned parts
    return p;
  };
  const size_t rows = d.plane();
  w.dnum = take(rows * d.dh);
  w.ddsum = take(rows);
  w.dC = take(d.slots() * d.dh * d.dh);
  w.dn = take(d.slots() * d.dh);
  w.S = take(d.slots() * d.cp * d.cp);
  w.dP = take(d.slots() * d.cp * d.cp);
  w.rowp = take(d.slots() * d.nt * KEY_TILES * d.nt * TILE);
  w.colp = take(d.slots() * KEY_TILES * d.nt * d.nt * KEYS);
  w.xw = take(rows * d.ncs);
  w.xk = take(rows * d.ncs);
  w.dot = take(d.slots() * combine_parts(d.dh, d.cvec) * CB_WARPS);
  w.floats = o;
  return w;
}

__device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ------------------------------------------------------------ 1. prep

// a warp a token: dnum = dh / den, ddsum = -(dh . h) / den sign(dsum)
// where |dsum| >= exp(-m_t) (den = max(|dsum|, exp(-m_t)))
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_prep(const float* __restrict__ h, const float* __restrict__ dh,
               const float* __restrict__ gates,
               const float* __restrict__ dsum, Workspace ws, Dims d) {
  const size_t t = (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= d.plane()) return;
  const float ds = dsum[t], floor_ = expf(-gates[d.plane() + t]);
  const float den = fmaxf(fabsf(ds), floor_);
  const float4* h4 = reinterpret_cast<const float4*>(h + t * d.dh);
  const float4* d4 = reinterpret_cast<const float4*>(dh + t * d.dh);
  float4* n4 = reinterpret_cast<float4*>(ws.dnum + t * d.dh);
  float dot = 0.f;
  for (int i = lane; i < d.dh / 4; i += 32) {
    const float4 a = h4[i], b = d4[i];
    dot += ((a.x * b.x + a.y * b.y) + a.z * b.z) + a.w * b.w;
    n4[i] = make_float4(b.x / den, b.y / den, b.z / den, b.w / den);
  }
  for (int off = 16; off; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (lane == 0) {
    const float sgn = ds > 0.f ? 1.f : (ds < 0.f ? -1.f : 0.f);
    ws.ddsum[t] = fabsf(ds) >= floor_ ? -sgn * dot / den : 0.f;
  }
}

// ------------------------------------------------------------ 2. inter

// E_j [d0.., e0..] = sum_l w_l q_l[d] dnum_l[e] over a 128 x N strip; the
// blocks of column strip 0 also En_j[d0..] = sum_l w_l ddsum_l q_l[d]
// (four running sums over the tokens by l % 4, then added in order).  Into the dC' and dn' slots (the combine
// reads them there).
template <int N>
__device__ __forceinline__ void inter_body(const Maps& m, Ring& ring,
                                           const float* gates, Workspace ws,
                                           const Dims& d, float* wsm,
                                           float* wd, int d0, int cs, int j,
                                           int bh) {
  const Frag f;
  const int e0 = WIDE * cs;
  const int slot = bh * d.nc + j;
  const Seg g{{&m.qt, slot, true}, d0, {&m.dnumt, slot, true}, e0, 0,
              round_up(d.c, KS)};
  prime<N>(ring, g);
  const size_t t0 = (size_t)bh * d.L + (size_t)j * d.c;
  for (int l = threadIdx.x; l < MAX_C; l += THREADS) {
    const float w = l < d.c ? gates[2 * d.plane() + t0 + l] : 0.f;
    wsm[l] = w;
    wd[l] = l < d.c ? w * ws.ddsum[t0 + l] : 0.f;
  }
  __syncthreads();
  // En_j[d0..] by the blocks of column strip 0 from q's raw tiles, a
  // thread a row of d
  const bool nrow = cs == 0 && threadIdx.x < TILE;
  float nacc[4] = {};                           // kk % 4
  float acc[N / 2] = {};
  product<N>(acc, ring, g, d.dh - d0, wsm, nullptr, nullptr,
             [&](const float* rawA, int k0) {
               if (nrow)
#pragma unroll
                 for (int kk = 0; kk < KS; ++kk)
                   nacc[kk % 4] += wd[k0 + kk] * rawA[swz_t(kk, threadIdx.x)];
             });
  if (nrow && d0 + (int)threadIdx.x < d.dh)
    ws.dn[(size_t)slot * d.dh + d0 + threadIdx.x] =
        (nacc[0] + nacc[1]) + (nacc[2] + nacc[3]);
  float* Eb = ws.dC + (size_t)slot * d.dh * d.dh;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = d0 + f.row(i);
    if (r < d.dh)
      *reinterpret_cast<float2*>(Eb + (size_t)r * d.dh + e0 + f.col(i)) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// x = d strip + ceil(dh / 128) (column strip + ncs (chunk - 1 + (nc - 1)
// bh))
__global__ void __launch_bounds__(THREADS, 1)
mlstm_bwd_inter(const __grid_constant__ Maps m,
                const float* __restrict__ gates, Workspace ws, Dims d) {
  __shared__ float wsm[MAX_C], wd[MAX_C];
  __shared__ uint64_t full[STAGES];
  Ring ring{full, 0, 0};
  ring_init(full);
  const int ndt = (d.dh + TILE - 1) / TILE;
  int x = blockIdx.x;
  const int d0 = (x % ndt) * TILE;
  x /= ndt;
  const int cs = x % d.ncs;
  x /= d.ncs;
  const int j = 1 + x % (d.nc - 1), bh = x / (d.nc - 1);
  switch (d.width(cs)) {
    case WIDE:
      inter_body<WIDE>(m, ring, gates, ws, d, wsm, wd, d0, cs, j, bh);
      break;
    case 128:
      inter_body<128>(m, ring, gates, ws, d, wsm, wd, d0, cs, j, bh);
      break;
    default: inter_body<64>(m, ring, gates, ws, d, wsm, wd, d0, cs, j, bh);
  }
}

// ------------------------------------------------------------ 3. combine

// chunks back to front: slot j gets dC' (the cotangent of the state after
// chunk j; 0 for the last), then dC = decay_j dC' + E_j (E_0 is never
// formed: the first chunk has no carried state, and its dC is unread).
// Each warp writes its share of <dC', C_j> + <dn', n_j> (its elements of
// the forward's carried state) per chunk; the gates launch sums them in
// order.  A thread holds VEC float4s
// of dC, CB_THREADS apart, and loads them all before it uses one (VEC 4
// where that still leaves two waves of blocks, else 1).
template <int VEC>
__global__ void __launch_bounds__(CB_THREADS)
mlstm_bwd_combine(const float* __restrict__ gates,
                  const float* __restrict__ states, Workspace ws, Dims d) {
  constexpr int CB_VEC = VEC;
  const int parts = combine_parts(d.dh, VEC);
  const int bh = blockIdx.x / parts, part = blockIdx.x % parts;
  const size_t sq = (size_t)d.dh * d.dh;
  const float* decay = gates + 4 * d.plane() + (size_t)bh * d.nc;
  const float* Cs = states;
  const float* ns = states + d.slots() * sq;
  const size_t e0 = (size_t)part * CB_THREADS * CB_VEC + threadIdx.x;
  const int ne = part == 0 ? d.dh : 0;          // block 0 also folds n
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc[CB_VEC];
#pragma unroll
  for (int v = 0; v < CB_VEC; ++v) acc[v] = zero;
  float nacc[MAX_DH / CB_THREADS] = {};
  // chunk j's E (0 for the first chunk) and carried C
  float4 u[CB_VEC], c[CB_VEC];
  auto fetch = [&](int j, float4(&uj)[CB_VEC], float4(&cj)[CB_VEC]) {
    const size_t slot = (size_t)bh * d.nc + j;
    const float4* p = reinterpret_cast<const float4*>(ws.dC + slot * sq);
    const float4* C = reinterpret_cast<const float4*>(Cs + slot * sq);
#pragma unroll
    for (int v = 0; v < CB_VEC; ++v) {
      const size_t e = e0 + (size_t)CB_THREADS * v;
      const bool in = e < sq / 4;
      uj[v] = in && j > 0 ? p[e] : zero;
      cj[v] = in ? C[e] : zero;
    }
  };
  // chunks j and j - 1 in flight while chunk j is combined
  float4 u1[CB_VEC], c1[CB_VEC];
  fetch(d.nc - 1, u, c);
  if (d.nc > 1) fetch(d.nc - 2, u1, c1);
  for (int j = d.nc - 1; j >= 0; --j) {
    const size_t slot = (size_t)bh * d.nc + j;
    float4* p = reinterpret_cast<float4*>(ws.dC + slot * sq);
    float4 u2[CB_VEC], c2[CB_VEC];
    if (j > 1) fetch(j - 2, u2, c2);
    float dot = 0.f;
    const float dc = decay[j];
#pragma unroll
    for (int v = 0; v < CB_VEC; ++v) {
      const size_t e = e0 + (size_t)CB_THREADS * v;
      if (e < sq / 4) p[e] = acc[v];
      const float4 a = acc[v];
      dot += ((a.x * c[v].x + a.y * c[v].y) + a.z * c[v].z) + a.w * c[v].w;
      acc[v] = make_float4(dc * a.x + u[v].x, dc * a.y + u[v].y,
                           dc * a.z + u[v].z, dc * a.w + u[v].w);
      u[v] = u1[v];
      c[v] = c1[v];
      u1[v] = u2[v];
      c1[v] = c2[v];
    }
    for (int i = 0, e = threadIdx.x; e < ne; ++i, e += CB_THREADS) {
      float* pn = ws.dn + slot * d.dh + e;
      const float en = j > 0 ? *pn : 0.f;
      *pn = nacc[i];
      dot += nacc[i] * ns[slot * d.dh + e];
      nacc[i] = dc * nacc[i] + en;
    }
    for (int off = 16; off; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (threadIdx.x % 32 == 0)
      ws.dot[(slot * parts + part) * CB_WARPS + threadIdx.x / 32] = dot;
  }
}

// ------------------------------------------------------------ 4. scores


// key tiles of 64 that query tile qt of a chunk of c reaches
__host__ __device__ __forceinline__ int key_tiles(int qt, int c) {
  const int reach = TILE * (qt + 1) < c ? TILE * (qt + 1) : c;
  return (reach + KEYS - 1) / KEYS;
}

// the tile pairs of a chunk: each query tile qt with its key tiles kt
__host__ __device__ __forceinline__ int tile_pairs(int nt, int c) {
  int n = 0;
  for (int qt = 0; qt < nt; ++qt) n += key_tiles(qt, c);
  return n;
}

// the (query tile qt, key tile kt) pair p of a chunk's causal tiles
__device__ __forceinline__ void tile_pair(int p, int c, int& qt, int& kt) {
  qt = 0;
  while (p >= key_tiles(qt, c)) p -= key_tiles(qt++, c);
  kt = p;
}

// x = pair + tile_pairs (chunk + nc bh): P = q k^T and dnum v^T over the
// full depth for 128 queries x 64 keys; S = scale P D, dS = dnum v^T +
// ddsum, dP' = scale dS D, da = dS S (0 off s <= l < c); S and dP' stored
// (the tile whole, zeros included), da's row and column sums.  64 keys a
// tile: twice the blocks of 128-key tiles, which at xlstm-125m's training
// batch (192 blocks) fill the card's 132 SMs a wave and a half.
__global__ void __launch_bounds__(THREADS, 1)
mlstm_bwd_scores(const __grid_constant__ Maps m,
                 const float* __restrict__ li,
                 const float* __restrict__ gates, Workspace ws, Dims d) {
  __shared__ uint64_t full[STAGES];
  Ring ring{full, 0, 0};
  ring_init(full);
  const Frag f;
  const int pairs = tile_pairs(d.nt, d.c);
  int qt, kt;
  tile_pair(blockIdx.x % pairs, d.c, qt, kt);
  const int z = blockIdx.x / pairs, j = z % d.nc, bh = z / d.nc;
  const int r0 = qt * TILE, s0 = kt * KEYS;
  const size_t t0 = (size_t)bh * d.L + (size_t)j * d.c;
  const int mvalid = d.c - r0;
  float p[KEYS / 2] = {}, dv[KEYS / 2] = {};
  const Seg sp{{&m.q, z, false}, r0, {&m.k, z, false}, s0, 0, d.dh};
  const Seg sv{{&m.dnum, z, false}, r0, {&m.v, z, false}, s0, 0, d.dh};
  prime<KEYS>(ring, sp);
  prefetch(sv);
  __syncthreads();                              // the ring's barriers
  product<KEYS>(p, ring, sp, mvalid, nullptr, nullptr, &sv);
  product<KEYS>(dv, ring, sv, mvalid);
  // per row g - m_t and ddsum, per key li - g (D = exp of their sum), then
  // da's column sums (8 x 64), in the planes' room, which the products
  // have left free
  float* const rowa = planes();
  float* const rowd = rowa + TILE;
  float* const keya = rowd + TILE;
  float(*const red)[KEYS] = reinterpret_cast<float(*)[KEYS]>(keya + KEYS);
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const bool rin = r0 + i < d.c;
    rowa[i] = rin ? gates[t0 + r0 + i] - gates[d.plane() + t0 + r0 + i]
                  : 0.f;
    rowd[i] = rin ? ws.ddsum[t0 + r0 + i] : 0.f;
    if (i < KEYS) {
      const bool kin = s0 + i < d.c;
      keya[i] = kin ? li[t0 + s0 + i] - gates[t0 + s0 + i] : 0.f;
    }
  }
  __syncthreads();
  const size_t slot = (size_t)bh * d.nc + j;
  float* Sb = ws.S + slot * d.cp * d.cp;
  float* dPb = ws.dP + slot * d.cp * d.cp;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < KEYS / 2; i += 2) {
    float sv[2], dpv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int rr = f.row(i + u), cc = f.col(i + u);
      const int l = r0 + rr, s = s0 + cc;
      const bool on = l < d.c && s <= l;
      // D = exp((g_l - m_t[l]) + (li_s - g_s)) <= 1, on the SFU
      const float D = on ? hopper::exp2_approx((rowa[rr] + keya[cc]) *
                                               1.44269504088896341f)
                         : 0.f;
      const float S = p[i + u] * d.scale * D;
      const float dS = on ? dv[i + u] + rowd[rr] : 0.f;
      sv[u] = S;
      dpv[u] = d.scale * (dS * D);
      p[i + u] = dS * S;                        // da, in P's room
      rs[(i >> 1) & 1] += p[i + u];
    }
    const size_t at = (size_t)(r0 + f.row(i)) * d.cp + s0 + f.col(i);
    *reinterpret_cast<float2*>(Sb + at) = make_float2(sv[0], sv[1]);
    *reinterpret_cast<float2*>(dPb + at) = make_float2(dpv[0], dpv[1]);
  }
  // da's row sums: a warp holds whole rows, a quad one row's columns
  const int nk = KEY_TILES * d.nt;
  float* rowp = ws.rowp + (slot * d.nt + qt) * nk * TILE + (size_t)kt * TILE;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float s = quad_sum(rs[h]);
    if (f.tq == 0) rowp[f.m0 + 8 * h] = s;
  }
  // column sums: a warp's 16 rows by shuffles, then the 8 warps in order
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < KEYS / 2; i += 4)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float c = p[i + u] + p[i + u + 2];
      c += __shfl_xor_sync(0xffffffffu, c, 4);
      c += __shfl_xor_sync(0xffffffffu, c, 8);
      c += __shfl_xor_sync(0xffffffffu, c, 16);
      if (threadIdx.x % 32 < 4) red[warp][f.col(i + u)] = c;
    }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < KEYS) {
    float cs = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) cs += red[w][t];
    ws.colp[((slot * nk + kt) * d.nt + qt) * KEYS + t] = cs;
  }
}

// ------------------------------------------------------------ 5. products

// The 128 x N strip (rows r0.. of the chunk, columns col0..) of dq (kind
// 0), dk (1) or dv (2).  First y, the inter or state term, with the row
// factor taken into A and the rank-one term as the accumulator's start
// (no instruction but a wgmma writes the accumulator between the two
// products): dq's y = (w dnum) C_p^T + w ddsum n_p, dk's y = (scale wk
// v) dC'^T + scale wk dn', dv's y = (scale wk k) dC'; with its gate term
// (q or k) . y over these columns.  Then the intra product added on top:
// dP' k (dq), dP'^T q (dk), S^T dnum (dv), over the causal tokens.
// rows[m]: A's row factor, w_l (dq) or scale wk_s (dk, dv); rows[128 + m]
// times vec[n], the accumulator's start: w_l ddsum_l n_p (dq), scale
// wk_s dn' (dk), 0 (dv).
template <int N>
__device__ __forceinline__ void products_body(
    const Maps& m, Ring& ring, const float* q, const float* k,
    const float* gates, const float* states, Workspace ws, const Dims& d,
    float* out, float* rows, float* vec, int kind, int r0, int cs, int j,
    int bh) {
  const Frag f;
  const int col0 = WIDE * cs;
  const size_t t0 = (size_t)bh * d.L + (size_t)j * d.c;
  const int slot = bh * d.nc + j;
  const size_t o = t0 * d.dh;
  const int mvalid = d.c - r0;
  const bool has_inter = kind == 0 ? j > 0 : j < d.nc - 1;
  const Seg inter{{kind == 0 ? &m.dnum : (kind == 1 ? &m.v : &m.k), slot,
                   false},
                  r0,
                  {kind == 0 ? &m.C : (kind == 1 ? &m.dC : &m.dCt), slot,
                   kind == 2},
                  col0, 0, d.dh};
  const Seg intra =
      kind == 0
          ? Seg{{&m.dP, slot, false}, r0, {&m.kt, slot, true}, col0, 0,
                round_up(min(r0 + TILE, d.c), KS)}
          : Seg{{kind == 1 ? &m.dPt : &m.St, slot, true}, r0,
                {kind == 1 ? &m.qt : &m.dnumt, slot, true}, col0, r0,
                round_up(d.c, KS)};
  if (has_inter)
    prime<N>(ring, inter);
  prefetch(intra);
  if (!has_inter)
    prime<N>(ring, intra);
  const float* np = states + d.slots() * d.dh * d.dh + (size_t)slot * d.dh;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const bool in = r0 + i < d.c;
    const float w =
        in ? gates[(kind == 0 ? 2 : 3) * d.plane() + t0 + r0 + i] : 0.f;
    rows[i] = kind == 0 ? w : d.scale * w;
    rows[TILE + i] = kind == 0 ? (in ? w * ws.ddsum[t0 + r0 + i] : 0.f)
                               : (kind == 1 ? d.scale * w : 0.f);
  }
  for (int i = threadIdx.x; i < N; i += THREADS)
    vec[i] = kind == 0   ? np[col0 + i]
             : kind == 1 ? ws.dn[(size_t)slot * d.dh + col0 + i]
                         : 0.f;
  __syncthreads();
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    acc[i] = rows[TILE + f.row(i)] * vec[f.col(i)];
  if (has_inter)
    product<N>(acc, ring, inter, mvalid, nullptr, rows, &intra);
  if (kind < 2) {                               // the gate term
    const float* gate = kind == 0 ? q + o : k + o;
    float g[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N / 2; i += 2) {
      const int l = r0 + f.row(i);
      if (l < d.c) {
        const float2 x = *reinterpret_cast<const float2*>(
            gate + (size_t)l * d.dh + col0 + f.col(i));
        g[(i >> 1) & 1] += x.x * acc[i] + x.y * acc[i + 1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = quad_sum(g[h]);
      const int l = r0 + f.m0 + 8 * h;
      if (f.tq == 0 && l < d.c)
        (kind == 0 ? ws.xw : ws.xk)[(t0 + l) * d.ncs + cs] = s;
    }
  }
  product<N>(acc, ring, intra, mvalid);
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int l = r0 + f.row(i);
    if (l < d.c)
      *reinterpret_cast<float2*>(out + (t0 + l) * d.dh + col0 + f.col(i)) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// x = kind + 3 (row strip + nt (column strip + ncs (chunk + nc bh)))
__global__ void __launch_bounds__(THREADS, 1)
mlstm_bwd_products(const __grid_constant__ Maps m,
                   const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ gates,
                   const float* __restrict__ states, Workspace ws, Dims d,
                   float* __restrict__ dq, float* __restrict__ dk,
                   float* __restrict__ dv) {
  __shared__ float rows[2 * TILE], vec[WIDE];
  __shared__ uint64_t full[STAGES];
  Ring ring{full, 0, 0};
  ring_init(full);
  int x = blockIdx.x;
  const int kind = x % 3;
  x /= 3;
  const int rt = x % d.nt;
  x /= d.nt;
  const int cs = x % d.ncs;
  x /= d.ncs;
  const int j = x % d.nc, bh = x / d.nc;
  float* out = kind == 0 ? dq : (kind == 1 ? dk : dv);
  switch (d.width(cs)) {
    case WIDE:
      products_body<WIDE>(m, ring, q, k, gates, states, ws, d, out, rows, vec,
                          kind, rt * TILE, cs, j, bh);
      break;
    case 128:
      products_body<128>(m, ring, q, k, gates, states, ws, d, out, rows, vec,
                         kind, rt * TILE, cs, j, bh);
      break;
    default:
      products_body<64>(m, ring, q, k, gates, states, ws, d, out, rows, vec,
                        kind, rt * TILE, cs, j, bh);
  }
}

// ------------------------------------------------------------ 6. gates

// a block a chunk, a thread a token: dg = rowsum(da) - colsum(da) + q .
// dq_inter - k . dk_state, the chunk's last token also sum_s k_s .
// dk_state_s + decay (<dC', C_p> + <dn', n_p>); dli = colsum(da) + k .
// dk_state; dlf = dg summed from the chunk's end
__global__ void __launch_bounds__(MAX_C)
mlstm_bwd_gates(const float* __restrict__ gates, Workspace ws, Dims d,
                float* __restrict__ dli, float* __restrict__ dlf) {
  __shared__ float dg[MAX_C], red[MAX_C / 32];
  const int j = blockIdx.x % d.nc, bh = blockIdx.x / d.nc;
  const size_t slot = (size_t)bh * d.nc + j;
  const size_t t0 = (size_t)bh * d.L + (size_t)j * d.c;
  const int l = threadIdx.x;
  const int nk = KEY_TILES * d.nt;
  float xk = 0.f, g = 0.f;
  if (l < d.c) {
    // da's row sums over the key tiles that row tile l / 128 reaches, its
    // column sums over the query tiles that reach key tile l / KEYS
    const int lt = l / TILE, ks = l / KEYS;
    float rs = 0.f, cs = 0.f, xw = 0.f;
    for (int kt = 0; kt < key_tiles(lt, d.c); ++kt)
      rs += ws.rowp[((slot * d.nt + lt) * nk + kt) * TILE + l % TILE];
    for (int qt = ks / KEY_TILES; qt < d.nt; ++qt)
      cs += ws.colp[((slot * nk + ks) * d.nt + qt) * KEYS + l % KEYS];
    for (int st = 0; st < d.ncs; ++st) {
      xw += ws.xw[(t0 + l) * d.ncs + st];
      xk += ws.xk[(t0 + l) * d.ncs + st];
    }
    g = ((rs - cs) + xw) - xk;
    dli[t0 + l] = cs + xk;
  }
  const float sxk = block_sum(xk, red);
  // the decay term's partials, a thread every MAX_C-th
  const int nparts = combine_parts(d.dh, d.cvec) * CB_WARPS;
  float part = 0.f;
  for (int p = l; p < nparts; p += MAX_C)
    part += ws.dot[slot * nparts + p];
  const float dot = block_sum(part, red);
  if (l < d.c) dg[l] = g;
  __syncthreads();
  if (l == 0) {
    dg[d.c - 1] += sxk + gates[4 * d.plane() + slot] * dot;
    float acc = 0.f;
    for (int i = d.c - 1; i >= 0; --i) {
      acc += dg[i];
      dlf[t0 + i] = acc;
    }
  }
}

Dims dims(int B, int H, int L, int dh, int c, float scale) {
  Dims d;
  d.BH = B * H, d.L = L, d.dh = dh, d.c = c, d.nc = L / c;
  d.nt = (c + TILE - 1) / TILE, d.cp = d.nt * TILE;
  d.ncs = (dh + WIDE - 1) / WIDE;
  d.cvec = d.BH * combine_parts(dh, 4) >= 2 * 132 ? 4 : 1;
  d.scale = scale;
  return d;
}

bool takes(int B, int H, int L, int dh, int c) {
  return B >= 1 && H >= 1 && L >= 1 && dh >= 64 && dh % 64 == 0 &&
         dh <= MAX_DH && c >= 1 && c <= MAX_C && L % c == 0 &&
         (long long)B * H * L * (dh / 64) * 3 < 0x7fffffffLL;
}

// the backward's TMA descriptors (Maps) over its inputs and workspace
bool make_maps(Maps& m, const Dims& d, const void* q, const void* k,
               const void* v, const void* states, const Workspace& w) {
  const uint64_t tok[3] = {(uint64_t)d.dh, (uint64_t)d.c, d.slots()};
  const uint64_t tok_s[2] = {4ull * d.dh, 4ull * d.dh * d.c};
  const uint64_t sq[3] = {(uint64_t)d.dh, (uint64_t)d.dh, d.slots()};
  const uint64_t sq_s[2] = {4ull * d.dh, 4ull * d.dh * d.dh};
  const uint64_t sc[3] = {(uint64_t)d.cp, (uint64_t)d.cp, d.slots()};
  const uint64_t sc_s[2] = {4ull * d.cp, 4ull * d.cp * d.cp};
  const uint32_t direct[3] = {KS, 64, 1}, trans[3] = {KS, 32, 1};
  auto enc = [](CUtensorMap* map, const void* base, const uint64_t* dims,
                const uint64_t* strides, const uint32_t* box) {
    return hopper::encode_map(map, base, 3, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  };
  return enc(&m.q, q, tok, tok_s, direct) &&
         enc(&m.k, k, tok, tok_s, direct) &&
         enc(&m.v, v, tok, tok_s, direct) &&
         enc(&m.dnum, w.dnum, tok, tok_s, direct) &&
         enc(&m.C, states, sq, sq_s, direct) &&
         enc(&m.dC, w.dC, sq, sq_s, direct) &&
         enc(&m.dP, w.dP, sc, sc_s, direct) &&
         enc(&m.qt, q, tok, tok_s, trans) &&
         enc(&m.kt, k, tok, tok_s, trans) &&
         enc(&m.dnumt, w.dnum, tok, tok_s, trans) &&
         enc(&m.dCt, w.dC, sq, sq_s, trans) &&
         enc(&m.St, w.S, sc, sc_s, trans) &&
         enc(&m.dPt, w.dP, sc, sc_s, trans);
}

}  // namespace

// The workspace, in floats, of a backward at these shapes; -1 where the
// kernel does not take them.
extern "C" long long mlstm_chunk_bwd_workspace(int B, int H, int L, int dh,
                                               int c) {
  if (!takes(B, H, L, dh, c)) return -1;
  return (long long)carve(nullptr, dims(B, H, L, dh, c, 1.f)).floats;
}

// q/k/v/h/dh (B, H, L, dh), li (B, H, L), and the forward's saves: gates
// (its 4 B H L + B H (L/c) floats), states (its C_j and n_j of every
// chunk: B H (L/c) (dh^2 + dh) floats, the forward run in one span of all
// the chunks) and dsum (B, H, L) -> dq, dk, dv (B, H, L, dh), dli, dlf
// (B, H, L); all f32, contiguous and 16-byte aligned; dh a multiple of 64
// up to 512, c dividing L and at most 256, `scale` the forward's.  `ws`
// holds mlstm_chunk_bwd_workspace floats.  Returns a cudaError_t.
extern "C" int mlstm_chunk_bwd_f32(const void* q, const void* k,
                                   const void* v, const void* li,
                                   const void* h, const void* dh_out,
                                   const void* gates, const void* states,
                                   const void* dsum, void* ws, void* dq,
                                   void* dk, void* dv, void* dli, void* dlf,
                                   int B, int H, int L, int dh, int c,
                                   float scale, long long ws_floats,
                                   void* stream) {
  if (!takes(B, H, L, dh, c)) return (int)cudaErrorInvalidValue;
  const Dims d = dims(B, H, L, dh, c, scale);
  const Workspace w = carve((float*)ws, d);
  if (ws_floats < (long long)w.floats) return (int)cudaErrorInvalidValue;
  cudaError_t rc;
  if ((rc = hopper::allow_smem<mlstm_bwd_inter>(SMEM_BYTES)) != cudaSuccess ||
      (rc = hopper::allow_smem<mlstm_bwd_scores>(SMEM_BYTES)) !=
          cudaSuccess ||
      (rc = hopper::allow_smem<mlstm_bwd_products>(SMEM_BYTES)) !=
          cudaSuccess)
    return (int)rc;
  Maps m;
  if (!make_maps(m, d, q, k, v, states, w)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* gt = (const float*)gates;
  const float* sts = (const float*)states;
  const size_t rows = d.plane();
  mlstm_bwd_prep<<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)),
                   THREADS, 0, st>>>((const float*)h, (const float*)dh_out,
                                     gt, (const float*)dsum, w, d);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  if (d.nc > 1) {
    const int ndt = (dh + TILE - 1) / TILE;
    mlstm_bwd_inter<<<(unsigned)(ndt * d.ncs * (d.nc - 1) * d.BH), THREADS,
                      SMEM_BYTES, st>>>(m, gt, w, d);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  }
  if (d.cvec == 4)
    mlstm_bwd_combine<4><<<(unsigned)(combine_parts(dh, 4) * d.BH),
                           CB_THREADS, 0, st>>>(gt, sts, w, d);
  else
    mlstm_bwd_combine<1><<<(unsigned)(combine_parts(dh, 1) * d.BH),
                           CB_THREADS, 0, st>>>(gt, sts, w, d);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  mlstm_bwd_scores<<<(unsigned)(tile_pairs(d.nt, d.c) * d.nc * d.BH),
                     THREADS, SMEM_BYTES, st>>>(m, (const float*)li, gt, w,
                                                d);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  mlstm_bwd_products<<<(unsigned)(3 * d.nt * d.ncs * d.nc * d.BH), THREADS,
                       SMEM_BYTES, st>>>(m, (const float*)q, (const float*)k,
                                         gt, sts, w, d, (float*)dq,
                                         (float*)dk, (float*)dv);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  mlstm_bwd_gates<<<(unsigned)(d.nc * d.BH), MAX_C, 0, st>>>(
      gt, w, d, (float*)dli, (float*)dlf);
  return (int)cudaGetLastError();
}
