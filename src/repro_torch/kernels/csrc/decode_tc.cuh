// The one-token decode body on Hopper's tensor cores, split over a thread
// block cluster: the row-cache decode (decode_attention.cu, full cache and
// ring), the paged decode over a bf16 or an int8 page pool
// (paged_attention.cu) and one shard's unnormalized partial over its slice
// of a sharded bank (paged_partial.cu).  The decode counterpart of
// verify_tc.cuh.
//
// What it computes: the G query heads (G <= 16) of one kv head of batch
// row b attend, in one softmax, over the row's keys t < n = min(pos[b],
// cap - 1) + 1, where cap is the keys a row holds (S, or P * page).  That
// is also the ring's set: the JAX ring mask (idx <= pos % S) | (pos >= S)
// admits slots 0 .. min(pos, S - 1).
//
// What bounds it: bytes.  Each live key's K and V rows are read once for
// all G heads, about 2 * G flops a byte, far under the card's ~295.
//
// The design, for that:
//   * Split-K inside a cluster.  Grid (splits, Hkv, B), cluster (splits, 1,
//     1), splits in {1, 2, 4, 8}, chosen by the wrapper from cap alone
//     (kernels.decode_splits: the most that leave each block at least two
//     tiles; never pos, so a call needs no device-to-host read and a CUDA
//     graph can capture it, and never B, so a row's output does not
//     depend on its batch).  The cap's T = ceil(cap / 64) key tiles are
//     cut into runs by key index: block r folds tiles [r T / splits, (r +
//     1) T / splits), clipped to n; a run past n loads nothing and keeps
//     the empty state (0, -1e30, 0).  The runs do not depend on page ids
//     or the pool, so a pool holding a row cache's keys gives the row
//     kernel's output bit for bit.  After a cluster barrier each block
//     merges every block's (acc, m, l) through distributed shared memory,
//     in rank order, for its share of the outputs and writes them
//     normalized, in bf16: one launch, no global workspace.
//   * Asynchronous tile copies.  K and V tiles of 64 keys go through a
//     ring of 3 stages (4 at hd <= 64) of cp.async (16 bytes a thread) in
//     dynamic shared memory, so each SM holds tens of KB in flight.  Each
//     16-byte chunk finds its own address (table[b, t / page] for a pool,
//     the run's page ids staged in shared memory while pos is read), so
//     any page size works.  A chunk of a key at or past n is
//     zero-filled and never read, so an unwritten slot, a ring slot past
//     pos or the park page cannot reach P V, not even through 0 x NaN.
//     No TMA: its descriptors would be encoded on the host every call.
//   * Products on the tensor cores: mma.sync m16n8k16, bf16 in, f32 out.
//     q's heads are the 16 M rows (rows past G are zero), each of 4 warps
//     takes 16 keys of every tile: S = Q K^T from ldmatrix fragments, the
//     online softmax in f32 registers (the softmax scale applied to the
//     f32 scores, in the log2 domain), then P V with P split into a bf16
//     high part and the bf16 rounding of the rest (two products), so
//     rounding P costs nothing measurable against the one-ulp limit of
//     the ring records.  Rows are padded by 16 bytes in shared memory,
//     which keeps ldmatrix free of bank conflicts.
//   * int8 pools: codes are copied as bytes and converted to bf16 in
//     shared memory (exact for |code| <= 128); the k scales multiply
//     score columns, the v scales P before it is split, as verify_tc.cuh.
//   * One shard's partial (PART): the same keys, runs and arithmetic over
//     a table of GLOBAL page ids, of which the shard owns [base, base +
//     L); a key on a page it does not own is zero-filled and scored -inf,
//     like a key past n, so it is never read.  The merged state leaves
//     unnormalized in f32 (acc, m in the natural-log domain, l), a block
//     that owns no key as exactly (0, -1e30, 0).  A row whose pages all
//     lie on one shard therefore ends, after the caller's pmax/psum and
//     division, at the global decode's output bit for bit.
// The 4 warps' states merge in shared memory (reusing the stages), then
// the cluster's.  One instantiation per head width serves every G <= 16.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace repro {
namespace dtc {
// internal linkage, as verify_tc.cuh: each library keeps its own kernels
// and their once-only shared-memory opt-in
namespace {

namespace cg = cooperative_groups;

constexpr int TK = 64;                  // keys of a tile
constexpr int WARPS = 4;                // warp w: keys 16 w .. 16 w + 15
constexpr int THREADS = 32 * WARPS;
constexpr int MAXG = 16;                // query heads of a launch: M rows
constexpr int MAX_SPLITS = 8;           // blocks of a cluster, at most
constexpr int PG_MAX = 64;              // page ids a block stages

template <int HD, bool QUANT, bool PART>
struct Cfg {
  static constexpr int STAGES = HD <= 64 ? 4 : 3;
  static constexpr int ROWB = 2 * HD + 16;      // bytes of a bf16 row
  static constexpr int CROWB = HD + 16;         // bytes of an int8 row
  static constexpr int KV_B = TK * (QUANT ? CROWB : ROWB);
  static constexpr int SC_B = QUANT ? 2 * TK * 4 : 0;   // k, v scales
  static constexpr int OWN_B = PART ? TK * 4 : 0;       // keys read
  static constexpr int STAGE_B = 2 * KV_B + SC_B + OWN_B;
  static constexpr int CONV_B = QUANT ? 2 * TK * ROWB : 0;
  static constexpr int Q_B = MAXG * ROWB;
  static constexpr int LOOP_B = STAGES * STAGE_B + CONV_B;
  // after the loop: each warp's (acc, m, l), then the block's
  static constexpr int PART_F = WARPS * MAXG * (HD + 2);
  static constexpr int STATE_F = MAXG * (HD + 2);
  static_assert(4 * (PART_F + STATE_F) <= LOOP_B, "the merge fits");
  static constexpr int SMEM = Q_B + LOOP_B;
};

// Everything a decode launch reads.
struct Args {
  const bf16* q;          // (B, Hkv, G, hd)
  const void* k;          // bf16 store or int8 codes: (pages, Hkv, page, hd)
  const void* v;
  const float* ks;        // int8 pool: (pages, Hkv, page) scales
  const float* vs;
  const int* table;       // (B, P) page ids; nullptr: row cache (page = S)
  const int* pos;         // (B,)
  bf16* out;              // (B, Hkv, G, hd)
  int Hkv, G, P, page;
  int cap;                // keys a row holds: S, or P * page
  float scale_log2;       // softmax scale * log2(e)
  // one shard's partial: it owns global page ids [base, base + L) (its
  // slice of k/v and the scales); acc (B, Hkv, G, hd), m, l (B, Hkv, G)
  int base, L;
  float* acc;
  float* m;
  float* l;
};

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// four 8x8 bf16 matrices from shared memory, row addresses from lanes
// 8i .. 8i + 7 for matrix i; TRANS: each transposed
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(hopper::smem_u32(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(hopper::smem_u32(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD, bool QUANT, bool PART>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const Args a) {
  using C = Cfg<HD, QUANT, PART>;
  constexpr int ST = C::STAGES, ROWB = C::ROWB;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* q_s = smem;                          // (16, hd) bf16, padded rows
  uint8_t* loop_s = smem + C::Q_B;              // stages, then the merge
  cg::cluster_group cluster = cg::this_cluster();

  const int split = blockIdx.x, splits = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * a.Hkv + h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4, grp = lane / 4;
  const int T = (a.cap + TK - 1) / TK;
  const int t0 = split * T / splits;            // this block's run of tiles
  const int t1c = (split + 1) * T / splits;
  const int* tb = a.table == nullptr ? nullptr : a.table + (size_t)b * a.P;

  // the pool page that holds a table entry: its id, or for a partial its
  // local id in the shard's slice, -1 where the shard does not own it
  auto local = [&](int pid) -> int {
    if constexpr (PART) {
      const int lp = pid - a.base;
      return lp >= 0 && lp < a.L ? lp : -1;
    }
    return pid;
  };
  // a pool's page ids for the run (its capacity, so pos is not waited
  // for), staged in shared memory once where they fit
  __shared__ int pid_s[PG_MAX];
  int pg0 = 0, npg = 0;
  if (tb != nullptr && t1c > t0) {
    pg0 = t0 * TK / a.page;
    npg = (min(t1c * TK, a.cap) - 1) / a.page - pg0 + 1;
    if (npg <= PG_MAX)
      for (int i = tid; i < npg; i += THREADS) pid_s[i] = local(tb[pg0 + i]);
  }
  const bool staged = npg <= PG_MAX;

  // q's G heads, zero rows up to 16
  const bf16* qg = a.q + bh * a.G * HD;
  for (int i = tid; i < MAXG * HD / 8; i += THREADS) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r < a.G) u = *reinterpret_cast<const uint4*>(qg + r * HD + c * 8);
    *reinterpret_cast<uint4*>(q_s + r * ROWB + c * 16) = u;
  }
  const int n = min(a.pos[b], a.cap - 1) + 1;   // keys 0 .. n - 1
  const int t1 = min(t1c, (n + TK - 1) / TK);
  const int NT = max(t1 - t0, 0);
  __syncthreads();                              // page ids staged

  // the flat (page, head, slot) row of key t, -1 on a page a partial's
  // shard does not own; a row cache is a store whose page bh holds the
  // row's S slots
  auto flat = [&](int t) -> long long {
    if (tb == nullptr) return (long long)(bh * a.page + t);
    const int pg = t / a.page;
    const int pid = staged ? pid_s[pg - pg0] : local(tb[pg]);
    if (PART && pid < 0) return -1;
    return ((long long)pid * a.Hkv + h) * a.page + (t - pg * a.page);
  };
  // the rows of a tile that lies in one page (or a row cache) are one run
  auto in_one_page = [&](int k0) {
    return tb == nullptr || k0 % a.page + TK <= a.page;
  };
  // tile i of the run into its stage; keys at or past n (or not owned)
  // zero-filled
  auto issue = [&](int i) {
    uint8_t* kst = loop_s + (i % ST) * C::STAGE_B;
    uint8_t* vst = kst + C::KV_B;
    const int k0 = (t0 + i) * TK;
    constexpr int EB = QUANT ? 1 : 2;           // bytes of an element
    constexpr int CPR = HD * EB / 16;           // 16-byte chunks a row
    constexpr int RB = QUANT ? C::CROWB : ROWB;
    const uint8_t* kg = static_cast<const uint8_t*>(a.k);
    const uint8_t* vg = static_cast<const uint8_t*>(a.v);
    const bool one = in_one_page(k0);
    const long long base = one ? flat(k0) : 0;
    // key k0 + r's row, -1 where it is not read
    auto row_of = [&](int r) -> long long {
      if (k0 + r >= n) return -1;
      if (!one) return flat(k0 + r);
      return PART && base < 0 ? -1 : base + r;
    };
#pragma unroll
    for (int j = 0; j < TK * CPR / THREADS; ++j) {
      const int e = tid + j * THREADS, r = e / CPR, c = e % CPR;
      const long long row = row_of(r);
      const bool in = row >= 0;
      const size_t off = in ? (size_t)row * HD * EB + c * 16 : 0;
      cp_async16(kst + r * RB + c * 16, kg + off, in ? 16 : 0);
      cp_async16(vst + r * RB + c * 16, vg + off, in ? 16 : 0);
    }
    if (tid < TK && (QUANT || PART)) {
      const long long row = row_of(tid);
      const bool in = row >= 0;
      if constexpr (QUANT) {
        float* kss = reinterpret_cast<float*>(vst + C::KV_B);
        const size_t f = in ? (size_t)row : 0;
        cp_async4(kss + tid, a.ks + f, in ? 4 : 0);
        cp_async4(kss + TK + tid, a.vs + f, in ? 4 : 0);
      }
      if constexpr (PART)
        reinterpret_cast<int*>(vst + C::KV_B + C::SC_B)[tid] = in;
    }
  };

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // ldmatrix row and column of this lane: q (A), K (B), V (B, transposed)
  const int qr = (lane % 8) + 8 * ((lane / 8) % 2), qc = 8 * (lane / 16);
  const int kr = 16 * warp + (lane % 8) + 8 * (lane / 16);
  const int kc = 8 * ((lane / 8) % 2);
  const int vr = 16 * warp + qr, vc = qc;

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < NT) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < NT; ++i) {
    cp_async_wait<ST - 2>();                    // tile i landed (this thread)
    __syncthreads();                            // ... every thread's; tile
    if (i + ST - 1 < NT) issue(i + ST - 1);     // i - 1's stage is free
    cp_async_commit();
    const uint8_t* kt = loop_s + (i % ST) * C::STAGE_B;
    const uint8_t* vt = kt + C::KV_B;
    const float* kss = reinterpret_cast<const float*>(vt + C::KV_B);
    const int* own = reinterpret_cast<const int*>(vt + C::KV_B + C::SC_B);
    if constexpr (QUANT) {                      // codes -> bf16, exactly
      uint8_t* conv = loop_s + ST * C::STAGE_B;
      constexpr int CPR = HD / 16;
      for (int e = tid; e < 2 * TK * CPR; e += THREADS) {
        const int which = e / (TK * CPR), r = (e / CPR) % TK, c = e % CPR;
        const uint4 u = *reinterpret_cast<const uint4*>(
            kt + which * C::KV_B + r * C::CROWB + c * 16);
        const int8_t* c8 = reinterpret_cast<const int8_t*>(&u);
        uint4 w[2];
        uint32_t* ww = reinterpret_cast<uint32_t*>(w);
#pragma unroll
        for (int x = 0; x < 8; ++x)
          ww[x] = hopper::pack_bf16((float)c8[2 * x], (float)c8[2 * x + 1]);
        uint8_t* dst = conv + which * TK * ROWB + r * ROWB + c * 32;
        *reinterpret_cast<uint4*>(dst) = w[0];
        *reinterpret_cast<uint4*>(dst + 16) = w[1];
      }
      __syncthreads();
      kt = conv;
      vt = conv + TK * ROWB;
    }

    // S = Q K^T over this warp's 16 keys: n-blocks of keys 0-7 and 8-15
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4<false>(qa, q_s + qr * ROWB + (kk * 16 + qc) * 2);
      ldsm_x4<false>(kb, kt + kr * ROWB + (kk * 16 + kc) * 2);
      mma16816(s[0], qa, kb[0], kb[1]);
      mma16816(s[1], qa, kb[2], kb[3]);
    }

    // online softmax, log2 domain; thread rows grp (e < 2) and grp + 8
    const int k0 = (t0 + i) * TK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * warp + 8 * j + 2 * quad + (e & 1);
        float x = s[j][e];
        if constexpr (QUANT) x *= kss[key];
        x *= a.scale_log2;
        if (PART ? !own[key] : k0 + key >= n) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
    // P as A fragments (rows grp, grp + 8; keys 2 quad + {0, 1}, + 8),
    // split into a bf16 high part and the bf16 rounding of the rest
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p0 = exp2f(s[j][2 * r] - m[r]);
        float p1 = exp2f(s[j][2 * r + 1] - m[r]);
        l[r] += p0 + p1;
        if constexpr (QUANT) {
          const float* vss = kss + TK;
          const int key = 16 * warp + 8 * j + 2 * quad;
          p0 *= vss[key];
          p1 *= vss[key + 1];
        }
        const uint32_t hi = hopper::pack_bf16(p0, p1);
        const float2 hf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
        ph[2 * j + r] = hi;
        pl[2 * j + r] = hopper::pack_bf16(p0 - hf.x, p1 - hf.y);
      }
    // O += P V: 16 head dims (two n-blocks) a transposed ldmatrix
#pragma unroll
    for (int nb = 0; nb < HD / 16; ++nb) {
      uint32_t vb[4];
      ldsm_x4<true>(vb, vt + vr * ROWB + (nb * 16 + vc) * 2);
      mma16816(o[2 * nb], ph, vb[0], vb[1]);
      mma16816(o[2 * nb + 1], ph, vb[2], vb[3]);
      mma16816(o[2 * nb], pl, vb[0], vb[1]);
      mma16816(o[2 * nb + 1], pl, vb[2], vb[3]);
    }
  }

  // merge the 4 warps' states in the stages' memory ...
  cp_async_wait<0>();
  __syncthreads();
  float* pacc = reinterpret_cast<float*>(loop_s);      // (WARPS, 16, hd)
  float* pm = pacc + WARPS * MAXG * HD;                 // (WARPS, 16)
  float* pl_ = pm + WARPS * MAXG;
  float* st = pacc + C::PART_F;         // the block's: acc (16, hd), m, l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const int row = grp + 8 * r;
    if (row < a.G) {
      float* dst = pacc + (warp * MAXG + row) * HD + 2 * quad;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (quad == 0) {
        pm[warp * MAXG + row] = m[r];
        pl_[warp * MAXG + row] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < a.G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF, L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, pm[w * MAXG + g]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f(pm[w * MAXG + g] - M);
      L += pl_[w * MAXG + g] * c;
      A += pacc[(w * MAXG + g) * HD + d] * c;
    }
    st[i] = A;
    if (d == 0) {
      st[MAXG * HD + g] = M;
      st[MAXG * HD + MAXG + g] = L;
    }
  }

  // ... then the cluster's: block r writes outputs r * 128 + tid, ...,
  // merging every block's state through distributed shared memory (all
  // of an output's remote loads issued before any is used; a rank past
  // the cluster reads as the empty state, which adds exact zeros).  A
  // partial writes the state itself: m back in the natural-log domain, or
  // exactly -1e30 where no key was read
  cluster.sync();
  bf16* og = a.out + bh * a.G * HD;
  for (int i = split * THREADS + tid; i < a.G * HD; i += splits * THREADS) {
    const int g = i / HD;
    float mr[MAX_SPLITS], lr[MAX_SPLITS], ar[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      mr[r] = NEG_INF;
      lr[r] = ar[r] = 0.f;
      if (r < splits) {
        const float* rs = cluster.map_shared_rank(st, r);
        mr[r] = rs[MAXG * HD + g];
        lr[r] = rs[MAXG * HD + MAXG + g];
        ar[r] = rs[i];
      }
    }
    float M = NEG_INF, L = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) M = fmaxf(M, mr[r]);
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      const float c = exp2f(mr[r] - M);
      L += lr[r] * c;
      A += ar[r] * c;
    }
    if constexpr (PART) {
      a.acc[bh * a.G * HD + i] = A;
      if (i % HD == 0) {
        a.m[bh * a.G + g] = L > 0.f ? M * 0.6931471805599453f : NEG_INF;
        a.l[bh * a.G + g] = L;
      }
    } else {
      og[i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    }
  }
  cluster.sync();                       // no block leaves while read
}

// Launch one decode: grid (splits, Hkv, B) in clusters of `splits` blocks.
// `a` holds the rest; its scale is set here.
template <int HD, bool QUANT, bool PART>
int launch(Args a, int B, int splits, float scale, cudaStream_t stream) {
  using C = Cfg<HD, QUANT, PART>;
  if (a.G < 1 || a.G > MAXG || a.Hkv < 1 || a.Hkv > 65535 || B < 1 ||
      B > 65535 || a.page < 1 || a.cap < 1 || (PART && a.L < 1) ||
      (splits != 1 && splits != 2 && splits != 4 && splits != MAX_SPLITS))
    return (int)cudaErrorInvalidValue;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaError_t rc =
      hopper::allow_smem<decode_kernel<HD, QUANT, PART>>(C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.Hkv, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, decode_kernel<HD, QUANT, PART>, a);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// launch<HD, QUANT, PART> for head width hd (32, 64, 128 or 256)
template <bool QUANT, bool PART = false>
int dispatch(int hd, const Args& a, int B, int splits, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, QUANT, PART>(a, B, splits, scale, stream);
    case 64: return launch<64, QUANT, PART>(a, B, splits, scale, stream);
    case 128: return launch<128, QUANT, PART>(a, B, splits, scale, stream);
    case 256: return launch<256, QUANT, PART>(a, B, splits, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dtc
}  // namespace repro
