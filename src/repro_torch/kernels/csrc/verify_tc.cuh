// The multi-query verify body on Hopper's tensor cores (chunked prefill,
// speculative verify), shared by the row-cache verify (verify_attention.cu)
// and the paged verify over a bf16 or an int8 page pool
// (paged_attention.cu).
//
// What it computes: K block queries of one batch row at positions pos ..
// pos+K-1, each of the G query heads of a kv head, attend in ONE softmax
// over the cache as it stood BEFORE the block (keys t < pos; a ring: its
// min(pos, S) written slots, each masked by the position it holds against
// the query's window) joined with the block's own K keys, under the causal
// mask (key j <= query i) or the tree's ancestor bits (bit j of anc[i],
// K <= 31).
//
// The design is flash prefill's (flash_attention.cu) with another key
// range and mask.  One block per (128 score rows, kv head, batch row):
// score row r of a tile is block query qi0 + r / GC under query head
// g0 + r % GC, where GC = min(G, 128) heads and QPT = 128 / GC queries
// make a tile (a G that does not divide 128 leaves the tile's last rows
// dead; a G past 128 takes ceil(G / 128) head chunks).  Q lands in that
// order straight from the caller's (B, K, H, hd) tensor, through a 5-D TMA
// view (hd, G, Hkv, K, B) whose box is (atom, GC, 1, QPT, 1); the output
// is written straight into (B, K, H, hd).  Two consumer warpgroups own 64
// rows each; a producer warpgroup streams K and V tiles of BK keys through
// a ring of shared-memory stages, each completing on an mbarrier and
// released by the consumers: first the ceil(n / BK) cache tiles (n = the cache keys the row reads), then the
// block's tiles, up to the last block key any row of the tile sees.  A
// warpgroup skips the products of the block tiles past its own last
// query.  S = Q K^T runs as wgmma with both operands in shared memory
// (K-major); the online softmax (m, l) stays in registers; P is rounded to
// bf16 in registers in wgmma's A-fragment layout and P V runs as wgmma
// with V MN-major (the transpose bit), the next tile's scores issued
// before this tile's P V.
//
// Where the keys come from:
//   * the cache's full tiles, bf16: TMA through a 4-D view of the store,
//     (hd, page, Hkv, pages); a row cache is a store whose row b is page
//     b of S slots, a pool is read page by page (table[b, t / page], one
//     load per R = gcd(page, BK) rows, so a load never crosses a page and
//     every load lands on a whole swizzle period);
//   * the cache's last, partial tile, and every tile of a pool whose page
//     is not a multiple of 8 rows: the producer warpgroup copies keys t < n
//     itself into the same swizzled layout and zeroes the rest, so a slot
//     at or past pos (and a page it does not need, the park page among
//     them) is never read and a poisoned one cannot reach P V;
//   * an int8 pool: the producer warpgroup loads the codes, converts them
//     to bf16 (exact for |code| <= 128) into the swizzled layout and
//     stages each key's f32 scales; a consumer multiplies each score
//     column by its k scale after Q K^T and each probability by its v
//     scale before P is rounded, so the scales never touch an operand;
//   * the block's own keys and values (B, K, Hkv, hd): TMA through a 4-D
//     view (hd, K, Hkv, B); keys past K arrive as zeros.
// Rows and keys are the same in every loader, so paged and row verify
// over the same keys in the same order give bitwise equal results.
//
// Numerics: f32 scores and softmax state, P rounded to bf16 before P V
// (as flash and SDPA).  On a ring, P is split into a bf16 high part and
// the bf16 rounding of the rest, and P V runs twice (SPLIT_P), so that
// the ring's records, held elementwise to one bf16 ulp of the plain
// version over 4096 keys, see little more than the output's rounding.
#pragma once

#include <string.h>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace repro {
namespace vtc {
// internal linkage: each library that includes this header keeps its own
// kernels and their one-time shared-memory opt-in (allow_smem's flag),
// which a symbol shared between two loaded libraries would otherwise
// merge
namespace {

constexpr int BQ = 128;                 // score rows of a block
constexpr int CONSUMERS = 256;          // two warpgroups of 64 rows

template <int HD>
struct Cfg {
  static constexpr int BK = HD <= 64 ? 128 : 64;       // keys of a tile
  static constexpr int STAGES = HD == 256 ? 2 : 3;
  static constexpr int ATOM = HD == 32 ? 32 : 64;       // columns of an atom
  static constexpr int ROWB = 2 * ATOM;                 // bytes of an atom row
  static constexpr int ATOMS = HD / ATOM;
  static constexpr int SWZ = HD == 32 ? hopper::SW64 : hopper::SW128;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int SMEM =
      Q_BYTES + STAGES * (2 * KV_BYTES + 2 * BK * 4) + 1024;
};

// Everything a verify launch reads besides its TMA views.
struct Args {
  const void* k;          // bf16 store or int8 codes: (pages, Hkv, page, hd)
  const void* v;
  const float* ks;        // int8 pool: (pages, Hkv, page) scales
  const float* vs;
  const int* table;       // (B, P) page ids; nullptr: row cache (page = S)
  const int* pos;         // (B,) base positions
  const int* anc;         // (B, K) ancestor bits; nullptr: causal
  bf16* out;              // (B, K, H, hd)
  int Hkv, G, K, P, page;
  int cap;                // cache keys a row holds: S, or P * page
  int GC, QPT, HC;        // heads and queries of a tile, head chunks
  int tma_rows;           // R (full bf16 tiles by TMA), 0: copied
  float scale_log2;       // softmax scale * log2(e)
};

// The byte offset of 16-byte chunk c of row r in a swizzled atom of rows of
// ROWB bytes (what a TMA load with the same swizzle writes).
template <int ROWB>
__device__ __forceinline__ int swizzled(int r, int c) {
  if constexpr (ROWB == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  else return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

constexpr int PRODUCERS = 128;          // one producer warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;

// QUANT: the cache is an int8 pool.  SPLIT_P: P V runs on a bf16 high and
// low part of P (the ring route).  RING: the cache is a sliding-window
// ring of cap slots.
template <int HD, bool QUANT, bool RING>
__global__ void __launch_bounds__(THREADS, 1)
verify_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tck,
              const __grid_constant__ CUtensorMap tcv,
              const __grid_constant__ CUtensorMap tbk,
              const __grid_constant__ CUtensorMap tbv, const Args a) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, ST = C::STAGES, ROWB = C::ROWB;
  constexpr int PT = PRODUCERS;
  constexpr bool SPLIT_P = RING;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[ST], v_full[ST], empty[ST];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* k_s = q_s + C::Q_BYTES;              // stage s: + s * KV_BYTES
  uint8_t* v_s = k_s + ST * C::KV_BYTES;
  float* ks_s = reinterpret_cast<float*>(v_s + ST * C::KV_BYTES);
  float* vs_s = ks_s + ST * BK;                 // stage s: + s * BK

  const int hc = blockIdx.x % a.HC, qt = blockIdx.x / a.HC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qi0 = qt * a.QPT, g0 = hc * a.GC;
  const int rows = a.QPT * a.GC;                // the tile's score rows
  const int pos = a.pos[b];
  const int n = min(max(pos, 0), a.cap);        // cache keys read
  const int nct = (n + BK - 1) / BK;
  const bool tree = a.anc != nullptr;
  const int nblk = tree ? a.K : min(qi0 + a.QPT, a.K);
  const int NT = nct + (nblk + BK - 1) / BK;
  const int* tb = a.table == nullptr ? nullptr : a.table + (size_t)b * a.P;

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

  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wg == CONSUMERS / 128) {
    // ------------------------------------------------------------ producer
    const int pt = threadIdx.x - CONSUMERS;
    if (pt == 0) {
      hopper::prefetch_map(&tq);
      hopper::prefetch_map(&tbk);
      hopper::prefetch_map(&tbv);
      if (a.tma_rows > 0) {
        hopper::prefetch_map(&tck);
        hopper::prefetch_map(&tcv);
      }
      hopper::mbar_expect_tx(&q_full, HD * 2 * rows);
      for (int c = 0; c < C::ATOMS; ++c)
        hopper::tma_load_5d(q_s + c * BQ * ROWB, &tq, &q_full, c * C::ATOM,
                            g0, h, qi0, b);
    }
    // the store row of cache key t < n, and its flat (page, head, slot)
    auto page_of = [&](int t) { return tb == nullptr ? b : tb[t / a.page]; };
    auto flat = [&](int t) {
      const int p = tb == nullptr ? t : t % a.page;
      return ((size_t)page_of(t) * a.Hkv + h) * a.page + p;
    };
    for (int t = 0; t < NT; ++t) {
      const int s = t % ST;
      hopper::mbar_wait(&empty[s], ((t / ST) & 1) ^ 1);
      uint8_t* ks = k_s + s * C::KV_BYTES;
      uint8_t* vs = v_s + s * C::KV_BYTES;
      const int k0 = t < nct ? t * BK : (t - nct) * BK;
      if (t >= nct || (!QUANT && a.tma_rows > 0 && k0 + BK <= n)) {
        if (pt == 0) {                  // TMA: a block tile or a full one
          hopper::mbar_expect_tx(&k_full[s], C::KV_BYTES);
          hopper::mbar_expect_tx(&v_full[s], C::KV_BYTES);
          if (t >= nct) {
            for (int c = 0; c < C::ATOMS; ++c) {
              hopper::tma_load_4d(ks + c * BK * ROWB, &tbk, &k_full[s],
                                  c * C::ATOM, k0, h, b);
              hopper::tma_load_4d(vs + c * BK * ROWB, &tbv, &v_full[s],
                                  c * C::ATOM, k0, h, b);
            }
          } else {
            const int R = a.tma_rows;
            for (int r = 0; r < BK; r += R) {
              const int key = k0 + r;
              const int pid = page_of(key);
              const int slot = tb == nullptr ? key : key % a.page;
              for (int c = 0; c < C::ATOMS; ++c) {
                hopper::tma_load_4d(ks + c * BK * ROWB + r * ROWB, &tck,
                                    &k_full[s], c * C::ATOM, slot, h, pid);
                hopper::tma_load_4d(vs + c * BK * ROWB + r * ROWB, &tcv,
                                    &v_full[s], c * C::ATOM, slot, h, pid);
              }
            }
          }
        }
        continue;
      }
      // copied by the producer's threads: keys k0 .. n-1 of the tile, the
      // rest zero.  Each thread loads a batch of 16-byte pieces before it
      // stores any, so the batch's global loads are in flight together.
      if constexpr (QUANT) {
        const int8_t* kc = static_cast<const int8_t*>(a.k);
        const int8_t* vc = static_cast<const int8_t*>(a.v);
        constexpr int CPR = HD / 16;            // 16-code loads a row
        constexpr int ITER = BK * CPR / PT;     // loads a thread
        uint4 ku[ITER], vu[ITER];
#pragma unroll
        for (int i = 0; i < ITER; ++i) {
          const int e = pt + i * PT, r = e / CPR, c = e % CPR, key = k0 + r;
          ku[i] = vu[i] = make_uint4(0, 0, 0, 0);
          if (key < n) {
            const size_t f = flat(key) * HD + c * 16;
            ku[i] = *reinterpret_cast<const uint4*>(kc + f);
            vu[i] = *reinterpret_cast<const uint4*>(vc + f);
          }
        }
#pragma unroll
        for (int i = 0; i < ITER; ++i) {
          const int e = pt + i * PT, r = e / CPR, c = e % CPR;
          const int8_t* kb8 = reinterpret_cast<const int8_t*>(&ku[i]);
          const int8_t* vb8 = reinterpret_cast<const int8_t*>(&vu[i]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint4 ko, vo;
            uint32_t* kw = reinterpret_cast<uint32_t*>(&ko);
            uint32_t* vw = reinterpret_cast<uint32_t*>(&vo);
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const int j = 8 * half + 2 * w;
              kw[w] = hopper::pack_bf16((float)kb8[j], (float)kb8[j + 1]);
              vw[w] = hopper::pack_bf16((float)vb8[j], (float)vb8[j + 1]);
            }
            const int chunk = 2 * c + half;     // 16-byte chunk of the row
            const int off = (chunk / (C::ATOM / 8)) * BK * ROWB +
                            swizzled<ROWB>(r, chunk % (C::ATOM / 8));
            *reinterpret_cast<uint4*>(ks + off) = ko;
            *reinterpret_cast<uint4*>(vs + off) = vo;
          }
        }
        for (int r = pt; r < BK; r += PT) {
          const int key = k0 + r;
          const bool in = key < n;
          const size_t f = in ? flat(key) : 0;
          ks_s[s * BK + r] = in ? a.ks[f] : 0.f;
          vs_s[s * BK + r] = in ? a.vs[f] : 0.f;
        }
      } else {
        const bf16* kc = static_cast<const bf16*>(a.k);
        const bf16* vc = static_cast<const bf16*>(a.v);
        constexpr int CPR = HD / 8;             // 16-byte chunks a row
        constexpr int ITER = BK * CPR / PT;     // chunks a thread
        constexpr int BATCH = ITER < 8 ? ITER : 8;
        static_assert(ITER % BATCH == 0, "whole batches");
        for (int i0 = 0; i0 < ITER; i0 += BATCH) {
          uint4 ku[BATCH], vu[BATCH];
#pragma unroll
          for (int i = 0; i < BATCH; ++i) {
            const int e = pt + (i0 + i) * PT, r = e / CPR, c = e % CPR;
            const int key = k0 + r;
            ku[i] = vu[i] = make_uint4(0, 0, 0, 0);
            if (key < n) {
              const size_t f = flat(key) * HD + c * 8;
              ku[i] = *reinterpret_cast<const uint4*>(kc + f);
              vu[i] = *reinterpret_cast<const uint4*>(vc + f);
            }
          }
#pragma unroll
          for (int i = 0; i < BATCH; ++i) {
            const int e = pt + (i0 + i) * PT, r = e / CPR, c = e % CPR;
            const int off = (c / (C::ATOM / 8)) * BK * ROWB +
                            swizzled<ROWB>(r, c % (C::ATOM / 8));
            *reinterpret_cast<uint4*>(ks + off) = ku[i];
            *reinterpret_cast<uint4*>(vs + off) = vu[i];
          }
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1, PT);
      if (pt == 0) {
        hopper::mbar_arrive(&k_full[s]);
        hopper::mbar_arrive(&v_full[s]);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumer
  // warpgroup wg owns tile rows 64 wg .. 64 wg + 63; this thread rows
  // rr[0] and rr[1] = rr[0] + 8 (the wgmma accumulator layout)
  const int cq = 2 * (lane % 4);
  int rr[2], qi[2];
  bool live[2];
  unsigned bits[2] = {0u, 0u};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rr[r] = 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * r;
    qi[r] = qi0 + rr[r] / a.GC;
    live[r] = rr[r] < rows && qi[r] < a.K && g0 + rr[r] % a.GC < a.G;
    if (tree && live[r]) bits[r] = (unsigned)a.anc[(size_t)b * a.K + qi[r]];
  }
  // the tiles this warpgroup reads: every cache tile, and the block tiles
  // up to its last live query (causal); the rest it releases unread
  int hi = NT;
  const int wr0 = 64 * wg;
  if (wr0 >= rows || qi0 + wr0 / a.GC >= a.K) {
    hi = 0;
  } else if (!tree) {
    const int last = min(qi0 + (min(wr0 + 63, rows - 1)) / a.GC, a.K - 1);
    hi = nct + last / BK + 1;
  }
  // ring: slot t holds position base + t (t <= w) or base + t - S (t > w),
  // visible to query i iff that position > pos + i - S
  int ring_w = 0, ring_thr[2] = {0, 0};
  if constexpr (RING) {
    if (n > 0) {
      ring_w = (pos - 1) % a.cap;
      const int base = pos - 1 - ring_w;
#pragma unroll
      for (int r = 0; r < 2; ++r) ring_thr[r] = pos + qi[r] - a.cap - base;
    }
  }

  float o[HD / 2], sc[BK / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[BK / 16][4];
  uint32_t pl[SPLIT_P ? BK / 16 : 1][4];

  auto scores = [&](int t) {
    const uint8_t* ks = k_s + (t % ST) * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 / C::ATOM, off = (kk * 16 % C::ATOM) * 2;
      const uint64_t dq = hopper::make_desc(
          q_s + c * BQ * ROWB + wg * 64 * ROWB + off, 16, 8 * ROWB, C::SWZ);
      const uint64_t dk = hopper::make_desc(ks + c * BK * ROWB + off, 16,
                                            8 * ROWB, C::SWZ);
      hopper::wgmma_ss<BK, 0>(sc, dq, dk, kk > 0);
    }
    hopper::wgmma_commit();
  };
  auto pv = [&](int t) {
    const uint8_t* vs = v_s + (t % ST) * C::KV_BYTES;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint64_t dv = hopper::make_desc(vs + c * 16 * ROWB, BK * ROWB,
                                            8 * ROWB, C::SWZ);
      hopper::wgmma_rs<HD>(o, pa[c], dv);
      if constexpr (SPLIT_P) hopper::wgmma_rs<HD>(o, pl[c], dv);
    }
    hopper::wgmma_commit();
  };
  auto wait_k = [&](int t) {
    hopper::mbar_wait(&k_full[t % ST], (t / ST) & 1);
  };
  auto wait_v = [&](int t) {
    hopper::mbar_wait(&v_full[t % ST], (t / ST) & 1);
  };
  auto free_tile = [&](int t) { hopper::mbar_arrive(&empty[t % ST]); };

  // online softmax of tile t's scores in sc: scaled into the log2 domain
  // (an int8 cache tile: times each key's scale), masked, m and l
  // updated, alpha set, exp2 of the scores less the new max left in sc
  auto softmax = [&](int t) {
    const bool cache = t < nct;
    const int k0 = cache ? t * BK : (t - nct) * BK;
    if (QUANT && cache) {
      const float* kss = ks_s + (t % ST) * BK;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        sc[j] *= a.scale_log2 * kss[(j / 4) * 8 + cq + (j & 1)];
    } else {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] *= a.scale_log2;
    }
    if (!cache || RING || k0 + BK > n) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int key = k0 + (j / 4) * 8 + cq + (j & 1);
        const int r = (j >> 1) & 1;
        bool ok;
        if (cache) {
          ok = key < n;
          if constexpr (RING)
            ok = ok && key - (key > ring_w ? a.cap : 0) > ring_thr[r];
        } else {
          ok = key < a.K &&
               (tree ? ((bits[r] >> key) & 1u) != 0u : key <= qi[r]);
        }
        if (!ok) sc[j] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY}, base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 2; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
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
      sum[r] += __shfl_xor_sync(FULL, sum[r], 1);
      sum[r] += __shfl_xor_sync(FULL, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
    if (QUANT && cache) {                // P times each key's v scale
      const float* vss = vs_s + (t % ST) * BK;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        sc[j] *= vss[(j / 4) * 8 + cq + (j & 1)];
    }
  };
  // rescale O by alpha and round P to bf16 as wgmma's A fragments (SPLIT_P:
  // and the rest of P, rounded again)
  auto to_p = [&]() {
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = sc[8 * c + 2 * e], x1 = sc[8 * c + 2 * e + 1];
        pa[c][e] = hopper::pack_bf16(x0, x1);
        if constexpr (SPLIT_P) {
          const __nv_bfloat162 hi2 =
              *reinterpret_cast<const __nv_bfloat162*>(&pa[c][e]);
          const float2 hf = __bfloat1622float2(hi2);
          pl[c][e] = hopper::pack_bf16(x0 - hf.x, x1 - hf.y);
        }
      }
  };
  auto release = [&](int t) {
    wait_k(t);
    wait_v(t);
    free_tile(t);
  };

  if (hi > 0) {
    hopper::mbar_wait(&q_full, 0);
    wait_k(0);
    hopper::wgmma_fence();
    scores(0);
    hopper::wgmma_wait<0>();
    softmax(0);
    to_p();
  }
  for (int t = 0; t + 1 < hi; ++t) {
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
  if (hi > 0) {
    wait_v(hi - 1);
    hopper::wgmma_fence();
    pv(hi - 1);
    hopper::wgmma_wait<0>();
    free_tile(hi - 1);
  }
  for (int t = hi; t < NT; ++t) release(t);

  const int H = a.Hkv * a.G;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* orow = a.out + (((size_t)b * a.K + qi[r]) * H + h * a.G + g0 +
                          rr[r] % a.GC) * HD;
#pragma unroll
    for (int j = 2 * r; j < HD / 2; j += 4)
      *reinterpret_cast<uint32_t*>(orow + (j / 4) * 8 + cq) =
          hopper::pack_bf16(o[j] * inv, o[j + 1] * inv);
  }
}

// Host side: encode the five TMA views and launch one verify.  q and out
// are (B, K, H, hd), kb/vb (B, K, Hkv, hd), all contiguous; the bf16 cache
// store is (pages, Hkv, page, hd) (a row cache: pages = B, page = S).
// `a` holds the rest; its tile fields and scale are set here.
template <int HD, bool QUANT, bool RING>
int launch(const void* q, const void* kb, const void* vb, int B, int pages,
           float scale, Args a, cudaStream_t stream) {
  using C = Cfg<HD>;
  if (a.G < 1 || a.K < 1 || a.Hkv < 1 || B < 1 || B > 65535 || a.page < 1 ||
      (a.anc != nullptr && a.K > 31))
    return (int)cudaErrorInvalidValue;
  a.GC = a.G < BQ ? a.G : BQ;
  a.QPT = BQ / a.GC;
  a.HC = (a.G + a.GC - 1) / a.GC;
  a.scale_log2 = scale * 1.4426950408889634f;
  const CUtensorMapSwizzle swz = HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t e = 2;                         // bytes of a bf16
  const uint64_t H = (uint64_t)a.Hkv * a.G;
  CUtensorMap mq, mck, mcv, mbk, mbv;
  const uint64_t dq[5] = {HD, (uint64_t)a.G, (uint64_t)a.Hkv, (uint64_t)a.K,
                          (uint64_t)B};
  const uint64_t sq[4] = {e * HD, e * HD * a.G, e * HD * H, e * HD * H * a.K};
  const uint32_t bq[5] = {C::ATOM, (uint32_t)a.GC, 1, (uint32_t)a.QPT, 1};
  const uint64_t db[4] = {HD, (uint64_t)a.K, (uint64_t)a.Hkv, (uint64_t)B};
  const uint64_t sb[3] = {e * HD * a.Hkv, e * HD, e * HD * a.Hkv * a.K};
  const uint32_t bb[4] = {C::ATOM, C::BK, 1, 1};
  if (!hopper::encode_map(&mq, q, 5, dq, sq, bq, swz) ||
      !hopper::encode_map(&mbk, kb, 4, db, sb, bb, swz) ||
      !hopper::encode_map(&mbv, vb, 4, db, sb, bb, swz))
    return (int)cudaErrorInvalidValue;
  memset(&mck, 0, sizeof(mck));
  memset(&mcv, 0, sizeof(mcv));
  if (!QUANT) {
    // full cache tiles by TMA: a row cache in one load of BK rows, a pool
    // in loads of R = gcd(page, BK) rows when its page is a multiple of 8
    int R = 0;
    if (a.table == nullptr) {
      R = C::BK;
    } else if (a.page % 8 == 0) {
      R = C::BK;
      while (a.page % R) R /= 2;
    }
    a.tma_rows = R;
    if (R > 0) {
      const uint64_t dc[4] = {HD, (uint64_t)a.page, (uint64_t)a.Hkv,
                              (uint64_t)pages};
      const uint64_t scs[3] = {e * HD, e * HD * a.page,
                               e * HD * a.page * a.Hkv};
      const uint32_t bc[4] = {C::ATOM, (uint32_t)R, 1, 1};
      if (!hopper::encode_map(&mck, a.k, 4, dc, scs, bc, swz) ||
          !hopper::encode_map(&mcv, a.v, 4, dc, scs, bc, swz))
        return (int)cudaErrorInvalidValue;
    }
  } else {
    a.tma_rows = 0;
  }
  const cudaError_t rc = hopper::allow_smem<verify_kernel<HD, QUANT, RING>>(
      C::SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const int qtiles = (a.K + a.QPT - 1) / a.QPT;
  const dim3 grid(qtiles * a.HC, a.Hkv, B);
  verify_kernel<HD, QUANT, RING>
      <<<grid, THREADS, C::SMEM, stream>>>(
          mq, mck, mcv, mbk, mbv, a);
  return (int)cudaGetLastError();
}

// launch<HD, QUANT, RING> for head width hd (32, 64, 128 or 256)
template <bool QUANT, bool RING>
int dispatch(int hd, const void* q, const void* kb, const void* vb, int B,
             int pages, float scale, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, QUANT, RING>(q, kb, vb, B, pages, scale, a,
                                            stream);
    case 64: return launch<64, QUANT, RING>(q, kb, vb, B, pages, scale, a,
                                            stream);
    case 128: return launch<128, QUANT, RING>(q, kb, vb, B, pages, scale, a,
                                              stream);
    case 256: return launch<256, QUANT, RING>(q, kb, vb, B, pages, scale, a,
                                              stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vtc
}  // namespace repro
