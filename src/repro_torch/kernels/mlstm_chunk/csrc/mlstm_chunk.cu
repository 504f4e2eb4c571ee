// Chunkwise mLSTM (xLSTM) from no history, for Hopper (sm_90a).
//
// Replaces: repro/kernels/mlstm_chunk/kernel.py ::
//   mlstm_chunk_kernel (body _mlstm_kernel).
//
// What it computes, per (row b, head h), chunk after chunk of c tokens,
// in f32 (g = cumsum of the chunk's log forget gates lf, li the log input
// gates, (C_p, n_p, m_p) the state before the chunk, NEG_INF at first):
//   m_t[l] = max(max_{s<=l}(g_l - g_s + li_s), g_l + m_p)
//   D[l,s] = exp(g_l - g_s + li_s - m_t[l])                 (s <= l)
//   S[l,s] = (q_l . k_s) * scale * D[l,s]    scale = 1/sqrt(dh), passed in
//   w_l    = exp(g_l + m_p - m_t[l])
//   h_l    = (sum_s S[l,s] v_s + w_l q_l C_p)
//            / max(|sum_s S[l,s] + w_l q_l . n_p|, exp(-m_t[l]))
// then hands the state on (gT = g_{c-1}):
//   m' = max(gT + m_p, max_s(gT - g_s + li_s)),  wk_s = exp(gT - g_s +
//   li_s - m'),  C' = exp(gT + m_p - m') C_p + sum_s (k_s scale)^T (wk_s
//   v_s),  n' likewise with 1 in place of v_s.  It returns every h_l and
//   the last (C, n, m).
//
// What bounds it on an H100: operations.  Per chunk of c tokens and head
// of width dh it does about 2 c^2 dh (causal scores and S V) + 4 c dh^2
// (q C_p and the state update) flops against 16 c dh bytes of q, k, v
// and h: about 290 flops a byte at c = dh = 256-384.  The products run
// on the tensor cores in 3xTF32 (below), 3 TF32 products for each f32
// one, so the bound is 3x the operations at 495 TFLOP/s.
//
// What the design does.  The TPU kernel walks a head's chunks in order
// with C (dh x dh f32, 576 KB at dh = 384) and the c x c decay matrix in
// VMEM; a Hopper block has 227 KB.  Here nothing walks the chunks
// except the scalar gate chain:
//   1. gates, one block per (b, h), four chunks at once: per chunk, g by
//      one tree scan in Sklansky levels over the chunk padded to a power
//      of two, the fixed order of the plain version's `chunk_cumsum`
//      (models/xlstm.py), so that m, held to 1e-5 where |g| reaches
//      ~100, rounds as the plain version does; the row maxima m_t by a
//      max-scan of li - g, the chunk's max by a block reduction; then the
//      chain m' = max(gT + m_p, ...) over the chunks (one value each),
//      with wk, w and the chunk's decay exp(gT + m_p - m').  Written to a
//      scratch of (g, m_t, w, wk) a token.
//   2. state, grid (dh/64 x chunks x B x H, dh/64): every chunk's own
//      update U = sum_s (k_s scale)^T (wk_s v_s) and its n counterpart at
//      once: a chunk's contribution does not depend on the carried state.
//   3. combine, elementwise over dh x dh: C_{j+1} = decay_j C_j + U_j in
//      chunk order, leaving each chunk's carried C_j in its U's slot.
//   4. outputs, grid (dh/64 x chunks x B x H, ceil(c/64)) in clusters of
//      the dh/64 column blocks of one 64-row query tile (the last query
//      tile, with the most key tiles, launched first): each block owns 64
//      columns of h and the same 64 of the depth.  The scores q . k of a
//      64 x 64 tile are summed over the depth once: each block takes its
//      depth slice on the tensor cores, then the cluster reduces and
//      scatters through distributed shared memory with stores only (rank
//      r adds up its share of the tile from every rank's partial, in rank
//      order, and stores the sums into every rank; two cluster barriers a
//      key tile), so all hold the same scores.  Then S and S V for its
//      columns, and q C_p (C_p from step 3) over the full depth, its
//      stages four deep.
// Products: mma.sync m16n8k8 in TF32 with each f32 operand split into
// a TF32 high part and its remainder, a b = a_hi b_hi + a_hi b_lo +
// a_lo b_hi (CUTLASS's 3xTF32): about f32's accuracy, where one TF32
// product keeps three digits.  Operand tiles land through cp.async; the
// next key tile's k (or v) is in flight while this one's products run.
// Memory: the chunks' states take chunks x B x H x dh^2 floats of
// scratch; the wrapper runs the chunks in spans that fit a budget, a
// span's first carried state being the previous span's final one.
// Under a gradient it runs them in one span and keeps the scratch (the
// gates and every chunk's carried state) with each token's signed den
// (`dsum`): the backward's saves (mlstm_chunk_bwd.cu).
// Not done: each block of a cluster streams the whole query tile for q C_p
// (a TMA multicast would read it once a cluster), the scores' exchange
// waits on two cluster barriers a key tile, and the combine is a launch
// of its own.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

namespace cg = cooperative_groups;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using tf32x3::mma3;
using tf32x3::stage;

constexpr float NEG_INF = -1e30f;   // JAX's NEG_INF: m_p + g stays finite
constexpr int TILE = 64;            // query rows, key rows, C rows/columns
constexpr int MAX_C = 256;          // chunk length of the gates' scans
constexpr int MAX_DH = 512;         // a cluster holds at most 8 blocks
constexpr int SQ = TILE + 4;        // row stride of [row][depth] tiles
constexpr int SV = TILE + 8;        // row stride of [depth or key][col] tiles

// ------------------------------------------------------------ 1. gates

// In-place inclusive scan of buf[0, w) (w a power of two; threads x <
// w / 2 of the group at work) under op, in Sklansky levels: level s adds
// the last value of each block's lower half (blocks of 2 s) to every
// value of its upper half, the order of the plain version's
// `chunk_cumsum`.  Every thread of the block calls it.
template <class Op>
__device__ void sklansky(float* buf, int w, int x, Op op) {
  for (int s = 1; s < w; s <<= 1) {
    if (x < w / 2) {
      const int a = (x / s) * 2 * s + s;
      const int ti = a + x % s;
      buf[ti] = op(buf[ti], buf[a - 1]);
    }
    __syncthreads();
  }
}

constexpr int GATE_CHUNKS = 4;      // chunks a gate block scans at once
constexpr int GATE_THREADS = GATE_CHUNKS * MAX_C;

// gates: 4 planes of (B H, L): g, m_t, w, wk; decay (B H, nc); m (B H).
// One block a (b, h); its 4 groups of 256 threads scan 4 chunks at once,
// then one thread runs the stabilizer chain over them.
__global__ void __launch_bounds__(GATE_THREADS)
mlstm_gates(const float* __restrict__ li, const float* __restrict__ lf,
            float* __restrict__ gates, float* __restrict__ decay,
            float* __restrict__ m_out, int BH, int L, int c) {
  __shared__ float gs[GATE_CHUNKS][MAX_C], buf[GATE_CHUNKS][MAX_C];
  __shared__ float red[GATE_CHUNKS][MAX_C / 32];
  __shared__ float top[GATE_CHUNKS][2], mpre[GATE_CHUNKS + 1];
  const float NO_MAX = __int_as_float(0xff800000);   // -inf
  const int bh = blockIdx.x, grp = threadIdx.x / MAX_C;
  const int tid = threadIdx.x % MAX_C;
  const int nc = L / c;
  int p2 = 1;
  while (p2 < c) p2 <<= 1;
  const size_t plane = (size_t)BH * L;
  const float* lib = li + (size_t)bh * L;
  const float* lfb = lf + (size_t)bh * L;
  float* gb = gates + (size_t)bh * L;
  float* bf = buf[grp];
  float* gg = gs[grp];
  auto add = [](float a, float b) { return a + b; };
  auto mx = [](float a, float b) { return fmaxf(a, b); };

  if (threadIdx.x == 0) mpre[GATE_CHUNKS] = NEG_INF;
  for (int jb = 0; jb < nc; jb += GATE_CHUNKS) {
    const int j = jb + grp;
    const bool on = j < nc;                     // this group's chunk
    const int t0 = on ? j * c : 0;
    if (tid < p2) bf[tid] = on && tid < c ? lfb[t0 + tid] : 0.f;
    __syncthreads();
    sklansky(bf, p2, tid, add);
    if (tid < c) gg[tid] = bf[tid];
    __syncthreads();
    const float gT = gg[c - 1];
    const bool in = on && tid < c;
    const float lv = in ? lib[t0 + tid] : 0.f;
    const float gl = tid < c ? gg[tid] : 0.f;
    const float a = in ? (gT - gl) + lv : NO_MAX;
    float r = a;
    for (int off = 16; off; off >>= 1)
      r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, off));
    if (tid % 32 == 0) red[grp][tid / 32] = r;
    if (tid < p2) bf[tid] = in ? lv - gl : NO_MAX;
    __syncthreads();
    float mloc = red[grp][0];
    for (int i = 1; i < MAX_C / 32; ++i) mloc = fmaxf(mloc, red[grp][i]);
    if (tid == 0) top[grp][0] = gT, top[grp][1] = mloc;
    sklansky(bf, p2, tid, mx);          // max_{s <= l} (li_s - g_s)
    __syncthreads();                    // every group's top
    if (threadIdx.x == 0) {             // the chain over this batch
      float m = mpre[GATE_CHUNKS];
      for (int g = 0; g < GATE_CHUNKS && jb + g < nc; ++g) {
        mpre[g] = m;
        m = fmaxf(top[g][0] + m, top[g][1]);
      }
      mpre[GATE_CHUNKS] = m;
    }
    __syncthreads();
    const float mp = mpre[grp];
    const float mn = fmaxf(gT + mp, mloc);
    if (in) {
      const float mi = gl + mp;
      const float mt = fmaxf(gl + bf[tid], mi);
      gb[t0 + tid] = gl;
      gb[plane + t0 + tid] = mt;
      gb[2 * plane + t0 + tid] = expf(mi - mt);
      gb[3 * plane + t0 + tid] = expf(a - mn);
    }
    if (on && tid == 0) decay[(size_t)bh * nc + j] = expf((gT + mp) - mn);
    __syncthreads();                    // gs, buf, red and top reused
  }
  if (threadIdx.x == 0) m_out[bh] = mpre[GATE_CHUNKS];
}

// ------------------------------------------------------------ 2. state

constexpr int ST_THREADS = 128;     // 2 x 2 warps of 32 x 32
constexpr int KS = 32;              // tokens a stage
constexpr int ST_STAGES = 2;        // stages in flight
constexpr int ST_STAGE_F = 2 * KS * SV;

// U (slot's dh x dh) [i0.., e0..] = scale sum_s k_s[i] (wk_s v_s[e]);
// the blocks of column tile 0 also sum n's rows i0.. of the chunk.  Grid
// (dh/64 x chunks x B x H, dh/64): x = the row tile, then the chunk
__global__ void __launch_bounds__(ST_THREADS)
mlstm_state(const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ gates, float* __restrict__ Us,
            float* __restrict__ Un, int BH, int L, int dh, int c, int j0,
            int ns, int span, float scale) {
  __shared__ __align__(16) float ssm[ST_STAGES * ST_STAGE_F];
  __shared__ float wks[MAX_C];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;
  const int rows = dh / TILE, z = blockIdx.x / rows;
  const int i0 = (blockIdx.x % rows) * TILE, e0 = blockIdx.y * TILE;
  const int bh = z / ns, jj = z % ns;
  const int t0 = (j0 + jj) * c;
  const float* kb = k + ((size_t)bh * L + t0) * dh;
  const float* vb = v + ((size_t)bh * L + t0) * dh;
  const float* wk = gates + 3 * (size_t)BH * L + (size_t)bh * L + t0;
  const int nst = (c + KS - 1) / KS;

  // stage st: k's rows s0.. (columns i0..) then v's (columns e0..)
  auto load = [&](int st) {
    float* kt = ssm + (st % ST_STAGES) * ST_STAGE_F;
    stage(kt, SV, kb + i0, dh, st * KS, KS, TILE, c, ST_THREADS);
    stage(kt + KS * SV, SV, vb + e0, dh, st * KS, KS, TILE, c, ST_THREADS);
  };
  for (int st = 0; st < ST_STAGES - 1; ++st) {
    if (st < nst) load(st);
    cp_async_commit();
  }
  for (int s = tid; s < MAX_C; s += ST_THREADS) wks[s] = s < c ? wk[s] : 0.f;

  float acc[2][4][4] = {};
  float nacc = 0.f;
  const bool nrow = blockIdx.y == 0 && tid < TILE;
  for (int st = 0; st < nst; ++st) {
    if (st + ST_STAGES - 1 < nst) load(st + ST_STAGES - 1);
    cp_async_commit();
    cp_async_wait<ST_STAGES - 1>();             // stage st landed
    __syncthreads();
    const float* kt = ssm + (st % ST_STAGES) * ST_STAGE_F;
    const float* vt = kt + KS * SV;
    const float* w = wks + st * KS;
    mma3<2, 4, KS>(
        acc, [&](int m, int kk) { return kt[kk * SV + 32 * wm + m]; },
        [&](int kk, int n) { return w[kk] * vt[kk * SV + 32 * wn + n]; });
    if (nrow) {
#pragma unroll 8
      for (int kk = 0; kk < KS; ++kk) nacc += w[kk] * kt[kk * SV + tid];
    }
    __syncthreads();
  }

  const int lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const size_t slot = (size_t)bh * span + jj;
  float* Ub = Us + slot * dh * dh;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = i0 + 32 * wm + 16 * i + gq;
      const int col = e0 + 32 * wn + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(Ub + (size_t)r * dh + col) =
          make_float2(acc[i][j][0] * scale, acc[i][j][1] * scale);
      *reinterpret_cast<float2*>(Ub + (size_t)(r + 8) * dh + col) =
          make_float2(acc[i][j][2] * scale, acc[i][j][3] * scale);
    }
  if (nrow) Un[slot * dh + i0 + tid] = nacc * scale;
}

// ------------------------------------------------------------ 3. combine

constexpr int CB_THREADS = 256;

// in chunk order: slot j gets the carried C_j (and n_j), then C_{j+1} =
// decay_j C_j + U_j; the last goes to C (n).  A span after the first
// starts from C and n as the previous span left them.
__global__ void __launch_bounds__(CB_THREADS)
mlstm_combine(float* __restrict__ Us, float* __restrict__ Un,
              const float* __restrict__ decay, float* __restrict__ C,
              float* __restrict__ n, int dh, int nc, int j0, int ns,
              int span) {
  const size_t sq = (size_t)dh * dh;
  const int parts = (int)((sq / 4 + CB_THREADS - 1) / CB_THREADS);
  const int bh = blockIdx.x / parts, part = blockIdx.x % parts;
  const float* dc = decay + (size_t)bh * nc + j0;
  auto fold = [&](float* slots, size_t stride, float* out, size_t e) {
    float acc = j0 == 0 ? 0.f : out[e];
    for (int jj = 0; jj < ns; ++jj) {
      float* p = slots + ((size_t)bh * span + jj) * stride + e;
      const float u = *p;
      *p = acc;
      acc = __fadd_rn(__fmul_rn(dc[jj], acc), u);
    }
    out[e] = acc;
  };
  const size_t e4 = (size_t)part * CB_THREADS + threadIdx.x;
  if (e4 < sq / 4) {
    float4 acc = j0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : reinterpret_cast<const float4*>(C + bh * sq)[e4];
    for (int jj = 0; jj < ns; ++jj) {
      float4* p = reinterpret_cast<float4*>(
                      Us + ((size_t)bh * span + jj) * sq) + e4;
      const float4 u = *p;
      *p = acc;
      const float d = dc[jj];
      acc = make_float4(__fadd_rn(__fmul_rn(d, acc.x), u.x),
                        __fadd_rn(__fmul_rn(d, acc.y), u.y),
                        __fadd_rn(__fmul_rn(d, acc.z), u.z),
                        __fadd_rn(__fmul_rn(d, acc.w), u.w));
    }
    reinterpret_cast<float4*>(C + bh * sq)[e4] = acc;
  }
  if (part == 0)
    for (int e = threadIdx.x; e < dh; e += CB_THREADS)
      fold(Un, dh, n + (size_t)bh * dh, e);
}

// ------------------------------------------------------------ 4. outputs

constexpr int OUT_THREADS = 256;    // 4 x 2 warps of 16 x 32
constexpr int DS = 32;              // depth a stage of q C_p
constexpr int SQI = DS + 4;
constexpr int A_STAGES = 4;         // stages of q C_p in flight
constexpr int MAX_CL = MAX_DH / TILE;     // blocks of a cluster, at most
// a score tile, fragment-major: thread t's 16 values as 4 float4 at
// t * 4 + (q ^ ((t >> 1) & 3)), a swizzle that keeps each phase of 8
// lanes on distinct banks
constexpr int TILE4 = OUT_THREADS * 4;          // float4 of a score tile
// the cluster's exchange: rank r adds up positions [r SH, (r + 1) SH) of
// the tile (SH = ceil(TILE4 / CL)); it receives each rank's partial of
// them in RECV (CL x SH float4) and every rank's sums in FULL (TILE4)
constexpr int RECV4 = TILE4 + MAX_CL;
constexpr int PP_F = 4 * (RECV4 + TILE4);

struct OutSmem {
  // the inter-chunk product's stages and the key loop's tiles share one
  // region: the product ends (a barrier) before the loop starts
  static constexpr int QO = 0;                          // [64][SQ]
  static constexpr int R = QO + TILE * SQ;
  static constexpr int QI = R;                          // stages x [64][SQI]
  static constexpr int CI = QI + A_STAGES * TILE * SQI; // stages x [DS][SV]
  static constexpr int KT = R;                          // [64][SQ]
  static constexpr int VT = KT + TILE * SQ;             // [64][SV]
  static constexpr int PP = VT + TILE * SV;             // RECV, FULL
  static constexpr int PS = PP + PP_F;                  // [64][SQ]
  static constexpr int R_END = PS + TILE * SQ;
  static_assert(CI + A_STAGES * DS * SV <= R_END, "stages fit the region");
  static constexpr int NP = R_END;                      // [MAX_DH]
  static constexpr int KEYG = NP + MAX_DH;              // [MAX_C] g_s
  static constexpr int KEYL = KEYG + MAX_C;             // [MAX_C] li_s
  static constexpr int ROWG = KEYL + MAX_C;             // [64] g_l
  static constexpr int ROWM = ROWG + TILE;              // [64] m_t
  static constexpr int ROWW = ROWM + TILE;              // [64] w_l
  static constexpr int QN = ROWW + TILE;                // [64] w_l q.n_p
  static constexpr int DEN = QN + TILE;                 // [2][64]
  static constexpr int FLOATS = DEN + 2 * TILE;
  static constexpr int BYTES = 4 * FLOATS;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// grid (dh / 64 x chunks x B x H, query tiles), the last query tile (the
// most key tiles) first; clusters of the dh / 64 blocks along x
__global__ void __launch_bounds__(OUT_THREADS, 2)
mlstm_out(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ li,
          const float* __restrict__ gates, const float* __restrict__ Us,
          const float* __restrict__ Un, float* __restrict__ h,
          float* __restrict__ dsum, int BH, int L, int dh, int c, int j0,
          int ns, int span, float scale) {
  using S = OutSmem;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = warp % 4, wn = warp / 4;       // rows 16 wm.., cols 32 wn..
  const int CL = dh / TILE;                     // blocks of the cluster
  const int rank = (int)cluster.block_rank();
  const int e0 = rank * TILE;                   // own columns and depth
  const int qt = gridDim.y - 1 - blockIdx.y, r0 = qt * TILE;
  const int z = blockIdx.x / CL;
  const int bh = z / ns, jj = z % ns, j = j0 + jj;
  const int t0 = j * c;
  const size_t plane = (size_t)BH * L;
  const size_t slot = (size_t)bh * span + jj;
  const float* qb = q + ((size_t)bh * L + t0) * dh;
  const float* kb = k + ((size_t)bh * L + t0) * dh;
  const float* vb = v + ((size_t)bh * L + t0) * dh;
  const float* gb = gates + (size_t)bh * L + t0;
  const int swz = (tid >> 1) & 3;

  float* qo = sm + S::QO;
  float* kt = sm + S::KT;
  float* vt = sm + S::VT;
  float* ps = sm + S::PS;
  float* np = sm + S::NP;
  float* keyg = sm + S::KEYG;
  float* keyl = sm + S::KEYL;
  float* rowg = sm + S::ROWG;
  float* rowm = sm + S::ROWM;
  float* roww = sm + S::ROWW;
  float* qn = sm + S::QN;
  float* den2 = sm + S::DEN;

  // this block's depth slice of the query tile, for the scores
  stage(qo, SQ, qb + e0, dh, r0, TILE, TILE, c, OUT_THREADS);
  cp_async_commit();
  for (int s = tid; s < c; s += OUT_THREADS) {
    keyg[s] = gb[s];
    keyl[s] = li[(size_t)bh * L + t0 + s];
  }
  for (int r = tid; r < TILE; r += OUT_THREADS) {
    const bool in = r0 + r < c;
    rowg[r] = in ? gb[r0 + r] : 0.f;
    rowm[r] = in ? gb[plane + r0 + r] : 0.f;
    roww[r] = in ? gb[2 * plane + r0 + r] : 0.f;
  }
  for (int e = tid; e < dh; e += OUT_THREADS)
    np[e] = j > 0 ? Un[slot * dh + e] : 0.f;
  __syncthreads();

  // ---- q C_p and q . n_p over the full depth, A_STAGES copies in flight
  // (none for the first chunk, which has no history: its w_l are 0)
  float acc[1][4][4] = {};
  float qnp = 0.f;
  if (j > 0) {
    const float* cp = Us + slot * dh * dh + e0;
    const int nd = dh / DS;
    auto load = [&](int st) {
      stage(sm + S::QI + (st % A_STAGES) * TILE * SQI, SQI, qb + st * DS, dh,
            r0, TILE, DS, c, OUT_THREADS);
      stage(sm + S::CI + (st % A_STAGES) * DS * SV, SV, cp, dh, st * DS, DS,
            TILE, dh, OUT_THREADS);
    };
    for (int st = 0; st < A_STAGES - 1; ++st) {
      if (st < nd) load(st);
      cp_async_commit();
    }
    for (int st = 0; st < nd; ++st) {
      if (st + A_STAGES - 1 < nd) load(st + A_STAGES - 1);
      cp_async_commit();
      cp_async_wait<A_STAGES - 1>();            // stage st landed
      __syncthreads();
      const float* qi = sm + S::QI + (st % A_STAGES) * TILE * SQI;
      const float* ci = sm + S::CI + (st % A_STAGES) * DS * SV;
      mma3<1, 4, DS>(
          acc, [&](int m, int kk) { return qi[(16 * wm + m) * SQI + kk]; },
          [&](int kk, int n) { return ci[kk * SV + 32 * wn + n]; });
      // row tid / 4, depths 4 x + tid % 4
#pragma unroll
      for (int x = 0; x < DS / 4; ++x)
        qnp += qi[(tid / 4) * SQI + 4 * x + tid % 4] *
               np[st * DS + 4 * x + tid % 4];
      __syncthreads();
    }
    qnp += __shfl_xor_sync(0xffffffffu, qnp, 1);
    qnp += __shfl_xor_sync(0xffffffffu, qnp, 2);
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[0][jn][e] *= roww[16 * wm + gq + 8 * (e / 2)];
  }
  if (tid % 4 == 0) qn[tid / 4] = qnp * roww[tid / 4];

  // ---- the key tiles at or before this query tile
  const int nkt = qt + 1;
  stage(kt, SQ, kb + e0, dh, 0, TILE, TILE, c, OUT_THREADS);
  cp_async_commit();
  stage(vt, SV, vb + e0, dh, 0, TILE, TILE, c, OUT_THREADS);
  cp_async_commit();
  float den[2] = {0.f, 0.f};
  float4* recv = reinterpret_cast<float4*>(sm + S::PP);
  float4* full = recv + RECV4;
  const int SH = (TILE4 + CL - 1) / CL;
  // the exchange buffers overlay the stages of q C_p: no rank stores into
  // them before every rank is done with its stages
  cluster_arrive();
  cluster_wait();
  for (int it = 0; it < nkt; ++it) {
    const int s0 = it * TILE;
    cp_async_wait<1>();                         // k (and q's slice) landed
    __syncthreads();
    float sc[1][4][4] = {};
    mma3<1, 4, TILE>(
        sc, [&](int m, int kk) { return qo[(16 * wm + m) * SQ + kk]; },
        [&](int kk, int n) { return kt[(32 * wn + n) * SQ + kk]; });
    // the scores summed over the cluster's depth slices: each rank adds
    // up one share of the tile (the ranks' partials in rank order) and
    // hands the sums to every rank; all remote accesses are stores
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int i = tid * 4 + (jn ^ swz), r = i / SH;
      float4* dst = cluster.map_shared_rank(recv, r);
      dst[rank * SH + i - r * SH] = make_float4(
          sc[0][jn][0], sc[0][jn][1], sc[0][jn][2], sc[0][jn][3]);
    }
    cluster_arrive();               // partials delivered; kt read
    // meanwhile: the tile's decay exp(g_l - g_s + li_s - m_t) on s <= l
    // < c (0 elsewhere)
    float dexp[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = 16 * wm + gq + 8 * (e / 2);
        const int s = s0 + 32 * wn + 8 * jn + 2 * tq + e % 2;
        dexp[jn][e] = r0 + rr < c && s <= r0 + rr
                          ? expf(((rowg[rr] - keyg[s]) + keyl[s]) - rowm[rr])
                          : 0.f;
      }
    cluster_wait();
    if (it + 1 < nkt) {
      stage(kt, SQ, kb + e0, dh, s0 + TILE, TILE, TILE, c, OUT_THREADS);
      cp_async_commit();
    }
    for (int x = tid; x < SH && rank * SH + x < TILE4; x += OUT_THREADS) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < CL; ++r) {
        const float4 y = recv[r * SH + x];
        sum.x += y.x, sum.y += y.y, sum.z += y.z, sum.w += y.w;
      }
      for (int r = 0; r < CL; ++r)
        cluster.map_shared_rank(full, r)[rank * SH + x] = sum;
    }
    cluster_arrive();
    cluster_wait();                 // every share summed and delivered
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const float4 x = full[tid * 4 + (jn ^ swz)];
      sc[0][jn][0] = x.x, sc[0][jn][1] = x.y;
      sc[0][jn][2] = x.z, sc[0][jn][3] = x.w;
    }
    // S = scores * scale * D, into ps; the rows' sums
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = 16 * wm + gq + 8 * (e / 2);
        const int cc = 32 * wn + 8 * jn + 2 * tq + e % 2;
        const float p = sc[0][jn][e] * scale * dexp[jn][e];
        den[e / 2] += p;
        ps[rr * SQ + cc] = p;
      }
    if (it + 1 < nkt)
      cp_async_wait<1>();                       // v landed, next k may not
    else
      cp_async_wait<0>();
    __syncthreads();
    mma3<1, 4, TILE>(
        acc, [&](int m, int kk) { return ps[(16 * wm + m) * SQ + kk]; },
        [&](int kk, int n) { return vt[kk * SV + 32 * wn + n]; });
    __syncthreads();                            // vt and ps read
    if (it + 1 < nkt) {
      stage(vt, SV, vb + e0, dh, s0 + TILE, TILE, TILE, c, OUT_THREADS);
      cp_async_commit();
    }
  }

  // ---- h = num / max(|den|, exp(-m_t))
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
  }
  if (tq == 0) {
    den2[wn * TILE + 16 * wm + gq] = den[0];
    den2[wn * TILE + 16 * wm + gq + 8] = den[1];
  }
  __syncthreads();
  float* hb = h + ((size_t)bh * L + t0) * dh + e0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = 16 * wm + gq + 8 * i, l = r0 + rr;
    if (l >= c) continue;
    const float ds = (den2[rr] + den2[TILE + rr]) + qn[rr];
    const float dd = fmaxf(fabsf(ds), expf(-rowm[rr]));
    if (dsum != nullptr && rank == 0 && wn == 0 && tq == 0)
      dsum[(size_t)bh * L + t0 + l] = ds;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
      *reinterpret_cast<float2*>(hb + (size_t)l * dh + 32 * wn + 8 * jn +
                                 2 * tq) =
          make_float2(acc[0][jn][2 * i] / dd, acc[0][jn][2 * i + 1] / dd);
  }
  cluster.sync();                   // no block leaves while read
}

}  // namespace

// q/k/v (B, H, L, dh), li/lf (B, H, L) -> h (B, H, L, dh), C (B, H, dh,
// dh), n (B, H, dh), m (B, H); all f32, contiguous and 16-byte aligned.
// `dsum` (B, H, L), or null: each token's den before its max, sum_s
// S[l,s] + w_l q_l . n_p, signed -- what the backward
// (mlstm_chunk_bwd.cu) reads beside `gates` and, run in one span of all
// the chunks, `states` (each chunk's carried C_j and n_j).  Null leaves
// every other output's bits as they are.
// dh a multiple of 64 up to 512 (the wrapper pads any other width with
// zero columns and passes the true width's scale, 1/sqrt(dh)); the chunk
// c divides L and is at most 256.  Scratch: `gates` 4 B H L + B H (L/c)
// floats, `states` span B H (dh^2 + dh) floats; the chunks run in spans
// of `span`.  Returns a cudaError_t.
extern "C" int mlstm_chunk_f32(const void* q, const void* k, const void* v,
                               const void* li, const void* lf, void* h,
                               void* C, void* n, void* m, void* gates,
                               void* states, void* dsum, int B, int H, int L,
                               int dh, int c, int span, float scale,
                               void* stream) {
  const long long BH = (long long)B * H;
  if (B < 1 || H < 1 || L < 1 || dh < TILE || dh % TILE || dh > MAX_DH ||
      c < 1 || c > MAX_C || L % c || span < 1 ||
      (long long)span * BH * (dh / TILE) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = L / c;
  float* gt = (float*)gates;
  float* decay = gt + 4 * BH * L;
  float* Us = (float*)states;
  float* Un = Us + (size_t)span * BH * dh * dh;
  cudaError_t rc = hopper::allow_smem<mlstm_out>(OutSmem::BYTES);
  if (rc != cudaSuccess) return (int)rc;
  mlstm_gates<<<(unsigned)BH, GATE_THREADS, 0, st>>>(
      (const float*)li, (const float*)lf, gt, decay, (float*)m, (int)BH, L,
      c);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  const unsigned parts =
      (unsigned)((dh * dh / 4 + CB_THREADS - 1) / CB_THREADS);
  for (int j0 = 0; j0 < nc; j0 += span) {
    const int ns = std::min(span, nc - j0);
    const unsigned z = (unsigned)(ns * BH);
    mlstm_state<<<dim3(dh / TILE * z, dh / TILE), ST_THREADS, 0, st>>>(
        (const float*)k, (const float*)v, gt, Us, Un, (int)BH, L, dh, c, j0,
        ns, span, scale);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
    mlstm_combine<<<parts * (unsigned)BH, CB_THREADS, 0, st>>>(
        Us, Un, decay, (float*)C, (float*)n, dh, nc, j0, ns, span);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(dh / TILE * z, (c + TILE - 1) / TILE);
    cfg.blockDim = dim3(OUT_THREADS);
    cfg.dynamicSmemBytes = OutSmem::BYTES;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = dh / TILE;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, mlstm_out, (const float*)q, (const float*)k,
                            (const float*)v, (const float*)li,
                            (const float*)gt, (const float*)Us,
                            (const float*)Un, (float*)h, (float*)dsum,
                            (int)BH, L, dh, c, j0, ns, span, scale);
    if (rc != cudaSuccess) return (int)rc;
  }
  return (int)cudaGetLastError();
}
