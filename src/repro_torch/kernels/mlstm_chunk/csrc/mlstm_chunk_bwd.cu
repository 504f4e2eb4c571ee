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
// causal tiles; dq, dk and dv's intra products) + 8 c dh^2 (the inter
// and state products and the chunk's own inter term) flops, against
// about 40 c dh bytes (q, k, v, h, dh and the state read, dq, dk and dv
// written): about 260 flops a byte at c = 256, dh = 384.  Every product
// runs on the tensor cores in 3xTF32 (tf32x3.cuh, the forward's route),
// three TF32 products for each f32 one: the bound is 3x the operations
// at 495 TFLOP/s.
//
// What the design does.  The forward's chunks are independent once each
// carried state is known, and so are the backward's once each dC' is:
// six launches, none of which walks the chunks except the elementwise
// reverse combine, the forward's launches 2-3 mirrored.
//   1. prep, a warp a token: dnum = dh / den and ddsum, from the saved
//      dsum and m_t.
//   2. inter, grid (dh/64 x dh/64 x chunks after the first x B x H):
//      every chunk's own E_j = sum_l (w_l q_l)^T dnum_l and its n
//      counterpart at once.
//   3. combine, elementwise over dh x dh, chunks back to front: dC' of
//      chunk j into E_j's slot, then dC = decay_j dC' + E_j; each block's
//      share of <dC', C_p> + <dn', n_p> a chunk.
//   4. scores, grid (causal 64 x 64 tile pairs x chunks x B x H): S and
//      dS over the full depth, then S and dP kept in a (c x c) scratch a
//      chunk, and da's row and column sums a tile.
//   5. products, grid (dq | dk | dv x 64-row tiles x 64-column tiles x
//      chunks x B x H): each a 64 x 64 tile of its output, the intra
//      product over the tokens from S or dP and the inter or state
//      product over the depth from C_p or dC'; the gate terms q .
//      dq_inter and k . dk_state summed over its 64 columns.
//   6. gates, a block a chunk: dg, dli, and dlf by a reverse sum.
// Deterministic: no atomics; every sum (over warps, tiles, column tiles,
// blocks and chunks) runs in one fixed order, so two launches agree bit
// for bit.  Products: 64 x 64 tiles of 8 warps (16 x 32 each), operands
// staged by cp.async two stages of 32 deep.  Simple before fast: the
// operations run on the tensor cores, but S and dP go through device
// memory, each product tile restages its operands from L2, and the
// scores are recomputed rather than kept from the forward.
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using hopper::cp_async_commit;
using hopper::cp_async_wait;
using tf32x3::mma3;
using tf32x3::stage;

constexpr int TILE = 64;            // rows and columns of an output tile
constexpr int MAX_C = 256;          // the forward's largest chunk
constexpr int MAX_DH = 512;
constexpr int THREADS = 256;        // 4 x 2 warps of 16 x 32
constexpr int KS = 32;              // depth of a stage
constexpr int SR = KS + 4;          // row stride of a [64 rows][32 deep] stage
constexpr int SC = TILE + 8;        // row stride of a [32 deep][64 cols] stage
constexpr int OPND_F = TILE * SR;   // floats of one operand's stage
static_assert(KS * SC <= OPND_F, "both stage shapes fit an operand's room");
constexpr int STAGE_F = 2 * OPND_F;            // A then B
constexpr int STAGES_F = 2 * STAGE_F;          // two stages in flight

// A block's 64 x 64 tile: warp (wm, wn) holds rows 16 wm.., columns 32
// wn.. as mma3's acc[0][jn][e] (row 16 wm + gq + 8 (e / 2), column 32 wn
// + 8 jn + 2 tq + e % 2).
struct Frag {
  int wm, wn, gq, tq;
  __device__ Frag() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wm = warp % 4, wn = warp / 4, gq = lane / 4, tq = lane % 4;
  }
  __device__ int row(int e) const { return 16 * wm + gq + 8 * (e / 2); }
  __device__ int col(int jn, int e) const {
    return 32 * wn + 8 * jn + 2 * tq + e % 2;
  }
};

// acc += sum over `steps` stages of A_st (64 x 32) B_st (32 x 64):
// load(st, buf) stages both operands of stage st into buf (A at 0, B at
// OPND_F) by cp.async; fa(buf, st, m, kk) and fb(buf, st, kk, n) read
// them; extra(buf, st) runs after each stage's product (before the
// stage is overwritten).  Two stages in flight.  Every thread calls it.
template <class Load, class FA, class FB, class Extra>
__device__ void gemm(float (&acc)[1][4][4], float* bufs, int steps, Load load,
                     FA fa, FB fb, Extra extra) {
  const Frag f;
  if (steps > 0) load(0, bufs);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) load(st + 1, bufs + ((st + 1) % 2) * STAGE_F);
    cp_async_commit();
    cp_async_wait<1>();                         // stage st landed
    __syncthreads();
    const float* b = bufs + (st % 2) * STAGE_F;
    mma3<1, 4, KS>(
        acc, [&](int m, int kk) { return fa(b, st, 16 * f.wm + m, kk); },
        [&](int kk, int n) { return fb(b, st, kk, 32 * f.wn + n); });
    extra(b, st);
    __syncthreads();                            // stage st read
  }
}

struct NoExtra {
  __device__ void operator()(const float*, int) const {}
};

// the [64 rows][32 deep] and [32 deep][64 cols] stage readers
__device__ __forceinline__ float rowmajor(const float* b, int r, int kk) {
  return b[r * SR + kk];
}
__device__ __forceinline__ float deepmajor(const float* b, int kk, int n) {
  return b[kk * SC + n];
}

// sum over a tile row's 64 columns of the fragment values x[jn][e] (rows
// f.row(e)): the row's two 32-column warps in order, through red (2 x
// 64); thread r < 64 returns row r's sum, the others 0.  Every thread
// calls it.
__device__ float row_sums(const float (&x)[4][4], float* red) {
  const Frag f;
  float r[2] = {0.f, 0.f};
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e / 2] += x[jn][e];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] += __shfl_xor_sync(0xffffffffu, r[i], 1);
    r[i] += __shfl_xor_sync(0xffffffffu, r[i], 2);
  }
  __syncthreads();                              // red free
  if (f.tq == 0) {
    red[f.wn * TILE + 16 * f.wm + f.gq] = r[0];
    red[f.wn * TILE + 16 * f.wm + f.gq + 8] = r[1];
  }
  __syncthreads();
  const int t = threadIdx.x;
  return t < TILE ? red[t] + red[TILE + t] : 0.f;
}

// sum over a tile column's 64 rows, likewise: the four 16-row warps in
// order, through red (4 x 64); thread t < 64 returns column t's sum
__device__ float col_sums(const float (&x)[4][4], float* red) {
  const Frag f;
  float cs[4][2];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float v = x[jn][p] + x[jn][p + 2];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      cs[jn][p] = v;
    }
  __syncthreads();                              // red free
  if (f.gq == 0)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        red[f.wm * TILE + f.col(jn, p)] = cs[jn][p];
  __syncthreads();
  const int t = threadIdx.x;
  return t < TILE ? ((red[t] + red[TILE + t]) + red[2 * TILE + t]) +
                        red[3 * TILE + t]
                  : 0.f;
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
// (slots of dh).  cp = ceil(c / 64) 64 pads a chunk to whole tiles; nt =
// cp / 64.
struct Dims {
  int BH, L, dh, c, nc, cp, nt, ct;             // ct: dh / 64 column tiles
  float scale;
  __host__ __device__ size_t plane() const { return (size_t)BH * L; }
  __host__ __device__ size_t slots() const { return (size_t)BH * nc; }
};

// the workspace, in floats: dnum (B H L dh), ddsum (B H L), dC' (slots x
// dh^2), dn' (slots x dh), S and dP (slots x cp^2 each), da's row and
// column sums (slots x nt^2 x 64 each), the gate terms q . dq_inter and
// k . dk_state (B H L x ct each), the decay dot (slots x parts)
struct Workspace {
  float *dnum, *ddsum, *dC, *dn, *S, *dP, *rowp, *colp, *xw, *xk, *dot;
  size_t floats;
};

constexpr int CB_THREADS = 256;
__host__ __device__ inline int combine_parts(int dh) {
  return (dh * dh / 4 + CB_THREADS - 1) / CB_THREADS;
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
  w.rowp = take(d.slots() * d.nt * d.nt * TILE);
  w.colp = take(d.slots() * d.nt * d.nt * TILE);
  w.xw = take(rows * d.ct);
  w.xk = take(rows * d.ct);
  w.dot = take(d.slots() * combine_parts(d.dh));
  w.floats = o;
  return w;
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

// E_j [d0.., e0..] = sum_l w_l q_l[d] dnum_l[e]; the blocks of column
// tile 0 also En_j[d0..] = sum_l w_l ddsum_l q_l[d].  Into the dC' and
// dn' slots (the combine reads them there).  x = d tile + ct (e tile +
// ct (chunk - 1 + (nc - 1) bh))
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_inter(const float* __restrict__ q, const float* __restrict__ gates,
                Workspace ws, Dims d) {
  __shared__ __align__(16) float bufs[STAGES_F];
  __shared__ float wsm[MAX_C], dds[MAX_C];
  const Frag f;
  int x = blockIdx.x;
  const int d0 = (x % d.ct) * TILE;
  x /= d.ct;
  const int e0 = (x % d.ct) * TILE;
  x /= d.ct;
  const int j = 1 + x % (d.nc - 1), bh = x / (d.nc - 1);
  const size_t t0 = (size_t)bh * d.L + (size_t)j * d.c;
  const float* qb = q + t0 * d.dh;
  const float* nb = ws.dnum + t0 * d.dh;
  for (int l = threadIdx.x; l < MAX_C; l += THREADS) {
    wsm[l] = l < d.c ? gates[2 * d.plane() + t0 + l] : 0.f;
    dds[l] = l < d.c ? ws.ddsum[t0 + l] : 0.f;
  }
  float acc[1][4][4] = {};
  float nacc = 0.f;
  const bool nrow = e0 == 0 && threadIdx.x < TILE;
  gemm(
      acc, bufs, (d.c + KS - 1) / KS,
      [&](int st, float* b) {
        stage(b, SC, qb + d0, d.dh, st * KS, KS, TILE, d.c, THREADS);
        stage(b + OPND_F, SC, nb + e0, d.dh, st * KS, KS, TILE, d.c, THREADS);
      },
      [&](const float* b, int st, int m, int kk) {
        return wsm[st * KS + kk] * deepmajor(b, kk, m);
      },
      [&](const float* b, int, int kk, int n) {
        return deepmajor(b + OPND_F, kk, n);
      },
      [&](const float* b, int st) {
        if (nrow)
          for (int kk = 0; kk < KS; ++kk) {
            const int l = st * KS + kk;
            nacc += (wsm[l] * dds[l]) * deepmajor(b, kk, threadIdx.x);
          }
      });
  const size_t slot = (size_t)bh * d.nc + j;
  float* Eb = ws.dC + slot * d.dh * d.dh;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = d0 + f.row(e), col = e0 + f.col(jn, e);
      *reinterpret_cast<float2*>(Eb + (size_t)r * d.dh + col) =
          make_float2(acc[0][jn][e], acc[0][jn][e + 1]);
    }
  if (nrow) ws.dn[slot * d.dh + d0 + threadIdx.x] = nacc;
}

// ------------------------------------------------------------ 3. combine

// chunks back to front: slot j gets dC' (the cotangent of the state after
// chunk j; 0 for the last), then dC = decay_j dC' + E_j (E_0 is never
// formed: the first chunk has no carried state, and its dC is unread).
// Each block writes its share of <dC', C_j> + <dn', n_j> (its elements
// of the forward's carried state) per chunk.
__global__ void __launch_bounds__(CB_THREADS)
mlstm_bwd_combine(const float* __restrict__ gates,
                  const float* __restrict__ states, Workspace ws, Dims d) {
  __shared__ float red[CB_THREADS / 32];
  const int parts = combine_parts(d.dh);
  const int bh = blockIdx.x / parts, part = blockIdx.x % parts;
  const size_t sq = (size_t)d.dh * d.dh;
  const float* decay = gates + 4 * d.plane() + (size_t)bh * d.nc;
  const float* Cs = states;
  const float* ns = states + d.slots() * sq;
  const size_t e4 = (size_t)part * CB_THREADS + threadIdx.x;
  const bool in = e4 < sq / 4;
  const int ne = part == 0 ? d.dh : 0;          // block 0 also folds n
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float nacc[MAX_DH / CB_THREADS] = {};
  for (int j = d.nc - 1; j >= 0; --j) {
    const size_t slot = (size_t)bh * d.nc + j;
    float dot = 0.f;
    if (in) {
      float4* p = reinterpret_cast<float4*>(ws.dC + slot * sq) + e4;
      const float4 u = j > 0 ? *p : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 c = reinterpret_cast<const float4*>(Cs + slot * sq)[e4];
      *p = acc;
      dot = ((acc.x * c.x + acc.y * c.y) + acc.z * c.z) + acc.w * c.w;
      const float dc = decay[j];
      acc = make_float4(dc * acc.x + u.x, dc * acc.y + u.y, dc * acc.z + u.z,
                        dc * acc.w + u.w);
    }
    for (int i = 0, e = threadIdx.x; e < ne; ++i, e += CB_THREADS) {
      float* p = ws.dn + slot * d.dh + e;
      const float u = j > 0 ? *p : 0.f;
      *p = nacc[i];
      dot += nacc[i] * ns[slot * d.dh + e];
      nacc[i] = decay[j] * nacc[i] + u;
    }
    const float s = block_sum(dot, red);
    if (threadIdx.x == 0) ws.dot[slot * parts + part] = s;
  }
}

// ------------------------------------------------------------ 4. scores

struct ScoreSmem {
  float bufs[STAGES_F];
  float keyg[TILE], keyl[TILE], rowg[TILE], rowm[TILE], rowd[TILE];
  float red[4 * TILE];
};

// the (query tile qt, key tile kt <= qt) pair p of a chunk's causal tiles
__device__ __forceinline__ void tile_pair(int p, int& qt, int& kt) {
  qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= p) ++qt;
  kt = p - qt * (qt + 1) / 2;
}

// x = pair + nt (nt + 1) / 2 (chunk + nc bh): P = scale q k^T and dnum
// v^T over the full depth; S = P D, dS = dnum v^T + ddsum, dP = dS D, da
// = dS S (0 off s <= l < c); S and dP stored (the tile whole, zeros
// included), da's row and column sums
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_scores(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ li,
                 const float* __restrict__ gates, Workspace ws, Dims d) {
  __shared__ __align__(16) ScoreSmem sm;
  const Frag f;
  const int pairs = d.nt * (d.nt + 1) / 2;
  int qt, kt;
  tile_pair(blockIdx.x % pairs, qt, kt);
  const int z = blockIdx.x / pairs, j = z % d.nc, bh = z / d.nc;
  const int r0 = qt * TILE, s0 = kt * TILE;
  const size_t t0 = (size_t)bh * d.L + (size_t)j * d.c;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const bool rin = r0 + i < d.c, kin = s0 + i < d.c;
    sm.rowg[i] = rin ? gates[t0 + r0 + i] : 0.f;
    sm.rowm[i] = rin ? gates[d.plane() + t0 + r0 + i] : 0.f;
    sm.rowd[i] = rin ? ws.ddsum[t0 + r0 + i] : 0.f;
    sm.keyg[i] = kin ? gates[t0 + s0 + i] : 0.f;
    sm.keyl[i] = kin ? li[t0 + s0 + i] : 0.f;
  }
  // (rows r0.. of a, rows s0.. of b) over the depth: a_l . b_s
  auto scores = [&](float (&acc)[1][4][4], const float* a, const float* b) {
    gemm(
        acc, sm.bufs, d.dh / KS,
        [&](int st, float* buf) {
          stage(buf, SR, a + t0 * d.dh + st * KS, d.dh, r0, TILE, KS, d.c,
                THREADS);
          stage(buf + OPND_F, SR, b + t0 * d.dh + st * KS, d.dh, s0, TILE,
                KS, d.c, THREADS);
        },
        [&](const float* buf, int, int m, int kk) {
          return rowmajor(buf, m, kk);
        },
        [&](const float* buf, int, int kk, int n) {
          return rowmajor(buf + OPND_F, n, kk);
        },
        NoExtra());
  };
  float p[1][4][4] = {}, dv[1][4][4] = {};
  scores(p, q, k);
  scores(dv, ws.dnum, v);
  const size_t slot = (size_t)bh * d.nc + j;
  float* Sb = ws.S + slot * d.cp * d.cp;
  float* dPb = ws.dP + slot * d.cp * d.cp;
  float da[4][4];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      float sv[2], dpv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int rr = f.row(e + u), cc = f.col(jn, e + u);
        const int l = r0 + rr, s = s0 + cc;
        const bool on = l < d.c && s <= l;
        // D's bits are the forward's (mlstm_out's dexp)
        const float D =
            on ? expf(((sm.rowg[rr] - sm.keyg[cc]) + sm.keyl[cc]) -
                      sm.rowm[rr])
               : 0.f;
        const float S = p[0][jn][e + u] * d.scale * D;
        const float dS = on ? dv[0][jn][e + u] + sm.rowd[rr] : 0.f;
        sv[u] = S;
        dpv[u] = dS * D;
        da[jn][e + u] = dS * S;
      }
      const size_t at = (size_t)(r0 + f.row(e)) * d.cp + s0 + f.col(jn, e);
      *reinterpret_cast<float2*>(Sb + at) = make_float2(sv[0], sv[1]);
      *reinterpret_cast<float2*>(dPb + at) = make_float2(dpv[0], dpv[1]);
    }
  const float rs = row_sums(da, sm.red);
  const float cs = col_sums(da, sm.red);
  const int t = threadIdx.x;
  if (t < TILE) {
    const size_t nn = (size_t)d.nt * d.nt * TILE;
    ws.rowp[slot * nn + ((size_t)qt * d.nt + kt) * TILE + t] = rs;
    ws.colp[slot * nn + ((size_t)kt * d.nt + qt) * TILE + t] = cs;
  }
}

// ------------------------------------------------------------ 5. products

struct ProdSmem {
  float bufs[STAGES_F];
  float roww[TILE], rowd[TILE], vec[TILE];
  float red[2 * TILE];
};

// x = kind + 3 (row tile + nt (column tile + ct (chunk + nc bh))); kind
// 0: dq's rows l0.. = scale dP k + w (dnum C_p^T + ddsum n_p); 1: dk's
// rows s0.. = scale dP^T q + scale wk (v dC'^T + dn'); 2: dv's rows s0..
// = S^T dnum + scale wk (k dC').  Columns col0..; the gate terms q .
// dq_inter (kind 0) and k . dk_state (kind 1) over those columns.
__global__ void __launch_bounds__(THREADS)
mlstm_bwd_products(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ gates,
                   const float* __restrict__ states, Workspace ws, Dims d,
                   float* __restrict__ dq, float* __restrict__ dk,
                   float* __restrict__ dv) {
  __shared__ __align__(16) ProdSmem sm;
  const Frag f;
  int x = blockIdx.x;
  const int kind = x % 3;
  x /= 3;
  const int rt = x % d.nt;
  x /= d.nt;
  const int ct = x % d.ct;
  x /= d.ct;
  const int j = x % d.nc, bh = x / d.nc;
  const int r0 = rt * TILE, col0 = ct * TILE;
  const size_t t0 = (size_t)bh * d.L + (size_t)j * d.c;
  const size_t slot = (size_t)bh * d.nc + j;
  const size_t sq = (size_t)d.dh * d.dh;
  const float* Sb = ws.S + slot * d.cp * d.cp;
  const float* dPb = ws.dP + slot * d.cp * d.cp;
  const float* qb = q + t0 * d.dh;
  const float* kb = k + t0 * d.dh;
  const float* vb = v + t0 * d.dh;
  const float* nb = ws.dnum + t0 * d.dh;
  const float* Cp = states + slot * sq;                    // carried C_j
  const float* np = states + d.slots() * sq + slot * d.dh;  // carried n_j
  const float* dC = ws.dC + slot * sq;                      // dC'
  const float* dn = ws.dn + slot * d.dh;                    // dn'
  // per row: w_l (dq) or wk_s (dk, dv); ddsum_l (dq); per column: n_p
  // (dq) or dn' (dk)
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const bool in = r0 + i < d.c;
    sm.roww[i] = in ? gates[(kind == 0 ? 2 : 3) * d.plane() + t0 + r0 + i]
                    : 0.f;
    sm.rowd[i] = in && kind == 0 ? ws.ddsum[t0 + r0 + i] : 0.f;
    sm.vec[i] = kind == 0 ? np[col0 + i] : (kind == 1 ? dn[col0 + i] : 0.f);
  }
  float ai[1][4][4] = {}, ax[1][4][4] = {};
  const bool first = j == 0, last = j == d.nc - 1;
  if (kind == 0) {
    // over the keys s < (rt + 1) 64: dP (64 x 32) k (32 x 64)
    gemm(
        ai, sm.bufs, 2 * (rt + 1),
        [&](int st, float* b) {
          stage(b, SR, dPb + st * KS, d.cp, r0, TILE, KS, d.cp, THREADS);
          stage(b + OPND_F, SC, kb + col0, d.dh, st * KS, KS, TILE, d.c,
                THREADS);
        },
        [&](const float* b, int, int m, int kk) { return rowmajor(b, m, kk); },
        [&](const float* b, int, int kk, int n) {
          return deepmajor(b + OPND_F, kk, n);
        },
        NoExtra());
    // over the depth e: dnum (64 x 32) C_p^T (32 x 64), C_p[col][e]
    if (!first)
      gemm(
          ax, sm.bufs, d.dh / KS,
          [&](int st, float* b) {
            stage(b, SR, nb + st * KS, d.dh, r0, TILE, KS, d.c, THREADS);
            stage(b + OPND_F, SR, Cp + st * KS, d.dh, col0, TILE, KS, d.dh,
                  THREADS);
          },
          [&](const float* b, int, int m, int kk) {
            return rowmajor(b, m, kk);
          },
          [&](const float* b, int, int kk, int n) {
            return rowmajor(b + OPND_F, n, kk);
          },
          NoExtra());
  } else {
    // over the queries l >= r0: dP^T or S^T (64 x 32) q or dnum (32 x 64)
    const float* A = kind == 1 ? dPb : Sb;
    const float* B = kind == 1 ? qb : nb;
    gemm(
        ai, sm.bufs, 2 * (d.nt - rt),
        [&](int st, float* b) {
          stage(b, SC, A + r0, d.cp, r0 + st * KS, KS, TILE, d.cp, THREADS);
          stage(b + OPND_F, SC, B + col0, d.dh, r0 + st * KS, KS, TILE, d.c,
                THREADS);
        },
        [&](const float* b, int, int m, int kk) {
          return deepmajor(b, kk, m);
        },
        [&](const float* b, int, int kk, int n) {
          return deepmajor(b + OPND_F, kk, n);
        },
        NoExtra());
    if (!last) {
      if (kind == 1)
        // over the depth e: v (64 x 32) dC'^T (32 x 64), dC'[col][e]
        gemm(
            ax, sm.bufs, d.dh / KS,
            [&](int st, float* b) {
              stage(b, SR, vb + st * KS, d.dh, r0, TILE, KS, d.c, THREADS);
              stage(b + OPND_F, SR, dC + st * KS, d.dh, col0, TILE, KS, d.dh,
                    THREADS);
            },
            [&](const float* b, int, int m, int kk) {
              return rowmajor(b, m, kk);
            },
            [&](const float* b, int, int kk, int n) {
              return rowmajor(b + OPND_F, n, kk);
            },
            NoExtra());
      else
        // over the depth d: k (64 x 32) dC' (32 x 64)
        gemm(
            ax, sm.bufs, d.dh / KS,
            [&](int st, float* b) {
              stage(b, SR, kb + st * KS, d.dh, r0, TILE, KS, d.c, THREADS);
              stage(b + OPND_F, SC, dC + col0, d.dh, st * KS, KS, TILE, d.dh,
                    THREADS);
            },
            [&](const float* b, int, int m, int kk) {
              return rowmajor(b, m, kk);
            },
            [&](const float* b, int, int kk, int n) {
              return deepmajor(b + OPND_F, kk, n);
            },
            NoExtra());
    }
  }
  // the epilogue: out = a ai + y, y the inter or state term; the gate
  // term (q or k) . y over these columns
  float* out = kind == 0 ? dq : (kind == 1 ? dk : dv);
  const float* gate = kind == 0 ? qb : kb;
  const float a = kind == 2 ? 1.f : d.scale;
  float g[4][4];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int rr = f.row(e), l = r0 + rr;
      float o[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = f.col(jn, e + u);
        float y;
        if (kind == 0)
          y = sm.roww[rr] * (ax[0][jn][e + u] + sm.rowd[rr] * sm.vec[cc]);
        else
          y = d.scale * sm.roww[rr] * (ax[0][jn][e + u] + sm.vec[cc]);
        o[u] = a * ai[0][jn][e + u] + y;
        g[jn][e + u] =
            l < d.c ? gate[(size_t)l * d.dh + col0 + cc] * y : 0.f;
      }
      if (l < d.c)
        *reinterpret_cast<float2*>(out + (t0 + l) * d.dh + col0 +
                                   f.col(jn, e)) = make_float2(o[0], o[1]);
    }
  if (kind == 2) return;                        // block-uniform
  const float s = row_sums(g, sm.red);
  const int t = threadIdx.x;
  if (t < TILE && r0 + t < d.c)
    (kind == 0 ? ws.xw : ws.xk)[(t0 + r0 + t) * d.ct + ct] = s;
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
  const size_t nn = (size_t)d.nt * d.nt * TILE;
  float xk = 0.f, g = 0.f;
  if (l < d.c) {
    const int lt = l / TILE, li_ = l % TILE;
    float rs = 0.f, cs = 0.f, xw = 0.f;
    for (int kt = 0; kt <= lt; ++kt)
      rs += ws.rowp[slot * nn + ((size_t)lt * d.nt + kt) * TILE + li_];
    for (int qt = lt; qt < d.nt; ++qt)
      cs += ws.colp[slot * nn + ((size_t)lt * d.nt + qt) * TILE + li_];
    for (int ct = 0; ct < d.ct; ++ct) {
      xw += ws.xw[(t0 + l) * d.ct + ct];
      xk += ws.xk[(t0 + l) * d.ct + ct];
    }
    g = ((rs - cs) + xw) - xk;
    dli[t0 + l] = cs + xk;
  }
  const float sxk = block_sum(xk, red);
  if (l < d.c) dg[l] = g;
  __syncthreads();
  if (l == 0) {
    const int parts = combine_parts(d.dh);
    float dot = 0.f;
    for (int p = 0; p < parts; ++p) dot += ws.dot[slot * parts + p];
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
  d.nt = (c + TILE - 1) / TILE, d.cp = d.nt * TILE, d.ct = dh / TILE;
  d.scale = scale;
  return d;
}

bool takes(int B, int H, int L, int dh, int c) {
  return B >= 1 && H >= 1 && L >= 1 && dh >= TILE && dh % TILE == 0 &&
         dh <= MAX_DH && c >= 1 && c <= MAX_C && L % c == 0 &&
         (long long)B * H * L * (dh / TILE) * 3 < 0x7fffffffLL;
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
  cudaStream_t st = (cudaStream_t)stream;
  const float* gt = (const float*)gates;
  const float* sts = (const float*)states;
  cudaError_t rc;
  const size_t rows = d.plane();
  mlstm_bwd_prep<<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)),
                   THREADS, 0, st>>>((const float*)h, (const float*)dh_out,
                                     gt, (const float*)dsum, w, d);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  if (d.nc > 1) {
    mlstm_bwd_inter<<<(unsigned)(d.ct * d.ct * (d.nc - 1) * d.BH), THREADS,
                      0, st>>>((const float*)q, gt, w, d);
    if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  }
  mlstm_bwd_combine<<<(unsigned)(combine_parts(dh) * d.BH), CB_THREADS, 0,
                      st>>>(gt, sts, w, d);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  mlstm_bwd_scores<<<(unsigned)(d.nt * (d.nt + 1) / 2 * d.nc * d.BH),
                     THREADS, 0, st>>>((const float*)q, (const float*)k,
                                       (const float*)v, (const float*)li, gt,
                                       w, d);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  mlstm_bwd_products<<<(unsigned)(3 * d.nt * d.ct * d.nc * d.BH), THREADS, 0,
                       st>>>((const float*)q, (const float*)k,
                             (const float*)v, gt, sts, w, d, (float*)dq,
                             (float*)dk, (float*)dv);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  mlstm_bwd_gates<<<(unsigned)(d.nc * d.BH), MAX_C, 0, st>>>(
      gt, w, d, (float*)dli, (float*)dlf);
  return (int)cudaGetLastError();
}
