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
// of width dh it does 4 c^2 dh + 4 c dh^2 flops against 16 c dh bytes of
// q, k, v and h: about 290 flops a byte at c = dh = 256-384, far past the
// f32 CUDA-core ridge (about 20).
//
// What the design does: the TPU kernel keeps C (dh x dh f32, 576 KB at dh
// = 384) and the c x c decay matrix in VMEM; a Hopper block has 227 KB of
// shared memory.  So the grid is (dh / 64, H, B): each block walks the
// chunks of one (b, h) in order (the TPU grid's sequential chunk axis)
// and owns a 64-column slice of C (dh x 64 f32, 96 KB at dh = 384) in
// shared memory.  n and m do not depend on v, so every block keeps its
// own copy and the first block writes them.  No c x c matrix is stored:
// query tiles of 64 rows meet key tiles of 64, the scores over the whole
// depth are accumulated in registers (each block recomputes them: 6x at
// dh = 384), and the decay is computed on the fly from g and m_t, which
// sit in shared memory with li.  A chunk's outputs read C_p before a
// barrier, and only then is C updated in place.  Products are f32 FMAs on
// CUDA cores (tensor cores' TF32 would round the inputs to 10 bits), 4x4
// register tiles per thread.  Not yet done: tensor cores (wgmma), TMA,
// splitting a (b, h) over more blocks at small B.
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;   // JAX's NEG_INF: m_p + g stays finite
constexpr int THREADS = 256;        // a 16 x 16 grid of 4x4 register tiles
constexpr int TILE = 64;            // query rows, key rows, C columns
constexpr int DT = 32;              // depth step of the score products
constexpr int MAX_C = 256;          // chunk length staged in shared memory

size_t smem_floats(int dh) {
  return (size_t)dh * TILE + dh + 4 * MAX_C + 2 * TILE * (DT + 1) +
         TILE * (TILE + 1) + TILE * TILE;
}

__global__ void __launch_bounds__(THREADS)
mlstm_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ li,
                   const float* __restrict__ lf, float* __restrict__ h,
                   float* __restrict__ C, float* __restrict__ n,
                   float* __restrict__ m, int H, int L, int dh, int c,
                   float scale) {
  extern __shared__ float smem[];
  float* Cs = smem;                         // [dh][TILE] this block's slice
  float* ns = Cs + (size_t)dh * TILE;       // [dh]
  float* gs = ns + dh;                      // [MAX_C] cumsum of lf
  float* ls = gs + MAX_C;                   // [MAX_C] li
  float* ms = ls + MAX_C;                   // [MAX_C] m_t
  float* ws = ms + MAX_C;                   // [MAX_C] w_l, then wk_s
  float* qs = ws + MAX_C;                   // [TILE][DT+1]
  float* ks = qs + TILE * (DT + 1);         // [TILE][DT+1]; [DT][TILE+1]
  float* ps = ks + TILE * (DT + 1);         // [TILE][TILE+1]; [DT][TILE]
  float* vs = ps + TILE * (TILE + 1);       // [TILE][TILE]
  __shared__ float m_prev, m_next;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // columns tx+16j, rows ty+16i
  const int j0 = blockIdx.x * TILE;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* qb = q + bh * L * dh;
  const float* kb = k + bh * L * dh;
  const float* vb = v + bh * L * dh;
  float* hb = h + bh * L * dh;

  for (int i = tid; i < dh * TILE; i += THREADS) Cs[i] = 0.f;
  for (int i = tid; i < dh; i += THREADS) ns[i] = 0.f;
  if (tid == 0) m_prev = NEG_INF;
  __syncthreads();

  // q rows [r0, r0+TILE) (or k rows, into dst) x depth [d0, d0+DT) of the
  // chunk at t0, zero past the chunk's end
  auto stage = [&](float* dst, const float* src, int t0, int r0, int d0) {
    for (int i = tid; i < TILE * DT; i += THREADS) {
      const int r = i / DT, cc = i % DT;
      dst[r * (DT + 1) + cc] =
          r0 + r < c ? src[(size_t)(t0 + r0 + r) * dh + d0 + cc] : 0.f;
    }
  };

  for (int t0 = 0; t0 < L; t0 += c) {
    const float mp = m_prev;
    for (int i = tid; i < c; i += THREADS) {
      ls[i] = li[bh * L + t0 + i];
      gs[i] = lf[bh * L + t0 + i];
    }
    __syncthreads();
    if (tid == 0)
      for (int i = 1; i < c; ++i) gs[i] += gs[i - 1];
    __syncthreads();
    for (int l = tid; l < c; l += THREADS) {
      const float gl = gs[l];
      float mi = gl - gs[0] + ls[0];
      for (int s = 1; s <= l; ++s) mi = fmaxf(mi, gl - gs[s] + ls[s]);
      const float mt = fmaxf(mi, gl + mp);
      ms[l] = mt;
      ws[l] = expf(gl + mp - mt);
    }
    __syncthreads();

    // ---- outputs: one 64-row query tile at a time ----------------------
    for (int r0 = 0; r0 < c; r0 += TILE) {
      float acc[4][4] = {}, den[4] = {}, qn[4] = {};
      // inter-chunk term q C_p and q . n_p
      for (int d0 = 0; d0 < dh; d0 += DT) {
        stage(qs, qb, t0, r0, d0);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < DT; ++kk) {
          float cv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) cv[j] = Cs[(d0 + kk) * TILE + tx + 16 * j];
          const float nv = ns[d0 + kk];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float qv = qs[(ty + 16 * i) * (DT + 1) + kk];
            qn[i] = fmaf(qv, nv, qn[i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv, cv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = r0 + ty + 16 * i;
        const float w = l < c ? ws[l] : 0.f;
        qn[i] *= w;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= w;
      }
      // intra-chunk term over the key tiles at or before this query tile
      for (int s0 = 0; s0 <= r0; s0 += TILE) {
        float sc[4][4] = {};
        for (int d0 = 0; d0 < dh; d0 += DT) {
          stage(qs, qb, t0, r0, d0);
          stage(ks, kb, t0, s0, d0);
          __syncthreads();
#pragma unroll 4
          for (int kk = 0; kk < DT; ++kk) {
            float kv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (DT + 1) + kk];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float qv = qs[(ty + 16 * i) * (DT + 1) + kk];
#pragma unroll
              for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv, kv[j], sc[i][j]);
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float p = 0.f;
            if (l < c && s <= l)
              p = sc[i][j] * scale * expf(gs[l] - gs[s] + ls[s] - ms[l]);
            ps[(ty + 16 * i) * (TILE + 1) + tx + 16 * j] = p;
            den[i] += p;
          }
        }
        for (int i = tid; i < TILE * TILE; i += THREADS) {
          const int r = i / TILE, e = i % TILE;
          vs[i] = s0 + r < c ? vb[(size_t)(t0 + s0 + r) * dh + j0 + e] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < TILE; ++s) {
          float vv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = vs[s * TILE + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = ps[(ty + 16 * i) * (TILE + 1) + s];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
      // a row's score sum is spread over the 16 lanes of its half-warp
#pragma unroll
      for (int i = 0; i < 4; ++i)
        for (int off = 8; off; off >>= 1)
          den[i] += __shfl_xor_sync(0xffffffffu, den[i], off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = r0 + ty + 16 * i;
        if (l >= c) continue;
        const float dd = fmaxf(fabsf(den[i] + qn[i]), expf(-ms[l]));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hb[(size_t)(t0 + l) * dh + j0 + tx + 16 * j] = acc[i][j] / dd;
      }
    }
    __syncthreads();   // every output has read C_p and n_p

    // ---- state hand-off ------------------------------------------------
    const float gT = gs[c - 1];
    if (tid == 0) {
      float mx = gT - gs[0] + ls[0];
      for (int s = 1; s < c; ++s) mx = fmaxf(mx, gT - gs[s] + ls[s]);
      m_next = fmaxf(gT + mp, mx);
    }
    __syncthreads();
    const float mn = m_next;
    const float decay = expf(gT + mp - mn);
    for (int s = tid; s < c; s += THREADS) ws[s] = expf(gT - gs[s] + ls[s] - mn);
    __syncthreads();
    for (int d0 = 0; d0 < dh; d0 += TILE) {
      float cacc[4][4] = {}, nacc[4] = {};
      for (int s0 = 0; s0 < c; s0 += DT) {
        for (int i = tid; i < DT * TILE; i += THREADS) {
          const int ss = i / TILE, e = i % TILE, s = s0 + ss;
          const bool in = s < c;
          ks[ss * (TILE + 1) + e] =
              in ? kb[(size_t)(t0 + s) * dh + d0 + e] * scale : 0.f;
          ps[i] = in ? ws[s] * vb[(size_t)(t0 + s) * dh + j0 + e] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int ss = 0; ss < DT; ++ss) {
          const float wk = s0 + ss < c ? ws[s0 + ss] : 0.f;
          float wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = ps[ss * TILE + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float kv = ks[ss * (TILE + 1) + ty + 16 * i];
            nacc[i] = fmaf(kv, wk, nacc[i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) cacc[i][j] = fmaf(kv, wv[j], cacc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = d0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& cd = Cs[d * TILE + tx + 16 * j];
          cd = decay * cd + cacc[i][j];
        }
        if (tx == 0) ns[d] = decay * ns[d] + nacc[i];
      }
    }
    if (tid == 0) m_prev = mn;
    __syncthreads();
  }

  float* Cb = C + bh * dh * dh;
  for (int i = tid; i < dh * TILE; i += THREADS)
    Cb[(size_t)(i / TILE) * dh + j0 + i % TILE] = Cs[i];
  if (blockIdx.x == 0) {
    for (int i = tid; i < dh; i += THREADS) n[bh * dh + i] = ns[i];
    if (tid == 0) m[bh] = m_prev;
  }
}

}  // namespace

// q/k/v (B, H, L, dh), li/lf (B, H, L) -> h (B, H, L, dh), C (B, H, dh,
// dh), n (B, H, dh), m (B, H); all f32 and contiguous.  dh a multiple of
// 64 up to 512 (the wrapper pads any other width with zero columns and
// passes the true width's scale, 1/sqrt(dh)); the chunk c divides L and is
// at most 256.  Returns a cudaError_t.
extern "C" int mlstm_chunk_f32(const void* q, const void* k, const void* v,
                               const void* li, const void* lf, void* h,
                               void* C, void* n, void* m, int B, int H,
                               int L, int dh, int c, float scale,
                               void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || dh < TILE ||
      dh % TILE || dh > 512 || c < 1 || c > MAX_C || L % c)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(dh / TILE, H, B);
  mlstm_chunk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)li,
      (const float*)lf, (float*)h, (float*)C, (float*)n, (float*)m, H, L, dh,
      c, scale);
  return (int)cudaGetLastError();
}
