"""Plain PyTorch version of the chunkwise-mLSTM kernel: the model's
chunkwise form, which the kernel computes, and its fully recurrent form,
the ground truth both are held to.

Layout: q/k/v (B, H, L, dh) f32; li/lf (B, H, L) f32 log gates; L a
multiple of ``chunk``.  Returns h (B, H, L, dh) and the final state (C
(B, H, dh, dh), n (B, H, dh), m (B, H)).

Also, for the tests only, the kernel's own arithmetic in plain torch:
``mlstm_chunk_split`` (every chunk's state update at once, then the
ordered combine, then each chunk's outputs from its carried state) and
``tf32_truncate`` / ``matmul_3xtf32`` (the split of each f32 operand
into a TF32 part and a remainder that the kernel's tensor-core products
take).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.xlstm import NEG_INF, chunk_cumsum
from repro_torch.models.xlstm import (
    mlstm_chunkwise as mlstm_chunk_reference,
    mlstm_recurrent as mlstm_recurrent_reference)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with its low 13 mantissa bits cleared: the TF32 value
    (10 mantissa bits) a tensor-core product reads from an f32 register,
    and the kernel's high part."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel's products take it: each operand split into
    its TF32 part and the remainder (which the product reads truncated
    to TF32), the three products that matter (hi hi, hi lo, lo hi) each
    exact (TF32 times TF32 fits f32) and summed in f32."""
    ah, bh = tf32_truncate(a), tf32_truncate(b)
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def mlstm_chunk_split(q, k, v, li, lf, chunk: int, scale=None,
                      matmul=torch.matmul):
    """The chunkwise mLSTM from no history, decomposed as the kernel runs
    it: (1) the gates of every chunk, the stabilizer chain m' = max(gT +
    m_p, max_s(gT - g_s + li_s)) over the chunks; (2) every chunk's own
    update U_j = sum_s (k_s scale)^T (wk_s v_s) at once, wk_s relative to
    the chunk's m'; (3) the ordered combine C_{j+1} = decay_j C_j + U_j;
    (4) each chunk's outputs from its carried C_j.  The row maxima m_t
    come from a prefix max of li - g, as in the kernel.  ``matmul`` takes
    the products (``matmul_3xtf32``: the kernel's tensor-core arithmetic).
    -> h, (C, n, m) as ``mlstm_chunk_reference``."""
    B, H, L, dh = q.shape
    if L % chunk:
        raise ValueError(f"L {L} is not a multiple of the chunk {chunk}")
    nc, c = L // chunk, chunk
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qc, kc, vc = (t.reshape(B, H, nc, c, dh) for t in (q, k, v))
    lic, g = li.reshape(B, H, nc, c), chunk_cumsum(lf.reshape(B, H, nc, c))
    gT = g[..., -1]                                         # (B, H, nc)
    a = gT[..., None] - g + lic                             # gT - g_s + li_s
    mloc = a.amax(-1)
    # (1) the chain over the chunks: one value each
    m_p = [torch.full((B, H), NEG_INF, dtype=torch.float32,
                      device=q.device)]
    for j in range(nc):
        m_p.append(torch.maximum(gT[..., j] + m_p[-1], mloc[..., j]))
    m_before = torch.stack(m_p[:-1], dim=-1)                # (B, H, nc)
    m_after = torch.stack(m_p[1:], dim=-1)
    decay = torch.exp(gT + m_before - m_after)
    wk = torch.exp(a - m_after[..., None])                  # (B, H, nc, c)
    # (2) every chunk's update at once
    ks = kc * scale
    U = matmul(ks.transpose(-1, -2), wk[..., None] * vc)   # (B, H, nc, dh, dh)
    Un = (wk[..., None] * ks).sum(-2)                      # (B, H, nc, dh)
    # (3) the ordered combine: the state each chunk starts from
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    Cp, npv = [], []
    for j in range(nc):
        Cp.append(C)
        npv.append(n)
        C = decay[..., j, None, None] * C + U[:, :, j]
        n = decay[..., j, None] * n + Un[:, :, j]
    Cp, npv = torch.stack(Cp, dim=2), torch.stack(npv, dim=2)
    # (4) the outputs of every chunk from its carried state
    m_intra = g + torch.cummax(lic - g, dim=-1).values
    m_inter = g + m_before[..., None]
    m_t = torch.maximum(m_intra, m_inter)
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    dmat = (g[..., :, None] - g[..., None, :]) + lic[..., None, :]
    D = torch.where(mask, torch.exp(dmat - m_t[..., None]), 0.0)
    S = matmul(qc, kc.transpose(-1, -2)) * scale * D
    w = torch.exp(m_inter - m_t)
    num = matmul(S, vc) + matmul(qc, Cp) * w[..., None]
    den = S.sum(-1) + torch.einsum("bhjld,bhjd->bhjl", qc, npv) * w
    den = torch.maximum(den.abs(), torch.exp(-m_t))
    h = (num / den[..., None]).reshape(B, H, L, dh)
    return h, (C, n, m_after[..., -1])


__all__ = ["chunk_cumsum", "matmul_3xtf32", "mlstm_chunk_reference",
           "mlstm_chunk_split",
           "mlstm_recurrent_reference", "tf32_truncate"]
