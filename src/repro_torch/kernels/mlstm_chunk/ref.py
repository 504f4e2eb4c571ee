"""Plain PyTorch version of the chunkwise-mLSTM kernel: the model's
chunkwise form, which the kernel computes, and its fully recurrent form,
the ground truth both are held to.

Layout: q/k/v (B, H, L, dh) f32; li/lf (B, H, L) f32 log gates; L a
multiple of ``chunk``.  Returns h (B, H, L, dh) and the final state (C
(B, H, dh, dh), n (B, H, dh), m (B, H)).

The plain backward, ``mlstm_chunk_backward_reference`` (autograd
through the chunkwise form): the CPU path of the gradient, and the
yardstick of the backward kernel on the card.

Also, for the tests only, the kernels' own arithmetic in plain torch:
``mlstm_chunk_split`` (every chunk's state update at once, then the
ordered combine, then each chunk's outputs from its carried state),
``mlstm_chunk_backward_split`` (the backward kernel's decomposition, and
its planted faults) and ``tf32_truncate`` / ``matmul_3xtf32`` (the split
of each f32 operand into a TF32 part and a remainder that the kernels'
tensor-core products take).
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


def _split_forward(q, k, v, li, lf, chunk: int, scale, matmul) -> dict:
    """``mlstm_chunk_split``'s arithmetic, returning what it forms: h, the
    final (C, n, m), and what the kernel's forward saves for the backward
    (g, m_t, w, wk and decay a chunk; each chunk's carried C_j and n_j;
    each token's signed den before the max, ``dsum``)."""
    B, H, L, dh = q.shape
    if L % chunk:
        raise ValueError(f"L {L} is not a multiple of the chunk {chunk}")
    nc, c = L // chunk, chunk
    qc, kc, vc = (t.reshape(B, H, nc, c, dh) for t in (q, k, v))
    lic, g = li.reshape(B, H, nc, c), chunk_cumsum(lf.reshape(B, H, nc, c))
    gT = g[..., -1]                                         # (B, H, nc)
    a = gT[..., None] - g + lic                             # gT - g_s + li_s
    mloc = a.amax(-1)
    # (1) the chain over the chunks: one value each
    m_p = [torch.full((B, H), NEG_INF, dtype=q.dtype, device=q.device)]
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
    C = torch.zeros((B, H, dh, dh), dtype=q.dtype, device=q.device)
    n = torch.zeros((B, H, dh), dtype=q.dtype, device=q.device)
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
    dsum = S.sum(-1) + torch.einsum("bhjld,bhjd->bhjl", qc, npv) * w
    den = torch.maximum(dsum.abs(), torch.exp(-m_t))
    h = (num / den[..., None]).reshape(B, H, L, dh)
    return {"h": h, "C": C, "n": n, "m": m_after[..., -1], "m_t": m_t,
            "D": D, "w": w, "wk": wk, "decay": decay, "Cp": Cp, "np": npv,
            "dsum": dsum}


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
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    f = _split_forward(q, k, v, li, lf, chunk, scale, matmul)
    return f["h"], (f["C"], f["n"], f["m"])


def mlstm_chunk_backward_reference(q, k, v, li, lf, chunk: int, dh_out):
    """The gradients (dq, dk, dv, dli, dlf) of ``sum(h * dh_out)``, h the
    chunkwise mLSTM from no history (``mlstm_chunk_reference``), by
    ``torch.autograd`` through the plain chunkwise form, in the inputs'
    dtype.  The final state (C, n, m) takes no cotangent.  The plain
    backward: the CPU path, and the yardstick of the kernel on the card."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v, li, lf)]
        h, _ = mlstm_chunk_reference(*leaves, chunk)
        return torch.autograd.grad(h, leaves, dh_out.to(h.dtype))


# planted faults of the backward's arithmetic (``mlstm_chunk_backward_split``'s
# ``fault``), each of which its checks on the card must catch
BACKWARD_FAULTS = ("dC's carry dropped at a chunk boundary",
                   "the decay term left out of dlf",
                   "w left out of the inter term",
                   "den's sign branch dropped",
                   "one 64-key tile left out of dk",
                   "the 3xTF32 correction terms dropped")

# the backward kernel's output strips: dh in 192-column strips and a
# remainder, each strip's gate terms summed apart and the strips in order
BACKWARD_STRIP = 192


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with each operand truncated to TF32 and no correction
    terms: plain TF32 products, the planted fault of 3xTF32."""
    return tf32_truncate(a) @ tf32_truncate(b)


def _strip_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over its last dimension as the kernel sums a gate
    term: each ``BACKWARD_STRIP``-column strip apart, then the strips in
    order."""
    parts = [p.sum(-1) for p in x.split(BACKWARD_STRIP, dim=-1)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def mlstm_chunk_backward_split(q, k, v, li, lf, chunk: int, dh_out,
                               fault=None):
    """``mlstm_chunk_backward_reference``'s gradients decomposed as the
    backward kernel (``csrc/mlstm_chunk_bwd.cu``) computes them, from what
    the forward saves (``_split_forward``): every stabilizer (m_t, m_p,
    m') held constant, since h does not depend on them (num and den both
    scale by exp(-m_t), the exp(-m_t) branch of den's max too), so that
    their gradient is 0 and the exp(-m_t) branch passes none.  In order:
    (1) each token's dnum = dh / den and dsum's cotangent ddsum = -(dh .
    h) / den sign(dsum) where |dsum| wins den's max (0 elsewhere); (2)
    every chunk's inter term E_j = sum_l (w_l q_l)^T dnum_l and its n
    counterpart at once; (3) the reverse combine dC_j = decay_j dC_{j+1} +
    E_j back over the chunks, the last chunk's dC' 0 (the final state
    takes no cotangent), with each chunk's decay term <dC', C_p> + <dn',
    n_p>; (4) per chunk S = scale q k^T D, dS = dnum v^T + ddsum, dP = dS
    D, kept as dP' = scale dP, and da = dS S; (5) dq, dk and dv: first
    the inter or state-update term, with its gate term (q . dq_inter, k .
    dk_state) summed strip by strip (``BACKWARD_STRIP``), then the intra
    product from dP' or S added on top; (6) dg from da's row and column
    sums and those terms, dli, and dlf as dg's reverse cumulative sum in
    the chunk.  ``fault`` plants one of ``BACKWARD_FAULTS``: the reverse
    combine's carry zeroed into chunk nc/2 - 1, the decay term dropped
    from dg, the inter term without its factor w, ddsum without
    sign(dsum), the first 64 keys of every chunk without dk's intra
    term, or every product of the backward in plain TF32 (each operand
    truncated, no correction terms).  -> (dq, dk, dv, dli, dlf) in the
    inputs' dtype."""
    if fault is not None and fault not in BACKWARD_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    B, H, L, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    nc, c = L // chunk, chunk
    f = _split_forward(q, k, v, li, lf, chunk, scale, torch.matmul)
    qc, kc, vc = (t.reshape(B, H, nc, c, dh) for t in (q, k, v))
    hc, doc = (t.reshape(B, H, nc, c, dh) for t in (f["h"], dh_out))
    # (1) each token's cotangents of num and of dsum
    dsum, floor = f["dsum"], torch.exp(-f["m_t"])
    den = torch.maximum(dsum.abs(), floor)
    dnum = doc / den[..., None]
    sign = (torch.ones_like(dsum) if fault == BACKWARD_FAULTS[3]
            else torch.sign(dsum))
    ddsum = torch.where(dsum.abs() >= floor,
                        -sign * (doc * hc).sum(-1) / den, 0.0)
    w, wk, decay = f["w"], f["wk"], f["decay"]
    mm = matmul_tf32 if fault == BACKWARD_FAULTS[5] else torch.matmul
    # (2) every chunk's inter term (the first chunk's w are 0)
    E = mm((w[..., None] * qc).transpose(-1, -2), dnum)
    En = ((w * ddsum)[..., None] * qc).sum(-2)
    # (3) the reverse combine: the cotangent of the state after each chunk
    G = torch.zeros_like(E[:, :, 0])
    Gn = torch.zeros_like(En[:, :, 0])
    dCn, dnn, Xd = [None] * nc, [None] * nc, [None] * nc
    for j in reversed(range(nc)):
        if fault == BACKWARD_FAULTS[0] and j == nc // 2 - 1:
            G, Gn = torch.zeros_like(G), torch.zeros_like(Gn)
        dCn[j], dnn[j] = G, Gn
        Xd[j] = decay[..., j] * ((G * f["Cp"][:, :, j]).sum((-1, -2))
                                 + (Gn * f["np"][:, :, j]).sum(-1))
        G = decay[..., j, None, None] * G + E[:, :, j]
        Gn = decay[..., j, None] * Gn + En[:, :, j]
    dCn, dnn, Xd = (torch.stack(t, dim=2) for t in (dCn, dnn, Xd))
    # (4) the scores and their cotangents
    D = f["D"]
    S = mm(qc, kc.transpose(-1, -2)) * scale * D
    dS = torch.where(D > 0, mm(dnum, vc.transpose(-1, -2))
                     + ddsum[..., None], 0.0)
    dPs = scale * (dS * D)
    da = dS * S
    # (5) the products: the inter or state term, then the intra product
    wq = torch.ones_like(w) if fault == BACKWARD_FAULTS[2] else w
    dq_inter = wq[..., None] * (mm(dnum, f["Cp"].transpose(-1, -2))
                                + ddsum[..., None] * f["np"][..., None, :])
    dq = dq_inter + mm(dPs, kc)
    dk_state = scale * wk[..., None] * (mm(vc, dCn.transpose(-1, -2))
                                        + dnn[..., None, :])
    dPk = dPs
    if fault == BACKWARD_FAULTS[4]:
        dPk = dPs.clone()
        dPk[..., :64] = 0.0
    dk = dk_state + mm(dPk.transpose(-1, -2), qc)
    dv = scale * wk[..., None] * mm(kc, dCn) + \
        mm(S.transpose(-1, -2), dnum)
    Xw = _strip_sum(qc * dq_inter)
    Xk = _strip_sum(kc * dk_state)
    # (6) the gates
    col = da.sum(-2)
    dg = da.sum(-1) - col + Xw - Xk
    dg[..., -1] += Xk.sum(-1) + (0.0 if fault == BACKWARD_FAULTS[1] else Xd)
    dli = col + Xk
    dlf = dg.flip(-1).cumsum(-1).flip(-1)
    return (dq.reshape(B, H, L, dh), dk.reshape(B, H, L, dh),
            dv.reshape(B, H, L, dh), dli.reshape(B, H, L),
            dlf.reshape(B, H, L))


__all__ = ["BACKWARD_FAULTS", "BACKWARD_STRIP", "chunk_cumsum",
           "matmul_3xtf32", "matmul_tf32",
           "mlstm_chunk_backward_reference",
           "mlstm_chunk_backward_split", "mlstm_chunk_reference",
           "mlstm_chunk_split",
           "mlstm_recurrent_reference", "tf32_truncate"]
