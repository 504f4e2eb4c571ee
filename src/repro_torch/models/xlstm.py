"""xLSTM blocks of the port: mLSTM (matrix memory, parallelizable) and
sLSTM (scalar memory, strictly recurrent), arXiv:2405.04517.

mLSTM has three numerically equivalent forms, all with log-space gate
stabilization (a running max ``m``):
  * ``mlstm_recurrent`` — step recurrence (decode and verify; O(1) state
    a token)
  * ``mlstm_parallel``  — the quadratic attention-like form (short prompts)
  * ``mlstm_chunkwise`` — quadratic inside a chunk, recurrent across
    chunks (long prefill); what the ``mlstm_chunk`` kernel computes, and
    that kernel's plain version

Per-head layout of the mLSTM core: q, k, v (B, H, L, dh) and the log
gates li, lf (B, H, L), all f32.  The states are updated by the caller
(``LM``) in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import PSpec
from repro_torch.models.ssm import _conv1d_causal

NEG_INF = -1e30       # "no history": finite, so m + g stays finite


class MLSTMState(NamedTuple):
    C: torch.Tensor      # (B, H, dk, dv) f32 matrix memory
    n: torch.Tensor      # (B, H, dk) f32 normalizer
    m: torch.Tensor      # (B, H) f32 stabilizer
    conv: torch.Tensor   # (B, d_in, K-1) last inputs of the causal conv


class SLSTMState(NamedTuple):
    h: torch.Tensor      # (B, H, dh) f32
    c: torch.Tensor      # (B, H, dh) f32
    n: torch.Tensor      # (B, H, dh) f32
    m: torch.Tensor      # (B, H, dh) f32


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ArchConfig) -> dict:
    x = cfg.xlstm
    d = cfg.d_model
    d_in = x.mlstm_expand * d
    H = cfg.num_heads
    return {
        "up_proj": PSpec((d, 2 * d_in)),
        "conv_w": PSpec((x.conv_width, d_in), init="scaled", scale=0.1),
        "conv_b": PSpec((d_in,), init="zeros"),
        "wq": PSpec((d_in, d_in)),
        "wk": PSpec((d_in, d_in)),
        "wv": PSpec((d_in, d_in)),
        "w_if": PSpec((d_in, 2 * H), init="scaled", scale=0.02),
        "b_if": PSpec((2 * H,), init="zeros"),
        "down_proj": PSpec((d_in, d)),
        "skip_scale": PSpec((d_in,), init="ones"),
    }


def slstm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    dff = int(4 * d * 2 / 3)
    return {
        "w_gates": PSpec((d, 4 * d)),                       # i, f, z, o
        "r_gates": PSpec((4, H, dh, dh), init="scaled", scale=0.02),
        "b_gates": PSpec((4 * d,), init="zeros"),
        "ffn": {
            "w_gate": PSpec((d, dff)),
            "w_up": PSpec((d, dff)),
            "w_down": PSpec((dff, d)),
        },
    }


# ---------------------------------------------------------------------------
# mLSTM core (f32)
# ---------------------------------------------------------------------------

def _fresh(q, dv):
    """No history, in q's dtype (f32 on every model path)."""
    B, H, _, dk = q.shape
    return (torch.zeros((B, H, dk, dv), dtype=q.dtype, device=q.device),
            torch.zeros((B, H, dk), dtype=q.dtype, device=q.device),
            torch.full((B, H), NEG_INF, dtype=q.dtype, device=q.device))


def chunk_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sum along the last axis in one fixed order on every
    device, the ``mlstm_chunk`` kernel's: Sklansky levels over the axis
    zero-padded to a power of two, level s adding the last value of each
    block's lower half (blocks of 2 s) to every value of its upper half.
    Every output is a tree sum of at most log2(c) + 1 levels, whatever
    the batch; ``torch.cumsum`` on a CUDA tensor picks its order from
    the tensor's shape."""
    c = x.shape[-1]
    p2 = 1 << max(c - 1, 0).bit_length()
    y = F.pad(x, (0, p2 - c))
    lead = y.shape[:-1]
    s = 1
    while s < p2:
        y = y.reshape(*lead, p2 // (2 * s), 2, s)
        lo, hi = y[..., 0, :], y[..., 1, :] + y[..., 0, -1:]
        y = torch.stack((lo, hi), dim=-2).reshape(*lead, p2)
        s *= 2
    return y[..., :c]


def mlstm_parallel(q, k, v, li, lf):
    """Quadratic stabilized form from no history.  -> h (B, H, L, dv) and
    the final state (C, n, m)."""
    L, dk = q.shape[2], q.shape[3]
    Fc = torch.cumsum(lf, dim=-1)                            # (B, H, L)
    # d_ts = F_t - F_s + li_s for s <= t
    dmat = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~mask, NEG_INF)
    m = dmat.amax(dim=-1)                                    # (B, H, L)
    D = torch.exp(dmat - m[..., None])
    scores = q @ k.transpose(-1, -2) / math.sqrt(dk)
    Cm = scores * D
    n = torch.maximum(Cm.sum(dim=-1).abs(), torch.exp(-m))
    h = (Cm @ v) / n[..., None]
    g = Fc[..., -1:]                                         # (B, H, 1)
    m_fin = (g - Fc + li).amax(dim=-1).clamp(min=NEG_INF)
    w = torch.exp(g - Fc + li - m_fin[..., None])            # (B, H, L)
    ks = k / math.sqrt(dk)
    C_fin = (ks * w[..., None]).transpose(-1, -2) @ v
    n_fin = torch.einsum("bhs,bhsd->bhd", w, ks)
    return h, (C_fin, n_fin, m_fin)


def mlstm_step(C, n, m, q, k, v, li, lf):
    """One recurrence step.  q, k, v: (B, H, dh); li, lf: (B, H)."""
    dk = q.shape[-1]
    m_new = torch.maximum(lf + m, li)                        # (B, H)
    f_s = torch.exp(lf + m - m_new)[..., None]
    i_s = torch.exp(li - m_new)[..., None]
    k = k / math.sqrt(dk)
    C_new = f_s[..., None] * C + i_s[..., None] * k[..., :, None] * \
        v[..., None, :]
    n_new = f_s * n + i_s * k
    num = torch.einsum("bhde,bhd->bhe", C_new, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n_new, q).abs(),
                        torch.exp(-m_new))
    return C_new, n_new, m_new, num / den[..., None]


def mlstm_recurrent(q, k, v, li, lf, state=None):
    """Sequential scan over L from ``state`` ((C, n, m), or no history):
    the ground truth, and the decode/verify path."""
    C, n, m = _fresh(q, v.shape[-1]) if state is None else state
    hs = []
    for t in range(q.shape[2]):
        C, n, m, h = mlstm_step(C, n, m, q[:, :, t], k[:, :, t], v[:, :, t],
                                li[:, :, t], lf[:, :, t])
        hs.append(h)
    return torch.stack(hs, dim=2), (C, n, m)


def mlstm_chunkwise(q, k, v, li, lf, chunk: int, state=None, scale=None):
    """Chunked form: the quadratic form inside each chunk plus the
    recurrent hand-off of (C, n, m) across chunks.  L % chunk == 0.  The
    keys are scaled by 1/sqrt(dk), or by ``scale`` where given (a width
    padded with zero columns keeps its true width's scale)."""
    L, dk = q.shape[2], q.shape[3]
    if L % chunk:
        raise ValueError(f"L {L} is not a multiple of the chunk {chunk}")
    C_p, n_p, m_p = _fresh(q, v.shape[-1]) if state is None else state
    sq = math.sqrt(dk) if scale is None else 1.0 / scale
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    hs = []
    for t0 in range(0, L, chunk):
        qc, kc, vc = (a[:, :, t0:t0 + chunk] for a in (q, k, v))
        lic, lfc = li[:, :, t0:t0 + chunk], lf[:, :, t0:t0 + chunk]
        g = chunk_cumsum(lfc)                                # (B, H, c)
        dmat = g[..., :, None] - g[..., None, :] + lic[..., None, :]
        dmat = dmat.masked_fill(~mask, NEG_INF)
        m_intra = dmat.amax(dim=-1)                          # (B, H, c)
        m_inter = g + m_p[..., None]
        m_t = torch.maximum(m_intra, m_inter)
        sD = (qc @ kc.transpose(-1, -2)) / sq * torch.exp(
            dmat - m_t[..., None])
        w_inter = torch.exp(m_inter - m_t)[..., None]        # (B, H, c, 1)
        num = sD @ vc + (qc @ C_p) * w_inter
        den = sD.sum(dim=-1) + torch.einsum("bhld,bhd->bhl", qc,
                                            n_p) * w_inter[..., 0]
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])
        # chunk-final state
        gT = g[..., -1:]                                     # (B, H, 1)
        m_new = torch.maximum(gT[..., 0] + m_p,
                              (gT - g + lic).amax(dim=-1))
        wk = torch.exp(gT - g + lic - m_new[..., None])      # (B, H, c)
        ks = kc / sq
        decay = torch.exp(gT[..., 0] + m_p - m_new)          # (B, H)
        C_p = decay[..., None, None] * C_p + \
            ks.transpose(-1, -2) @ (wk[..., None] * vc)
        n_p = decay[..., None] * n_p + torch.einsum("bhs,bhsd->bhd", wk, ks)
        m_p = m_new
    return torch.cat(hs, dim=2), (C_p, n_p, m_p)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mlstm_qkv(params, x, cfg: ArchConfig, conv_state=None):
    H = cfg.num_heads
    xz = x @ params["up_proj"].to(x.dtype)
    xi, z = xz.chunk(2, dim=-1)                              # (B, L, d_in)
    xc, conv_new = _conv1d_causal(xi, params["conv_w"].to(x.dtype),
                                  params["conv_b"].to(x.dtype), conv_state)
    xc = F.silu(xc)
    B, L, d_in = xi.shape
    dh = d_in // H

    def heads(t):
        return t.reshape(B, L, H, dh).transpose(1, 2).float()

    q = heads(xc @ params["wq"].to(x.dtype))
    k = heads(xc @ params["wk"].to(x.dtype))
    v = heads(xi @ params["wv"].to(x.dtype))
    gates = (xc @ params["w_if"].to(x.dtype)
             + params["b_if"].to(x.dtype)).float()
    li, lf_raw = gates.chunk(2, dim=-1)                      # (B, L, H)
    li = li.transpose(1, 2)
    lf = F.logsigmoid(lf_raw).transpose(1, 2)                # log f < 0
    return q, k, v, li, lf, z, xi, conv_new


def mlstm_block(params, x, cfg: ArchConfig, mode: str = "parallel",
                state: MLSTMState | None = None):
    """x: (B, L, D) -> (y, the new ``MLSTMState``).  ``mode`` parallel |
    chunkwise (the ``mlstm_chunk`` kernel) from no history, or recurrent
    from ``state`` (decode and verify)."""
    # imported here: the kernel's plain version (its ref.py) is this module
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    if mode in ("parallel", "chunkwise") and state is not None:
        raise ValueError(f"mlstm mode {mode!r} starts from no history")
    B, L, _ = x.shape
    conv_state = None if state is None else state.conv
    q, k, v, li, lf, z, xi, conv_new = _mlstm_qkv(params, x, cfg, conv_state)
    if mode == "parallel":
        h, fin = mlstm_parallel(q, k, v, li, lf)
    elif mode == "chunkwise":
        h, fin = mlstm_chunk(q, k, v, li, lf, chunk=cfg.xlstm.chunk_size)
    elif mode == "recurrent":
        h, fin = mlstm_recurrent(q, k, v, li, lf,
                                 None if state is None else
                                 (state.C, state.n, state.m))
    else:
        raise ValueError(f"unknown mlstm mode {mode!r}")
    h = h.transpose(1, 2).reshape(B, L, xi.shape[-1]).to(x.dtype)
    h = h + params["skip_scale"].to(x.dtype) * xi            # learnable skip
    y = (h * F.silu(z)) @ params["down_proj"].to(x.dtype)
    return y, MLSTMState(C=fin[0], n=fin[1], m=fin[2], conv=conv_new)


def slstm_block(params, x, cfg: ArchConfig, state: SLSTMState | None = None):
    """Strictly recurrent sLSTM with exponential gating, then its gated
    FFN.  x: (B, L, D) -> (y, the new ``SLSTMState``).  One step of about
    fifteen small ops per token: no kernel (the JAX package has none)."""
    B, L, D = x.shape
    H = cfg.num_heads
    dh = D // H
    gates_x = x @ params["w_gates"].to(x.dtype) + params["b_gates"].to(x.dtype)
    gates_x = gates_x.reshape(B, L, 4, H, dh).float()
    R = params["r_gates"].float()                            # (4, H, dh, dh)
    if state is None:
        state = init_slstm_state(cfg, B, x.device)
    h, c, n, m = state
    hs = []
    for t in range(L):
        gx = gates_x[:, t]                                   # (B, 4, H, dh)
        rec = torch.einsum("ghde,bhd->gbhe", R, h)           # (4, B, H, dh)
        gi, gf, gz, go = (gx[:, i] + rec[i] for i in range(4))
        m_new = torch.maximum(gf + m, gi)
        i_s = torch.exp(gi - m_new)
        f_s = torch.exp(gf + m - m_new)
        c = f_s * c + i_s * torch.tanh(gz)
        n = f_s * n + i_s
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, L, D).to(x.dtype)
    f = params["ffn"]
    y = y + (F.gelu(y @ f["w_gate"].to(x.dtype), approximate="tanh")
             * (y @ f["w_up"].to(x.dtype))) @ f["w_down"].to(x.dtype)
    return y, SLSTMState(h=h, c=c, n=n, m=m)


# ---------------------------------------------------------------------------
# state factories
# ---------------------------------------------------------------------------

def init_mlstm_state(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> MLSTMState:
    """C, n and m in f32 whatever the cache dtype; the conv inputs in
    ``dtype``."""
    d_in = cfg.xlstm.mlstm_expand * cfg.d_model
    H = cfg.num_heads
    dh = d_in // H
    K = cfg.xlstm.conv_width
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        C=torch.zeros((batch, H, dh, dh), **f32),
        n=torch.zeros((batch, H, dh), **f32),
        m=torch.full((batch, H), NEG_INF, **f32),
        conv=torch.zeros((batch, d_in, K - 1), dtype=dtype, device=device))


def init_slstm_state(cfg: ArchConfig, batch: int, device=None) -> SLSTMState:
    H = cfg.num_heads
    dh = cfg.d_model // H
    return SLSTMState(*(torch.zeros((batch, H, dh), dtype=torch.float32,
                                    device=device) for _ in range(4)))
