"""Plain PyTorch version of the flash-attention kernel.

Layout: q (B, H, S, hd); k/v (B, Hkv, S, hd) with H % Hkv == 0 (GQA).
Semantics: causal self-attention over a common position range [0, S),
optionally banded to a sliding window of width ``window`` (token t
attends to (t-window, t]).  Computes in float32 and returns q's dtype.
``mha_backward_reference`` is the plain version of the backward kernel:
its explicit formulas in float32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    assert H % Hkv == 0, (H, Hkv)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= (i - j) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def mha_backward_reference(q, k, v, dout, *, causal: bool = True,
                           window: int = 0, scale: float | None = None,
                           out=None):
    """The gradients (dq, dk, dv) of ``mha_reference`` for an output
    gradient ``dout``, by the explicit formulas in float32 (each in its
    input's dtype): P = softmax(scale Q K^T) under the mask, D =
    rowsum(dO * O), dV = P^T dO, dS = P (dO V^T - D), dQ = scale dS K,
    dK = scale dS^T Q, dK and dV summed over each kv head's query group.
    O is the float32 output unless ``out`` is given: then D reads it, as
    the backward kernel reads the forward kernel's rounded output.  The
    backward kernel's plain version."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    qf, do = q.float(), dout.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= (i - j) < window
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, NEG_INF)),
                      dim=-1)
    o = (torch.einsum("bhst,bhtd->bhsd", p, vf) if out is None
         else out.float())
    dp = torch.einsum("bhsd,bhtd->bhst", do, vf)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    dv = torch.einsum("bhst,bhsd->bhtd", p, do)
    dk = dk.reshape(B, Hkv, G, S, hd).sum(2)
    dv = dv.reshape(B, Hkv, G, S, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
