"""Plain PyTorch version of the flash-decode kernel: one query token per
row against a row KV cache.

Layout: q (B, H, hd); k/v cache (B, Hkv, S, hd); ``pos`` is the position
of the current token (its k/v already written at its slot), a scalar or
a per-row (B,) vector.

Valid slots are [0, min(pos, S-1)].  That is also a ring cache's set
(sliding window, S == window slots): the JAX ring mask
``(idx <= pos % S) | (pos >= S)`` equals ``idx <= pos`` for every
pos >= 0, so one mask serves both.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_reference(q, k, v, pos, *,
                     scale: float | None = None) -> torch.Tensor:
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    assert H % Hkv == 0
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    G = H // Hkv
    qh = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bngd,bnsd->bngs", qh, k.float()) * scale
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos = pos.expand(B)[:, None, None, None]
    idx = torch.arange(S, device=q.device)
    s = torch.where(idx <= pos, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngs,bnsd->bngd", p, v.float())
    return out.reshape(B, H, hd).to(q.dtype)
