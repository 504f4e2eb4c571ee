"""Plain PyTorch version of the flash-attention kernel.

Layout: q (B, H, S, hd); k/v (B, Hkv, S, hd) with H % Hkv == 0 (GQA).
Semantics: causal self-attention over a common position range [0, S),
optionally banded to a sliding window of width ``window`` (token t
attends to (t-window, t]).  Computes in float32 and returns q's dtype.
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
