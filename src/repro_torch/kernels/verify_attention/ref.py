"""Plain PyTorch version of the verify kernel: K query tokens per row
scored against a row KV cache in one pass (chunked prefill's chunk, a
speculative verify block).

Layout: q (B, K, H, hd), the K block tokens of each row at positions
``pos[b] .. pos[b]+K-1``; k/v cache (B, Hkv, S, hd) as it stood BEFORE
the block (positions <= pos-1 are valid); blk_k/blk_v (B, K, Hkv, hd)
the block's own keys/values.  ``pos`` is a scalar or a per-row (B,)
vector.

Query i sees cache slots [0, pos-1] and block tokens j <= i -- exactly
what the i-th sequential one-token decode step would see.  ``tree``
((B, K) int32, optional) replaces the intra-block causal mask: bit j of
``tree[b, i]`` makes block token j visible to block query i (the cache
side is unchanged).

A ``ring`` cache (sliding window, cache length == window, K <= S, no
tree): cache slot s holds position p(s) = (pos-1) - ((pos-1-s) mod S)
and is valid for query i iff p(s) >= 0 (written) and p(s) > pos+i-S
(inside query i's window).  Reading the cache before the block keeps
this exact across a wrap, where a later block token's write would land
on a slot an earlier query still reads.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def verify_reference(q, k, v, blk_k, blk_v, pos, *, ring: bool = False,
                     scale: float | None = None, tree=None) -> torch.Tensor:
    B, K, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    assert H % Hkv == 0
    assert blk_k.shape == (B, K, Hkv, hd), blk_k.shape
    if ring:
        assert K <= S, (K, S)
        assert tree is None, "tree verify is full-attention only"
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    G = H // Hkv
    dev = q.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B)
    qh = q.reshape(B, K, Hkv, G, hd).float().permute(0, 2, 1, 3, 4)

    # cache side: slots < pos (the same for every query of the row), or
    # the ring's per-query window
    s_c = torch.einsum("bnigd,bnsd->bnigs", qh, k.float()) * scale
    cols = torch.arange(S, device=dev)[None, None, :]               # (1,1,S)
    pb = pos[:, None, None]                                         # (B,1,1)
    if ring:
        i = torch.arange(K, device=dev)[None, :, None]              # (1,K,1)
        p = (pb - 1) - torch.remainder(pb - 1 - cols, S)
        valid = (p >= 0) & (p > pb + i - S)                         # (B,K,S)
    else:
        valid = (cols < pb).expand(B, K, S)
    s_c = torch.where(valid[:, None, :, None, :], s_c,
                      torch.full_like(s_c, NEG_INF))

    # block side: intra-block causal (j <= i) or the tree bitmask
    kb = blk_k.permute(0, 2, 1, 3).float()                 # (B, Hkv, K, hd)
    vb = blk_v.permute(0, 2, 1, 3).float()
    s_b = torch.einsum("bnigd,bnjd->bnigj", qh, kb) * scale
    ar = torch.arange(K, device=dev)
    if tree is None:
        vis = (ar[None, :] <= ar[:, None])[None]                # (1, K, K)
    else:
        t = torch.as_tensor(tree, dtype=torch.int32, device=dev)
        t = t.expand(B, K)
        vis = ((t[:, :, None] >> ar[None, None, :]) & 1) == 1   # (B, K, K)
    s_b = torch.where(vis[:, None, :, None, :], s_b,
                      torch.full_like(s_b, NEG_INF))

    # one softmax across cache + block (the flash-decode combine)
    p = torch.softmax(torch.cat([s_c, s_b], dim=-1), dim=-1)
    v_all = torch.cat([v.float(), vb], dim=2)
    out = torch.einsum("bnigt,bntd->bnigd", p, v_all)       # (B,Hkv,K,G,hd)
    out = out.permute(0, 2, 1, 3, 4).reshape(B, K, H, hd)
    return out.to(q.dtype)
