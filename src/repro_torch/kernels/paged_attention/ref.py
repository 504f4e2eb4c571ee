"""Plain PyTorch version of the paged attention kernels: the KV cache
rows live as pages of one shared pool, addressed through a per-row page
table (and, for one shard of a sharded bank, its unnormalized decode
partial over the pages it owns).

Layout:
  * ``k_pages``/``v_pages`` — (NP, Hkv, page, hd): the shared pool.
    Page 0 is the PARK page (dead page-table entries point at it).
  * ``k_scale``/``v_scale`` — (NP, Hkv, page) f32, present for an int8
    pool only: entry ``[p, h, s, :]`` is ``codes * scale[p, h, s]``.
  * ``page_table`` — (B, P) int32: row b's positions
    ``[j*page, (j+1)*page)`` live in pool page ``page_table[b, j]``.
  * ``pos`` — (B,) int32 (or scalar, broadcast).

The plain versions gather each row's pages back into a contiguous
(B, Hkv, P*page, hd) row (dequantized for an int8 pool) and defer to the
row-cache versions: a paged cache read through its table IS the row
cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_reference
from repro_torch.kernels.verify_attention.ref import verify_reference


def gather_pages(pages, page_table):
    """(NP, Hkv, page, hd) pool + (B, P) table -> (B, Hkv, P*page, hd)
    contiguous per-row cache (position j*page+s = slot s of entry j)."""
    g = pages[page_table.long()]                    # (B, P, Hkv, page, hd)
    B, P, Hkv, page, hd = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, P * page, hd)


def gather_scales(scales, page_table):
    """(NP, Hkv, page) int8-pool scale leaf + (B, P) table -> (B, Hkv,
    P*page) per-position scales: ``gather_pages`` minus the head dim."""
    g = scales[page_table.long()]                   # (B, P, Hkv, page)
    B, P, Hkv, page = g.shape
    return g.permute(0, 2, 1, 3).reshape(B, Hkv, P * page)


def _dequant(pages, scales, page_table):
    codes = gather_pages(pages, page_table)
    return codes.float() * gather_scales(scales, page_table)[..., None]


def _rows(k_pages, v_pages, page_table, k_scale, v_scale):
    if k_scale is not None:
        return (_dequant(k_pages, k_scale, page_table),
                _dequant(v_pages, v_scale, page_table))
    return gather_pages(k_pages, page_table), gather_pages(v_pages,
                                                           page_table)


def paged_decode_reference(q, k_pages, v_pages, page_table, pos, *,
                           scale: float | None = None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """q: (B, H, hd) -> (B, H, hd); see the module docstring."""
    k, v = _rows(k_pages, v_pages, page_table, k_scale, v_scale)
    return decode_reference(q, k, v, pos, scale=scale)


def paged_verify_reference(q, k_pages, v_pages, blk_k, blk_v, page_table,
                           pos, *, scale: float | None = None, k_scale=None,
                           v_scale=None, tree=None) -> torch.Tensor:
    """q: (B, K, H, hd); blk_k/blk_v: (B, K, Hkv, hd) block keys/values;
    the pool holds the cache BEFORE the block's writes -> (B, K, H, hd).
    An int8 pool dequantizes its pages; the block k/v stay full precision
    (they have not been written yet).  ``tree`` as in
    ``verify_reference``."""
    k, v = _rows(k_pages, v_pages, page_table, k_scale, v_scale)
    return verify_reference(q, k, v, blk_k, blk_v, pos, scale=scale,
                            tree=tree)


NEG_INF = -1e30          # the masked score; finite, so exp(m - m) == 1


def paged_decode_partial_reference(q, k_pages, v_pages, page_table, pos,
                                   base: int, *, scale: float | None = None,
                                   k_scale=None, v_scale=None):
    """One shard's unnormalized flash-decode state over its LOCAL slice
    ``k_pages``/``v_pages`` (L, Hkv, page, hd) of a sharded bank (int8
    codes with (L, Hkv, page) ``k_scale``/``v_scale``).  ``page_table``
    (B, P) holds GLOBAL page ids and ``base`` is the shard's first one:
    the shard owns ids [base, base + L).  q: (B, H, hd); pos: () or (B,)
    -> (acc (B, Hkv, G, hd) f32, m (B, Hkv, G) f32, l (B, Hkv, G) f32)
    over the keys t <= pos[b] on owned pages; a row that owns no such
    key is exactly (0, -1e30, 0)."""
    B, H, hd = q.shape
    L, Hkv, page, _ = k_pages.shape
    G = H // Hkv
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    lt = page_table.long() - int(base)
    owned = (lt >= 0) & (lt < L)
    lt = torch.where(owned, lt, torch.zeros_like(lt))
    if k_scale is not None:
        k, v = _dequant(k_pages, k_scale, lt), _dequant(v_pages, v_scale, lt)
    else:
        k, v = gather_pages(k_pages, lt), gather_pages(v_pages, lt)
    S = k.shape[2]
    pos = torch.as_tensor(pos, device=q.device).expand(B)
    own_pos = owned.repeat_interleave(page, dim=1)                # (B, S)
    valid = ((torch.arange(S, device=q.device)[None, :] <= pos[:, None])
             & own_pos)[:, None, None, :]                       # (B,1,1,S)
    qh = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bngd,bnsd->bngs", qh, k.float()) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    acc = torch.einsum("bngs,bnsd->bngd", p, v.float())
    return acc, m, p.sum(dim=-1)
