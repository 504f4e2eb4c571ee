"""Plain PyTorch version of the paged flash-decode kernel: the KV cache
rows live as pages of one shared pool, addressed through a per-row page
table.

Layout:
  * ``k_pages``/``v_pages`` — (NP, Hkv, page, hd): the shared pool.
    Page 0 is the PARK page (dead page-table entries point at it).
  * ``page_table`` — (B, P) int32: row b's positions
    ``[j*page, (j+1)*page)`` live in pool page ``page_table[b, j]``.
  * ``pos`` — (B,) int32 (or scalar, broadcast).

The plain version gathers each row's pages back into a contiguous
(B, Hkv, P*page, hd) row and defers to the row-cache decode: a paged
cache read through its table IS the row cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_reference


def gather_pages(pages, page_table):
    """(NP, Hkv, page, hd) pool + (B, P) table -> (B, Hkv, P*page, hd)
    contiguous per-row cache (position j*page+s = slot s of entry j)."""
    g = pages[page_table.long()]                    # (B, P, Hkv, page, hd)
    B, P, Hkv, page, hd = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, P * page, hd)


def paged_decode_reference(q, k_pages, v_pages, page_table, pos, *,
                           scale: float | None = None) -> torch.Tensor:
    """q: (B, H, hd) -> (B, H, hd); see the module docstring."""
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    return decode_reference(q, k, v, pos, scale=scale)
