"""Public wrapper of the paged flash-decode kernel (full-precision pool).

A CPU tensor runs the plain version (``ref.paged_decode_reference``); a
CUDA tensor launches ``csrc/paged_attention.cu`` or raises.  The int8
pool of the JAX package is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                     paged_decode_reference)

_fn = None


def paged_decode_attention(q, k_pages, v_pages, page_table, pos, *,
                           scale: float | None = None) -> torch.Tensor:
    """q: (B, H, hd); k_pages/v_pages: (NP, Hkv, page, hd) shared pool;
    page_table: (B, P) int32; pos: () or (B,) int32 -> (B, H, hd).

    Row b attends to its positions [0, pos[b]], key t read from pool
    page ``page_table[b, t // page]``.  Dead table entries (past a row's
    allocation) must hold a valid pool index (the park page); they are
    never read for a position <= pos."""
    B, H, hd = q.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos = pos.expand(B).contiguous()
    if K.on_cpu(q, k_pages, v_pages, page_table, pos):
        return paged_decode_reference(q, k_pages, v_pages, page_table, pos,
                                      scale=scale)
    global _fn
    NP, Hkv, page, _ = k_pages.shape
    P = page_table.shape[1]
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hkv}")
    G = H // Hkv
    if hd not in (32, 64, 128) or G not in (1, 2, 4, 8):
        raise ValueError(f"paged kernel takes head_dim 32/64/128 and "
                         f"group 1/2/4/8, got {hd}, {G}")
    q = q.contiguous()
    K.check_cuda_input("q", q, torch.bfloat16, (B, H, hd))
    K.check_cuda_input("k_pages", k_pages, torch.bfloat16,
                       (NP, Hkv, page, hd))
    K.check_cuda_input("v_pages", v_pages, torch.bfloat16,
                       (NP, Hkv, page, hd))
    K.check_cuda_input("page_table", page_table, torch.int32, (B, P))
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    if _fn is None:
        _fn = K.c_function("paged_attention", "paged_decode_attention_bf16",
                           [K.P] * 6 + [K.I] * 6 + [K.F, K.P])
    rc = _fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
             B, Hkv, G, P, page, hd, float(scale), K.stream_ptr(q))
    K.check_launch("paged_decode_attention", rc)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

__all__ = ["gather_pages", "paged_decode_attention",
           "paged_decode_reference"]
