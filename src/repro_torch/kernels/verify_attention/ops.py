"""Public wrapper of the verify kernel (row cache).

A CPU tensor runs the plain version (``ref.verify_reference``); a CUDA
tensor launches ``csrc/verify_attention.cu`` or raises.  The ring route
(a sliding-window cache) counts its launches apart, in
``verify_attention.launches_ring``.  The kernel reads q (B, Kb, H, hd) and
the block's keys and values in place and writes its (B, Kb, H, hd) output
itself; it is instantiated for head widths 32/64/128/256 and any group,
and any other width up to 256 runs zero-padded (``kernels.verify_padded``),
which is exact.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels.verify_attention.ref import verify_reference

_fn = None


def verify_attention(q, k, v, blk_k, blk_v, pos, *, ring: bool = False,
                     scale: float | None = None, tree=None) -> torch.Tensor:
    """q: (B, Kb, H, hd); k/v: (B, Hkv, S, hd) cache BEFORE the block's
    writes; blk_k/blk_v: (B, Kb, Hkv, hd); pos: () or (B,) int32 base
    positions; ``tree``: optional (B, Kb) int32 ancestor bitmasks ->
    (B, Kb, H, hd).  Query i of row b (position pos[b] + i) attends to
    cache slots [0, pos[b]-1] plus block tokens j <= i (or the tree's
    bits); over a ``ring`` cache (Kb <= S, no tree), to the slots whose
    positions lie inside its window (see ``ref.py``)."""
    B, Kb, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if ring and (tree is not None or Kb > S):
        raise ValueError(f"verify_attention: a ring cache takes a causal "
                         f"block of at most S={S} tokens (no tree), got "
                         f"{Kb} tokens, tree={tree is not None}")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos = pos.expand(B).contiguous()
    if tree is not None:
        tree = torch.as_tensor(tree, dtype=torch.int32, device=q.device)
    if K.on_cpu(q, k, v, blk_k, blk_v, pos,
                *(() if tree is None else (tree,))):
        return verify_reference(q, k, v, blk_k, blk_v, pos, ring=ring,
                                scale=scale, tree=tree)
    K.require_no_grad("verify_attention", q, k, v, blk_k, blk_v)
    global _fn
    q, blk_k, blk_v, tree, G, width = K.verify_padded(
        "verify_attention", q, blk_k, blk_v, tree, Hkv)
    K.check_verify_operands(q, blk_k, blk_v, tree)
    k, v = K.pad_last(k, width), K.pad_last(v, width)
    K.check_cuda_input("k", k, torch.bfloat16, (B, Hkv, S, width))
    K.check_cuda_input("v", v, torch.bfloat16, (B, Hkv, S, width))
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    if _fn is None:
        _fn = K.c_function("verify_attention", "verify_attention_bf16",
                           [K.P] * 8 + [K.I] * 7 + [K.F, K.P])
    rc = _fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), blk_k.data_ptr(),
             blk_v.data_ptr(), pos.data_ptr(),
             None if tree is None else tree.data_ptr(), out.data_ptr(),
             B, Hkv, G, Kb, S, width, int(ring), float(scale),
             K.stream_ptr(q))
    K.check_launch("verify_attention", rc)
    if ring:
        verify_attention.launches_ring += 1
    else:
        verify_attention.launches += 1
    return out[..., :hd]


verify_attention.launches = 0
verify_attention.launches_ring = 0

__all__ = ["verify_attention", "verify_reference"]
