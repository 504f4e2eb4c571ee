"""Public wrapper of the flash-decode kernel (row cache).

A CPU tensor runs the plain version (``ref.decode_reference``); a CUDA
tensor launches ``csrc/decode_attention.cu`` or raises.  One launch a call
(a slice of 16 query heads a launch past 16): a cluster of
``kernels.decode_splits`` blocks a (row, kv head), chosen from the cache
length alone, so a call reads nothing back from the card and a row's
output does not depend on its batch.

The ring route (a sliding-window cache of S == window slots) runs the same
kernel body and plain version: the JAX ring mask ``(idx <= pos % S) |
(pos >= S)`` selects slots ``0 .. min(pos, S-1)``, which is what both
read for any pos.  ``ring`` only selects the launch count:
``decode_attention.launches_ring`` instead of ``.launches``.

The kernel is instantiated for head widths 32/64/128/256 and takes any
group up to 16; any other width up to 256 runs zero-padded and a wider
group in slices of 16 heads (``kernels.decode_padded``), which is exact.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels.decode_attention.ref import decode_reference

_fn = None


def decode_attention(q, k, v, pos, *, ring: bool = False,
                     scale: float | None = None) -> torch.Tensor:
    """q: (B, H, hd); k/v: (B, Hkv, S, hd); pos: () or (B,) int32 ->
    (B, H, hd).  Row b attends to cache slots [0, pos[b]]; a ``ring``
    cache, once wrapped (pos[b] >= S), to every slot."""
    B, H, hd = q.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    pos = pos.expand(B).contiguous()
    if K.on_cpu(q, k, v, pos):
        return decode_reference(q, k, v, pos, scale=scale)
    K.require_no_grad("decode_attention", q, k, v)
    Hkv, S = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)

    def body(qp, kv, G):
        global _fn
        kp, vp = kv
        width = qp.shape[-1]
        K.check_cuda_input("q", qp, torch.bfloat16, (B, Hkv * G, width))
        K.check_cuda_input("k", kp, torch.bfloat16, (B, Hkv, S, width))
        K.check_cuda_input("v", vp, torch.bfloat16, (B, Hkv, S, width))
        out = torch.empty_like(qp)
        if _fn is None:
            _fn = K.c_function("decode_attention", "decode_attention_bf16",
                               [K.P] * 5 + [K.I] * 6 + [K.F, K.P])
        splits = K.decode_splits(S)
        rc = _fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), B, Hkv, G, S, width, splits, float(scale),
                 K.stream_ptr(qp))
        K.check_launch("decode_attention", rc)
        if ring:
            decode_attention.launches_ring += 1
        else:
            decode_attention.launches += 1
        return (out.view(B, Hkv, G, width),)

    (out,) = K.decode_padded(q, Hkv, (k, v), body)
    return out.reshape(B, H, hd)


decode_attention.launches = 0
decode_attention.launches_ring = 0

__all__ = ["decode_attention", "decode_reference"]
