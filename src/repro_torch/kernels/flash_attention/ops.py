"""Public wrapper of the flash-attention kernel.

A CPU tensor runs the plain version (``ref.mha_reference``); a CUDA
tensor launches ``csrc/flash_attention.cu`` or raises.  The kernel masks
the ragged edge itself, so no padding happens here.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention.ref import mha_reference

_fn = None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, H, S, hd); k/v: (B, Hkv, S, hd) -> (B, H, S, hd) in q's
    dtype.  bf16 in, f32 accumulation on the card."""
    if K.on_cpu(q, k, v):
        return mha_reference(q, k, v, causal=causal, window=window,
                             scale=scale)
    global _fn
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hkv}")
    if hd not in (32, 64, 128):
        raise ValueError(f"flash kernel takes head_dim 32/64/128, got {hd}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    K.check_cuda_input("q", q, torch.bfloat16, (B, H, S, hd))
    K.check_cuda_input("k", k, torch.bfloat16, (B, Hkv, S, hd))
    K.check_cuda_input("v", v, torch.bfloat16, (B, Hkv, S, hd))
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    out = torch.empty_like(q)
    if _fn is None:
        _fn = K.c_function("flash_attention", "flash_attention_bf16",
                           [K.P] * 4 + [K.I] * 7 + [K.F, K.P])
    rc = _fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, Hkv, S, hd, int(causal), int(window), float(scale),
             K.stream_ptr(q))
    K.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["flash_attention", "mha_reference"]
