"""Public wrapper of the flash-attention kernel.

A CPU tensor runs the plain version (``ref.mha_reference``); a CUDA
tensor launches ``csrc/flash_attention.cu`` or raises.  The kernel reads
strided views (the model's (B, S, H, hd) projections transposed to
(B, H, S, hd)) through TMA descriptors, so they are not copied, and masks
the ragged edge past S itself.  It is instantiated for head widths 32,
64, 128 and 256; any other width up to 256 runs padded with zeros to the
next one (``with_head_dim_padding``), which is exact.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention.ref import mha_reference

kernel_head_dim = K.kernel_head_dim

_fn = None


def with_head_dim_padding(body, q, k, v, *, causal: bool, window: int,
                          scale: float | None):
    """``body(q, k, v, causal=, window=, scale=)`` on q, k, v zero-padded
    along head_dim to ``kernel_head_dim``, the output cropped back.  The
    scale stays that of the true width; zero columns add nothing to the
    scores, and V's zero columns are cropped, so the result is exact."""
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    width = kernel_head_dim(hd)
    if width == hd:
        return body(q, k, v, causal=causal, window=window, scale=scale)
    out = body(*(K.pad_last(t, width) for t in (q, k, v)), causal=causal,
               window=window, scale=scale)
    return out[..., :hd]


def _tma_view(t: torch.Tensor):
    """A (B, heads, S, hd) operand as TMA reads it -> (view, (sb, sh, ss)
    in elements).  TMA needs the last dimension contiguous, the other
    strides multiples of 8 elements (16 bytes) and a 16-byte aligned
    base: the model's views are; any other view is copied once.  A size-1
    dimension's stride is never followed; it is given a valid one."""
    s0, s1, s2, s3 = t.stride()
    n0, n1, n2, _ = t.shape
    if (s3 != 1 or (s0 % 8 and n0 > 1) or (s1 % 8 and n1 > 1)
            or (s2 % 8 and n2 > 1) or t.data_ptr() % 16):
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        s0, s1, s2, _ = t.stride()
    return t, (s0 if n0 > 1 else 8, s1 if n1 > 1 else 8, s2 if n2 > 1 else 8)


def _launch(q, k, v, *, causal: bool, window: int, scale: float):
    global _fn
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"flash kernel takes torch.bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.shape != (B, Hkv, S, hd) or v.shape != k.shape:
        raise ValueError(f"k/v: expected shape {(B, Hkv, S, hd)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    q, sq = _tma_view(q)
    k, sk = _tma_view(k)
    v, sv = _tma_view(v)
    out, so = _tma_view(torch.empty_like(q))          # in q's layout
    if _fn is None:
        _fn = K.c_function("flash_attention", "flash_attention_bf16",
                           [K.P] * 4 + [K.I] * 7
                           + [K.F, ctypes.POINTER(ctypes.c_longlong), K.P])
    rc = _fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, Hkv, S, hd, int(causal), int(window), float(scale),
             (ctypes.c_longlong * 12)(*sq, *sk, *sv, *so), K.stream_ptr(q))
    K.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    flash_attention.launches_by_shape[(B, H, Hkv, S, hd, int(window))] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, H, S, hd); k/v: (B, Hkv, S, hd) with H % Hkv == 0 -> (B, H,
    S, hd) in q's dtype.  bf16 in, f32 softmax state on the card."""
    if K.on_cpu(q, k, v):
        return mha_reference(q, k, v, causal=causal, window=window,
                             scale=scale)
    B, H, S, hd = q.shape
    if H % k.shape[1]:
        raise ValueError(f"heads {H} not a multiple of kv heads "
                         f"{k.shape[1]}")
    return with_head_dim_padding(_launch, q, k, v, causal=causal,
                                 window=window, scale=scale)


flash_attention.launches = 0
# (B, H, Hkv, S, hd, window) -> launches at that shape
flash_attention.launches_by_shape = collections.Counter()

__all__ = ["flash_attention", "kernel_head_dim", "mha_reference",
           "with_head_dim_padding"]
