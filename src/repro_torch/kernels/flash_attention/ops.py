"""Public wrappers of the flash-attention kernel and its backward.

A CPU tensor runs the plain version (``ref.mha_reference``); a CUDA
tensor launches ``csrc/flash_attention.cu`` or raises.  Where a gradient
is needed (grad enabled and an input that requires it), the CUDA path is
a ``torch.autograd.Function``: its forward launches the same kernel and
also keeps each row's log-sum-exp, its backward launches
``csrc/flash_attention_bwd.cu`` (``flash_attention_backward``; on the CPU
autograd differentiates the plain version).  The kernel reads
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
from repro_torch.kernels.flash_attention.ref import (mha_backward_reference,
                                                     mha_reference)

kernel_head_dim = K.kernel_head_dim

_fn = None
_bwd_fn = None


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
    """A (B, heads, S, hd) operand as TMA reads it (and the backward
    kernel, in bf16 pairs) -> (view, (sb, sh, ss) in elements).  TMA
    needs the last dimension contiguous, the other strides multiples of
    8 elements (16 bytes) and a 16-byte aligned base: the model's views
    are; any other view is copied once.  A size-1 dimension's stride is
    never followed; it is given a valid one."""
    s0, s1, s2, s3 = t.stride()
    n0, n1, n2, _ = t.shape
    if (s3 != 1 or (s0 % 8 and n0 > 1) or (s1 % 8 and n1 > 1)
            or (s2 % 8 and n2 > 1) or t.data_ptr() % 16):
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        s0, s1, s2, _ = t.stride()
    return t, (s0 if n0 > 1 else 8, s1 if n1 > 1 else 8, s2 if n2 > 1 else 8)


def _launch(q, k, v, *, causal: bool, window: int, scale: float,
            lse: torch.Tensor | None = None):
    """The forward kernel -> out (B, H, S, hd); with ``lse`` ((B, H, S)
    f32, contiguous) it also writes each row's log-sum-exp there."""
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
    if lse is not None:
        K.check_cuda_input("lse", lse, torch.float32, (B, H, S))
    if _fn is None:
        _fn = K.c_function("flash_attention", "flash_attention_bf16",
                           [K.P] * 5 + [K.I] * 7
                           + [K.F, ctypes.POINTER(ctypes.c_longlong), K.P])
    rc = _fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             B, H, Hkv, S, hd, int(causal), int(window), float(scale),
             (ctypes.c_longlong * 12)(*sq, *sk, *sv, *so), K.stream_ptr(q))
    K.check_launch("flash_attention", rc)
    flash_attention.launches += 1
    flash_attention.launches_by_shape[(B, H, Hkv, S, hd, int(window))] += 1
    return out


def _launch_bwd(q, k, v, out, dout, lse, *, causal: bool, window: int,
                scale: float):
    global _bwd_fn
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    for label, t in (("q", q), ("k", k), ("v", v), ("out", out),
                     ("dout", dout)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash backward kernel takes torch.bfloat16, "
                            f"got {t.dtype} for {label}")
    if hd not in K.HEAD_DIMS:
        raise ValueError(f"flash backward kernel takes head_dim in "
                         f"{K.HEAD_DIMS}, got {hd}")
    if (k.shape != (B, Hkv, S, hd) or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"flash backward: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    K.check_cuda_input("lse", lse, torch.float32, (B, H, S))
    views = [_tma_view(t) for t in (q, k, v, out, dout)]
    # contiguous outputs, dK and dV in one allocation
    dq = torch.empty((B, H, S, hd), dtype=torch.bfloat16, device=q.device)
    dk, dv = torch.empty((2, B, Hkv, S, hd), dtype=torch.bfloat16,
                         device=q.device)
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if _bwd_fn is None:
        _bwd_fn = K.c_function("flash_attention_bwd",
                               "flash_attention_bwd_bf16",
                               [K.P] * 10 + [K.I] * 7
                               + [K.F, ctypes.POINTER(ctypes.c_longlong),
                                  K.P])
    strides = [s for _, st in views for s in st]
    strides += [H * S * hd, S * hd, hd] + [Hkv * S * hd, S * hd, hd] * 2
    rc = _bwd_fn(*(t.data_ptr() for t, _ in views), lse.data_ptr(),
                 dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, H, Hkv, S, hd, int(causal), int(window),
                 float(scale), (ctypes.c_longlong * 24)(*strides),
                 K.stream_ptr(q))
    K.check_launch("flash_attention_backward", rc)
    flash_attention_backward.launches += 1
    flash_attention_backward.launches_by_shape[
        (B, H, Hkv, S, hd, int(window))] += 1
    return dq, dk, dv


class _FlashFunction(torch.autograd.Function):
    """B1 with a gradient on the card: the forward kernel, keeping each
    row's log-sum-exp, and the backward kernel.  Takes kernel widths
    (``with_head_dim_padding`` pads and crops outside it, as ordinary
    differentiable ops)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        B, H, S, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = _launch(q, k, v, causal=causal, window=window, scale=scale,
                      lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.to(torch.bfloat16), lse, causal=causal,
            window=window, scale=scale)
        return dq, dk, dv, None, None, None


def _launch_with_grad(q, k, v, *, causal: bool, window: int, scale: float):
    return _FlashFunction.apply(q, k, v, causal, window, scale)


def flash_attention_backward(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: int = 0, scale: float | None = None):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for an
    output gradient ``dout``: q, out, dout (B, H, S, hd), k/v (B, Hkv, S,
    hd).  On the CPU the plain version (``ref.mha_backward_reference``,
    which recomputes everything from q, k, v); on the card the backward
    kernel, from the forward's ``out`` and ``lse`` ((B, H, S) f32 row
    log-sum-exps), bf16 in and out, head_dim one of the kernel widths.
    Deterministic on the card: no atomics, the GQA sum in one order."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if K.on_cpu(q, k, v, out, dout, lse):
        return mha_backward_reference(q, k, v, dout, causal=causal,
                                      window=window, scale=scale)
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")
    return _launch_bwd(q, k, v, out, dout, lse, causal=causal,
                       window=window, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, H, S, hd); k/v: (B, Hkv, S, hd) with H % Hkv == 0 -> (B, H,
    S, hd) in q's dtype.  bf16 in, f32 softmax state on the card; with a
    gradient needed, differentiable through the backward kernel."""
    if K.on_cpu(q, k, v):
        return mha_reference(q, k, v, causal=causal, window=window,
                             scale=scale)
    B, H, S, hd = q.shape
    if H % k.shape[1]:
        raise ValueError(f"heads {H} not a multiple of kv heads "
                         f"{k.shape[1]}")
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    return with_head_dim_padding(_launch_with_grad if grad else _launch,
                                 q, k, v, causal=causal, window=window,
                                 scale=scale)


flash_attention.launches = 0
# (B, H, Hkv, S, hd, window) -> launches at that shape
flash_attention.launches_by_shape = collections.Counter()
flash_attention_backward.launches = 0
# (B, H, Hkv, S, hd, window) -> backward launches (a dq and a dkdv kernel
# each) at that shape
flash_attention_backward.launches_by_shape = collections.Counter()

__all__ = ["flash_attention", "flash_attention_backward", "kernel_head_dim",
           "mha_backward_reference", "mha_reference",
           "with_head_dim_padding"]
