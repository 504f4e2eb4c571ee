"""Public wrapper of the grouped-matmul kernel, and the expert FFN built
from three of its calls.

A CPU tensor runs the plain version (``ref.gmm_reference``); a CUDA
tensor launches ``csrc/gmm.cu`` (bf16 only) or raises.  The kernel loads
through TMA, whose rows must be multiples of 16 bytes: D and F that are
not multiples of 8 run zero-padded (``with_stride_padding``), which is
exact.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch.kernels.gmm.ref import expert_mlp_reference, gmm_reference

_fn = None


def with_stride_padding(body, x, w):
    """``body(x, w)`` on x (E, C, D) and w (E, D, F) zero-padded so that D
    and F are multiples of 8, the output cropped back to F columns.  Zero
    depth adds nothing to a product and the padded columns are cropped,
    so the result is exact."""
    D, Fo = x.shape[2], w.shape[2]
    Dp, Fp = -(-D // 8) * 8, -(-Fo // 8) * 8
    if (Dp, Fp) == (D, Fo):
        return body(x, w)
    out = body(F.pad(x, (0, Dp - D)), F.pad(w, (0, Fp - Fo, 0, Dp - D)))
    return out[..., :Fo].contiguous()


def _launch(x, w):
    global _fn
    E, C, D = x.shape
    Fo = w.shape[2]
    x, w = x.contiguous(), w.contiguous()
    K.check_cuda_input("x", x, torch.bfloat16, (E, C, D))
    K.check_cuda_input("w", w, torch.bfloat16, (E, D, Fo))
    if _fn is None:
        _fn = K.c_function("gmm", "gmm_bf16", [K.P] * 3 + [K.I] * 4 + [K.P])
    out = torch.empty((E, C, Fo), dtype=x.dtype, device=x.device)
    rc = _fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, Fo,
             K.stream_ptr(x))
    K.check_launch("gmm_bf16", rc)
    gmm.launches += 1
    gmm.launches_by_shape[(E, C, D, Fo)] += 1
    return out


def gmm(x, w) -> torch.Tensor:
    """Grouped matmul x (E, C, D) @ w (E, D, F) -> (E, C, F) in x's dtype,
    with f32 accumulation.  The kernel takes bf16 and any E, C, D, F >=
    1."""
    if K.on_cpu(x, w):
        return gmm_reference(x, w)
    K.require_no_grad("gmm", x, w)
    E, C, D = x.shape
    if w.shape[:2] != (E, D):
        raise ValueError(f"gmm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if min(E, C, D, w.shape[2]) < 1:
        raise ValueError(f"gmm: kernel takes E, C, D, F >= 1, got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    for label, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{label}: kernel takes torch.bfloat16, got "
                            f"{t.dtype}")
    return with_stride_padding(_launch, x, w)


gmm.launches = 0
gmm.launches_by_shape = collections.Counter()   # (E, C, D, F) -> launches


def expert_mlp(x, w_gate, w_up, w_down) -> torch.Tensor:
    """Per-expert gated FFN through three grouped matmuls: x (E, C, D),
    w_gate/w_up (E, D, F), w_down (E, F, D) -> (E, C, D).  Each product
    comes back in x's dtype; silu and the gate product run in f32 and
    are cast back before the down projection, as in JAX."""
    h = F.silu(gmm(x, w_gate).float())
    h = h * gmm(x, w_up).float()
    return gmm(h.to(x.dtype), w_down)


__all__ = ["expert_mlp", "expert_mlp_reference", "gmm", "gmm_reference",
           "with_stride_padding"]
