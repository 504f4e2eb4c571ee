"""Public wrapper of the grouped-matmul kernel, and the expert FFN built
from three of its calls.

A CPU tensor runs the plain version (``ref.gmm_reference``); a CUDA
tensor launches ``csrc/gmm.cu`` (bf16 only) or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
from repro_torch.kernels.gmm.ref import expert_mlp_reference, gmm_reference

_fn = None


def gmm(x, w) -> torch.Tensor:
    """Grouped matmul x (E, C, D) @ w (E, D, F) -> (E, C, F) in x's dtype,
    with f32 accumulation.  The kernel takes bf16, any C >= 1, D a
    multiple of 32 and F a multiple of 8."""
    if K.on_cpu(x, w):
        return gmm_reference(x, w)
    global _fn
    E, C, D = x.shape
    Fo = w.shape[2]
    if C < 1 or D % 32 or Fo % 8:
        raise ValueError(f"gmm: kernel takes C >= 1, D % 32 == 0 and "
                         f"F % 8 == 0, got C={C}, D={D}, F={Fo}")
    K.check_cuda_input("x", x, torch.bfloat16, (E, C, D))
    K.check_cuda_input("w", w, torch.bfloat16, (E, D, Fo))
    if _fn is None:
        _fn = K.c_function("gmm", "gmm_bf16", [K.P] * 3 + [K.I] * 4 + [K.P])
    out = torch.empty((E, C, Fo), dtype=x.dtype, device=x.device)
    rc = _fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, Fo,
             K.stream_ptr(x))
    K.check_launch("gmm_bf16", rc)
    gmm.launches += 1
    return out


gmm.launches = 0


def expert_mlp(x, w_gate, w_up, w_down) -> torch.Tensor:
    """Per-expert gated FFN through three grouped matmuls: x (E, C, D),
    w_gate/w_up (E, D, F), w_down (E, F, D) -> (E, C, D).  Each product
    comes back in x's dtype; silu and the gate product run in f32 and
    are cast back before the down projection, as in JAX."""
    h = F.silu(gmm(x, w_gate).float())
    h = h * gmm(x, w_up).float()
    return gmm(h.to(x.dtype), w_down)


__all__ = ["expert_mlp", "expert_mlp_reference", "gmm", "gmm_reference"]
