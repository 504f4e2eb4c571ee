"""Plain PyTorch version of the grouped (per-expert) matmul and of the
expert FFN built from it."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gmm_reference(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype, accumulated
    in f32."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def expert_mlp_reference(x, w_gate, w_up, w_down):
    """The gated expert FFN on grouped tokens x (E, C, D): each product
    in x's dtype, silu and the gate product in f32, cast back before the
    down projection."""
    h = F.silu(gmm_reference(x, w_gate).float())
    h = h * gmm_reference(x, w_up).float()
    return gmm_reference(h.to(x.dtype), w_down)
