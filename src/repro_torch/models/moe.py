"""Mixture-of-Experts FFN of the port (mixtral, jamba).

On one device the JAX package runs ``moe_dense_ref``: every token goes
through every expert's FFN, masked to its top-k router weights.  Its
products are plain einsums outside any Pallas kernel, so here they are
plain ``torch.matmul``s.  The expert-parallel (``moe_ep``: capacity
dispatch, ``all_to_all`` and the grouped-matmul kernel) and
tensor-parallel (``moe_tp``) strategies need a mesh of several devices;
they come with the multi-GPU slice of the port and raise until then.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import PSpec

_MULTI_GPU = ("is not yet ported to repro_torch: expert-parallel and "
              "tensor-parallel MoE come with the multi-GPU slice")


def moe_specs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    return {
        "w_router": PSpec((d, e), init="scaled", scale=0.02),
        "w_gate": PSpec((e, d, f)),
        "w_up": PSpec((e, d, f)),
        "w_down": PSpec((e, f, d)),
    }


def router(params, x, m: MoEConfig):
    """x: (T, D) -> top-k probs (T, k) in x's dtype, indices (T, k) and
    the Switch-style load-balancing aux loss (a () f32 tensor).  Logits
    and softmax in f32; the top-k probs are renormalized to sum to 1."""
    logits = x.float() @ params["w_router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    density = F.one_hot(top_i[:, 0], m.num_experts).float().mean(dim=0)
    aux = (density * probs.mean(dim=0)).sum() * m.num_experts
    return top_p.to(x.dtype), top_i, aux


def moe_dense_ref(params, x, cfg: ArchConfig):
    """x: (B, S, D) -> (out (B, S, D), aux).  Every token through every
    expert, each expert's output weighted by the token's router weight
    for it (0 outside its top-k)."""
    m = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    top_p, top_i, aux = router(params, xt, m)
    out = torch.zeros_like(xt)
    dt = x.dtype
    for e in range(m.num_experts):
        w = torch.where(top_i == e, top_p, torch.zeros_like(top_p)).sum(-1)
        h = F.silu(torch.matmul(xt, params["w_gate"][e].to(dt)))
        h = h * torch.matmul(xt, params["w_up"][e].to(dt))
        y = torch.matmul(h, params["w_down"][e].to(dt))
        out = out + w[:, None].to(dt) * y
    return out.reshape(B, S, D), aux


def _dispatch_local(*args, **kwargs):
    """Capacity-padded scatter of tokens into per-expert buffers (the
    expert-parallel path's dispatch)."""
    raise NotImplementedError(f"_dispatch_local {_MULTI_GPU}")


def _combine_local(*args, **kwargs):
    """Gather of expert outputs back to token order (the expert-parallel
    path's combine)."""
    raise NotImplementedError(f"_combine_local {_MULTI_GPU}")


def moe_apply(params, x, cfg: ArchConfig, strategy: str = "auto"):
    """Entry point of the model's MoE layers -> (out, aux).  ``auto``
    resolves to the dense reference on one device, as in JAX."""
    if strategy in ("ep", "tp"):
        raise NotImplementedError(f"MoE strategy {strategy!r} {_MULTI_GPU}")
    if strategy not in ("auto", "ref"):
        raise ValueError(f"unknown MoE strategy {strategy!r}")
    return moe_dense_ref(params, x, cfg)
