"""Mixture-of-Experts FFN of the port (mixtral, jamba).

Three strategies, chosen as the JAX package chooses them (``moe_apply``):

* ``moe_dense_ref`` — every token through every expert's FFN, masked to
  its top-k router weights.  One device runs it.  Its products are plain
  einsums outside any Pallas kernel, so here they are plain
  ``torch.matmul``s.
* ``moe_tp``        — tensor-parallel experts: every token through every
  expert, the router weights folded in before the down projection.
  Under a mesh each shard takes one slice of the expert hidden dim F and
  the shards' partial outputs meet in one ``psum``.
* ``moe_ep``        — expert-parallel: the sequence splits over the
  mesh's shards; each shard routes its own tokens into capacity-padded
  per-expert buffers (``_dispatch_local``), an ``all_to_all`` hands every
  shard the buffers of its E/ep experts, the grouped-matmul kernel runs
  their FFN (``_expert_mlp``), a second ``all_to_all`` brings the
  outputs home and ``_combine_local`` weighs them back into token order.
  A (token, choice) past its expert's capacity is dropped: it loses its
  weight, and the kept weights are not renormalized.

A mesh (``repro_torch.distributed.mesh.Mesh``) is a tuple of devices
driven by this process; its shards' expert slices are views of the one
weight tensor, so no step copies the weights.  JAX's sharding hints
(``constrain``) have no counterpart: activations stay on the mesh's
device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.distributed.mesh import Mesh, all_to_all, psum
from repro_torch.kernels.gmm.ops import expert_mlp
from repro_torch.models.common import PSpec


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


# ---------------------------------------------------------------------------
# TP strategy: every token through every expert, F sliced over the mesh
# ---------------------------------------------------------------------------

def moe_tp(params, x, cfg: ArchConfig, mesh: Mesh | None = None):
    """x: (B, S, D) -> (out, aux).  Capacity-free top-k: every expert runs
    on every token, and the router weights (``comb`` (T, E), JAX's
    one-hot scatter-add) scale each expert's hidden activations before
    the down projection, so the contraction over (e, f) yields the
    combined output at once.  Under ``mesh`` shard s computes the hidden
    slice F[s*F/tp : (s+1)*F/tp] of every expert and the shards' (T, D)
    partial outputs meet in one ``psum`` -- JAX's TP all-reduce.  The
    weight slices are views (a column slice goes to the matmul with its
    row stride), so no weight is copied."""
    m = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    top_p, top_i, aux = router(params, xt, m)
    comb = torch.zeros((xt.shape[0], m.num_experts), dtype=x.dtype,
                       device=x.device).scatter_add_(1, top_i, top_p)
    tp = 1 if mesh is None else mesh.size
    Fe = params["w_gate"].shape[2]
    if Fe % tp:
        raise ValueError(f"expert hidden dim {Fe} does not split over "
                         f"{tp} shards")
    dt = x.dtype
    parts = []
    for s in range(tp):
        fs = slice(s * Fe // tp, (s + 1) * Fe // tp)
        out = torch.zeros_like(xt)
        for e in range(m.num_experts):
            h = F.silu(torch.matmul(xt, params["w_gate"][e][:, fs].to(dt)))
            h = h * torch.matmul(xt, params["w_up"][e][:, fs].to(dt))
            h = h * comb[:, e:e + 1]
            out = out + torch.matmul(h, params["w_down"][e][fs].to(dt))
        parts.append(out)
    return psum(parts).reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# EP strategy: capacity-padded dispatch, all_to_all, grouped matmul
# ---------------------------------------------------------------------------

def _expert_mlp(w_gate, w_up, w_down, x):
    """x: (E, C, D) grouped tokens; weights (E, D, F) / (E, F, D) ->
    (E, C, D) through three grouped matmuls (the kernel on a CUDA
    tensor, its plain version on the CPU)."""
    return expert_mlp(x, w_gate, w_up, w_down)


def _dispatch_local(xt, top_p, top_i, num_experts: int, capacity: int):
    """Scatter one shard's tokens into per-expert capacity buffers.

    (token, choice) pairs rank within their expert by a cumulative count
    over the flattened (T, k) order; rank ``slot`` < ``capacity`` is
    kept, the rest dropped (their rows go to a spare row that is cut
    off).  Returns (buf (E, C, D), slot (T, k), kept (T, k))."""
    T, D = xt.shape
    k = top_i.shape[1]
    flat_e = top_i.reshape(-1)                                   # (T*k,)
    onehot = F.one_hot(flat_e, num_experts)                      # (T*k, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - 1
    slot = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    kept = slot < capacity
    dst = torch.where(kept, flat_e * capacity + slot,
                      torch.full_like(slot, num_experts * capacity))
    buf = xt.new_zeros((num_experts * capacity + 1, D))
    buf[dst] = xt.repeat_interleave(k, dim=0)
    return (buf[:-1].reshape(num_experts, capacity, D), slot.reshape(T, k),
            kept.reshape(T, k))


def _combine_local(y_buf, top_p, top_i, slot, kept, capacity: int):
    """Gather expert outputs (E, C, D) back to token order, each weighted
    by its router probability (0 for a dropped choice) -> (T, D)."""
    T, k = top_i.shape
    E = y_buf.shape[0]
    flat = y_buf.reshape(E * capacity, -1)
    idx = torch.where(kept, top_i * capacity + slot, torch.zeros_like(slot))
    y = flat[idx.reshape(-1)].reshape(T, k, -1)
    w = torch.where(kept, top_p, torch.zeros_like(top_p))
    return torch.einsum("tkd,tk->td", y, w.to(y.dtype))


def moe_ep(params, x, cfg: ArchConfig, mesh: Mesh,
           capacity_factor: float | None = None):
    """Expert-parallel MoE over ``mesh``'s one axis (ep shards).

    As JAX's ``shard_map`` lays it out (tokens ``P(data, model, None)``
    on a ``("model",)`` mesh): the SEQUENCE splits over the shards and
    the batch does not, so shard s takes ``x[:, s*S/ep : (s+1)*S/ep]``,
    and the experts split ``E/ep`` per shard.  Each shard routes its
    tokens, capacity ``max(ceil(T_local * k / E * cf), 1)`` from its own
    token count, into per-expert buffers; ``all_to_all`` (split the
    experts, gather the capacity) hands shard s its experts' buffers
    from every shard, (E/ep, C*ep, D); the grouped-matmul FFN runs on
    views of the shard's expert weights; the inverse ``all_to_all``
    brings the outputs home.  ``aux`` is the mean over shards.
    Returns (out (B, S, D), aux)."""
    m = cfg.moe
    ep = mesh.size
    E = m.num_experts
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} shards")
    B, S, D = x.shape
    if S % ep:
        raise ValueError(f"sequence {S} does not split over {ep} shards")
    cf = capacity_factor or m.capacity_factor
    dev = mesh.device
    Sl, El = S // ep, E // ep
    bufs, routes = [], []
    for s in range(ep):
        xt = x[:, s * Sl:(s + 1) * Sl].to(dev).reshape(-1, D)
        top_p, top_i, aux = router(params, xt, m)
        capacity = max(int(math.ceil(xt.shape[0] * m.top_k / E * cf)), 1)
        buf, slot, kept = _dispatch_local(xt, top_p, top_i, E, capacity)
        bufs.append(buf)
        routes.append((top_p, top_i, slot, kept, capacity, aux))
    recv = all_to_all(bufs, split_axis=0, concat_axis=1)  # (E/ep, C*ep, D)
    dt = x.dtype
    ys = [_expert_mlp(*(params[n][s * El:(s + 1) * El].to(dt)
                        for n in ("w_gate", "w_up", "w_down")), recv[s])
          for s in range(ep)]
    back = all_to_all(ys, split_axis=1, concat_axis=0)    # (E, C, D) home
    outs, auxes = [], []
    for s, (top_p, top_i, slot, kept, capacity, aux) in enumerate(routes):
        outs.append(_combine_local(back[s], top_p, top_i, slot, kept,
                                   capacity).reshape(B, Sl, D))
        auxes.append(aux)
    return (torch.cat([o.to(x.device) for o in outs], dim=1),
            psum(auxes) / ep)


def moe_apply(params, x, cfg: ArchConfig, mesh: Mesh | None = None,
              strategy: str = "auto"):
    """Entry point of the model's MoE layers -> (out, aux).  ``auto``
    follows JAX's rule over tp = the mesh's size: ``ep`` when
    tp > 1 and both the experts and the sequence split over tp (a decode
    step's S == 1 does not), else ``tp`` when tp > 1, else the dense
    reference."""
    m = cfg.moe
    if strategy == "auto":
        tp = mesh.size if mesh is not None else 1
        if tp > 1 and m.num_experts % tp == 0 and x.shape[1] % tp == 0:
            strategy = "ep"
        elif tp > 1:
            strategy = "tp"
        else:
            strategy = "ref"
    if strategy == "ep":
        if mesh is None:
            raise ValueError("the expert-parallel MoE needs a mesh")
        return moe_ep(params, x, cfg, mesh)
    if strategy == "tp":
        return moe_tp(params, x, cfg, mesh)
    if strategy != "ref":
        raise ValueError(f"unknown MoE strategy {strategy!r}")
    return moe_dense_ref(params, x, cfg)
