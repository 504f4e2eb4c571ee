"""AdamW and learning-rate schedules of the port, as plain functions.

The JAX package's formulas, step for step (``make_schedule``,
``global_norm``, ``adamw_init``, ``adamw_update``, which clips the
gradients as JAX's ``clip_by_global_norm`` does), on the port's
parameter tree (nested dicts and lists of tensors) rather than
``torch.optim``: the tests hold one update of each package to the other
from the same gradients and state.  State is
f32 ``m`` and ``v`` trees shaped like the parameters and an int32
``count``; weight decay applies to every leaf, as in JAX.  Everything
stays on the parameters' device (no host sync: the learning rate and the
norm are () tensors).  Updates are functional, as JAX's: new trees are
returned and the inputs are left as they were; or, with ``donate``, the
parameters and moments are written in place (JAX's ``donate_argnums``:
the old state's memory holds the new one, so a state of 3.7 B parameters,
about 45 GB in f32 with its moments, is not held twice).  Each
elementwise operation runs over groups of leaf pieces (a leaf cut into
flat pieces of at most ``GROUP_ELEMENTS``) in multi-tensor launches
(``torch._foreach_*``: the same elementwise arithmetic, rounded the same
way, as one operation a leaf, in place or not).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.context import tree_leaves, tree_map


GROUP_ELEMENTS = 1 << 27      # f32 elements of a leaf group: 512 MB


def _groups(leaves) -> list[tuple[int, int]]:
    """[lo, hi) runs of ``leaves`` of at most ``GROUP_ELEMENTS`` elements
    each (a larger leaf alone)."""
    out, lo, n = [], 0, 0
    for i, t in enumerate(leaves):
        if i > lo and n + t.numel() > GROUP_ELEMENTS:
            out.append((lo, i))
            lo, n = i, 0
        n += t.numel()
    if lo < len(leaves):
        out.append((lo, len(leaves)))
    return out


def make_schedule(cfg: OptimizerConfig) -> Callable:
    """step -> learning rate, a () f32 tensor on the step's device: linear
    warmup over ``warmup_steps``, then constant, linear or cosine decay to
    0 at ``total_steps`` (f32 arithmetic, as JAX's)."""
    span = max(cfg.total_steps - cfg.warmup_steps, 1)

    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "constant":
            decay = 1.0
        else:
            t = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
            if cfg.schedule == "linear":
                decay = 1.0 - t
            else:                                    # cosine
                decay = 0.5 * (1 + torch.cos(math.pi * t))
        return cfg.lr * warm * decay
    return sched


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32: a () tensor."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.float()))
                                   for x in tree_leaves(tree)]).sum())


def adamw_init(params) -> dict:
    """Zero f32 ``m`` and ``v`` shaped like ``params``, ``count`` 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _pieces(*leaf_lists) -> list[list]:
    """The leaves of each list (the same shapes list to list) cut into flat
    pieces of at most ``GROUP_ELEMENTS`` elements, grouped by
    ``_groups``: -> per group, one list of pieces per input list.  The
    update's temporaries stay a few hundred megabytes whatever the size
    of a leaf (an expert tensor of mixtral-8x7b or jamba-v0.1-52b holds
    up to 940 M elements).  A piece is a view where the leaf is
    contiguous (always so for a leaf written in place)."""
    cut = [[piece for t in leaves
            for piece in t.reshape(-1).split(GROUP_ELEMENTS)]
           for leaves in leaf_lists]
    return [[pieces[lo:hi] for pieces in cut] for lo, hi in _groups(cut[0])]


def adamw_update(grads, opt_state, params, cfg: OptimizerConfig,
                 schedule: Callable | None = None, donate: bool = False):
    """One AdamW step -> (new params, new optimizer state, metrics
    ``{"grad_norm", "lr"}``), the JAX formula: the gradients clipped to
    ``cfg.grad_clip`` by global norm; ``count + 1`` picks the learning
    rate and the bias corrections; decoupled weight decay on every leaf;
    f32 arithmetic, each parameter returned in its dtype.  With
    ``donate`` the parameters' and moments' leaves are updated in place
    and returned in new trees; the numbers are the same either way."""
    sched = schedule or make_schedule(cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    count = opt_state["count"] + 1
    lr = sched(count)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** count.to(torch.float32)
    bc2 = 1 - b2 ** count.to(torch.float32)

    ps, gs, ms, vs = (tree_leaves(t) for t in (params, grads,
                                               opt_state["m"], opt_state["v"]))
    if donate:
        if not all(t.is_contiguous() for t in (*ps, *ms, *vs)):
            raise ValueError("adamw_update(donate=True) writes the "
                             "parameters and moments in place: every leaf "
                             "must be contiguous")
        outs = (ps, ms, vs)
    else:
        outs = tuple([torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in leaves] for leaves in (ps, ms, vs))
    # each operation over a group of leaf pieces in one multi-tensor launch
    add, mul, div = torch._foreach_add, torch._foreach_mul, torch._foreach_div
    for p, g, m, v, new_p, new_m, new_v in _pieces(ps, gs, ms, vs, *outs):
        # JAX's clip_by_global_norm, piece by piece
        g32 = [c.to(t.dtype).float()
               for c, t in zip(mul([t.float() for t in g], scale), g)]
        p32 = [t.float() for t in p]
        m = add(mul(m, b1), mul(g32, 1 - b1))
        v = add(mul(v, b2), mul(mul(g32, 1 - b2), g32))
        step = div(div(m, bc1),
                   add(torch._foreach_sqrt(div(v, bc2)), cfg.eps))
        step = add(step, mul(p32, cfg.weight_decay))
        p32 = torch._foreach_sub(p32, mul(step, lr))
        torch._foreach_copy_(new_p, [n.to(t.dtype) for n, t in zip(p32, p)])
        torch._foreach_copy_(new_m, m)
        torch._foreach_copy_(new_v, v)

    def rebuild(flat):
        it = iter(flat)
        return tree_map(lambda _: next(it), params)
    new_p, new_m, new_v = outs
    return (rebuild(new_p), {"m": rebuild(new_m), "v": rebuild(new_v),
                             "count": count},
            {"grad_norm": gnorm, "lr": lr})
