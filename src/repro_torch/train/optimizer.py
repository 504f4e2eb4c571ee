"""AdamW and learning-rate schedules of the port, as plain functions.

The JAX package's formulas, step for step (``make_schedule``,
``global_norm``, ``clip_by_global_norm``, ``adamw_init``,
``adamw_update``), on the port's parameter tree (nested dicts and lists
of tensors) rather than ``torch.optim``: the tests hold one update of
each package to the other from the same gradients and state.  State is
f32 ``m`` and ``v`` trees shaped like the parameters and an int32
``count``; weight decay applies to every leaf, as in JAX.  Everything
stays on the parameters' device (no host sync: the learning rate and the
norm are () tensors).  Updates are functional, as JAX's: new trees are
returned and the inputs are left as they were.  Each elementwise
operation runs over groups of leaves in multi-tensor launches
(``torch._foreach_*``: the same elementwise arithmetic, rounded the same
way, as one operation a leaf).
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
    each (a larger leaf alone): the update's temporaries stay a few
    hundred megabytes whatever the model's size."""
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


def clip_by_global_norm(tree, max_norm: float):
    """-> (the tree scaled by min(1, max_norm / (norm + 1e-9)), each leaf
    in its dtype, the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    leaves = tree_leaves(tree)
    out = []
    for lo, hi in _groups(leaves):
        out += [g.to(t.dtype) for g, t in zip(
            torch._foreach_mul([t.float() for t in leaves[lo:hi]], scale),
            leaves[lo:hi])]
    it = iter(out)
    return tree_map(lambda _: next(it), tree), norm


def adamw_init(params) -> dict:
    """Zero f32 ``m`` and ``v`` shaped like ``params``, ``count`` 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads, opt_state, params, cfg: OptimizerConfig,
                 schedule: Callable | None = None):
    """One AdamW step -> (new params, new optimizer state, metrics
    ``{"grad_norm", "lr"}``), the JAX formula: the gradients clipped to
    ``cfg.grad_clip`` by global norm; ``count + 1`` picks the learning
    rate and the bias corrections; decoupled weight decay on every leaf;
    f32 arithmetic, each parameter returned in its dtype."""
    sched = schedule or make_schedule(cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = opt_state["count"] + 1
    lr = sched(count)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** count.to(torch.float32)
    bc2 = 1 - b2 ** count.to(torch.float32)

    ps, gs, ms, vs = (tree_leaves(t) for t in (params, grads,
                                               opt_state["m"], opt_state["v"]))
    # each operation over a group of leaves in one multi-tensor launch
    add, mul, div = torch._foreach_add, torch._foreach_mul, torch._foreach_div
    new_p, new_m, new_v = [], [], []
    for lo, hi in _groups(ps):
        p32 = [p.float() for p in ps[lo:hi]]
        g32 = [g.float() for g in gs[lo:hi]]
        m = add(mul(ms[lo:hi], b1), mul(g32, 1 - b1))
        v = add(mul(vs[lo:hi], b2), mul(mul(g32, 1 - b2), g32))
        step = div(div(m, bc1),
                   add(torch._foreach_sqrt(div(v, bc2)), cfg.eps))
        step = add(step, mul(p32, cfg.weight_decay))
        new_p += [n.to(p.dtype) for n, p in zip(
            torch._foreach_sub(p32, mul(step, lr)), ps[lo:hi])]
        new_m += m
        new_v += v

    def rebuild(flat):
        it = iter(flat)
        return tree_map(lambda _: next(it), params)
    return (rebuild(new_p), {"m": rebuild(new_m), "v": rebuild(new_v),
                             "count": count},
            {"grad_norm": gnorm, "lr": lr})
