"""Train the Super-Sub cascade's members, then run dynamic inference
(paper Fig 6a/b): the port's counterpart of the JAX package's
``examples/train_cascade.py``.

    python -m repro_torch.train.cascade [--steps 200] [--full] [--device cpu]

A superclass router, a generalist (every subclass) and one specialist per
superclass are transformer classifiers (the LM backbone's final states,
mean-pooled, times a head) trained with one-hot cross-entropy and AdamW
on ``HierarchicalTask``; they are wired into ``SuperSubCascade`` on a
two-slot ``ContextSwitchEngine``, and the cascade's static accuracy (the
generalist alone) is printed beside its dynamic accuracy (router, then
the superclass's specialist).  By default the members are the JAX
example's reduced widths (2 layers, d 64); ``--full`` trains
``supersub-super`` (router, generalist) and ``supersub-sub``
(specialists) at their published widths (4 layers, d 256, 8 heads,
vocab 512).  It runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.cascade import (CascadeMember, SuperSubCascade,
                                      classifier_logits)
from repro_torch.core.context import ContextSwitchEngine
from repro_torch.core.env import resolve_device
from repro_torch.models.model import build_model
from repro_torch.train.data import HierarchicalTask
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         make_schedule)
from repro_torch.train.trainer import value_and_grad

# a member's logits: the backbone's final states, mean-pooled, times the
# (d, classes) head, in f32
apply_classifier = classifier_logits


def make_classifier(cfg, num_classes: int, seed: int, device=None):
    """-> (model, {"backbone": LM params from ``seed``, "head": (d,
    num_classes) f32, 0.02 N(0, 1)}) on ``device``."""
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    head = 0.02 * torch.randn(cfg.d_model, num_classes, generator=gen,
                              device=model.device)
    return model, {"backbone": model.init(seed), "head": head}


def classifier_loss(model, params, x, y, num_classes: int):
    """Mean one-hot cross-entropy of the classifier's logits."""
    logits = apply_classifier(model, params, x)
    onehot = F.one_hot(y.long(), num_classes).float()
    return -(torch.log_softmax(logits, dim=-1) * onehot).sum(-1).mean()


def train_classifier(model, params, batches, steps: int, num_classes: int,
                     lr: float = 2e-3):
    """``steps`` AdamW steps (the JAX example's schedule: cosine, warmup a
    tenth of the steps) on ``next(batches)`` (``{"x", "label"}``) ->
    (trained params, the last step's loss as a float)."""
    ocfg = OptimizerConfig(lr=lr, total_steps=steps,
                           warmup_steps=max(steps // 10, 1))
    sched = make_schedule(ocfg)
    opt = adamw_init(params)
    dev = model.device
    loss = None
    for _ in range(steps):
        b = next(batches)
        x, y = b["x"].to(dev), b["label"].to(dev)
        loss, _, grads = value_and_grad(
            lambda p: (classifier_loss(model, p, x, y, num_classes), {}),
            params)
        params, opt, _ = adamw_update(grads, opt, params, ocfg, sched)
    return params, float(loss)


def member_configs(task: HierarchicalTask, full: bool):
    """(router / generalist config, specialist config): the published
    ``supersub-super`` / ``supersub-sub`` with ``full``, else the JAX
    example's reduced cut of ``supersub-super`` for all of them."""
    if full:
        return get_arch("supersub-super"), get_arch("supersub-sub")
    cfg = reduced(get_arch("supersub-super"), vocab_size=task.vocab,
                  num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128)
    return cfg, cfg


def main(argv=None) -> dict:
    """Train the members, run the cascade; print and return its static and
    dynamic accuracy, the members' last losses and the engine's stats."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--num-super", type=int, default=3)
    ap.add_argument("--subs-per-super", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="published supersub widths (default: reduced)")
    ap.add_argument("--sub-strength", type=float, default=1.5,
                    help="how far a subclass's tokens stray from its "
                         "superclass's (the JAX example's 1.5; at 0.5 the "
                         "generalist no longer solves the task alone)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    task = HierarchicalTask(num_super=args.num_super,
                            subs_per_super=args.subs_per_super,
                            vocab=512 if args.full else 256,
                            seq_len=24, seed=0, super_strength=3.0,
                            sub_strength=args.sub_strength)
    num_sub = task.num_sub
    sup_cfg, sub_cfg = member_configs(task, args.full)

    def batches(label_key, subclasses=None, seed=0):
        it = task.batch_iter(32, seed=seed, subclasses=subclasses)
        while True:
            b = next(it)
            yield {"x": b["x"], "label": b[label_key]}

    t0 = time.time()
    losses = {}
    print("training superclass router ...")
    sup_model, sup_p = make_classifier(sup_cfg, task.num_super, 1, dev)
    sup_p, losses["router"] = train_classifier(
        sup_model, sup_p, batches("sup", seed=1), args.steps, task.num_super)
    print(f"  router loss {losses['router']:.3f}")

    print("training generalist (all subclasses, same budget) ...")
    gen_model, gen_p = make_classifier(sup_cfg, num_sub, 2, dev)
    gen_p, losses["generalist"] = train_classifier(
        gen_model, gen_p, batches("sub", seed=2), args.steps, num_sub)
    print(f"  generalist loss {losses['generalist']:.3f}")

    specialists = []
    for g in range(task.num_super):
        subs = np.where(task.sub_of_super == g)[0]
        k = len(subs)
        model_s, p_s = make_classifier(sub_cfg, k, 10 + g, dev)

        def local_batches(subs=subs, g=g):
            it = task.batch_iter(32, seed=50 + g, subclasses=subs)
            while True:
                b = next(it)
                local = np.searchsorted(subs, b["sub"].numpy())
                yield {"x": b["x"], "label": torch.from_numpy(local)}

        p_s, losses[f"spec{g}"] = train_classifier(
            model_s, p_s, local_batches(), args.steps, k)
        print(f"  specialist {g} loss {losses[f'spec{g}']:.3f}")
        specialists.append((model_s, p_s, g))
    train_s = time.time() - t0

    # --- wire everything into the context-switching engine ----------------
    eng = ContextSwitchEngine(num_slots=2, device=dev)
    sup_m = CascadeMember(
        "super", lambda p, x: apply_classifier(sup_model, p, x),
        lambda: sup_p)
    gen_m = CascadeMember(
        "generalist", lambda p, x: apply_classifier(gen_model, p, x),
        lambda: gen_p)
    spec_ms = [CascadeMember(
        f"spec{g}", lambda p, x, m=m: apply_classifier(m, p, x),
        lambda p=p: p, covers=g) for m, p, g in specialists]
    cascade = SuperSubCascade(eng, sup_m, spec_ms, gen_m, task.sub_of_super)

    # --- evaluate: dynamic (paper Fig 6a) vs static ------------------------
    # three single-subclass batches of 64 for every subclass (the JAX
    # example's eight batches see only each superclass's first subclass)
    res = []
    for b in range(3 * num_sub):
        x, sub, _ = task.sample(64, seed=500 + b,
                                subclasses=np.array([b % num_sub]))
        res.append(cascade.evaluate(x.to(dev), sub.numpy(), batch=64))
    dyn = float(np.mean([r["dynamic_acc"] for r in res]))
    sta = float(np.mean([r["static_acc"] for r in res]))
    out = {"static_acc": sta, "dynamic_acc": dyn,
           "chance": 1.0 / num_sub, "losses": losses, "steps": args.steps,
           "train_seconds": train_s, "switches": eng.stats["switches"],
           "loads": eng.stats["loads"],
           "wall_seconds": time.time() - t0}
    eng.shutdown()
    print(f"\nstatic accuracy  : {sta:.3f}")
    print(f"dynamic accuracy : {dyn:.3f}  (improvement {dyn - sta:+.3f})")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
