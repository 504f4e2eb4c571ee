"""Super-Sub dynamic inference (paper Fig 6a/b, Fig S1a).

Two-stage cascade: a generalist *super* network predicts the superclass; if a
specialist exists for that superclass it is context-switched in and produces
the final subclass; otherwise the generalist finishes the job (the paper's
workflow, Fig 6a).

Only a context-switching fabric runs this efficiently: with dual slots the
specialist of batch *i* loads while the super network of batch *i+1*
executes (Fig S1a's 8-cycles-for-4-images pipeline).

Argmaxes run on the device (``torch.argmax`` returns the first maximal
index, as ``jnp.argmax`` does); the superclass of a batch is its one
readback before the specialist pass.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.context import ContextDescriptor, ContextSwitchEngine


@dataclass
class CascadeMember:
    name: str
    apply_fn: Callable              # (params, x) -> class logits
    weights_fn: Callable[[], Any]
    covers: int | None = None       # superclass id this specialist covers


def classifier_logits(model, params, tokens):
    """A transformer cascade member: the LM backbone's final states,
    mean-pooled over the sequence, times a (d, classes) head ->
    (B, classes) float32.  ``params`` is ``{"backbone": LM params,
    "head": (d, classes)}``."""
    h = model.hidden(params["backbone"], tokens)
    return h.mean(1).float() @ params["head"].float()


class SuperSubCascade:
    """Dynamic-inference cascade driven by a ContextSwitchEngine."""

    def __init__(self, engine: ContextSwitchEngine,
                 super_net: CascadeMember,
                 specialists: Sequence[CascadeMember],
                 generalist: CascadeMember,
                 sub_of_super: np.ndarray):
        """``sub_of_super[sub_id] -> super_id`` label hierarchy."""
        self.engine = engine
        self.super_net = super_net
        self.generalist = generalist
        self.specialists = {m.covers: m for m in specialists}
        self.sub_of_super = np.asarray(sub_of_super)
        for m in [super_net, generalist, *specialists]:
            engine.register(ContextDescriptor(
                name=m.name, apply_fn=m.apply_fn, weights_fn=m.weights_fn))

    # ------------------------------------------------------------ inference
    def static_infer(self, x) -> np.ndarray:
        """Paper's 'static inference': generalist only."""
        self.engine.preload(self.generalist.name)
        self.engine.switch(self.generalist.name)
        return self.engine.run(x).argmax(-1).cpu().numpy()

    def _super_pass(self, x) -> int:
        """Run the (active) super net on a batch -> its superclass."""
        return int(self.engine.run(x).mean(0).argmax())

    def dynamic_infer(self, x) -> dict:
        """Paper's 'dynamic inference' for one batch (Fig 6a workflow)."""
        self.engine.preload(self.super_net.name)
        self.engine.switch(self.super_net.name)
        return self._specialist_pass(x, self._super_pass(x))

    def _specialist_pass(self, x, super_pred: int) -> dict:
        """Switch to the specialist for `super_pred` and finish the batch."""
        m = self.specialists.get(super_pred, self.generalist)
        self.engine.preload(m.name)           # no-op if resident/in flight
        self.engine.switch(m.name, wait=True)
        pred = self.engine.run(x).argmax(-1).cpu().numpy()
        if m is not self.generalist:
            # specialist predicts within-superclass ids -> map to global ids
            l2g = np.where(self.sub_of_super == super_pred)[0]
            pred = l2g[pred]
        return {"super": super_pred, "sub": pred}

    def dynamic_infer_pipelined(self, batches: Sequence[Any]) -> list:
        """Fig S1(a): one batch is always in flight — while batch i's
        specialist weights stream into the shadow slot, the super net
        classifies batch i+1.  Prime with batch 0, drain batch i-1 after
        classifying batch i, flush the last batch at the end; the
        specialist load is never awaited in the same step it was issued,
        so it hides behind real execution (engine stats show
        ``hidden_load_seconds > 0``).

        Batch i's specialist is preloaded before batch i-1's specialist
        pass when that load cannot evict the specialist the pass still
        needs: with more than two slots, or when both batches need the
        same member.  The load then hides behind the drain and the next
        super pass, as in the JAX package.  On two slots otherwise the
        preload waits until the drain is done and the select is back on
        the super net: the super net keeps one slot and the specialists
        take turns in the other, so the load hides behind the next super
        pass only.  (The JAX package always preloads before the drain,
        which on two slots evicts the specialist the drain needs.)"""
        results: list[dict] = []
        in_flight: Optional[tuple[Any, int]] = None   # (batch, super_pred)
        spare_slot = len(self.engine.slots) > 2
        self.engine.preload(self.super_net.name, block=True)
        self.engine.switch(self.super_net.name)
        for x in batches:
            sp = self._super_pass(x)
            member = self.specialists.get(sp, self.generalist)
            early = (in_flight is None or spare_slot or member is
                     self.specialists.get(in_flight[1], self.generalist))
            if early:                         # streams behind the drain too
                self.engine.preload(member.name)
            if in_flight is not None:         # drain the previous batch
                results.append(self._specialist_pass(*in_flight))
                self.engine.switch(self.super_net.name)
            if not early:                     # streams behind the next pass
                self.engine.preload(member.name)
            in_flight = (x, sp)
        if in_flight is not None:             # flush
            results.append(self._specialist_pass(*in_flight))
        return results

    # ------------------------------------------------------------ accuracy
    def evaluate(self, xs, sub_labels, batch: int = 256) -> dict:
        """Fig 6(b): dynamic vs static subclass accuracy."""
        sub_labels = np.asarray(sub_labels)
        static_hits = dyn_hits = n = 0
        for i in range(0, len(xs), batch):
            xb, yb = xs[i:i + batch], sub_labels[i:i + batch]
            static_hits += (self.static_infer(xb) == yb).sum()
            out = self.dynamic_infer(xb)
            dyn_hits += (out["sub"] == yb).sum()
            n += len(yb)
        return {"static_acc": static_hits / n, "dynamic_acc": dyn_hits / n,
                "improvement": (dyn_hits - static_hits) / n}
