"""Data of the port: deterministic synthetic sources and a
straggler-tolerant prefetch.

The same numpy generator calls as the JAX package's sources, so one seed
gives the same tokens in both packages: ``SyntheticTokens`` (the LM
trainer's stream, batch for batch) and ``HierarchicalTask`` (the paper's
Super-Sub classification task: distributions, tokens, subclasses and
superclasses, as CPU ``torch.int32`` tensors).  Sources are stateless:
``batch_at(step)`` derives the batch from the step alone, so a
checkpoint's data cursor is the step and a resume is exact.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.env import resolve_device


def _int32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int32))


class SyntheticTokens:
    """Zipf-ish token stream for LM training shapes: ``batch_at(step)``
    draws ``{"tokens": (batch, seq_len)}`` from ``np.random.default_rng(
    (seed, step))`` as the JAX package's does (the same tokens, batch for
    batch), as ``dtype`` (int32 or int64) on ``device`` (the CUDA card
    unless the caller names the CPU).  ``patch_spec`` ((positions, dim))
    also draws bf16 ``patch_embeds``, as JAX's does after the tokens."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 patch_spec: tuple[int, int] | None = None, device=None,
                 dtype: torch.dtype = torch.int32):
        if dtype not in (torch.int32, torch.int64):
            raise ValueError(f"tokens are int32 or int64, got {dtype}")
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        self.seed = seed
        self.patch_spec = patch_spec          # (num_positions, embed_dim)
        self.device = resolve_device(device)
        self.dtype = dtype

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        # zipf-like marginal so the loss curve is non-trivial
        ranks = np.arange(1, self.vocab + 1)
        p = 1.0 / ranks
        p /= p.sum()
        toks = rng.choice(self.vocab, size=(self.batch, self.seq_len), p=p)
        out = {"tokens": torch.from_numpy(toks).to(self.device, self.dtype)}
        if self.patch_spec is not None:
            n, d = self.patch_spec
            out["patch_embeds"] = torch.from_numpy(
                rng.standard_normal((self.batch, n, d))).to(
                self.device, torch.bfloat16)
        return out


class HierarchicalTask:
    """Super/sub-class sequence classification (the paper's Fig 6a/b data).

    Each subclass s (of superclass g(s)) has a token distribution =
    superclass base mixture + subclass perturbation; a sequence is iid draws.
    A classifier must infer the distribution — learnable by a small
    transformer with mean pooling, and the hierarchy makes specialists
    genuinely better *within* their superclass (the paper's premise).
    """

    def __init__(self, num_super: int = 10, subs_per_super: int = 8,
                 vocab: int = 512, seq_len: int = 32, seed: int = 0,
                 super_strength: float = 3.0, sub_strength: float = 1.2):
        self.num_super = num_super
        self.subs_per_super = subs_per_super
        self.num_sub = num_super * subs_per_super
        self.vocab, self.seq_len = vocab, seq_len
        rng = np.random.default_rng(seed)
        base = rng.standard_normal((num_super, vocab)) * super_strength
        pert = rng.standard_normal((self.num_sub, vocab)) * sub_strength
        logits = base[np.arange(self.num_sub) // subs_per_super] + pert
        self.dists = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        self.sub_of_super = np.arange(self.num_sub) // subs_per_super

    def sample(self, n: int, seed: int = 0,
               subclasses: Optional[np.ndarray] = None):
        """-> (tokens (n, seq_len), subclasses (n,), superclasses (n,))."""
        rng = np.random.default_rng((seed, 777))
        subs = (rng.integers(0, self.num_sub, n) if subclasses is None
                else rng.choice(subclasses, n))
        toks = np.stack([rng.choice(self.vocab, self.seq_len,
                                    p=self.dists[s]) for s in subs])
        return _int32(toks), _int32(subs), _int32(self.sub_of_super[subs])

    def batch_iter(self, batch: int, seed: int = 0,
                   subclasses: Optional[np.ndarray] = None):
        step = 0
        while True:
            x, sub, sup = self.sample(batch, seed=(seed * 100003 + step),
                                      subclasses=subclasses)
            yield {"x": x, "sub": sub, "sup": sup}
            step += 1


class PrefetchLoader:
    """Deadline-bounded background prefetch (straggler mitigation), as the
    JAX package's.

    A slow ``batch_at`` (network stall, bad host) never blocks the step
    longer than ``deadline_s``: the loader hands out the freshest *backup*
    batch instead and counts the event (``stats["stragglers"]``).  On a
    real cluster the backup comes from a replicated sample store; here it
    is the previous batch.
    """

    def __init__(self, source, depth: int = 2, deadline_s: float = 5.0):
        self.source = source
        self.deadline_s = deadline_s
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.stats = {"stragglers": 0, "batches": 0}
        self._backup: Any = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = 0
        while not self._stop.is_set():
            b = self.source.batch_at(step)
            self.q.put((step, b))
            step += 1

    def batch_at(self, step: int):
        """Step-ordered fetch with deadline."""
        deadline = time.monotonic() + self.deadline_s
        while True:
            try:
                s, b = self.q.get(timeout=max(0.0, deadline -
                                              time.monotonic()))
            except queue.Empty:
                self.stats["stragglers"] += 1
                if self._backup is None:    # cold start: block once
                    s, b = self.q.get()
                else:
                    self.stats["batches"] += 1
                    return self._backup
            self._backup = b
            self.stats["batches"] += 1
            if s >= step:
                return b
            # stale early batches are drained (after resume at step > 0)

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
