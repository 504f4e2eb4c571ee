"""Synthetic data: the paper's Super-Sub classification task.

The same numpy generator calls as the JAX package's ``HierarchicalTask``,
so one seed gives the same distributions, tokens, subclasses and
superclasses in both packages; the port returns them as CPU
``torch.int32`` tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _int32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int32))


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
