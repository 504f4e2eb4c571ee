"""Load the JAX package's parameters into the port's layout.

``params_from_jax`` takes the JAX ``LM`` parameter pytree with its leaves
already converted to numpy (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict: the leading layer axis of every
``blocks/b0/*`` leaf is unstacked into one dict per layer, and every leaf
keeps its dtype (bfloat16 included).  Both packages then compute on the
same weights, so the port's own init need not reproduce JAX's PRNG.
This module imports neither JAX nor the JAX package: it sees numpy only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.env import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                     # a private, writable copy
    if a.dtype.name == "bfloat16":      # numpy has no native bf16
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, device=None) -> dict:
    """JAX ``LM`` params (numpy leaves) -> the port's params on ``device``.

    Only the dense layout is accepted: ``blocks`` must hold exactly one
    period entry ``b0`` whose leaves carry the layer axis first."""
    dev = resolve_device(device)
    blocks = tree["blocks"]
    if set(blocks) != {"b0"}:
        raise ValueError(f"expected a dense block pattern {{'b0'}}, got "
                         f"{sorted(blocks)}")
    stacked = _map(np.asarray, blocks["b0"])
    n_layers = {a.shape[0] for a in _leaves(stacked)}
    if len(n_layers) != 1:
        raise ValueError(f"inconsistent layer axes {sorted(n_layers)}")
    out = {k: _tensor(v, dev) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_map(lambda a, i=i: _tensor(a[i], dev), stacked)
                     for i in range(n_layers.pop())]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
