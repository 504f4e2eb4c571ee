"""Load the JAX package's parameters into the port's layout.

``params_from_jax`` takes the JAX ``LM`` parameter pytree with its leaves
already converted to numpy (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict.  JAX stacks each of the P block kinds
of a period (``blocks/b0 .. blocks/b{P-1}``) over a leading repeat axis
R; layer ``r*P + i`` of the port takes ``blocks[f"b{i}"][r]``, the order
in which the JAX model's layer scan runs them.  Every leaf keeps its
dtype (bfloat16 included).  Both packages then compute on the same
weights, so the port's own init need not reproduce JAX's PRNG.
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

    ``blocks`` must hold the period entries ``b0 .. b{P-1}``, every leaf
    with the same leading repeat axis."""
    dev = resolve_device(device)
    blocks = tree["blocks"]
    P = len(blocks)
    if set(blocks) != {f"b{i}" for i in range(P)}:
        raise ValueError(f"expected period blocks b0..b{P - 1}, got "
                         f"{sorted(blocks)}")
    stacked = [_map(np.asarray, blocks[f"b{i}"]) for i in range(P)]
    repeats = {a.shape[0] for b in stacked for a in _leaves(b)}
    if len(repeats) != 1:
        raise ValueError(f"period blocks need one repeat axis, got "
                         f"{sorted(repeats)}")
    out = {k: _tensor(v, dev) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_map(lambda a, r=r: _tensor(a[r], dev), stacked[i])
                     for r in range(repeats.pop()) for i in range(P)]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
