"""Load the JAX package's parameters into the port's layout.

``params_from_jax`` takes the JAX ``LM`` parameter pytree with its leaves
already converted to numpy (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict.  JAX stacks each of the P block kinds
of a period (``blocks/b0 .. blocks/b{P-1}``) over a leading repeat axis
R; layer ``r*P + i`` of the port takes ``blocks[f"b{i}"][r]``, the order
in which the JAX model's layer scan runs them.  Every leaf keeps its
dtype (bfloat16 included).  Both packages then compute on the same
weights, so the port's own init need not reproduce JAX's PRNG.
``tree_from_numpy`` carries any other nested dict of arrays across (a
classifier's head, a likelihood member's tables); ``train_state_from_jax``
a JAX training state (parameters, AdamW moments and count, step).
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


def tree_from_numpy(tree, device=None):
    """A nested dict of numpy arrays -> the same dict of tensors on
    ``device``, every dtype kept (bfloat16 included): a cascade head, or
    a likelihood member's tables."""
    dev = resolve_device(device)
    return _map(lambda a: _tensor(a, dev), tree)


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


def train_state_from_jax(state: dict, device=None) -> dict:
    """A JAX train state (``{"params", "opt": {"m", "v", "count"}, "step"}``,
    numpy leaves) -> the port's (``repro_torch.train.trainer.init_state``'s
    layout): params and both moments through ``params_from_jax`` (the
    moments are params-shaped), count and step as int32 () tensors.  Both
    packages then take the same step from the same state."""
    dev = resolve_device(device)
    opt = state["opt"]
    out = {"params": params_from_jax(state["params"], dev),
           "opt": {"m": params_from_jax(opt["m"], dev),
                   "v": params_from_jax(opt["v"], dev),
                   "count": _tensor(np.asarray(opt["count"], np.int32),
                                    dev)},
           "step": _tensor(np.asarray(state["step"], np.int32), dev)}
    if "ef" in state:
        out["ef"] = params_from_jax(state["ef"], dev)
    return out
