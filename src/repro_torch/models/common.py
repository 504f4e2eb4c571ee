"""Parameter specs and their initialization.

A model declares a nested dict of ``PSpec`` (shape + init kind); ``init``
materializes it with an explicit ``torch.Generator``.  The port's own
init need not reproduce JAX's PRNG: parity tests load the JAX weights
through ``repro_torch.bridge`` instead.  Stds follow the JAX package:
``normal`` uses 1/sqrt(shape[-2]) (the last dim for vectors), ``scaled``
0.02, each unless ``scale`` overrides.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PSpec:
    shape: tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | scaled
    scale: float | None = None  # stddev override for normal/scaled


def init_one(s: PSpec, generator: torch.Generator, dtype: torch.dtype,
             device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype, device=device)
    if s.init == "normal":
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(
            max(fan_in, 1))
    elif s.init == "scaled":
        std = s.scale if s.scale is not None else 0.02
    else:
        raise ValueError(s.init)
    x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def init_params(specs, generator: torch.Generator, dtype: torch.dtype,
                device):
    """Materialize a nested dict/list of ``PSpec`` (depth-first order)."""
    if isinstance(specs, PSpec):
        return init_one(specs, generator, dtype, device)
    if isinstance(specs, dict):
        return {k: init_params(v, generator, dtype, device)
                for k, v in specs.items()}
    return [init_params(v, generator, dtype, device) for v in specs]
