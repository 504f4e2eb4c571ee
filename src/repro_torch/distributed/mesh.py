"""Mesh construction and the per-shard collectives of the port.

The JAX package lays the sharded page bank and the expert weights over a
``jax.sharding.Mesh`` and runs the per-shard work inside ``shard_map``,
one controller process driving every device (``--host-devices N`` forces
N logical CPU devices for that).  The port keeps that architecture: a
``Mesh`` is a tuple of torch devices driven by one process, and a
per-shard function is a Python loop over the shards whose results meet
in the collectives below.  A device may be named more than once; each
naming is one logical shard with its own slice, so ``Mesh((dev,) * 4)``
is four shards on one card, the counterpart of forced host devices.

Every collective reduces in the fixed order 0..N-1, so its result is
deterministic, and moves each input with ``.to(device)`` (a no-op while
all shards share one device).  Placing the shards' slices on several
distinct cards is not done yet: ``Mesh.device`` raises for such a mesh
where the bank or the expert weights would be placed.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

AXIS_MODEL = "model"


class Mesh:
    """``devices`` (one per shard, repeats allowed) over ``axis_names``;
    ``shape[axis]`` is the number of shards on ``axis``, as on a JAX
    mesh.  Only one-dimensional meshes are built here."""

    def __init__(self, devices: Sequence, axis_names=(AXIS_MODEL,)):
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError(f"the port's meshes have one axis, got "
                             f"{axis_names}")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(_index(torch.device(d)) for d in devices)
        self.axis_names = axis_names
        self.shape = {axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on.  Raises
        ``NotImplementedError`` for a mesh over several distinct devices:
        their placement is not ported yet."""
        distinct = set(self.devices)
        if len(distinct) != 1:
            raise NotImplementedError(
                "placing shards on several distinct devices "
                f"({sorted(map(str, distinct))}) is not yet ported to "
                "repro_torch: every shard of a mesh must name one device")
        return self.devices[0]

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


def _index(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that equal devices compare
    equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_count(shards: Optional[int], mesh: Optional[Mesh]) -> int:
    """The number of page-bank shards asked for: ``shards`` when given,
    else the mesh's size, else 1 (unsharded)."""
    if shards is not None:
        return shards
    return mesh.size if mesh is not None else 1


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``prod(shape)`` of ``devices`` (default: the
    visible CUDA cards), as JAX's ``make_mesh`` takes the first devices;
    raises when there are fewer."""
    n = math.prod(shape)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                         f"{len(devices)} visible")
    return Mesh(devices[:n], axes)


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of the per-shard tensors, in shard order 0..N-1, on shard 0's
    device."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise maximum of the per-shard tensors, on shard 0's
    device."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p.to(dev))
    return out


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> list[torch.Tensor]:
    """JAX's ``all_to_all(..., tiled=True)`` over N per-shard tensors:
    each splits into N equal pieces along ``split_axis``, and shard s
    receives piece s of every source, concatenated along
    ``concat_axis`` in source order, on shard s's own device."""
    n = len(parts)
    for p in parts:
        if p.shape[split_axis] % n:
            raise ValueError(f"all_to_all: axis {split_axis} of size "
                             f"{p.shape[split_axis]} does not split into "
                             f"{n} pieces")
    pieces = [torch.chunk(p, n, dim=split_axis) for p in parts]
    out = []
    for s in range(n):
        dev = parts[s].device
        out.append(torch.cat([pieces[src][s].to(dev) for src in range(n)],
                             dim=concat_axis))
    return out
