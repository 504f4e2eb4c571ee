"""Device resolution for the port's entry points.

Every entry point takes ``device=``.  Left out (``None``), it means the
CUDA card; with no card visible that raises instead of carrying on
silently on the CPU.  The CPU is chosen only by asking for it.
"""
from __future__ import annotations

import platform

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                               "device is visible")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


def describe(device) -> dict:
    """Where a run happened, for reports."""
    dev = torch.device(device)
    out = {"torch": torch.__version__, "python": platform.python_version(),
           "device": str(dev)}
    if dev.type == "cuda":
        out.update(cuda=torch.version.cuda,
                   device_name=torch.cuda.get_device_name(dev),
                   device_count=torch.cuda.device_count())
    return out


def synchronize(device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) -> torch dtype."""
    return getattr(torch, name)
