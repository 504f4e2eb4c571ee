"""Hand-written Hopper kernels for the port's attention hot spots.

Each kernel package has:
  csrc/<name>.cu — CUDA C++ for sm_90a with a plain C entry point
  ops.py         — the wrapper: checks its inputs, allocates the output,
                   launches on ``torch.cuda.current_stream()`` and counts
                   the launch (``<wrapper>.launches``)
  ref.py         — the plain PyTorch version of the same function

Dispatch follows the tensor's device and nothing else: a CPU tensor goes
to the plain version (the CPU tests), a CUDA tensor goes to the kernel,
and a CUDA card that is not sm_90 (or an input the kernel does not take)
raises.  There is no fallback from a CUDA tensor to the plain version.
Sources compile on first use (``_build``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_CHECKED: set[int] = set()


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every input lies on the CPU (-> plain version); False when
    every input lies on one CUDA card (-> kernel).  Anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _CHECKED:
        cap = torch.cuda.get_device_capability(idx)
        if cap != (9, 0):
            raise RuntimeError(
                f"the repro_torch kernels are built for sm_90a (Hopper); "
                f"device {idx} is sm_{cap[0]}{cap[1]}")
        _CHECKED.add(idx)
    return False


def check_cuda_input(name: str, t: torch.Tensor, dtype: torch.dtype,
                     shape: tuple) -> None:
    """Raise unless ``t`` is what a kernel takes: dtype, exact shape,
    contiguous and 16-byte aligned."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: kernel takes a 16-byte aligned tensor")


def c_function(kernel: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of one kernel library (built on first
    use), with its ctypes signature set."""
    fn = getattr(_build.load(kernel), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def reset_launch_counts() -> None:
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    for fn in (flash_attention, decode_attention, paged_decode_attention):
        fn.launches = 0


build_all = _build.build_all
