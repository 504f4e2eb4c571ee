"""Hand-written Hopper kernels for the port's hot spots: attention (and
one shard's partial over a sharded page bank), the Mamba selective scan,
the chunkwise mLSTM and the per-expert grouped matmul.

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


def f32_operand(t: torch.Tensor) -> torch.Tensor:
    """An f32, contiguous, 16-byte aligned copy of ``t`` (``t`` itself when
    it already is one): the f32 kernels' wrappers cast every operand to
    f32, as their JAX wrappers do."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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

MAX_TREE = 31       # a tree bitmask lives in a non-negative int32


def check_group(name: str, hd: int, G: int) -> None:
    if hd not in (32, 64, 128) or G not in (1, 2, 4, 8):
        raise ValueError(f"{name}: kernel takes head_dim 32/64/128 and "
                         f"group 1/2/4/8, got {hd}, {G}")


def verify_operands(name: str, q, blk_k, blk_v, tree, Hkv: int):
    """Check the block side of a verify call for the kernels and lay it
    out as they take it: q (B, Kb, H, hd) -> (B, Hkv, Kb*G, hd) score rows
    (row r = block query r // G under head r % G), blk_k/blk_v (B, Kb,
    Hkv, hd) -> (B, Hkv, Kb, hd), all contiguous bf16.  -> (qg, kb, vb,
    tree, G)."""
    B, Kb, H, hd = q.shape
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hkv}")
    G = H // Hkv
    check_group(name, hd, G)
    if Kb < 1:
        raise ValueError(f"{name}: empty block")
    for label, t in (("q", q), ("blk_k", blk_k), ("blk_v", blk_v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{label}: kernel takes torch.bfloat16, got "
                            f"{t.dtype}")
    if tuple(blk_k.shape) != (B, Kb, Hkv, hd) or blk_v.shape != blk_k.shape:
        raise ValueError(f"blk_k/blk_v: expected shape {(B, Kb, Hkv, hd)}, "
                         f"got {tuple(blk_k.shape)}, {tuple(blk_v.shape)}")
    if tree is not None:
        if Kb > MAX_TREE:
            raise ValueError(f"{name}: a tree mask takes at most "
                             f"{MAX_TREE} block tokens, got {Kb}")
        tree = tree.expand(B, Kb).contiguous()
        check_cuda_input("tree", tree, torch.int32, (B, Kb))
    qg = (q.reshape(B, Kb, Hkv, G, hd).permute(0, 2, 1, 3, 4)
          .reshape(B, Hkv, Kb * G, hd).contiguous())
    kb = blk_k.transpose(1, 2).contiguous()
    vb = blk_v.transpose(1, 2).contiguous()
    check_cuda_input("q", qg, torch.bfloat16, (B, Hkv, Kb * G, hd))
    check_cuda_input("blk_k", kb, torch.bfloat16, (B, Hkv, Kb, hd))
    check_cuda_input("blk_v", vb, torch.bfloat16, (B, Hkv, Kb, hd))
    return qg, kb, vb, tree, G


def verify_output(out, Kb: int, H: int):
    """The verify kernels' (B, Hkv, Kb*G, hd) rows -> (B, Kb, H, hd)."""
    B, Hkv, _, hd = out.shape
    return (out.reshape(B, Hkv, Kb, H // Hkv, hd).permute(0, 2, 1, 3, 4)
            .reshape(B, Kb, H, hd))


def reset_launch_counts() -> None:
    """Zero every kernel body's launch count (the int8 bodies of the
    paged wrappers count apart, in ``launches_int8``, the paged verify's
    tree route in ``launches_tree``, and the ring routes of the row
    decode and verify wrappers in ``launches_ring``; flash and gmm also
    count by shape, in ``launches_by_shape``)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.gmm.ops import gmm
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_decode_partial, paged_verify_attention)
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.verify_attention.ops import verify_attention
    for fn in (flash_attention, ssm_scan, mlstm_chunk, gmm):
        fn.launches = 0
    for fn in (flash_attention, gmm):
        fn.launches_by_shape.clear()
    for fn in (decode_attention, verify_attention):
        fn.launches = 0
        fn.launches_ring = 0
    for fn in (paged_decode_attention, paged_verify_attention,
               paged_decode_partial):
        fn.launches = 0
        fn.launches_int8 = 0
    paged_verify_attention.launches_tree = 0


build_all = _build.build_all
