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

Gradients: flash attention (B1), the selective scan (B8) and the
chunkwise mLSTM (B9) have backward kernels (each a
``torch.autograd.Function`` on the card).  No other kernel has one yet:
on a CUDA tensor with grad enabled and an input that requires grad,
every other wrapper raises ``MissingBackwardKernel`` rather than return
a tensor that silently carries no gradient (``require_no_grad``).  On
the CPU autograd differentiates every plain version.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build

_CHECKED: set[int] = set()


class MissingBackwardKernel(NotImplementedError):
    """A gradient was asked of a kernel that has no backward kernel yet."""


def require_no_grad(name: str, *tensors) -> None:
    """Raise ``MissingBackwardKernel`` when autograd would need the
    gradient of kernel ``name`` (grad enabled and a tensor input that
    requires it): its launch writes a fresh tensor with no ``grad_fn``,
    so the loss would silently miss that path's gradient.  Called on the
    CUDA path of every wrapper whose kernel has no backward."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise MissingBackwardKernel(
            f"{name}: the backward kernel of {name} is not ported yet, so "
            f"it cannot be differentiated on the card (run under "
            f"torch.no_grad(), or on the CPU, where its plain version is "
            f"differentiable)")


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

HEAD_DIMS = (32, 64, 128, 256)   # the attention kernels' instantiated widths
MAX_DECODE_GROUP = 16   # query heads of one decode launch, at most


DECODE_TILE = 64        # keys of a decode tile (kernels/csrc/decode_tc.cuh)
MAX_DECODE_SPLITS = 8   # blocks of a decode cluster, at most
DECODE_RUN = 2          # tiles a decode block folds, at least


def decode_splits(cap: int) -> int:
    """The blocks (1, 2, 4 or 8, one cluster) over which a one-token
    decode splits the keys of each (row, kv head): the most that give
    every block at least ``DECODE_RUN`` of the ``cap`` keys' 64-key
    tiles.  From the capacity alone, so a row's output does not depend on
    its batch, the other rows or the card, and the row, paged and
    partial decode of the same keys split them alike.  Never the rows'
    positions: reading them would sync the host and break CUDA-graph
    capture."""
    tiles = -(-cap // DECODE_TILE)
    s = 1
    while 2 * s <= MAX_DECODE_SPLITS and 2 * s * DECODE_RUN <= tiles:
        s *= 2
    return s


def decode_runs(cap: int, splits: int) -> list[tuple[int, int]]:
    """The key run ``[lo, hi)`` that each block of a decode cluster folds:
    the ``ceil(cap / 64)`` tiles cut by key index, block r taking tiles
    ``[r T / splits, (r + 1) T / splits)``.  The same for a row cache and
    a page pool of ``cap`` keys a row (page ids never enter it); the
    kernel clips each run to the row's keys ``[0, pos]``."""
    tiles = -(-cap // DECODE_TILE)
    return [(min(cap, DECODE_TILE * (r * tiles // splits)),
             min(cap, DECODE_TILE * ((r + 1) * tiles // splits)))
            for r in range(splits)]


def kernel_head_dim(hd: int) -> int:
    """The narrowest instantiated head width that holds ``hd``."""
    for width in HEAD_DIMS:
        if hd <= width:
            return width
    raise ValueError(f"kernel takes head_dim up to {HEAD_DIMS[-1]}, got {hd}")


def pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns appended to its last dimension up to
    ``width`` (``t`` itself when it is that wide)."""
    n = t.shape[-1]
    if n == width:
        return t
    return torch.nn.functional.pad(t, (0, width - n))


def decode_padded(q, Hkv: int, kv: tuple, body) -> tuple:
    """The decode family's domain: q (B, H, hd), H = Hkv * G, run through
    ``body`` in what the decode body takes, exactly.  head_dim goes to the
    next of ``HEAD_DIMS`` (zero columns of q and of each tensor in ``kv``,
    whose last dimension is head_dim); a group past ``MAX_DECODE_GROUP``
    runs in slices of 16 heads, one launch each (any group up to 16 is
    one launch as it is).  ``body(qp, kvp, Gs)`` takes qp (B, Hkv * Gs,
    width) contiguous and returns outputs shaped (B, Hkv, Gs, ...); ->
    those outputs joined over the slices and cropped (where a 4-D output
    ends in head_dim) to the true columns, each (B, Hkv, G, ...).  A zero
    column adds nothing to a score and is cropped from the output; the
    scale stays the caller's."""
    B, H, hd = q.shape
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hkv}")
    G = H // Hkv
    width = kernel_head_dim(hd)
    kv = tuple(pad_last(t, width) for t in kv)
    qg = q.reshape(B, Hkv, G, hd)
    parts = []
    for g0 in range(0, G, MAX_DECODE_GROUP):
        gc = min(MAX_DECODE_GROUP, G - g0)
        qc = pad_last(qg[:, :, g0:g0 + gc], width)
        parts.append(body(qc.reshape(B, Hkv * gc, width).contiguous(), kv,
                          gc))
    outs = [torch.cat(p, dim=2) if len(p) > 1 else p[0] for p in zip(*parts)]
    return tuple(o[..., :hd] if o.dim() == 4 else o for o in outs)


def verify_padded(name: str, q, blk_k, blk_v, tree, Hkv: int):
    """The block side of a verify call, padded to the tensor-core verify
    body's widths: q (B, Kb, H, hd), blk_k/blk_v (B, Kb, Hkv, hd), any
    group, head_dim zero-padded to the next of ``HEAD_DIMS`` (exact: the
    caller pads its cache alike and crops the output's columns).  The
    kernel reads q and the block in place and writes (B, Kb, H, width)
    itself, so nothing is permuted.  -> (q, blk_k, blk_v, tree, G, width),
    contiguous; ``check_verify_operands`` then holds them to the kernel's
    types."""
    B, Kb, H, hd = q.shape
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hkv}")
    if Kb < 1:
        raise ValueError(f"{name}: empty block")
    if tuple(blk_k.shape) != (B, Kb, Hkv, hd) or blk_v.shape != blk_k.shape:
        raise ValueError(f"blk_k/blk_v: expected shape {(B, Kb, Hkv, hd)}, "
                         f"got {tuple(blk_k.shape)}, {tuple(blk_v.shape)}")
    if tree is not None:
        if Kb > MAX_TREE:
            raise ValueError(f"{name}: a tree mask takes at most "
                             f"{MAX_TREE} block tokens, got {Kb}")
        tree = tree.expand(B, Kb).contiguous()
    width = kernel_head_dim(hd)
    q, blk_k, blk_v = (pad_last(t, width).contiguous()
                       for t in (q, blk_k, blk_v))
    return q, blk_k, blk_v, tree, H // Hkv, width


def check_verify_operands(q, blk_k, blk_v, tree) -> None:
    """Raise unless ``verify_padded``'s results are what the verify kernels
    take: bf16 q and block, an int32 tree (or none)."""
    B, Kb, _, width = q.shape
    check_cuda_input("q", q, torch.bfloat16, tuple(q.shape))
    for label, t in (("blk_k", blk_k), ("blk_v", blk_v)):
        check_cuda_input(label, t, torch.bfloat16, tuple(blk_k.shape))
    if tree is not None:
        check_cuda_input("tree", tree, torch.int32, (B, Kb))


def _counted() -> tuple:
    """Every wrapper that counts its launches."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_backward)
    from repro_torch.kernels.gmm.ops import gmm
    from repro_torch.kernels.mlstm_chunk.ops import (mlstm_chunk,
                                                     mlstm_chunk_backward)
    from repro_torch.kernels.paged_attention.ops import (
        paged_decode_attention, paged_decode_partial, paged_verify_attention)
    from repro_torch.kernels.ssm_scan.ops import ssm_scan, ssm_scan_backward
    from repro_torch.kernels.verify_attention.ops import verify_attention
    return (flash_attention, flash_attention_backward, decode_attention,
            verify_attention,
            paged_decode_attention, paged_verify_attention,
            paged_decode_partial, ssm_scan, ssm_scan_backward, mlstm_chunk,
            mlstm_chunk_backward, gmm)


def launch_counts() -> dict:
    """A copy of every launch count: ``(wrapper, attribute) -> count``,
    an int, or a ``Counter`` for ``launches_by_shape``."""
    out = {}
    for fn in _counted():
        for attr, v in vars(fn).items():
            if attr.startswith("launches"):
                out[(fn, attr)] = (collections.Counter(v)
                                   if isinstance(v, collections.Counter)
                                   else v)
    return out


def launches_since(before: dict) -> dict:
    """What every launch count gained since ``before``
    (``launch_counts()``), in the same form."""
    return {k: (v - before[k] if isinstance(v, int)
                else collections.Counter({s: c - before[k][s]
                                          for s, c in v.items()
                                          if c != before[k][s]}))
            for k, v in launch_counts().items()}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (``launches_since``) to the counts.  A
    CUDA graph's replay launches what its capture recorded without
    calling the wrappers: it adds the capture's delta once per replay
    (and the capture, which launches nothing, takes it back once)."""
    for (fn, attr), d in delta.items():
        if isinstance(d, int):
            setattr(fn, attr, getattr(fn, attr) + times * d)
        else:
            counter = getattr(fn, attr)
            for shape, c in d.items():
                counter[shape] += times * c


def reset_launch_counts() -> None:
    """Zero every kernel body's launch count (the int8 bodies of the
    paged wrappers count apart, in ``launches_int8``, the paged verify's
    tree route in ``launches_tree``, and the ring routes of the row
    decode and verify wrappers in ``launches_ring``; flash, gmm, the
    paged decode and verify, the scan and the mLSTM, and the flash, scan
    and mLSTM backwards also count by shape, in ``launches_by_shape``)."""
    for (fn, attr), v in launch_counts().items():
        if isinstance(v, int):
            setattr(fn, attr, 0)
        else:
            getattr(fn, attr).clear()


build_all = _build.build_all
