"""Public wrappers of the chunkwise-mLSTM kernel and its backward.

A CPU tensor runs the plain version (``ref.mlstm_chunk_reference``); a
CUDA tensor launches ``csrc/mlstm_chunk.cu`` or raises.  Where a
gradient is needed (grad enabled and an input that requires it), the
CUDA path is a ``torch.autograd.Function``: its forward launches the same
kernel with its saves set (each chunk's carried state, the gates and
each token's signed den), its backward hands them to
``mlstm_chunk_backward``, which launches ``csrc/mlstm_chunk_bwd.cu`` (on
the CPU autograd differentiates the plain version).  The final state (C,
n, m) takes no cotangent on the card: training discards it.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch import kernels as K
from repro_torch.kernels.mlstm_chunk.ref import (
    mlstm_chunk_backward_reference, mlstm_chunk_reference,
    mlstm_recurrent_reference)

DEFAULT_CHUNK = 128
MAX_CHUNK = 256          # the kernel scans a chunk's gates in one block
MAX_DH = 512             # a cluster of dh / 64 blocks: at most 8
STATE_BUDGET = 256 << 20  # bytes of the chunks' states, at most, a span

_fn = None
_bwd_fn = None
_ws_fn = None


def kernel_width(dh: int) -> int:
    """The width the kernels run dh at: the next multiple of 64."""
    width = -(-dh // 64) * 64
    if width > MAX_DH:
        raise ValueError(f"mlstm_chunk: kernel takes dh up to {MAX_DH}, "
                         f"got {dh}")
    return width


def with_dh_padding(body, q, k, v, li, lf, chunk: int):
    """``body(q, k, v, li, lf, chunk, scale)`` with dh zero-padded to a
    multiple of 64 and the scale 1/sqrt(dh) of the true width; h, C and n
    cropped back.  A zero column of k adds nothing to a score or to n, of
    q nothing to n . q or q C, of v nothing to the kept columns of C or
    h, so the result is exact.  So are the gradients through it: a padded
    column of h takes no cotangent, and the padded columns' own
    gradients are cropped unread (``_MLSTMFunction`` pads and
    ``mlstm_chunk_backward`` crops so)."""
    dh = q.shape[-1]
    width = kernel_width(dh)
    scale = 1.0 / math.sqrt(dh)
    if width == dh:
        return body(q, k, v, li, lf, chunk, scale)
    h, (C, n, m) = body(*(K.pad_last(t, width) for t in (q, k, v)), li, lf,
                        chunk, scale)
    return h[..., :dh], (C[..., :dh, :dh], n[..., :dh], m)


def chunk_span(B: int, H: int, nc: int, dh: int) -> int:
    """Chunks whose states the kernel holds at once: all ``nc`` where
    their ``B H (dh^2 + dh)`` floats a chunk fit ``STATE_BUDGET``, else
    as many as fit, at least one."""
    per = 4 * B * H * (dh * dh + dh)
    return max(1, min(nc, STATE_BUDGET // per))


def _launch(q, k, v, li, lf, c, scale, save: bool = False):
    """One forward launch -> h, (C, n, m); with ``save`` also the saves
    (gates, states, dsum) that the backward reads, the chunks then run in
    one span whatever ``STATE_BUDGET`` says."""
    global _fn
    B, H, L, dh = q.shape
    for name, t, shape in (("q", q, (B, H, L, dh)), ("k", k, (B, H, L, dh)),
                           ("v", v, (B, H, L, dh)), ("li", li, (B, H, L)),
                           ("lf", lf, (B, H, L))):
        K.check_cuda_input(name, t, torch.float32, shape)
    nc = L // c
    span = nc if save else chunk_span(B, H, nc, dh)
    dev = q.device
    h = torch.empty((B, H, L, dh), dtype=torch.float32, device=dev)
    C = torch.empty((B, H, dh, dh), dtype=torch.float32, device=dev)
    n = torch.empty((B, H, dh), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    gates = torch.empty(4 * B * H * L + B * H * nc, dtype=torch.float32,
                        device=dev)
    states = torch.empty(span * B * H * (dh * dh + dh), dtype=torch.float32,
                         device=dev)
    dsum = (torch.empty((B, H, L), dtype=torch.float32, device=dev)
            if save else None)
    if _fn is None:
        _fn = K.c_function("mlstm_chunk", "mlstm_chunk_f32",
                           [K.P] * 12 + [K.I] * 6 + [K.F, K.P])
    rc = _fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
             lf.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
             m.data_ptr(), gates.data_ptr(), states.data_ptr(),
             None if dsum is None else dsum.data_ptr(), B, H, L, dh, c,
             span, float(scale), K.stream_ptr(q))
    K.check_launch("mlstm_chunk", rc)
    mlstm_chunk.launches += 1
    mlstm_chunk.launches_by_shape[(B, H, L, dh, c)] += 1
    if not save:
        return h, (C, n, m)
    mlstm_chunk.launches_saved += 1
    return h, (C, n, m), (gates, states, dsum)


def _launch_bwd(q, k, v, li, h, dh_out, saves, c, scale):
    """One backward launch from the forward's ``saves`` -> (dq, dk, dv,
    dli, dlf)."""
    global _bwd_fn, _ws_fn
    B, H, L, dh = q.shape
    gates, states, dsum = saves
    nc = L // c
    for name, t, shape in (("q", q, (B, H, L, dh)), ("k", k, (B, H, L, dh)),
                           ("v", v, (B, H, L, dh)), ("li", li, (B, H, L)),
                           ("h", h, (B, H, L, dh)),
                           ("dh", dh_out, (B, H, L, dh)),
                           ("gates", gates, (4 * B * H * L + B * H * nc,)),
                           ("states", states,
                            (nc * B * H * (dh * dh + dh),)),
                           ("dsum", dsum, (B, H, L))):
        K.check_cuda_input(name, t, torch.float32, shape)
    if _bwd_fn is None:
        _ws_fn = K.c_function("mlstm_chunk_bwd", "mlstm_chunk_bwd_workspace",
                              [K.I] * 5)
        _ws_fn.restype = ctypes.c_longlong
        _bwd_fn = K.c_function("mlstm_chunk_bwd", "mlstm_chunk_bwd_f32",
                               [K.P] * 15 + [K.I] * 5
                               + [K.F, ctypes.c_longlong, K.P])
    n_ws = _ws_fn(B, H, L, dh, c)
    if n_ws < 0:
        raise ValueError(f"mlstm_chunk_backward: kernel does not take "
                         f"(B, H, L, dh, chunk) {(B, H, L, dh, c)}")
    dev = q.device
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    dq, dk, dv = torch.empty((3, B, H, L, dh), dtype=torch.float32,
                             device=dev)
    dli, dlf = torch.empty((2, B, H, L), dtype=torch.float32, device=dev)
    rc = _bwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
                 h.data_ptr(), dh_out.data_ptr(), gates.data_ptr(),
                 states.data_ptr(), dsum.data_ptr(), ws.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dli.data_ptr(),
                 dlf.data_ptr(), B, H, L, dh, c, float(scale), n_ws,
                 K.stream_ptr(q))
    K.check_launch("mlstm_chunk_backward", rc)
    mlstm_chunk_backward.launches += 1
    mlstm_chunk_backward.launches_by_shape[(B, H, L, dh, c)] += 1
    return dq, dk, dv, dli, dlf


class FinalStateCotangent(K.MissingBackwardKernel):
    """A cotangent of the chunkwise mLSTM's final state (C, n, m) reached
    the card's backward, which takes only h's."""


class _MLSTMFunction(torch.autograd.Function):
    """B9 with a gradient on the card: the forward kernel at the kernel's
    width (dh zero-padded as ``with_dh_padding`` pads it), writing its
    saves, then ``mlstm_chunk_backward`` from the saved inputs, h and
    saves.  Takes f32 inputs and a chunk that divides L.  h's gradient
    may be None; a gradient of C, n or m raises ``FinalStateCotangent``
    rather than be dropped."""

    @staticmethod
    def forward(ctx, q, k, v, li, lf, c):
        ctx.set_materialize_grads(False)
        dh = q.shape[-1]
        width = kernel_width(dh)
        h, (C, n, m), saves = _launch(
            *(K.pad_last(t, width) for t in (q, k, v)), li, lf, c,
            1.0 / math.sqrt(dh), save=True)
        ctx.c = c
        ctx.save_for_backward(q, k, v, li, lf, h, *saves)
        if width == dh:
            return h, C, n, m
        return (h[..., :dh].contiguous(), C[..., :dh, :dh].contiguous(),
                n[..., :dh].contiguous(), m)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh, dC, dn, dm):
        if any(g is not None for g in (dC, dn, dm)):
            raise FinalStateCotangent(
                "mlstm_chunk: a gradient reached the final state (C, n, m), "
                "and the backward kernel takes h's alone (differentiate "
                "through the state on the CPU, where the plain version "
                "carries it)")
        if dh is None:
            return (None,) * 6
        q, k, v, li, lf, h, *saves = ctx.saved_tensors
        return mlstm_chunk_backward(q, k, v, li, lf, dh, ctx.c,
                                    saved=(h, *saves)) + (None,)


def _chunk(L: int, chunk: int) -> int:
    """The chunk the kernel runs: ``chunk`` shrunk to a divisor of L, as
    the JAX wrapper does."""
    c = min(chunk, L)
    while L % c:
        c //= 2
    return c


def mlstm_chunk(q, k, v, li, lf, chunk: int = DEFAULT_CHUNK):
    """q/k/v: (B, H, L, dh); li/lf: (B, H, L) -> (h (B, H, L, dh) f32, (C
    (B, H, dh, dh), n (B, H, dh), m (B, H)) f32), from no history.
    Casts to f32 and shrinks the chunk to a divisor of L, as the JAX
    wrapper does.  Any dh up to 512: multiples of 64 run as they are,
    other widths zero-padded (``with_dh_padding``).  With a gradient
    needed, differentiable on the card through the backward kernel (h's
    gradient; the final state takes none there)."""
    c = _chunk(q.shape[2], chunk)
    q, k, v, li, lf = (K.f32_operand(t) for t in (q, k, v, li, lf))
    if K.on_cpu(q, k, v, li, lf):
        return mlstm_chunk_reference(q, k, v, li, lf, c)
    if c > MAX_CHUNK or q.shape[2] < 1:
        raise ValueError(f"mlstm_chunk: kernel takes a chunk of at most "
                         f"{MAX_CHUNK}, got {c}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, li, lf)):
        h, C, n, m = _MLSTMFunction.apply(q, k, v, li, lf, c)
        return h, (C, n, m)
    return with_dh_padding(_launch, q, k, v, li, lf, c)


def mlstm_chunk_backward(q, k, v, li, lf, dh_out, chunk: int = DEFAULT_CHUNK,
                         *, saved=None):
    """The gradients (dq, dk, dv, dli, dlf) of ``mlstm_chunk(q, k, v, li,
    lf, chunk)``'s h for its cotangent ``dh_out`` (B, H, L, dh), each f32
    in its input's shape; the final state takes none.  On the CPU the
    plain version (``ref.mlstm_chunk_backward_reference``: autograd through
    the plain chunkwise form), ``saved`` unread; on the card the backward
    kernel, dh zero-padded as the forward pads it, from ``saved``: h at
    the kernel's width and the saves of the forward launch that made it,
    which the autograd Function of ``mlstm_chunk`` keeps (the card's
    backward is reached through autograd on ``mlstm_chunk``).  Every
    stabilizer is held constant (h does not depend on them).
    Deterministic on the card: no atomics, every sum in one order."""
    c = _chunk(q.shape[2], chunk)
    q, k, v, li, lf, dh_out = (K.f32_operand(t)
                               for t in (q, k, v, li, lf, dh_out))
    if K.on_cpu(q, k, v, li, lf, dh_out):
        return mlstm_chunk_backward_reference(q, k, v, li, lf, c, dh_out)
    if saved is None:
        raise ValueError("mlstm_chunk_backward: on the card the kernel reads "
                         "the saves of the forward launch that made h; "
                         "differentiate mlstm_chunk, whose autograd Function "
                         "keeps them")
    dh = q.shape[-1]
    width = kernel_width(dh)
    q, k, v, dh_out = (K.f32_operand(K.pad_last(t, width))
                       for t in (q, k, v, dh_out))
    h, *saves = saved
    dq, dk, dv, dli, dlf = _launch_bwd(q, k, v, li, h, dh_out, saves, c,
                                       1.0 / math.sqrt(dh))
    return dq[..., :dh], dk[..., :dh], dv[..., :dh], dli, dlf


mlstm_chunk.launches = 0
# launches that wrote the backward's saves (a forward under a gradient)
mlstm_chunk.launches_saved = 0
# (B, H, L, dh, chunk) -> launches at that shape (dh as launched, padded)
mlstm_chunk.launches_by_shape = collections.Counter()
mlstm_chunk_backward.launches = 0
# (B, H, L, dh, chunk) -> backward launches (six kernels each) at that
# shape (dh as launched, padded)
mlstm_chunk_backward.launches_by_shape = collections.Counter()

__all__ = ["FinalStateCotangent", "chunk_span", "kernel_width",
           "mlstm_chunk", "mlstm_chunk_backward",
           "mlstm_chunk_backward_reference", "mlstm_chunk_reference",
           "mlstm_recurrent_reference",
           "with_dh_padding"]
