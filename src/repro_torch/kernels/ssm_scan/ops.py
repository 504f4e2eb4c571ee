"""Public wrappers of the selective-scan kernel and its backward.

A CPU tensor runs the plain version (``ref.selective_scan_reference``); a
CUDA tensor launches ``csrc/ssm_scan.cu`` or raises.  Where a gradient is
needed (grad enabled and an input that requires it), the CUDA path is a
``torch.autograd.Function``: its forward launches the same kernel with
its checkpoint output set (the state before every ``CHECKPOINT_STEPS``
steps, saved for the backward), its backward launches
``csrc/ssm_scan_bwd.cu`` from them (``ssm_scan_backward``; on the CPU
autograd differentiates the plain version).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.ssm_scan.ref import (
    selective_scan_backward_reference, selective_scan_checkpoints,
    selective_scan_reference)

_fn = None
_bwd_fn = None
_ws_fn = None

STATE_SIZES = (8, 16, 32, 64)   # the kernel's template instantiations of N
# steps between two checkpoints: the backward's chunk (ssm_scan_bwd.cu's
# T, ssm_scan.cu's CKPT_T)
CHECKPOINT_STEPS = 16


def checkpoint_shape(B: int, L: int, d_in: int, N: int) -> tuple:
    """The checkpoints' shape at state size ``N``: (B, ceil(L / 16), d_in,
    N)."""
    return (B, -(-L // CHECKPOINT_STEPS), d_in, N)


def kernel_state_size(N: int) -> int:
    """The narrowest instantiated state size that holds ``N``."""
    for size in STATE_SIZES:
        if N <= size:
            return size
    raise ValueError(f"ssm_scan: kernel takes N up to {STATE_SIZES[-1]}, "
                     f"got N={N}")


def with_state_padding(body, u, dt, Bm, Cm, A, D, init_state=None):
    """``body(u, dt, Bm, Cm, A, D, init_state)`` with the state size N
    zero-padded to ``kernel_state_size``, the final state cropped back.
    A zero column of ``A``, ``Bm`` and ``init_state`` keeps its state at 0
    (exp(0) s + dt * 0 * u) and a zero column of ``Cm`` reads nothing, so
    y and the kept state are exact.  So are the gradients through it (the
    pad and the crop are ordinary differentiable ops): a padded column's
    gradient g stays 0 (no cotangent reaches it), so it adds nothing to
    du or ddt, and its own gradients are cropped unread."""
    N = A.shape[1]
    size = kernel_state_size(N)
    if size == N:
        return body(u, dt, Bm, Cm, A, D, init_state)
    Bm, Cm, A = (K.pad_last(t, size) for t in (Bm, Cm, A))
    if init_state is not None:
        init_state = K.pad_last(init_state, size)
    y, s = body(u, dt, Bm, Cm, A, D, init_state)
    return y, s[..., :N]


def _launch(u, dt, Bm, Cm, A, D, init_state, checkpoints: bool = False):
    """One forward launch -> (y, s), and the checkpoints (B, ceil(L / 16),
    d_in, N) after them with ``checkpoints``."""
    global _fn
    B, L, d_in = u.shape
    N = A.shape[1]
    u, dt, Bm, Cm, A, D = (K.f32_operand(t) for t in (u, dt, Bm, Cm, A, D))
    for name, t, shape in (("u", u, (B, L, d_in)), ("dt", dt, (B, L, d_in)),
                           ("Bm", Bm, (B, L, N)), ("Cm", Cm, (B, L, N)),
                           ("A", A, (d_in, N)), ("D", D, (d_in,))):
        K.check_cuda_input(name, t, torch.float32, shape)
    if init_state is not None:
        init_state = K.f32_operand(init_state)
        K.check_cuda_input("init_state", init_state, torch.float32,
                           (B, d_in, N))
    y = torch.empty((B, L, d_in), dtype=torch.float32, device=u.device)
    s = torch.empty((B, d_in, N), dtype=torch.float32, device=u.device)
    ck = (torch.empty(checkpoint_shape(B, L, d_in, N), dtype=torch.float32,
                      device=u.device) if checkpoints else None)
    if _fn is None:
        _fn = K.c_function("ssm_scan", "ssm_scan_f32",
                           [K.P] * 10 + [K.I] * 4 + [K.P])
    rc = _fn(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             A.data_ptr(), D.data_ptr(),
             None if init_state is None else init_state.data_ptr(),
             y.data_ptr(), s.data_ptr(), None if ck is None else ck.data_ptr(),
             B, L, d_in, N, K.stream_ptr(u))
    K.check_launch("ssm_scan", rc)
    ssm_scan.launches += 1
    ssm_scan.launches_by_shape[(B, L, d_in, N)] += 1
    if not checkpoints:
        return y, s
    ssm_scan.launches_checkpointed += 1
    return y, s, ck


def _launch_bwd(u, dt, Bm, Cm, A, D, checkpoints, dy, dstate):
    global _bwd_fn, _ws_fn
    B, L, d_in = u.shape
    N = A.shape[1]
    for name, t, shape in (("u", u, (B, L, d_in)), ("dt", dt, (B, L, d_in)),
                           ("Bm", Bm, (B, L, N)), ("Cm", Cm, (B, L, N)),
                           ("A", A, (d_in, N)), ("D", D, (d_in,)),
                           ("checkpoints", checkpoints,
                            checkpoint_shape(B, L, d_in, N)),
                           ("dy", dy, (B, L, d_in))):
        K.check_cuda_input(name, t, torch.float32, shape)
    if dstate is not None:
        K.check_cuda_input("dstate", dstate, torch.float32, (B, d_in, N))
    if _bwd_fn is None:
        _ws_fn = K.c_function("ssm_scan_bwd", "ssm_scan_bwd_workspace",
                              [K.I] * 4)
        _ws_fn.restype = ctypes.c_longlong
        _bwd_fn = K.c_function("ssm_scan_bwd", "ssm_scan_bwd_f32",
                               [K.P] * 17 + [K.I] * 4
                               + [ctypes.c_longlong, K.P])
    n_ws = _ws_fn(B, L, d_in, N)
    if n_ws < 0:
        raise ValueError(f"ssm_scan_backward: kernel takes N in "
                         f"{STATE_SIZES}, got N={N}")
    dev = u.device
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    du, ddt = torch.empty((2, B, L, d_in), dtype=torch.float32, device=dev)
    dB, dC = torch.empty((2, B, L, N), dtype=torch.float32, device=dev)
    dA = torch.empty((d_in, N), dtype=torch.float32, device=dev)
    dD = torch.empty((d_in,), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, d_in, N), dtype=torch.float32, device=dev)
    rc = _bwd_fn(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 A.data_ptr(), D.data_ptr(), checkpoints.data_ptr(),
                 dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
                 ws.data_ptr(),
                 du.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 dA.data_ptr(), dD.data_ptr(), ds0.data_ptr(), B, L, d_in, N,
                 n_ws, K.stream_ptr(u))
    K.check_launch("ssm_scan_backward", rc)
    ssm_scan_backward.launches += 1
    ssm_scan_backward.launches_by_shape[(B, L, d_in, N)] += 1
    return du, ddt, dB, dC, dA, dD, ds0


def ssm_scan_backward(u, dt, Bm, Cm, A, D, init_state=None, dy=None,
                      dstate=None, *, checkpoints=None):
    """The gradients (du, ddt, dBm, dCm, dA, dD, d init_state) of
    ``ssm_scan(u, dt, Bm, Cm, A, D, init_state)`` for cotangents ``dy``
    (B, L, d_in) of y and ``dstate`` (B, d_in, N) of the final state
    (either may be None: zeros), each f32 in its input's shape (d
    init_state also where ``init_state`` is None).  On the CPU the plain
    version (``ref.selective_scan_backward_reference``, which recomputes
    every state and reads no ``checkpoints``); on the card the backward
    kernel, N zero-padded as the forward pads it, from ``checkpoints``:
    the forward's states before every 16 steps at the kernel's state size
    (``ssm_scan_checkpointed``; init_state is their first), or, where
    they are None, from those of one forward launch made here.
    Deterministic on the card: no atomics, every sum in one order."""
    opt = tuple(t for t in (init_state, dy, dstate, checkpoints)
                if t is not None)
    if K.on_cpu(u, dt, Bm, Cm, A, D, *opt):
        return selective_scan_backward_reference(u, dt, Bm, Cm, A, D,
                                                 init_state, dy, dstate)
    N = A.shape[1]
    size = kernel_state_size(N)
    u, dt, Bm, Cm, A, D = (K.f32_operand(t) for t in (u, dt, Bm, Cm, A, D))
    dy = torch.zeros_like(u) if dy is None else K.f32_operand(dy)
    Bm, Cm, A = (K.f32_operand(K.pad_last(t, size)) for t in (Bm, Cm, A))
    init_state, dstate = (None if t is None
                          else K.f32_operand(K.pad_last(t, size))
                          for t in (init_state, dstate))
    if checkpoints is None:
        checkpoints = _launch(u, dt, Bm, Cm, A, D, init_state,
                              checkpoints=True)[2]
    grads = _launch_bwd(u, dt, Bm, Cm, A, D, checkpoints, dy, dstate)
    if size == N:
        return grads
    du, ddt, dB, dC, dA, dD, ds0 = grads
    return (du, ddt, dB[..., :N], dC[..., :N], dA[..., :N], dD,
            ds0[..., :N])


class _ScanFunction(torch.autograd.Function):
    """B8 with a gradient on the card: the forward kernel, writing its
    checkpoints, then the backward kernel from the saved inputs and
    checkpoints (which hold init_state as their first).  Takes f32 inputs
    at a kernel state size (``ssm_scan`` casts and ``with_state_padding``
    pads and crops outside it, as ordinary differentiable ops).  Either
    output's gradient may be None."""

    @staticmethod
    def forward(ctx, u, dt, Bm, Cm, A, D, init_state):
        ctx.set_materialize_grads(False)
        y, s, ck = _launch(u, dt, Bm, Cm, A, D, init_state, checkpoints=True)
        ctx.has_init = init_state is not None
        ctx.save_for_backward(u, dt, Bm, Cm, A, D, ck)
        return y, s

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dstate):
        u, dt, Bm, Cm, A, D, ck = ctx.saved_tensors
        grads = ssm_scan_backward(u, dt, Bm, Cm, A, D, None, dy, dstate,
                                  checkpoints=ck)
        return grads[:6] + (grads[6] if ctx.has_init else None,)


def _launch_with_grad(u, dt, Bm, Cm, A, D, init_state):
    return _ScanFunction.apply(u, dt, Bm, Cm, A, D, init_state)


def ssm_scan(u, dt, Bm, Cm, A, D, init_state=None):
    """u/dt: (B, L, d_in); Bm/Cm: (B, L, N); A: (d_in, N); D: (d_in,);
    ``init_state``: (B, d_in, N) or None (zeros) -> (y (B, L, d_in) f32,
    final state (B, d_in, N) f32).  Any L >= 1 and N up to 64 (8, 16, 32
    and 64 are instantiated; other sizes run zero-padded).  With a
    gradient needed, differentiable on the card through the backward
    kernel."""
    state = () if init_state is None else (init_state,)
    if K.on_cpu(u, dt, Bm, Cm, A, D, *state):
        return selective_scan_reference(u, dt, Bm, Cm, A, D, init_state)
    if u.shape[1] < 1:
        raise ValueError(f"ssm_scan: kernel takes L >= 1, got {u.shape[1]}")
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u, dt, Bm, Cm, A, D, *state))
    if not grad:
        return with_state_padding(_launch, u, dt, Bm, Cm, A, D, init_state)
    u, dt, Bm, Cm, A, D = (t.float() for t in (u, dt, Bm, Cm, A, D))
    if init_state is not None:
        init_state = init_state.float()
    return with_state_padding(_launch_with_grad, u, dt, Bm, Cm, A, D,
                              init_state)


def ssm_scan_checkpointed(u, dt, Bm, Cm, A, D, init_state=None):
    """``ssm_scan``'s (y, final state) and its checkpoints: the state
    before steps 0, 16, 32, ... (B, ceil(L / 16), d_in,
    ``kernel_state_size(N)``) f32, zero state columns past N, which
    ``ssm_scan_backward`` takes.  On the card one forward launch with its
    checkpoint output set (what the forward under a gradient saves); on
    the CPU the plain recurrence's states.  Not differentiable."""
    state = () if init_state is None else (init_state,)
    size = kernel_state_size(A.shape[1])
    if K.on_cpu(u, dt, Bm, Cm, A, D, *state):
        y, s, ck = selective_scan_checkpoints(u, dt, Bm, Cm, A, D,
                                              init_state, CHECKPOINT_STEPS)
        return y, s, K.pad_last(ck, size)
    N = A.shape[1]
    Bm, Cm, A = (K.pad_last(t, size) for t in (Bm, Cm, A))
    if init_state is not None:
        init_state = K.pad_last(init_state, size)
    y, s, ck = _launch(u, dt, Bm, Cm, A, D, init_state, checkpoints=True)
    return y, s[..., :N], ck


ssm_scan.launches = 0
# launches that wrote checkpoints (a forward under a gradient)
ssm_scan.launches_checkpointed = 0
# (B, L, d_in, N) -> launches at that shape (N as launched, padded)
ssm_scan.launches_by_shape = collections.Counter()
ssm_scan_backward.launches = 0
# (B, L, d_in, N) -> backward launches (a scan and a reduction kernel
# each) at that shape (N as launched, padded)
ssm_scan_backward.launches_by_shape = collections.Counter()

__all__ = ["CHECKPOINT_STEPS", "checkpoint_shape", "kernel_state_size",
           "selective_scan_backward_reference", "selective_scan_reference",
           "ssm_scan", "ssm_scan_backward", "ssm_scan_checkpointed",
           "with_state_padding"]
