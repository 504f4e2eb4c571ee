"""Public wrapper of the selective-scan kernel.

A CPU tensor runs the plain version (``ref.selective_scan_reference``); a
CUDA tensor launches ``csrc/ssm_scan.cu`` or raises.
"""
from __future__ import annotations

import collections

import torch

from repro_torch import kernels as K
from repro_torch.kernels.ssm_scan.ref import selective_scan_reference

_fn = None

STATE_SIZES = (8, 16, 32, 64)   # the kernel's template instantiations of N


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
    y and the kept state are exact."""
    N = A.shape[1]
    size = kernel_state_size(N)
    if size == N:
        return body(u, dt, Bm, Cm, A, D, init_state)
    Bm, Cm, A = (K.pad_last(t, size) for t in (Bm, Cm, A))
    if init_state is not None:
        init_state = K.pad_last(init_state, size)
    y, s = body(u, dt, Bm, Cm, A, D, init_state)
    return y, s[..., :N]


def _launch(u, dt, Bm, Cm, A, D, init_state):
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
    if _fn is None:
        _fn = K.c_function("ssm_scan", "ssm_scan_f32",
                           [K.P] * 9 + [K.I] * 4 + [K.P])
    rc = _fn(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             A.data_ptr(), D.data_ptr(),
             None if init_state is None else init_state.data_ptr(),
             y.data_ptr(), s.data_ptr(), B, L, d_in, N, K.stream_ptr(u))
    K.check_launch("ssm_scan", rc)
    ssm_scan.launches += 1
    ssm_scan.launches_by_shape[(B, L, d_in, N)] += 1
    return y, s


def ssm_scan(u, dt, Bm, Cm, A, D, init_state=None):
    """u/dt: (B, L, d_in); Bm/Cm: (B, L, N); A: (d_in, N); D: (d_in,);
    ``init_state``: (B, d_in, N) or None (zeros) -> (y (B, L, d_in) f32,
    final state (B, d_in, N) f32).  Any L >= 1 and N up to 64 (8, 16, 32
    and 64 are instantiated; other sizes run zero-padded)."""
    state = () if init_state is None else (init_state,)
    if K.on_cpu(u, dt, Bm, Cm, A, D, *state):
        return selective_scan_reference(u, dt, Bm, Cm, A, D, init_state)
    K.require_no_grad("ssm_scan", u, dt, Bm, Cm, A, D, *state)
    if u.shape[1] < 1:
        raise ValueError(f"ssm_scan: kernel takes L >= 1, got {u.shape[1]}")
    return with_state_padding(_launch, u, dt, Bm, Cm, A, D, init_state)


ssm_scan.launches = 0
# (B, L, d_in, N) -> launches at that shape (N as launched, padded)
ssm_scan.launches_by_shape = collections.Counter()

__all__ = ["kernel_state_size", "selective_scan_reference", "ssm_scan",
           "with_state_padding"]
