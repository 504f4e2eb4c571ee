"""Public wrapper of the selective-scan kernel.

A CPU tensor runs the plain version (``ref.selective_scan_reference``); a
CUDA tensor launches ``csrc/ssm_scan.cu`` or raises.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as K
from repro_torch.kernels.ssm_scan.ref import selective_scan_reference

_fn = None

STATE_SIZES = (8, 16)       # the kernel's template instantiations of N


def ssm_scan(u, dt, Bm, Cm, A, D, init_state=None):
    """u/dt: (B, L, d_in); Bm/Cm: (B, L, N); A: (d_in, N); D: (d_in,);
    ``init_state``: (B, d_in, N) or None (zeros) -> (y (B, L, d_in) f32,
    final state (B, d_in, N) f32).  Any L >= 1; N of 8 or 16."""
    state = () if init_state is None else (init_state,)
    if K.on_cpu(u, dt, Bm, Cm, A, D, *state):
        return selective_scan_reference(u, dt, Bm, Cm, A, D, init_state)
    global _fn
    B, L, d_in = u.shape
    N = A.shape[1]
    if N not in STATE_SIZES or L < 1:
        raise ValueError(f"ssm_scan: kernel takes N in {STATE_SIZES} and "
                         f"L >= 1, got N={N}, L={L}")
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
    return y, s


ssm_scan.launches = 0

__all__ = ["ssm_scan", "selective_scan_reference"]
