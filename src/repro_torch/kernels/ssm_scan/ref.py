"""Plain PyTorch version of the selective-scan kernel: the exact
sequential Mamba scan of the JAX model (``_selective_scan_ref``).

Layout: u/dt (B, L, d_in); Bm/Cm (B, L, N); A (d_in, N); D (d_in,);
``init_state`` (B, d_in, N) or None (zeros).  Everything runs in f32:

    s_t = exp(dt_t * A) * s_{t-1} + dt_t * B_t * u_t
    y_t = s_t . C_t + u_t * D

Returns y (B, L, d_in) and the final state (B, d_in, N).

Also, for the tests only, ``selective_scan_lanes``: the kernel's own
arithmetic, each channel's states split over lanes, in plain torch.
"""
from __future__ import annotations

import torch


def selective_scan_reference(u, dt, Bm, Cm, A, D, init_state=None):
    u, dt, Bm, Cm, A, D = (t.float() for t in (u, dt, Bm, Cm, A, D))
    B, L, d_in = u.shape
    N = A.shape[1]
    s = (torch.zeros((B, d_in, N), dtype=torch.float32, device=u.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(L):
        dt_t = dt[:, t, :, None]                          # (B, d_in, 1)
        s = torch.exp(dt_t * A) * s + \
            dt_t * Bm[:, t, None, :] * u[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", s, Cm[:, t]))
    y = torch.stack(ys, dim=1) + u * D
    return y, s


def selective_scan_lanes(u, dt, Bm, Cm, A, D, init_state=None,
                         per_lane: int = 4):
    """The scan as the kernel computes it: exp(dt A) as 2^(dt (A log2 e)),
    the input term as (dt u) B, and y's dot product s . C_t summed first
    over each lane's ``per_lane`` states, then over the channel's N /
    per_lane lanes in butterfly order (``__shfl_xor_sync`` with offsets
    1, 2, ...).  Same layout and results as
    ``selective_scan_reference``."""
    u, dt, Bm, Cm, A, D = (t.float() for t in (u, dt, Bm, Cm, A, D))
    B, L, d_in = u.shape
    N = A.shape[1]
    lanes = N // per_lane
    a2 = A * 1.4426950408889634
    s = (torch.zeros((B, d_in, N), dtype=torch.float32, device=u.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(L):
        dt_t = dt[:, t, :, None]
        du = (dt[:, t] * u[:, t])[..., None]
        s = torch.exp2(dt_t * a2) * s + du * Bm[:, t, None, :]
        p = (s * Cm[:, t, None, :]).reshape(B, d_in, lanes, per_lane)
        p = p.sum(-1)                                       # each lane's
        off = 1
        while off < lanes:                                  # butterfly
            idx = torch.arange(lanes, device=u.device) ^ off
            p = p + p[..., idx]
            off *= 2
        ys.append(p[..., 0] + u[:, t] * D)
    return torch.stack(ys, dim=1), s
