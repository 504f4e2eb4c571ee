"""Plain PyTorch version of the selective-scan kernel: the exact
sequential Mamba scan of the JAX model (``_selective_scan_ref``).

Layout: u/dt (B, L, d_in); Bm/Cm (B, L, N); A (d_in, N); D (d_in,);
``init_state`` (B, d_in, N) or None (zeros).  Everything runs in f32:

    s_t = exp(dt_t * A) * s_{t-1} + dt_t * B_t * u_t
    y_t = s_t . C_t + u_t * D

Returns y (B, L, d_in) and the final state (B, d_in, N).
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
