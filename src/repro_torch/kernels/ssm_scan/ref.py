"""Plain PyTorch version of the selective-scan kernel: the exact
sequential Mamba scan of the JAX model (``_selective_scan_ref``).

Layout: u/dt (B, L, d_in); Bm/Cm (B, L, N); A (d_in, N); D (d_in,);
``init_state`` (B, d_in, N) or None (zeros).  Everything runs in f32:

    s_t = exp(dt_t * A) * s_{t-1} + dt_t * B_t * u_t
    y_t = s_t . C_t + u_t * D

Returns y (B, L, d_in) and the final state (B, d_in, N).

``selective_scan_backward_reference`` is the plain version of the
backward kernel (``csrc/ssm_scan_bwd.cu``): an explicit reverse loop in
f32 that gives the gradients of all seven inputs.

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


def selective_scan_backward_reference(u, dt, Bm, Cm, A, D, init_state=None,
                                      dy=None, dstate=None):
    """The gradients of ``selective_scan_reference`` for cotangents ``dy``
    of y (B, L, d_in) and ``dstate`` of the final state (B, d_in, N)
    (either may be None: zeros) -> (du, ddt, dBm, dCm, dA, dD,
    d init_state), each f32 in its input's shape (d init_state (B, d_in,
    N) also where ``init_state`` is None, the gradient of its zeros).

    The states are recomputed from the inputs as the forward computes
    them, then a reverse loop carries g_t, the gradient of s_t:
    g_L = C_L dy_L + dstate, g_t = C_t dy_t + a_{t+1} g_{t+1}, with
    a_t = exp(dt_t A), and

        du_t  = D dy_t + dt_t sum_n g_t B_t
        ddt_t = sum_n g_t (A a_t s_{t-1} + B_t u_t)
        dB_t  = sum_d g_t dt_t u_t          dC_t = sum_d dy_t s_t
        dA    = sum_{b,t} g_t dt_t a_t s_{t-1}
        dD    = sum_{b,t} dy_t u_t          d init_state = a_1 g_1
    """
    u, dt, Bm, Cm, A, D = (t.float() for t in (u, dt, Bm, Cm, A, D))
    B, L, d_in = u.shape
    N = A.shape[1]
    zeros = torch.zeros((B, d_in, N), dtype=torch.float32, device=u.device)
    s = zeros if init_state is None else init_state.float()
    states = [s]
    for t in range(L):
        dt_t = dt[:, t, :, None]
        s = torch.exp(dt_t * A) * s + \
            dt_t * Bm[:, t, None, :] * u[:, t, :, None]
        states.append(s)
    dy = torch.zeros_like(u) if dy is None else dy.float()
    carry = zeros if dstate is None else dstate.float()
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    for t in reversed(range(L)):
        dt_t = dt[:, t, :, None]
        a = torch.exp(dt_t * A)                          # (B, d_in, N)
        g = Cm[:, t, None, :] * dy[:, t, :, None] + carry
        a_prev = a * states[t]
        du[:, t] = D * dy[:, t] + dt[:, t] * (g * Bm[:, t, None, :]).sum(-1)
        ddt[:, t] = (g * (A * a_prev + Bm[:, t, None, :]
                          * u[:, t, :, None])).sum(-1)
        dB[:, t] = (g * (dt[:, t] * u[:, t])[..., None]).sum(1)
        dC[:, t] = (dy[:, t, :, None] * states[t + 1]).sum(1)
        dA += (g * dt_t * a_prev).sum(0)
        carry = a * g
    dD = (dy * u).sum((0, 1))
    return du, ddt, dB, dC, dA, dD, carry


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
