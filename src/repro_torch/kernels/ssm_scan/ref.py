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
``selective_scan_checkpoints`` adds to the scan the states that the
kernel's forward saves for the backward: the state before every
``steps`` steps.

Also, for the tests only, ``selective_scan_lanes`` and
``selective_scan_backward_chunked``: the forward and the backward
kernel's own arithmetic in plain torch.
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


def selective_scan_checkpoints(u, dt, Bm, Cm, A, D, init_state=None,
                               steps: int = 16):
    """``selective_scan_reference``'s (y, final state) and its checkpoints:
    the state before steps 0, ``steps``, 2 ``steps``, ... (B,
    ceil(L / steps), d_in, N), init_state (or zeros) first."""
    u, dt, Bm, Cm, A, D = (t.float() for t in (u, dt, Bm, Cm, A, D))
    B, L, d_in = u.shape
    s = (torch.zeros((B, d_in, A.shape[1]), dtype=torch.float32,
                     device=u.device)
         if init_state is None else init_state.float())
    ys, cks = [], []
    for t in range(L):
        if t % steps == 0:
            cks.append(s)
        dt_t = dt[:, t, :, None]
        s = torch.exp(dt_t * A) * s + \
            dt_t * Bm[:, t, None, :] * u[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", s, Cm[:, t]))
    return torch.stack(ys, dim=1) + u * D, s, torch.stack(cks, dim=1)


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


def selective_scan_backward_chunked(u, dt, Bm, Cm, A, D, checkpoints,
                                    dy=None, dstate=None, steps: int = 16,
                                    tile: int = 64, warp: int = 8,
                                    cluster: int = 2):
    """The backward kernel's arithmetic: the seven gradients of
    ``selective_scan_backward_reference`` from the forward's
    ``checkpoints`` (``selective_scan_checkpoints``) instead of a
    recurrence over all L steps.  The chunks of ``steps`` steps run back
    to front: each recomputes its states from its checkpoint (exp(dt A)
    as 2^(dt (A log2 e))), then steps back with the carry a_{t+1} g_{t+1}
    kept across chunks.  dB and dC are summed as the kernel sums them:
    over each warp's ``warp`` channels in channel order, then over a
    block's ``tile / warp`` warps, then over a cluster's ``cluster``
    blocks in rank order, then over the clusters, in order.  d init_state
    is the carry after the first step."""
    u, dt, Bm, Cm, A, D = (t.float() for t in (u, dt, Bm, Cm, A, D))
    B, L, d_in = u.shape
    N = A.shape[1]
    a2 = A * 1.4426950408889634
    dy = torch.zeros_like(u) if dy is None else dy.float()
    carry = (torch.zeros((B, d_in, N), dtype=torch.float32, device=u.device)
             if dstate is None else dstate.float())
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros((B, d_in, N), dtype=torch.float32, device=u.device)
    tiles = -(-d_in // tile)
    blocks = -(-tiles // cluster) * cluster

    def channel_sum(p):                   # (B, d_in, N) -> (B, N)
        p = torch.nn.functional.pad(p, (0, 0, 0, blocks * tile - d_in))
        p = p.reshape(B, blocks // cluster, cluster, tile // warp, warp, N)
        out = 0.0
        for c in range(blocks // cluster):
            part = 0.0
            for r in range(cluster):
                block = 0.0
                for w in range(tile // warp):
                    wsum = 0.0
                    for ch in range(warp):
                        wsum = wsum + p[:, c, r, w, ch]
                    block = block + wsum
                part = part + block
            out = out + part
        return out

    for k in reversed(range(-(-L // steps))):
        t0, t1 = k * steps, min(L, (k + 1) * steps)
        states = [checkpoints[:, k].float()]
        for t in range(t0, t1):
            du_t = (dt[:, t] * u[:, t])[..., None]
            states.append(torch.exp2(dt[:, t, :, None] * a2) * states[-1]
                          + du_t * Bm[:, t, None, :])
        for t in reversed(range(t0, t1)):
            dt_t = dt[:, t, :, None]
            a = torch.exp2(dt_t * a2)
            g = Cm[:, t, None, :] * dy[:, t, :, None] + carry
            a_prev = a * states[t - t0]
            du[:, t] = D * dy[:, t] + \
                dt[:, t] * (g * Bm[:, t, None, :]).sum(-1)
            ddt[:, t] = (g * (A * a_prev + Bm[:, t, None, :]
                              * u[:, t, :, None])).sum(-1)
            dB[:, t] = channel_sum(g * (dt[:, t] * u[:, t])[..., None])
            dC[:, t] = channel_sum(dy[:, t, :, None] * states[t - t0 + 1])
            dA += g * dt_t * a_prev
            carry = a * g
    return du, ddt, dB, dC, dA.sum(0), (dy * u).sum((0, 1)), carry
