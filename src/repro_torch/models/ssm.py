"""Mamba-style selective SSM block of the port (jamba's non-attention
layers).

A sequence of L > 1 tokens (prefill, or a verify block with the carried
state) goes through the selective-scan kernel (its plain version on the
CPU); a single decode token takes the plain sequential step.  That split
is the JAX model's own (``mamba_forward``).

State for decode: ``SSMState`` with the causal conv's last inputs
(B, d_in, d_conv-1) and the scan state (B, d_in, N) f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import selective_scan_reference
from repro_torch.models.common import PSpec


class SSMState(NamedTuple):
    conv: torch.Tensor    # (B, d_in, d_conv-1) last inputs of the causal conv
    ssm: torch.Tensor     # (B, d_in, N) f32 recurrent state


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.d_state, s.d_conv


def ssm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_in, dt_rank, N, K = _dims(cfg)
    return {
        "in_proj": PSpec((d, 2 * d_in)),
        "conv_w": PSpec((K, d_in), init="scaled", scale=0.1),
        "conv_b": PSpec((d_in,), init="zeros"),
        "x_proj": PSpec((d_in, dt_rank + 2 * N)),
        "dt_proj": PSpec((dt_rank, d_in)),
        "dt_bias": PSpec((d_in,), init="zeros"),
        "A_log": PSpec((d_in, N), init="zeros"),
        "D": PSpec((d_in,), init="ones"),
        "out_proj": PSpec((d_in, d)),
    }


def _conv1d_causal(x, w, b, state=None):
    """x: (B, L, d_in); w: (K, d_in) depthwise.  Optional carry-in
    ``state`` (B, d_in, K-1) of the previous inputs; returns (y,
    new_state)."""
    B, L, D = x.shape
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((B, K - 1, D), dtype=x.dtype, device=x.device)
    else:
        pad = state.transpose(1, 2).to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                          # (B, L+K-1, D)
    y = sum(xp[:, i:i + L] * w[i] for i in range(K)) + b
    return y, xp[:, -(K - 1):].transpose(1, 2)               # (B, D, K-1)


def _ssm_inputs(params, x, cfg: ArchConfig):
    """The shared front half: dt (B, L, d_in), B and C (B, L, N) and A
    (d_in, N), all f32."""
    d_in, dt_rank, N, K = _dims(cfg)
    dt_bc = x @ params["x_proj"].to(x.dtype)                 # (B, L, R+2N)
    dt, Bm, Cm = torch.split(dt_bc, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt @ params["dt_proj"].to(x.dtype)
                    + params["dt_bias"].to(x.dtype))
    A = -torch.exp(params["A_log"].float())
    return dt.float(), Bm.float(), Cm.float(), A


def mamba_forward(params, x, cfg: ArchConfig, state: SSMState | None = None):
    """x: (B, L, D) -> (y (B, L, D), final ``SSMState``), continuing from
    ``state`` when given."""
    xz = x @ params["in_proj"].to(x.dtype)
    u, z = xz.chunk(2, dim=-1)                               # (B, L, d_in)
    u, conv_state = _conv1d_causal(u, params["conv_w"].to(x.dtype),
                                   params["conv_b"].to(x.dtype),
                                   None if state is None else state.conv)
    u = F.silu(u)
    dt, Bm, Cm, A = _ssm_inputs(params, u, cfg)
    scan = ssm_scan if x.shape[1] > 1 else selective_scan_reference
    y, s_fin = scan(u.float(), dt, Bm, Cm, A, params["D"].float(),
                    None if state is None else state.ssm)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"].to(x.dtype)
    return out, SSMState(conv=conv_state, ssm=s_fin)


def mamba_decode(params, x, state: SSMState, cfg: ArchConfig):
    """x (B, L, D) tokens after ``state`` (one decode token, or a verify
    block of L tokens) -> (y, new ``SSMState``)."""
    return mamba_forward(params, x, cfg, state=state)


def init_ssm_state(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> SSMState:
    d_in, _, N, K = _dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, d_in, K - 1), dtype=dtype, device=device),
        ssm=torch.zeros((batch, d_in, N), dtype=torch.float32,
                        device=device))
