"""Public wrapper of the chunkwise-mLSTM kernel.

A CPU tensor runs the plain version (``ref.mlstm_chunk_reference``); a
CUDA tensor launches ``csrc/mlstm_chunk.cu`` or raises.
"""
from __future__ import annotations

import collections
import math

import torch

from repro_torch import kernels as K
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_reference,
                                                 mlstm_recurrent_reference)

DEFAULT_CHUNK = 128
MAX_CHUNK = 256          # the kernel scans a chunk's gates in one block
MAX_DH = 512             # a cluster of dh / 64 blocks: at most 8
STATE_BUDGET = 256 << 20  # bytes of the chunks' states, at most, a span

_fn = None


def with_dh_padding(body, q, k, v, li, lf, chunk: int):
    """``body(q, k, v, li, lf, chunk, scale)`` with dh zero-padded to a
    multiple of 64 and the scale 1/sqrt(dh) of the true width; h, C and n
    cropped back.  A zero column of k adds nothing to a score or to n, of
    q nothing to n . q or q C, of v nothing to the kept columns of C or
    h, so the result is exact."""
    dh = q.shape[-1]
    width = -(-dh // 64) * 64
    if width > MAX_DH:
        raise ValueError(f"mlstm_chunk: kernel takes dh up to {MAX_DH}, "
                         f"got {dh}")
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


def _launch(q, k, v, li, lf, c, scale):
    global _fn
    B, H, L, dh = q.shape
    for name, t, shape in (("q", q, (B, H, L, dh)), ("k", k, (B, H, L, dh)),
                           ("v", v, (B, H, L, dh)), ("li", li, (B, H, L)),
                           ("lf", lf, (B, H, L))):
        K.check_cuda_input(name, t, torch.float32, shape)
    nc = L // c
    span = chunk_span(B, H, nc, dh)
    dev = q.device
    h = torch.empty((B, H, L, dh), dtype=torch.float32, device=dev)
    C = torch.empty((B, H, dh, dh), dtype=torch.float32, device=dev)
    n = torch.empty((B, H, dh), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    gates = torch.empty(4 * B * H * L + B * H * nc, dtype=torch.float32,
                        device=dev)
    states = torch.empty(span * B * H * (dh * dh + dh), dtype=torch.float32,
                         device=dev)
    if _fn is None:
        _fn = K.c_function("mlstm_chunk", "mlstm_chunk_f32",
                           [K.P] * 11 + [K.I] * 6 + [K.F, K.P])
    rc = _fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
             lf.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
             m.data_ptr(), gates.data_ptr(), states.data_ptr(), B, H, L, dh,
             c, span, float(scale), K.stream_ptr(q))
    K.check_launch("mlstm_chunk", rc)
    mlstm_chunk.launches += 1
    mlstm_chunk.launches_by_shape[(B, H, L, dh, c)] += 1
    return h, (C, n, m)


def mlstm_chunk(q, k, v, li, lf, chunk: int = DEFAULT_CHUNK):
    """q/k/v: (B, H, L, dh); li/lf: (B, H, L) -> (h (B, H, L, dh) f32, (C
    (B, H, dh, dh), n (B, H, dh), m (B, H)) f32), from no history.
    Casts to f32 and shrinks the chunk to a divisor of L, as the JAX
    wrapper does.  Any dh up to 512: multiples of 64 run as they are,
    other widths zero-padded (``with_dh_padding``)."""
    L = q.shape[2]
    c = min(chunk, L)
    while L % c:
        c //= 2
    q, k, v, li, lf = (K.f32_operand(t) for t in (q, k, v, li, lf))
    if K.on_cpu(q, k, v, li, lf):
        return mlstm_chunk_reference(q, k, v, li, lf, c)
    K.require_no_grad("mlstm_chunk", q, k, v, li, lf)
    if c > MAX_CHUNK or L < 1:
        raise ValueError(f"mlstm_chunk: kernel takes a chunk of at most "
                         f"{MAX_CHUNK}, got {c}")
    return with_dh_padding(_launch, q, k, v, li, lf, c)


mlstm_chunk.launches = 0
# (B, H, L, dh, chunk) -> launches at that shape (dh as launched, padded)
mlstm_chunk.launches_by_shape = collections.Counter()

__all__ = ["chunk_span", "mlstm_chunk", "mlstm_chunk_reference",
           "mlstm_recurrent_reference", "with_dh_padding"]
