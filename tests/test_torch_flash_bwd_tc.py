"""The arithmetic of B1's tensor-core backward, in plain torch on the CPU,
against the JAX package's gradient on the same numpy inputs.

The kernel (``flash_attention_bwd.cu``, head widths 32-128) recomputes P
from the forward's row log-sum-exp L as exp2(S scale log2e - L log2e),
takes D = rowsum(dO O) from the forward's bf16 output, rounds P and dS to
bf16 before their products (the products' A operands, as the forward
rounds P), and accumulates in f32 tile by tile in its loop order: dQ over
64-key tiles in key order; dK and dV over the group's heads in order and,
for each, query tiles (64 rows; 32 at hd 128) in order.  Its outputs are
rounded to bf16.  ``tc_backward`` does the same in float32 torch.  It is
held to ``jax.grad`` of the JAX package's ``flash_attention/ref.py``
``mha_reference`` within the card's limit ``BWD_RTOL`` (each gradient's
relative L2, ``chip_smoke.py``): causal with G=1, GQA with a ragged S, and
windowed GQA.  Leaving D out moves it past the limit.  The kernel itself
is held on the card by ``chip_smoke.py`` and ``test_torch_cuda.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    mha_reference as jax_mha)

BWD_RTOL = 2.0 ** -7   # relative L2 of each gradient (chip_smoke.py)
KEY_TILE = 64          # keys of a dQ tile


def _bf16(t):
    return t.to(torch.bfloat16).float()


def tc_backward(q, k, v, do, *, window=0, causal=True, use_d=True):
    """(dq, dk, dv) as the tensor-core kernel computes them, from float32
    tensors holding bf16 values: q, do (B, H, S, hd); k, v (B, Hkv, S,
    hd)."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = hd ** -0.5
    log2e = 1.0 / math.log(2.0)
    kf, vf = (t.repeat_interleave(G, dim=1) for t in (k, v))
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= (i - j) < window
    s = q @ kf.transpose(-1, -2)
    # the forward: L (f32) and its output rounded to bf16
    lse = torch.logsumexp((s * scale).masked_fill(~mask, -math.inf), -1)
    out = _bf16(torch.softmax((s * scale).masked_fill(~mask, -math.inf),
                              -1) @ vf)
    d = (do * out).sum(-1, keepdim=True) if use_d else 0.0
    p = torch.exp2(s * (scale * log2e) - lse[..., None] * log2e)
    p = p.masked_fill(~mask, 0.0)
    ds = p * (do @ vf.transpose(-1, -2) - d)
    p, ds = _bf16(p), _bf16(ds)
    dq = torch.zeros_like(q)
    for k0 in range(0, S, KEY_TILE):
        dq += ds[..., k0:k0 + KEY_TILE] @ kf[..., k0:k0 + KEY_TILE, :]
    bq = 32 if hd == 128 else 64
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for g in range(G):                       # the group's heads, in order
        h = list(range(g, H, G))             # head g of each kv group
        for q0 in range(0, S, bq):           # query tiles, in order
            rows = slice(q0, q0 + bq)
            dv += p[:, h, rows].transpose(-1, -2) @ do[:, h, rows]
            dk += ds[:, h, rows].transpose(-1, -2) @ q[:, h, rows]
    return _bf16(dq * scale), _bf16(dk * scale), _bf16(dv)


def _inputs(B, H, Hkv, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [_bf16(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))).numpy()
        for s in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd),
                  (B, H, S, hd))]


def _jax_grads(q, k, v, do, window):
    def f(q, k, v):
        return jnp.sum(jax_mha(q, k, v, causal=True, window=window) * do)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _rel(got, want):
    return float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))


CASES = [
    # B, H, Hkv, S, hd, window
    (2, 2, 2, 128, 32, 0),      # causal, G=1, two key tiles
    (1, 8, 2, 97, 64, 0),       # GQA group 4, ragged S
    (2, 4, 1, 150, 32, 40),     # windowed GQA, group 4
]


@pytest.mark.parametrize("B,H,Hkv,S,hd,window", CASES)
def test_tensor_core_backward_matches_jax_grad(B, H, Hkv, S, hd, window):
    """P and dS rounded to bf16, f32 tile sums in the kernel's order: each
    gradient within BWD_RTOL relative L2 of JAX's float32 gradient."""
    q, k, v, do = _inputs(B, H, Hkv, S, hd, seed=S)
    want = _jax_grads(q, k, v, do, window)
    got = tc_backward(*(torch.from_numpy(a) for a in (q, k, v, do)),
                      window=window)
    rels = [_rel(g, w) for g, w in zip(got, want)]
    assert max(rels) <= BWD_RTOL, rels


@pytest.mark.parametrize("B,H,Hkv,S,hd,window", CASES)
def test_backward_without_d_leaves_the_limit(B, H, Hkv, S, hd, window):
    """The limit sees the arithmetic: D left out of dS moves dQ or dK past
    BWD_RTOL (dV does not read D)."""
    q, k, v, do = _inputs(B, H, Hkv, S, hd, seed=S)
    want = _jax_grads(q, k, v, do, window)
    got = tc_backward(*(torch.from_numpy(a) for a in (q, k, v, do)),
                      window=window, use_d=False)
    assert max(_rel(g, w) for g, w in zip(got[:2], want[:2])) > BWD_RTOL
