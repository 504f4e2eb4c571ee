"""The flash backward's plain version against the JAX package's gradient.

On the CPU ``flash_attention_backward`` runs its plain version
(``ref.mha_backward_reference``: autograd through ``mha_reference`` in
float32), and autograd differentiates ``flash_attention`` itself through
the plain forward.  Both are held against ``jax.grad`` of the JAX
package's ``flash_attention/ref.py`` ``mha_reference`` (the JAX Pallas
kernel has no VJP) on the same numpy inputs, causal, windowed and GQA,
in float32 within ``atol=2e-5`` (``test_kernels.py``'s float32 limit)
and ``rtol=1e-3``.  The backward kernel itself is held on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.  Also: the guard that makes
every other kernel wrapper refuse a gradient on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    mha_reference as jax_mha)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_backward, mha_backward_reference)

ATOL, RTOL = 2e-5, 1e-3

CASES = [
    # B, H, Hkv, S, hd, causal, window
    (2, 4, 4, 40, 32, True, 0),       # causal, G=1
    (1, 8, 2, 33, 16, True, 0),       # GQA group 4, ragged S
    (2, 6, 3, 48, 24, True, 10),      # windowed GQA
    (1, 4, 1, 25, 8, False, 7),       # a window without the causal mask
]


def _inputs(B, H, Hkv, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd),
                      (B, H, S, hd))]


def _jax_grads(q, k, v, do, causal, window):
    def f(q, k, v):
        out = jax_mha(q, k, v, causal=causal, window=window)
        return jnp.sum(out * do)
    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("B,H,Hkv,S,hd,causal,window", CASES)
def test_plain_backward_matches_jax_grad(B, H, Hkv, S, hd, causal, window):
    q, k, v, do = _inputs(B, H, Hkv, S, hd)
    want = _jax_grads(q, k, v, do, causal, window)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    got = mha_backward_reference(t[0], t[1], t[2], t[3], causal=causal,
                                 window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("B,H,Hkv,S,hd,causal,window", CASES)
def test_autograd_through_flash_matches_jax_grad(B, H, Hkv, S, hd, causal,
                                                 window):
    """The wrapper on CPU tensors that require grad: autograd through the
    plain forward gives JAX's gradient, and ``flash_attention_backward``
    (the backward kernel's CPU dispatch) the same numbers."""
    q, k, v, do = _inputs(B, H, Hkv, S, hd, seed=1)
    want = _jax_grads(q, k, v, do, causal, window)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    lse = torch.zeros(B, H, S)
    via = flash_attention_backward(qt.detach(), kt.detach(), vt.detach(),
                                   out.detach(), torch.from_numpy(do), lse,
                                   causal=causal, window=window)
    for t, g, w in zip((qt, kt, vt), via, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


def test_gqa_gradient_sums_the_group():
    """dk/dv of a kv head are the sums over its query group: with every
    query head of a group the same, the GQA gradient is G times the
    gradient of one head attending alone (the kernel's fixed-order group
    sum is held to this plain version on the card)."""
    B, G, S, hd = 1, 3, 20, 8
    rng = np.random.default_rng(2)
    q1 = rng.standard_normal((B, 1, S, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, 1, S, hd)).astype(np.float32)
            for _ in range(2))
    do1 = rng.standard_normal((B, 1, S, hd)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    _, dk, dv = mha_backward_reference(t(np.repeat(q1, G, 1)), t(k), t(v),
                                       t(np.repeat(do1, G, 1)))
    _, dk1, dv1 = mha_backward_reference(t(q1), t(k), t(v), t(do1))
    torch.testing.assert_close(dk, G * dk1, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(dv, G * dv1, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("grad_enabled,requires,raises", [
    (True, True, True), (False, True, False), (True, False, False)])
def test_require_no_grad(grad_enabled, requires, raises):
    """The guard every kernel wrapper without a backward runs on the card:
    a gradient asked of it raises ``MissingBackwardKernel`` naming the
    kernel; under ``torch.no_grad()`` or without a tensor that requires
    grad (serving) it passes."""
    x = torch.zeros(3, requires_grad=requires)
    with torch.set_grad_enabled(grad_enabled):
        if raises:
            with pytest.raises(kernels.MissingBackwardKernel,
                               match="backward kernel of ssm_scan"):
                kernels.require_no_grad("ssm_scan", torch.zeros(2), x)
        else:
            kernels.require_no_grad("ssm_scan", torch.zeros(2), x)
