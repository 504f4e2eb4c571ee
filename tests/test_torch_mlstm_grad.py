"""The chunkwise mLSTM's backward (B9) in its plain version and in the
backward kernel's arithmetic against the JAX package's gradient.

On the CPU ``mlstm_chunk_backward`` runs its plain version
(``ref.mlstm_chunk_backward_reference``: autograd through the plain
chunkwise form in float32), and autograd differentiates ``mlstm_chunk``
itself through the plain forward.  Both are held against ``jax.grad`` of
the JAX package's ``mlstm_chunk/ref.py`` ``mlstm_chunk_reference`` (the
JAX Pallas mLSTM has no VJP; JAX trains through that form) on the same
numpy inputs, for the cotangent of h, at one, two and eight chunks, at
dh 64 and at dh 40 (which the card runs zero-padded to 64), and with li
shifted by -8 so that every row takes den's exp(-m) branch (unshifted,
about half do), in float32 within ``atol=2e-5, rtol=1e-3``
(``test_torch_scan_grad.py``'s limit; also the gradients through a
zero-padded width against the true width's).  The
backward kernel's own decomposition in plain torch
(``ref.mlstm_chunk_backward_split``: every stabilizer held constant, each
chunk's inter term at once, the reverse combine of dC over the chunks,
then S, dP and da, the products and the gates) is held to the same
``jax.grad`` within the same limits, and in float64 to the plain
backward within 1e-12 (the two sum in other orders, so not bit for bit),
and each of its planted faults (``BACKWARD_FAULTS``, which
``chip_smoke.py`` shows its limits to catch on the card) leaves these.
The backward kernel itself is held on the card by ``test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_chunk.ref import (  # noqa: E402
    mlstm_chunk_reference as jax_mlstm)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ops import (  # noqa: E402
    mlstm_chunk, mlstm_chunk_backward, mlstm_chunk_backward_reference)
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    BACKWARD_FAULTS, mlstm_chunk_backward_split, mlstm_chunk_reference)

ATOL, RTOL = 2e-5, 1e-3
NAMES = ("dq", "dk", "dv", "dli", "dlf")

CASES = [
    # B, H, L, dh, chunk, li shift
    (2, 2, 16, 64, 16, 0.0),       # one chunk
    (1, 2, 32, 64, 16, 0.0),       # two chunks
    (1, 2, 64, 64, 8, 0.0),        # eight chunks
    (2, 1, 48, 40, 16, 0.0),       # dh 40: padded to 64 on the card
    (1, 2, 32, 64, 16, -8.0),      # rows in den's exp(-m) branch
]


def _inputs(B, H, L, dh, shift=0.0, seed=0):
    rng = np.random.default_rng(seed)

    def rn(*s):
        return rng.standard_normal(s).astype(np.float32)
    q, k, v = rn(B, H, L, dh), rn(B, H, L, dh), rn(B, H, L, dh)
    li = (rn(B, H, L) * 0.5 + shift).astype(np.float32)
    lf = -np.log1p(np.exp(-(rn(B, H, L) + 1.0))).astype(np.float32)
    return (q, k, v, li, lf), rn(B, H, L, dh)


def _jax_grads(args, dh_out, chunk):
    def f(*a):
        return jnp.sum(jax_mlstm(*a, chunk)[0] * dh_out)
    return jax.grad(f, argnums=tuple(range(5)))(*args)


def _close(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,H,L,dh,chunk,shift", CASES)
def test_plain_backward_matches_jax_grad(B, H, L, dh, chunk, shift):
    args, dh_out = _inputs(B, H, L, dh, shift)
    got = mlstm_chunk_backward_reference(*_t(args), chunk,
                                         torch.from_numpy(dh_out))
    _close(got, _jax_grads(args, dh_out, chunk))


@pytest.mark.parametrize("B,H,L,dh,chunk,shift", CASES)
def test_kernel_arithmetic_matches_jax_grad(B, H, L, dh, chunk, shift):
    """The backward kernel's decomposition (``mlstm_chunk_backward_split``)
    gives JAX's gradient."""
    args, dh_out = _inputs(B, H, L, dh, shift, seed=2)
    got = mlstm_chunk_backward_split(*_t(args), chunk,
                                     torch.from_numpy(dh_out))
    _close(got, _jax_grads(args, dh_out, chunk))


@pytest.mark.parametrize("B,H,L,dh,chunk,shift", CASES)
def test_autograd_through_mlstm_chunk_matches_jax_grad(B, H, L, dh, chunk,
                                                       shift):
    """The wrapper on CPU tensors that require grad: autograd through the
    plain forward gives JAX's gradient, and ``mlstm_chunk_backward`` (the
    backward kernel's CPU dispatch) the same numbers, launching
    nothing."""
    args, dh_out = _inputs(B, H, L, dh, shift, seed=1)
    want = _jax_grads(args, dh_out, chunk)
    kernels.reset_launch_counts()
    leaves = [t.requires_grad_() for t in _t(args)]
    h, _ = mlstm_chunk(*leaves, chunk=chunk)
    h.backward(torch.from_numpy(dh_out))
    _close([t.grad for t in leaves], want)
    _close(mlstm_chunk_backward(*_t(args), torch.from_numpy(dh_out),
                                chunk=chunk), want)
    assert mlstm_chunk.launches == mlstm_chunk_backward.launches == 0


@pytest.mark.parametrize("B,H,L,dh,chunk,shift", CASES)
def test_kernel_order_matches_the_plain_backward_in_float64(B, H, L, dh,
                                                            chunk, shift):
    """In float64 the decomposition with the stabilizers held constant
    equals autograd through the whole chunkwise form (which also
    differentiates through every max) within 1e-12 of each gradient's
    largest value: h does not depend on the stabilizers."""
    args, dh_out = _inputs(B, H, L, dh, shift, seed=3)
    t64 = [t.double() for t in _t(args)]
    do = torch.from_numpy(dh_out).double()
    got = mlstm_chunk_backward_split(*t64, chunk, do)
    want = mlstm_chunk_backward_reference(*t64, chunk, do)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-12 * float(w.abs().max()),
                                   msg=name)


def test_cases_take_both_branches_of_den():
    """Unshifted, some rows take den's exp(-m_t) branch (whose gradient
    reaches only the stabilizer) and some |dsum|; with li shifted by -8,
    every row takes exp(-m_t)."""
    from repro_torch.kernels.mlstm_chunk.ref import _split_forward
    for B, H, L, dh, chunk, shift in (CASES[1], CASES[-1]):
        args, _ = _inputs(B, H, L, dh, shift)
        f = _split_forward(*_t(args), chunk, dh ** -0.5, torch.matmul)
        floor = int((f["dsum"].abs() < torch.exp(-f["m_t"])).sum())
        rows = f["dsum"].numel()
        assert 0 < floor < rows if shift == 0 else floor == rows


@pytest.mark.parametrize("dh", [40, 64])
def test_backward_of_the_padded_width_equals_the_true_width(dh):
    """The gradients of h through a zero-padded width (as the card pads
    and crops: the true width's scale, the padded columns' cotangents 0
    and their gradients cropped) equal the unpadded ones in the kept
    columns."""
    args, dh_out = _inputs(1, 2, 32, dh, seed=4)
    want = mlstm_chunk_backward_reference(*_t(args), 16,
                                          torch.from_numpy(dh_out))
    leaves = [t.requires_grad_() for t in _t(args)]
    pad = [torch.nn.functional.pad(t, (0, 128 - dh)) for t in leaves[:3]]
    h, _ = mlstm_chunk_reference(*pad, *leaves[3:], 16, scale=dh ** -0.5)
    h[..., :dh].backward(torch.from_numpy(dh_out))
    _close([t.grad for t in leaves], want)


@pytest.mark.parametrize("fault", BACKWARD_FAULTS)
def test_each_planted_fault_leaves_the_limits(fault):
    """The decomposition with one planted fault misses JAX's gradient
    beyond the limits, at four chunks of 16."""
    args, dh_out = _inputs(1, 2, 64, 64, seed=5)
    got = mlstm_chunk_backward_split(*_t(args), 16, torch.from_numpy(dh_out),
                                     fault=fault)
    with pytest.raises(AssertionError):
        _close(got, _jax_grads(args, dh_out, 16))
