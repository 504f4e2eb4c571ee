"""The selective scan's backward (B8) in its plain version against the
JAX package's gradient.

On the CPU ``ssm_scan_backward`` runs its plain version
(``ref.selective_scan_backward_reference``: the reverse loop in
float32), and autograd differentiates ``ssm_scan`` itself through the
plain forward.  Both are held against ``jax.grad`` of the JAX package's
``ssm_scan/ref.py`` ``selective_scan_reference`` (the JAX Pallas scan
has no VJP) on the same numpy inputs, for cotangents of y and of the
final state, with and without a carried initial state, at N 16 and at
N 12 (which the card runs zero-padded to 16), in float32 within
``atol=2e-5, rtol=1e-3`` (``test_torch_flash_grad.py``'s limit).  Also:
the gradients through ``with_state_padding`` equal the unpadded ones in
the kept columns.  The backward kernel's own arithmetic in plain torch
(``ref.selective_scan_backward_chunked``: chunks of 16 steps back to
front from the forward's checkpoints, dB and dC summed by warp, channel
tile, cluster and cluster tile) is held to the same ``jax.grad`` within the
same limits, from checkpoints that ``ssm_scan_checkpointed`` gives on
the CPU and that are held to JAX's scan over each prefix.  The backward
kernel itself is held on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan.ref import (  # noqa: E402
    selective_scan_reference as jax_scan)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import (  # noqa: E402
    CHECKPOINT_STEPS, kernel_state_size, selective_scan_backward_reference,
    selective_scan_reference, ssm_scan, ssm_scan_backward,
    ssm_scan_checkpointed, with_state_padding)
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    selective_scan_backward_chunked)

ATOL, RTOL = 2e-5, 1e-3
NAMES = ("du", "ddt", "dBm", "dCm", "dA", "dD", "dinit")

CASES = [
    # B, L, d_in, N, init, dy, dstate
    (2, 13, 24, 16, False, True, False),     # y's cotangent alone
    (1, 9, 16, 16, True, True, True),        # carried state, both
    (2, 11, 20, 12, True, False, True),      # final state's alone, N 12
    (2, 7, 12, 12, False, True, True),       # N 12, zero state
    (2, 1, 8, 16, True, True, True),         # one step
]


def _inputs(B, L, d_in, N, seed=0):
    rng = np.random.default_rng(seed)

    def rn(*s):
        return rng.standard_normal(s).astype(np.float32)
    u, Bm, Cm = rn(B, L, d_in), rn(B, L, N), rn(B, L, N)
    dt = np.log1p(np.exp(rn(B, L, d_in) - 1.0)).astype(np.float32)
    A = (-np.exp(rn(d_in, N) * 0.5)).astype(np.float32)
    return {"u": u, "dt": dt, "Bm": Bm, "Cm": Cm, "A": A, "D": rn(d_in),
            "init": rn(B, d_in, N), "dy": rn(B, L, d_in),
            "dstate": rn(B, d_in, N)}


def _jax_grads(x, init, dy, dstate):
    """jax.grad of sum(y dy) + sum(s dstate) w.r.t. the seven inputs
    (the initial state's gradient taken at zeros where there is none)."""
    s0 = x["init"] if init else np.zeros_like(x["init"])

    def f(u, dt, Bm, Cm, A, D, s0):
        y, s = jax_scan(u, dt, Bm, Cm, A, D, s0)
        out = 0.0
        if dy:
            out = out + jnp.sum(y * x["dy"])
        if dstate:
            out = out + jnp.sum(s * x["dstate"])
        return out
    return jax.grad(f, argnums=tuple(range(7)))(
        *(x[k] for k in ("u", "dt", "Bm", "Cm", "A", "D")), s0)


def _close(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def _t(x, *keys):
    return [torch.from_numpy(x[k]) for k in keys]


ARGS = ("u", "dt", "Bm", "Cm", "A", "D")


@pytest.mark.parametrize("B,L,d_in,N,init,dy,dstate", CASES)
def test_plain_backward_matches_jax_grad(B, L, d_in, N, init, dy, dstate):
    x = _inputs(B, L, d_in, N)
    want = _jax_grads(x, init, dy, dstate)
    got = selective_scan_backward_reference(
        *_t(x, *ARGS), torch.from_numpy(x["init"]) if init else None,
        torch.from_numpy(x["dy"]) if dy else None,
        torch.from_numpy(x["dstate"]) if dstate else None)
    _close(got, want)


@pytest.mark.parametrize("B,L,d_in,N,init,dy,dstate", CASES)
def test_autograd_through_ssm_scan_matches_jax_grad(B, L, d_in, N, init, dy,
                                                    dstate):
    """The wrapper on CPU tensors that require grad: autograd through the
    plain forward gives JAX's gradient, and ``ssm_scan_backward`` (the
    backward kernel's CPU dispatch) the same numbers, launching
    nothing."""
    x = _inputs(B, L, d_in, N, seed=1)
    want = _jax_grads(x, init, dy, dstate)
    leaves = [t.requires_grad_() for t in _t(x, *ARGS, "init")]
    y, s = ssm_scan(*leaves[:6], leaves[6] if init else None)
    out = 0.0
    if dy:
        out = out + (y * torch.from_numpy(x["dy"])).sum()
    if dstate:
        out = out + (s * torch.from_numpy(x["dstate"])).sum()
    grads = torch.autograd.grad(out, leaves[:6 + init], allow_unused=True)
    # an input the loss does not reach (Cm and D without dy) gets None
    _close([torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, leaves)], want[:6 + init])
    kernels.reset_launch_counts()
    via = ssm_scan_backward(*_t(x, *ARGS),
                            torch.from_numpy(x["init"]) if init else None,
                            torch.from_numpy(x["dy"]) if dy else None,
                            torch.from_numpy(x["dstate"]) if dstate else None)
    _close(via, want)
    assert ssm_scan_backward.launches == 0            # CPU: plain version


@pytest.mark.parametrize("N,init", [(12, True), (12, False), (5, True)])
def test_state_padding_keeps_the_gradients(N, init):
    """``with_state_padding`` (zero state columns up to the kernel's size,
    the final state cropped) differentiated on the CPU: every gradient
    equals the unpadded scan's, in the kept columns of dBm, dCm, dA and
    the initial state's."""
    B, L, d_in = 2, 10, 16
    x = _inputs(B, L, d_in, N, seed=2)

    def grads(body):
        leaves = [t.requires_grad_() for t in _t(x, *ARGS, "init")]
        y, s = body(*leaves[:6], leaves[6] if init else None)
        out = (y * torch.from_numpy(x["dy"])).sum() + \
            (s * torch.from_numpy(x["dstate"])).sum()
        assert s.shape == (B, d_in, N)
        return torch.autograd.grad(out, leaves[:6 + init])

    padded = grads(lambda *a: with_state_padding(selective_scan_reference,
                                                 *a))
    plain = grads(selective_scan_reference)
    for name, g, w in zip(NAMES, padded, plain):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6, msg=name)


# the chunked backward at lengths over one, two and three chunks (ragged
# and whole), with channel tiles and clusters small enough that d_in
# spans several clusters and leaves a ragged last tile
CHUNKED_CASES = [
    # B, L, d_in, N, init, dy, dstate, tile, warp, cluster
    (2, 13, 24, 16, False, True, False, 32, 8, 8),  # one chunk, one tile
    (1, 40, 20, 16, True, True, True, 4, 2, 2),     # 3 chunks, 3 clusters
    (2, 32, 12, 12, True, False, True, 4, 4, 4),    # 2 whole chunks, N 12
    (2, 17, 10, 12, False, True, True, 2, 1, 8),    # a one-step last chunk
]


@pytest.mark.parametrize("B,L,d_in,N,init,dy,dstate,tile,warp,cluster",
                         CHUNKED_CASES)
def test_chunked_backward_from_checkpoints_matches_jax_grad(
        B, L, d_in, N, init, dy, dstate, tile, warp, cluster):
    """The backward kernel's arithmetic from the forward's checkpoints
    (the CPU's, at the padded state size as the card keeps them, cropped
    back) gives JAX's gradient of all seven inputs."""
    x = _inputs(B, L, d_in, N, seed=3)
    want = _jax_grads(x, init, dy, dstate)
    args = _t(x, *ARGS)
    s0 = torch.from_numpy(x["init"]) if init else None
    ck = ssm_scan_checkpointed(*args, s0)[2][..., :N]
    got = selective_scan_backward_chunked(
        *args, ck, torch.from_numpy(x["dy"]) if dy else None,
        torch.from_numpy(x["dstate"]) if dstate else None,
        steps=CHECKPOINT_STEPS, tile=tile, warp=warp, cluster=cluster)
    _close(got, want)


@pytest.mark.parametrize("L,N,init", [(40, 16, True), (16, 12, False),
                                      (5, 8, True)])
def test_checkpoints_are_the_states_before_each_chunk(L, N, init):
    """``ssm_scan_checkpointed`` on the CPU: y and the final state are the
    plain scan's, and checkpoint k is JAX's final state after the first
    16 k steps (init_state, or zeros, for k = 0), zero-padded to the
    kernel's state size."""
    B, d_in = 2, 8
    x = _inputs(B, L, d_in, N, seed=4)
    args = _t(x, *ARGS)
    s0 = torch.from_numpy(x["init"]) if init else None
    y, s, ck = ssm_scan_checkpointed(*args, s0)
    want_y, want_s = selective_scan_reference(*args, s0)
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    chunks = -(-L // CHECKPOINT_STEPS)
    assert ck.shape == (B, chunks, d_in, kernel_state_size(N))
    assert torch.equal(ck[..., N:], torch.zeros_like(ck[..., N:]))
    start = x["init"] if init else np.zeros_like(x["init"])
    np.testing.assert_array_equal(ck[:, 0, :, :N].numpy(), start)
    for k in range(1, chunks):
        t = k * CHECKPOINT_STEPS
        _, js = jax_scan(*(x[a][:, :t] if x[a].ndim == 3 and a in (
            "u", "dt", "Bm", "Cm") else x[a] for a in ARGS), start)
        np.testing.assert_allclose(ck[:, k, :, :N].numpy(), np.asarray(js),
                                   atol=ATOL, rtol=RTOL)
