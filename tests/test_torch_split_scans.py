"""The arithmetic of the redesigned scan and chunkwise-mLSTM kernels, in
plain torch on the CPU, against the JAX package on the same numpy inputs.

The mLSTM kernel computes every chunk's own state update at once, then
combines the chunks' states in order, then each chunk's outputs from the
state it carries (``mlstm_chunk_split``): held to JAX's chunkwise and
recurrent forms for h and the final (C, n, m).  Both it and the model's
chunkwise form sum the forget gates in one fixed tree order
(``chunk_cumsum``): held to a float64 sum.  Its products run on the
tensor cores in 3xTF32 (``matmul_3xtf32``, the TF32 operands emulated by
masking the low mantissa bits): held to an f32 product, and the whole
mLSTM at xlstm-125m's depth of 384 in 3xTF32 to JAX within the card's
limits (``MLSTM_TOL`` for h, C and n, ``MLSTM_M_TOL`` for m, each times
max(1, the largest value)), which one TF32 pass does not hold.  The scan
kernel splits each channel's states over lanes and sums y's dot product
in butterfly order (``selective_scan_lanes``): held to JAX's sequential
scan within ``SCAN_RTOL`` of the largest value.  Small shapes, f32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    chunk_cumsum, matmul_3xtf32, mlstm_chunk_reference, mlstm_chunk_split,
    tf32_truncate)
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    selective_scan_lanes)

# the card's limits (chip_smoke.py): the mLSTM's h, C and n and its m,
# each times max(1, the largest value); the scan's, times the largest y
MLSTM_TOL, MLSTM_M_TOL = 5e-4, 1e-5
SCAN_RTOL = 1e-4


def _mlstm_inputs(rng, B, H, L, dh):
    """``tests/test_kernels.py``'s draw: q, k, v standard normal, li of std
    0.5, lf = log_sigmoid(N + 1)."""
    q, k, v = (rng.standard_normal((B, H, L, dh)).astype(np.float32)
               for _ in range(3))
    li = (rng.standard_normal((B, H, L)) * 0.5).astype(np.float32)
    lf = -np.logaddexp(0.0, -(rng.standard_normal((B, H, L)) + 1.0))
    return q, k, v, li, lf.astype(np.float32)


def _within(got, want, rel):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    return err / (rel * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("B,H,L,dh,chunk", [
    (2, 2, 16, 16, 16),          # one chunk: no carried state
    (1, 2, 32, 16, 16),          # two chunks, one row
    (2, 2, 48, 16, 16),          # three
    (1, 3, 128, 32, 16)])        # eight
def test_chunk_parallel_state_matches_jax(B, H, L, dh, chunk):
    """Every chunk's update at once, then the ordered combine: h and the
    final (C, n, m) against JAX's chunkwise form (the Pallas kernel's
    arithmetic) and its recurrent form (the ground truth)."""
    args = _mlstm_inputs(np.random.default_rng(L + dh), B, H, L, dh)
    h, state = mlstm_chunk_split(*(torch.from_numpy(a) for a in args), chunk)
    jargs = [jnp.asarray(a) for a in args]
    for jh, jstate in (JX.mlstm_chunkwise(*jargs, chunk),
                       JX.mlstm_recurrent(*jargs)):
        assert _within(h, jh, MLSTM_TOL) <= 1.0
        for got, want, rel in zip(state, jstate,
                                  (MLSTM_TOL, MLSTM_TOL, MLSTM_M_TOL)):
            assert _within(got, want, rel) <= 1.0


@pytest.mark.parametrize("c", [1, 3, 64, 200, 256])
def test_chunk_cumsum_fixed_order(c):
    """The kernel's sum of the forget gates, ``chunk_cumsum`` (Sklansky
    levels over c padded to a power of two): within one rounding a level
    of the float64 sum, the same bits for a row alone as within any
    batch, and the final m of the split decomposition bit for bit that
    of the model's chunkwise form (both sum g so)."""
    rng = np.random.default_rng(c)
    q, k, v, li, lf = (torch.from_numpy(a)
                       for a in _mlstm_inputs(rng, 3, 5, 2 * c, 8))
    x = lf[..., :c]
    g = chunk_cumsum(x)
    exact = x.double().cumsum(-1)
    levels = max(c - 1, 0).bit_length()
    bound = levels * 2.0 ** -24 * float(exact.abs().max())
    assert float((g.double() - exact).abs().max()) <= bound
    assert torch.equal(chunk_cumsum(x[1:2, 3:4]), g[1:2, 3:4])
    _, (_, _, m_split) = mlstm_chunk_split(q, k, v, li, lf, c)
    _, (_, _, m_model) = mlstm_chunk_reference(q, k, v, li, lf, c)
    assert torch.equal(m_split, m_model)


def test_tf32_split_recovers_f32():
    """The split a = hi + lo: hi keeps 10 mantissa bits (the low 13 are
    zero), hi + lo (lo as a product reads it) is a to within 2**-20
    relative, and the 3xTF32 product at xlstm's depth (256 x 384 by 384
    x 384) is the f32 product's to within 1e-6 of its largest value,
    while one TF32 product is not."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((384, 384)).astype(np.float32))
    hi = tf32_truncate(a)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    lo = tf32_truncate(a - hi)
    assert float(((hi + lo - a).abs() / a.abs()).max()) <= 2.0 ** -20
    f32 = (a.double() @ b.double()).float()
    top = float(f32.abs().max())
    assert float((matmul_3xtf32(a, b) - f32).abs().max()) <= 1e-6 * top
    one = tf32_truncate(a) @ tf32_truncate(b)
    assert float((one - f32).abs().max()) > 1e-5 * top


def test_mlstm_in_3xtf32_holds_the_card_limits():
    """The whole chunkwise mLSTM at xlstm-125m's head width (dh = 384,
    chunk 256, two chunks) with every product in 3xTF32, against JAX's
    chunkwise form: h, C, n within a tenth of MLSTM_TOL times the
    largest value, and m within MLSTM_M_TOL (m takes no product: its
    error is the cumulative sum's order, one ulp of |g| ~ 100 here); one
    TF32 pass takes h past its limit."""
    args = _mlstm_inputs(np.random.default_rng(7), 1, 2, 512, 384)
    targs = [torch.from_numpy(a) for a in args]
    jh, jstate = JX.mlstm_chunkwise(*(jnp.asarray(a) for a in args), 256)
    want = (jh, *jstate)
    got = mlstm_chunk_split(*targs, 256, matmul=matmul_3xtf32)
    for g, w in zip((got[0], *got[1][:2]), want[:3]):
        assert _within(g, w, MLSTM_TOL) <= 0.1
    assert _within(got[1][2], want[3], MLSTM_M_TOL) <= 1.0

    def one_pass(x, y):
        return tf32_truncate(x) @ tf32_truncate(y)

    h1, _ = mlstm_chunk_split(*targs, 256, matmul=one_pass)
    assert _within(h1, jh, MLSTM_TOL) > 1.0


@pytest.mark.parametrize("N,per_lane", [(16, 4), (8, 4), (64, 4), (16, 2)])
@pytest.mark.parametrize("init", [False, True])
def test_lane_split_scan_matches_jax(N, per_lane, init):
    """Each channel's N states over N / per_lane lanes, y's dot product
    summed per lane and then over the lanes in butterfly order, the
    exponential taken as a power of two: y and the final state against
    JAX's sequential scan, within SCAN_RTOL of the largest value."""
    rng = np.random.default_rng(N + per_lane)
    B, L, d_in = 2, 40, 24
    u = rng.standard_normal((B, L, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, d_in)) - 2.0))
    Bm, Cm = (rng.standard_normal((B, L, N)).astype(np.float32)
              for _ in range(2))
    A = -np.exp(rng.standard_normal((d_in, N)) * 0.5).astype(np.float32)
    D = rng.standard_normal(d_in).astype(np.float32)
    s0 = rng.standard_normal((B, d_in, N)).astype(np.float32) if init \
        else None
    args = (u, dt.astype(np.float32), Bm, Cm, A, D, s0)
    y, s = selective_scan_lanes(
        *(None if a is None else torch.from_numpy(a) for a in args),
        per_lane=per_lane)
    jy, js = JS._selective_scan_ref(
        *(None if a is None else jnp.asarray(a) for a in args))
    top = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=SCAN_RTOL * top)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0,
                               atol=SCAN_RTOL * float(np.abs(js).max()))
