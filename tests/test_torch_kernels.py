"""The port's three attention kernels against the JAX package's.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version (``ref.py``); these tests hold that version against the JAX
Pallas kernel run in interpret mode and against the JAX reference, on the
same numpy inputs, in float32 (``atol=2e-5``, the float32 tolerance of
``test_kernels.py``).  The hand-written kernels themselves are tested on
the card by ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode, decode_reference as jax_decode_ref)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash, mha_reference as jax_flash_ref)
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_attention as jax_paged)
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_reference as jax_paged_ref)
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_reference)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, mha_reference)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_attention, paged_decode_reference)

ATOL = 2e-5          # float32, as test_kernels.py:_tol


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-2)


def _shuffled_tables(rng, B, P, page, pos):
    """(B, P) page tables over a pool of B*P+1 pages in shuffled order;
    entries whose first position lies past the row's ``pos`` are dead
    and point at the park page 0."""
    ids = rng.permutation(np.arange(1, B * P + 1)).reshape(B, P)
    dead = np.arange(P)[None, :] * page > np.asarray(pos)[:, None]
    return np.where(dead, 0, ids).astype(np.int32)


# ---------------------------------------------------------------------------
# flash prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,S,hd,window", [
    (2, 4, 4, 72, 32, 0),       # G=1, S not a block multiple
    (1, 4, 2, 100, 32, 0),      # G=2, ragged
    (2, 4, 2, 64, 16, 24),      # G=2, sliding window
    (1, 2, 1, 40, 32, 7),       # G=2, window narrower than a block
    (1, 8, 2, 48, 128, 20),     # G=4 at hd 128 (mixtral), window < S
])
def test_flash_plain_matches_jax(B, H, Hkv, S, hd, window):
    rng = np.random.default_rng(S + window)
    q, k, v = (_randn(rng, B, H, S, hd), _randn(rng, B, Hkv, S, hd),
               _randn(rng, B, Hkv, S, hd))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=window)
    assert got.shape == (B, H, S, hd) and got.dtype == torch.float32
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       window=window, block_q=32, block_k=32, interpret=True)
    ref = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        window=window)
    _close(got, pallas)
    _close(got, ref)


# ---------------------------------------------------------------------------
# row-cache decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,S,hd,pos", [
    (3, 4, 4, 96, 32, [0, 41, 95]),       # G=1, ragged positions
    (4, 4, 2, 80, 32, [79, 3, 64, 17]),   # G=2
    (2, 2, 1, 64, 16, 30),                # G=2, one shared position
])
def test_decode_plain_matches_jax(B, H, Hkv, S, hd, pos):
    rng = np.random.default_rng(S + B)
    q, k, v = (_randn(rng, B, H, hd), _randn(rng, B, Hkv, S, hd),
               _randn(rng, B, Hkv, S, hd))
    p = np.asarray(pos, np.int32)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(p))
    pallas = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(p), block_k=32, interpret=True)
    ref = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(p))
    _close(got, pallas)
    _close(got, ref)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,P,page,hd,pos", [
    (3, 4, 4, 4, 16, 32, [0, 37, 63]),        # G=1
    (4, 4, 2, 3, 32, 32, [95, 5, 40, 64]),    # G=2, dead tail entries
    (2, 2, 1, 5, 8, 16, [12, 39]),            # G=2, small pages
])
def test_paged_plain_matches_jax(B, H, Hkv, P, page, hd, pos):
    rng = np.random.default_rng(P * page + B)
    NP = B * P + 1
    q = _randn(rng, B, H, hd)
    kp, vp = _randn(rng, NP, Hkv, page, hd), _randn(rng, NP, Hkv, page, hd)
    p = np.asarray(pos, np.int32)
    table = _shuffled_tables(rng, B, P, page, p)
    got = paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp),
                                 torch.from_numpy(table), torch.from_numpy(p))
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(p))
    _close(got, jax_paged(*args, interpret=True))
    _close(got, jax_paged_ref(*args))


def test_paged_plain_never_reads_park_page():
    """Garbage in the park page (and in pages past ``pos``) changes
    nothing: only positions [0, pos] of a row are read."""
    rng = np.random.default_rng(5)
    B, H, Hkv, P, page, hd = 2, 4, 2, 4, 8, 16
    q = torch.from_numpy(_randn(rng, B, H, hd))
    kp = torch.from_numpy(_randn(rng, B * P + 1, Hkv, page, hd))
    vp = torch.from_numpy(_randn(rng, B * P + 1, Hkv, page, hd))
    pos = torch.tensor([9, 20], dtype=torch.int32)
    table = torch.from_numpy(_shuffled_tables(rng, B, P, page, pos.numpy()))
    base = paged_decode_attention(q, kp, vp, table, pos)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0], vp2[0] = 1e4, -1e4
    out = paged_decode_attention(q, kp2, vp2, table, pos)
    torch.testing.assert_close(out, base, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dispatch and the launch counters
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(_randn(rng, 1, 2, 16, 16)),
               torch.from_numpy(_randn(rng, 1, 1, 16, 16)),
               torch.from_numpy(_randn(rng, 1, 1, 16, 16)))
    torch.testing.assert_close(flash_attention(q, k, v),
                               mha_reference(q, k, v), rtol=0, atol=0)
    pos = torch.tensor([7], dtype=torch.int32)
    torch.testing.assert_close(decode_attention(q[:, :, 0], k, v, pos),
                               decode_reference(q[:, :, 0], k, v, pos),
                               rtol=0, atol=0)
    table = torch.tensor([[1]], dtype=torch.int32)
    pool = torch.cat([torch.zeros_like(k), k])
    pool = pool.reshape(2, 1, 16, 16)
    torch.testing.assert_close(
        paged_decode_attention(q[:, :, 0], pool, pool, table, pos),
        paged_decode_reference(q[:, :, 0], pool, pool, table, pos),
        rtol=0, atol=0)
    assert (flash_attention.launches, decode_attention.launches,
            paged_decode_attention.launches) == (0, 0, 0)


def test_non_cpu_non_cuda_tensors_raise():
    """No silent fallback: a tensor on a device that is neither the CPU
    nor a CUDA card has no kernel and no plain path."""
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="several devices"):
        kernels.on_cpu(torch.zeros(1), q)
