"""The JAX domain of the flash and grouped-matmul wrappers, and the
launcher's choice of a mesh, on the CPU.

The flash kernel is instantiated for head widths 32, 64, 128 and 256 and
any group; ``with_head_dim_padding`` runs any other width zero-padded to
the next one.  The grouped-matmul kernel loads through TMA, whose rows
are multiples of 16 bytes; ``with_stride_padding`` zero-pads D and F to
multiples of 8.  Both are exact, so here each runs the plain version
through the padding and must equal the plain version unpadded (flash
also the JAX Pallas kernel in interpret mode on the same numpy inputs),
in float32 (``atol=2e-5``, the float32 tolerance of ``test_kernels.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash)
from repro_torch.distributed.mesh import Mesh  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    kernel_head_dim, mha_reference, with_head_dim_padding)
from repro_torch.kernels.gmm.ops import (  # noqa: E402
    gmm_reference, with_stride_padding)
from repro_torch.launch import serve as launch  # noqa: E402

ATOL = 2e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=1e-2)


@pytest.mark.parametrize("H,Hkv,S,hd,window", [
    (2, 2, 37, 16, 0),       # G=1, ragged S, the narrowest width
    (9, 1, 45, 48, 13),      # G=9, window narrower than S
    (16, 1, 29, 80, 0),      # G=16
    (4, 4, 50, 96, 20),      # G=1, windowed
])
def test_flash_head_dim_padding_is_exact(H, Hkv, S, hd, window):
    rng = np.random.default_rng(hd + S)
    q, k, v = (_randn(rng, 1, H, S, hd), _randn(rng, 1, Hkv, S, hd),
               _randn(rng, 1, Hkv, S, hd))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    seen = []

    def body(qp, kp, vp, **kw):
        seen.append(qp.shape[-1])
        return mha_reference(qp, kp, vp, **kw)

    got = with_head_dim_padding(body, tq, tk, tv, causal=True,
                                window=window, scale=None)
    assert seen == [kernel_head_dim(hd)] and seen[0] > hd
    assert got.shape == (1, H, S, hd)
    torch.testing.assert_close(got, mha_reference(tq, tk, tv, window=window),
                               atol=ATOL, rtol=0)
    _close(got, jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          window=window, block_q=32, block_k=32,
                          interpret=True))


def test_flash_instantiated_widths_are_not_padded():
    assert [kernel_head_dim(hd) for hd in (1, 32, 33, 64, 65, 128, 200,
                                           256)] == [32, 32, 64, 64, 128,
                                                     128, 256, 256]
    with pytest.raises(ValueError, match="head_dim up to 256"):
        kernel_head_dim(257)


@pytest.mark.parametrize("E,C,D,F", [(2, 5, 136, 130), (1, 3, 131, 64),
                                     (3, 1, 13, 7)])
def test_gmm_stride_padding_is_exact(E, C, D, F):
    rng = np.random.default_rng(D + F)
    x, w = _randn(rng, E, C, D), _randn(rng, E, D, F)
    seen = []

    def body(xp, wp):
        seen.append((xp.shape[2], wp.shape[2]))
        return gmm_reference(xp, wp)

    got = with_stride_padding(body, torch.from_numpy(x), torch.from_numpy(w))
    assert seen == [(-(-D // 8) * 8, -(-F // 8) * 8)]
    assert got.shape == (E, C, F)
    torch.testing.assert_close(got, gmm_reference(torch.from_numpy(x),
                                                  torch.from_numpy(w)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_serving_mesh_never_spans_distinct_cards(cards, monkeypatch, capsys):
    """``--paged --shards N`` on a machine with 1, 2 or 4 cards: the bank
    shards logically (no mesh), since shards on distinct cards are not
    ported; the CPU platform's N logical devices get a mesh over the
    model's device; a CPU launcher run with ``--shards 2`` serves (once,
    under two cards)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    cuda = launch.visible_devices("gpu", None)
    assert len(cuda) == cards
    for shards in (2, 4):
        assert launch.serving_mesh(shards, cuda, torch.device("cuda", 0)) \
            is None
    cpu = torch.device("cpu")
    mesh = launch.serving_mesh(2, launch.visible_devices("cpu", 2), cpu)
    assert isinstance(mesh, Mesh) and mesh.devices == (cpu, cpu)
    assert mesh.device == cpu
    assert launch.serving_mesh(2, [cpu], cpu) is None         # too few
    assert launch.serving_mesh(1, [cpu] * 4, cpu) is None     # unsharded
    if cards != 2:
        return
    assert launch.main(["--platform", "cpu", "--mode", "continuous",
                        "--paged", "--page-size", "16", "--shards", "2",
                        "--host-devices", "2", "--requests", "2",
                        "--steps", "2", "--seq", "8", "--batch", "1"]) == 0
    assert '"mode": "continuous"' in capsys.readouterr().out


def test_reset_clears_the_launch_counts_by_shape():
    """``chip_smoke.py`` reads the launches of flash, gmm, the scan,
    the mLSTM and the paged verify at its later records' shapes from
    ``launches_by_shape``; zeroing the counts before a pass must clear
    them too."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.gmm.ops import gmm
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.paged_attention.ops import paged_verify_attention
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    flash_attention.launches_by_shape[(1, 32, 8, 4160, 128, 4096)] += 2
    gmm.launches_by_shape[(2, 320, 14336, 4096)] += 1
    ssm_scan.launches_by_shape[(1, 410, 8192, 16)] += 7
    mlstm_chunk.launches_by_shape[(1, 4, 768, 384, 256)] += 9
    paged_verify_attention.launches_by_shape[
        (1, 4, 8, 32, 9, 256, 64, True)] += 22
    kernels.reset_launch_counts()
    for fn in (flash_attention, gmm, ssm_scan, mlstm_chunk,
               paged_verify_attention):
        assert not fn.launches_by_shape
    assert gmm.launches_by_shape[(2, 320, 14336, 4096)] == 0
