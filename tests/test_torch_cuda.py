"""The hand-written Hopper kernels on the card, against their plain
PyTorch versions on the same CUDA tensors (bf16 in, ``atol=2e-2``, the
bf16 tolerance of ``test_kernels.py``).  Every test here is marked
``cuda`` and skips without a card.  This file imports neither JAX nor
the JAX package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_reference)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, mha_reference)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_attention, paged_decode_reference)

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (sm_90a kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)


@pytest.mark.parametrize("H,Hkv,hd", [(32, 4, 64), (8, 8, 32), (8, 4, 128),
                                      (4, 2, 64)])
def test_kernels_match_plain_and_count_launches(gen, H, Hkv, hd):
    kernels.reset_launch_counts()
    B, S = 2, 200                                   # S not a tile multiple
    q, k, v = _rn(gen, B, H, S, hd), _rn(gen, B, Hkv, S, hd), \
        _rn(gen, B, Hkv, S, hd)
    for window in (0, 48):
        _close(flash_attention(q, k, v, window=window),
               mha_reference(q, k, v, window=window))
    pos = torch.tensor([0, 199], dtype=torch.int32, device="cuda")
    qd = q[:, :, 0].contiguous()
    _close(decode_attention(qd, k, v, pos), decode_reference(qd, k, v, pos))
    page, P = 16, 13
    kp, vp = _rn(gen, B * P + 1, Hkv, page, hd), _rn(gen, B * P + 1, Hkv,
                                                    page, hd)
    table = torch.randperm(B * P, generator=gen, device="cuda") + 1
    table = table.reshape(B, P).to(torch.int32)
    table[0, 1:] = 0                                # row 0: one live page
    _close(paged_decode_attention(qd, kp, vp, table, pos),
           paged_decode_reference(qd, kp, vp, table, pos))
    torch.cuda.synchronize()
    assert (flash_attention.launches, decode_attention.launches,
            paged_decode_attention.launches) == (2, 1, 1)


def test_paged_kernel_never_reads_the_park_page(gen):
    B, H, Hkv, P, page, hd = 2, 8, 2, 4, 16, 64
    q = _rn(gen, B, H, hd)
    kp, vp = _rn(gen, B * P + 1, Hkv, page, hd), _rn(gen, B * P + 1, Hkv,
                                                    page, hd)
    table = (torch.arange(B * P, device="cuda") + 1).reshape(B, P)
    table = table.to(torch.int32)
    table[:, 2:] = 0
    pos = torch.tensor([20, 31], dtype=torch.int32, device="cuda")
    base = paged_decode_attention(q, kp, vp, table, pos)
    kp[0], vp[0] = float("nan"), float("nan")       # poison the park page
    out = paged_decode_attention(q, kp, vp, table, pos)
    torch.testing.assert_close(out, base, rtol=0, atol=0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q = torch.zeros(1, 4, 8, 64, device="cuda")      # float32
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, q, q)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(qb[..., :48], qb[..., :48], qb[..., :48])
    kv = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="group"):
        decode_attention(torch.zeros(1, 48, 64, dtype=torch.bfloat16,
                                     device="cuda"), kv, kv, 3)
